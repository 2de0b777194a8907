"""System/host/library info + TimeInfo trees (ref: examples/tools/
multithreading1.cpp env dumps + System::info)."""
import time
from gatb_core_tpu_torch.misc.time_info import TimeInfo
from gatb_core_tpu_torch.system.info import SystemInfo, host_info, library_info

from _common import device

device()  # host only: the flag is taken and unused

ti = TimeInfo()
with ti.section("work"):
    time.sleep(0.01)
print("host:", sorted(host_info().keys()))
print("library:", library_info()["version"] if
      "version" in library_info() else library_info())
print("cores:", SystemInfo().nb_cores(), "timed:",
      round(ti.entries["work"], 3) >= 0.01)
