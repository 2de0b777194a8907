"""IProperties + XML dump + Progress + TimeInfo (ref: the reference's
Tool/Algorithm info plumbing, tools/misc/impl/Property.cpp)."""
import time
from gatb_core_tpu_torch.misc.properties import Properties
from gatb_core_tpu_torch.misc.time_info import TimeInfo, Progress

from _common import device

device()  # host only: the flag is taken and unused

props = Properties()
props.add(0, "demo")
props.add(1, "kmer_size", 31)
props.add(1, "abundance_min", 3)
print(props.dump_raw())
print(props.dump_xml())

ti = TimeInfo()
with ti.section("work"):
    time.sleep(0.05)
print("timed:", ti.get_properties("time"))
p = Progress(10, "demo progress", verbose=False)
for _ in range(10):
    p.inc(1)
p.finish()
