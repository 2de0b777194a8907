"""Raw-file storage backend (ref: StorageFactory STORAGE_FILE mode,
tools/storage/impl/StorageFile.hpp)."""
import tempfile
import numpy as np
from gatb_core_tpu_torch.storage.filedir import StorageFactory

from _common import device

device()  # host only: the flag is taken and unused

base = tempfile.mkdtemp()
st = StorageFactory.create(f"{base}/graph", mode="file", file_mode="w")
g = st.group("dsk")
g.set_dataset("solid", np.arange(12, dtype=np.uint64).reshape(3, 4))
g.set_property("nb_solid", 3)
back = StorageFactory.create(f"{base}/graph", mode="file")
print("rows:", back.group("dsk").get_dataset("solid").shape[0],
      "prop:", back.group("dsk").get_property("nb_solid"))
gz = StorageFactory.create(f"{base}/graph_gz", mode="gzfile",
                           file_mode="w")
gz.group("x").set_dataset("blob", np.zeros(1000, np.uint8))
print("gz backend ok")
