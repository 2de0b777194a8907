"""Storage byte streams inside HDF5 groups (ref: Storage::ostream /
istream, tools/storage/impl/Storage.cpp — the Repartitor and Leon
containers persist through these)."""
import os
import tempfile
from gatb_core_tpu_torch.storage.hdf5 import Storage

from _common import device

device()  # host only: the flag is taken and unused

_fd, path = tempfile.mkstemp(suffix=".h5")
os.close(_fd)
st = Storage(path, "w")
g = st.group("demo")
with g.ostream("blob") as os_:
    os_.write(b"reference-compatible ")
    os_.write(b"byte stream")
st.flush()

st2 = Storage(path, "r")
data = st2.group("demo").istream("blob").read()
print("round-tripped:", data.decode())
