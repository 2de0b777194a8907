"""Bag/IteratorFile containers (ref: tools/collections — BagFile,
BagCache, IteratorFile used by the debloom cFP spill)."""
import os
import tempfile
from gatb_core_tpu_torch.collections.containers import (BagCache, BagFile,
                                                  IteratorFile)

from _common import device

device()  # host only: the flag is taken and unused

fd, path = tempfile.mkstemp(suffix=".bag")
os.close(fd)
with BagFile(path) as bag:
    cache = BagCache(bag, 4)
    for v in range(10):
        cache.insert(v * 7)
    cache.flush()
back = list(IteratorFile(path))
print("bag round-trip:", back == [v * 7 for v in range(10)])
os.unlink(path)
