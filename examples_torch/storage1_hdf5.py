"""Storage tree persistence + reload (ref: examples/storage/storage1.cpp)."""
import os
import tempfile
from gatb_core_tpu_torch import Graph
from gatb_core_tpu_torch.storage.hdf5 import Storage

from _common import device

dev = device()
h5 = os.path.join(tempfile.gettempdir(), "storage_example.h5")

graph = Graph.create("/root/reference/gatb-core/test/db/reads1.fa",
                     kmer_size=31, abundance_min=3,
                     output=h5, device=dev)
graph.storage.close()
g2 = Graph.load(h5, device=dev)
print("reloaded:", g2.nb_nodes, "state resumes after:",
      hex(g2.storage.get_state()))
g2.storage.close()
