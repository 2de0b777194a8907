"""gatb_core_tpu_torch — the k-mer / de Bruijn graph engine on PyTorch and CUDA.

A port of ``gatb_core_tpu`` (JAX on a TPU) to one NVIDIA H100. It keeps
the JAX package's module layout and function names; the JAX package stays
the reference it is tested against. The port covers counting (fold path
and LSM merge chain, multibank), the whole graph build of dbgh5 (MPHF,
Bloom, debloom, adjacency, branching, the node queries), ``Graph.load``,
unitig compaction, simplification (tips, bulges, erroneous connections)
and the Monument assembly:

    from gatb_core_tpu_torch import Graph, count_kmers
    res = count_kmers("reads.fa", kmer_size=31, abundance_min=3)
    graph = Graph.create("reads.fa", kmer_size=31)
    unitigs = graph.unitig_graph()
    graph.simplify()
    contigs, _ = graph.contigs(traversal="monument")

    python -m gatb_core_tpu_torch.tools.dbgh5 -in reads.fa -out graph.h5
    python -m gatb_core_tpu_torch.tools.dbginfo -in graph.h5

Tensors live on ``device="cuda"`` by default; the Pallas sort kernels of
the JAX package are hand-written CUDA kernels here (ops/limb_sort.py), as
is the rank search every graph stage stands on (ops/rank_search.py), built
with nvcc at first use.
"""

from .bank.fasta import (  # noqa: F401
    BankAlbum, BankComposite, BankFasta, BankStrings, IBank, Sequence,
    open_bank)
from .collections.bloom import BloomFilter, build_bloom  # noqa: F401
from .debruijn.graph import Graph  # noqa: F401
from .debruijn.traversal import assemble_contigs  # noqa: F401
from .kmer.counting import (  # noqa: F401
    CountConfig, CountResult, MultiBankCountResult, SortingCount,
    count_kmers, count_kmers_multibank, solidity_check)
from .kmer.histogram import Histogram  # noqa: F401
from .storage.hdf5 import Storage  # noqa: F401

__version__ = "0.1.0"
