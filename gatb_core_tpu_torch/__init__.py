"""gatb_core_tpu_torch — the k-mer counting engine on PyTorch and CUDA.

A port of ``gatb_core_tpu`` (JAX on a TPU) to one NVIDIA H100. It keeps
the JAX package's module layout and function names; the JAX package stays
the reference it is tested against. The port covers counting (fold path
and LSM merge chain, multibank) and the counting stage of dbgh5:

    from gatb_core_tpu_torch import count_kmers
    res = count_kmers("reads.fa", kmer_size=31, abundance_min=3)

    python -m gatb_core_tpu_torch.tools.dbgh5 -in reads.fa -out graph.h5 \
        -bloom none -debloom none -mphf none -branching-nodes none

Tensors live on ``device="cuda"`` by default; the Pallas sort kernels of
the JAX package are hand-written CUDA kernels here (ops/limb_sort.py),
built with nvcc at first use.
"""

from .bank.fasta import (  # noqa: F401
    BankFasta, BankStrings, IBank, Sequence, open_bank)
from .kmer.counting import (  # noqa: F401
    CountConfig, CountResult, MultiBankCountResult, SortingCount,
    count_kmers, count_kmers_multibank)
from .kmer.histogram import Histogram  # noqa: F401
