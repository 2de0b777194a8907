"""End-to-end multi-rank k-mer counting over a mesh.

The full SortingCount pipeline in SPMD form: reads shard over the data
axis, kmers are exchanged by minimizer partition via all-to-all (the
reference's fillPartitions spill, SortingCountAlgorithm.cpp:1211-1345),
each rank sorts/reduces its partitions, and the result equals the
single-device (and reference) table exactly. The JAX example's 8-device
mesh becomes 8 ranks spawned by RankPool over gloo: on the CPU with
``--device cpu``, and on the one card by default (every collective staged
through the host, so not a multi-card figure). Every rank returns the
global result; the ranks must agree, and the first one's is printed.
"""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.kmer.counting import count_kmers
from gatb_core_tpu_torch.parallel.exchange import count_kmers_distributed
from gatb_core_tpu_torch.parallel.mesh import RankPool

from _common import device


def count(mesh, reads):
    res = count_kmers_distributed(BankStrings(*reads), mesh, kmer_size=21,
                                  abundance_min=1, nb_passes=2)
    ref = count_kmers(BankStrings(*reads), kmer_size=21, abundance_min=1,
                      device=mesh.device)
    assert (res.solid_kmers == ref.solid_kmers).all()
    assert (res.solid_counts == ref.solid_counts).all()
    return (f"{res.info['nb_devices']} devices, "
            f"{res.info['nb_passes']} passes: "
            f"{res.info['kmers_nb_distinct']} distinct kmers — "
            "identical to the single-device table")


def inputs():
    """count's arguments after the mesh: the reads."""
    rng = np.random.default_rng(0)
    genome = "".join(rng.choice(list("ACGT"), size=500))
    return ([genome[s:s + 80] for s in rng.integers(0, 420, size=64)],)


def main():
    with RankPool(8, device=device(), backend="gloo") as pool:
        outs = pool.run(count, *inputs())
    assert all(o == outs[0] for o in outs)
    print(outs[0])


if __name__ == "__main__":
    main()
