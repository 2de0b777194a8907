"""Mesh-sharded postsolid: adjacency + debloom + unitigs over an
8-rank mesh, equal to single-device (ref: the Dispatcher-parallel
sweeps in DebloomAlgorithm.cpp:270-300 / Graph.cpp:3508-3610).

The JAX example's 8-device mesh becomes 8 ranks spawned by RankPool over
gloo: on the CPU with ``--device cpu``, and on the one card by default
(every collective staged through the host). Every rank builds both graphs
and returns the comparison; the ranks must agree, and the first one's is
printed."""
import numpy as np
from gatb_core_tpu_torch.bank.fasta import BankStrings
from gatb_core_tpu_torch.debruijn.graph import Graph
from gatb_core_tpu_torch.parallel.mesh import RankPool

from _common import device


def compare(mesh, reads):
    g1 = Graph.create(BankStrings(*reads), kmer_size=15, abundance_min=1,
                      device=mesh.device)
    g2 = Graph.create(BankStrings(*reads), kmer_size=15, abundance_min=1,
                      mesh=mesh)
    same_adj = (g1.precompute_adjacency()
                == g2.precompute_adjacency()).all()
    same_cfp = (g1._debloom.cfp == g2._debloom.cfp).all()
    same_sum = g1.checksum_branching() == g2.checksum_branching()
    return (f"8-device mesh postsolid == single-device: "
            f"adjacency={same_adj} cfp={same_cfp} checksum={same_sum}")


def inputs():
    """compare's arguments after the mesh: the reads."""
    rng = np.random.default_rng(21)
    genome = "".join(rng.choice(list("ACGT"), size=900))
    return ([genome[s:s+100] for s in rng.integers(0, 800, size=120)],)


def main():
    with RankPool(8, device=device(), backend="gloo") as pool:
        outs = pool.run(compare, *inputs())
    assert all(o == outs[0] for o in outs)
    print(outs[0])


if __name__ == "__main__":
    main()
