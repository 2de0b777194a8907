"""The multi-rank dry run: the whole pipeline over a mesh, held to one device.

Port of ``dryrun_multichip`` (the JAX package's ``__graft_entry__.py``).
``dryrun_multichip(n)`` spawns n ranks (``mesh.RankPool``) and runs
``dryrun_rank`` on each:

1. counting: the superbatch exchange driver with the DSK pass loop
   (nb_passes=2) and small capacities (capacity_factor=0.5, as in the JAX
   package, with small superbatches and tables), held to the dict ground
   truth; at 2 ranks the send windows overflow and superbatches are
   replayed (at more ranks this small bank fits every window); with
   n >= 4, also on a 2 x (n/2) (host, chip) mesh;
2. postsolid: the sharded adjacency and debloom sweeps and branching, held
   to the same graph built on one device;
3. unitigs, ``simplify()`` and Monument contigs over the mesh, held to the
   one-device graph: unitig sequences and abundances, ``node_state``, the
   removal counts and the contigs.

Run as ``python -m gatb_core_tpu_torch.parallel.dryrun [n] [--device D]
[--backend B]`` (default: 2 ranks, a card each, over NCCL;
``--device cpu``: gloo on the CPU).
"""

from __future__ import annotations

import numpy as np


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def dryrun_rank(mesh):
    """The dry run's body, called by every rank of ``mesh`` (a 1-D mesh);
    raises AssertionError where the mesh result differs from the ground
    truth or the one-device graph. Returns (the summary line, the
    superbatches replayed after an overflow)."""
    from ..bank.fasta import BankStrings
    from ..debruijn.graph import Graph
    from ..kmer.model import count_kmers_py
    from ..ops.kmer_ops import kmers_to_py
    from . import superbatch
    from .exchange import count_kmers_distributed
    from .mesh import make_mesh2d

    n_devices = mesh.size
    K, M = 31, 10
    rng = np.random.default_rng(1)
    genome = "".join(rng.choice(list("ACGT"), size=400))
    # overlapping reads covering the genome ~6x: duplicate k-mers whose
    # counts merge across ranks and across batches
    reads = [genome[s:s + 96]
             for s in rng.integers(0, 304, size=24 * n_devices)]
    reads.append("ACGTN" * 20)   # invalid characters
    for _ in range(6):           # mutated re-reads: branches and bulges
        s = int(rng.integers(0, 304))
        r = list(genome[s:s + 96])
        r[48] = "ACGT"[int(rng.integers(4))]
        reads.append("".join(r))
    replays = superbatch.retries["superbatch"]
    res = count_kmers_distributed(
        BankStrings(*reads), mesh, kmer_size=K, minimizer_size=M,
        abundance_min=1, nb_passes=2, batch_reads_per_device=8,
        # small windows and tables: the overflow retry
        capacity_factor=0.5, distinct_ratio_hint=0.001,
        superbatch_rows=1 << 12)
    exp = count_kmers_py(reads, K, abundance_min=1)
    got = dict(zip(kmers_to_py(res.solid_kmers), res.solid_counts.tolist()))
    _check(got == exp, f"mesh count differs ({len(got)} vs {len(exp)})")
    replays = superbatch.retries["superbatch"] - replays

    # ---- postsolid + unitigs on the mesh -------------------------------
    g_mesh = Graph(K, res.solid_kmers, res.solid_counts, mesh=mesh)
    g_mesh.build_postsolid(build_branching=True)
    ug_mesh = g_mesh.unitig_graph()
    g_one = Graph(K, res.solid_kmers, res.solid_counts, device=mesh.device)
    g_one.build_postsolid(build_branching=True)
    ug_one = g_one.unitig_graph()

    # ---- 2-D (host, chip) topology --------------------------------------
    twod_note = ""
    if n_devices >= 4 and n_devices % 2 == 0:
        mesh2 = make_mesh2d(2, n_devices // 2, device=mesh.device)
        res2 = count_kmers_distributed(
            BankStrings(*reads), mesh2, kmer_size=K, minimizer_size=M,
            abundance_min=1, nb_passes=2, batch_reads_per_device=8)
        got2 = dict(zip(kmers_to_py(res2.solid_kmers),
                        res2.solid_counts.tolist()))
        _check(got2 == exp, f"2-D mesh count differs ({len(got2)} vs "
               f"{len(exp)})")
        twod_note = (f"; 2x{n_devices // 2} (host, chip) mesh equal "
                     f"(chip-axis all-to-all + host-axis merge)")

    _check(np.array_equal(g_mesh.precompute_adjacency(),
                          g_one.precompute_adjacency()), "adjacency")
    _check(g_mesh.checksum_branching() == g_one.checksum_branching(),
           "branching checksum")
    _check(np.array_equal(g_mesh._debloom.cfp, g_one._debloom.cfp),
           "cFP set")
    _check(sorted(zip(list(ug_mesh.sequences),
                      ug_mesh.mean_abundance.tolist()))
           == sorted(zip(list(ug_one.sequences),
                         ug_one.mean_abundance.tolist())), "unitigs")

    # ---- simplify + contigs on the mesh ---------------------------------
    stats_mesh = g_mesh.simplify()
    stats_one = g_one.simplify()
    _check(np.array_equal(g_mesh.node_state, g_one.node_state),
           "mesh simplify diverged from one device")
    _check((stats_mesh.tips_removed, stats_mesh.bulges_removed,
            stats_mesh.ec_removed)
           == (stats_one.tips_removed, stats_one.bulges_removed,
               stats_one.ec_removed), "simplify stats")
    contigs_mesh, _ = g_mesh.contigs(traversal="monument")
    contigs_one, _ = g_one.contigs(traversal="monument")
    _check(sorted(contigs_mesh) == sorted(contigs_one),
           "mesh Monument contigs diverged")
    return (f"dryrun_multichip({n_devices}): OK, {len(got)} distinct, "
            f"{res.info['kmers_nb_valid']} total k-mers, 2-pass superbatch "
            f"exchange ({replays} superbatch replays after an overflow);"
            f" postsolid (adjacency + debloom + "
            f"branching), {ug_mesh.nb_unitigs} unitigs, simplify "
            f"({stats_mesh.tips_removed} tips/{stats_mesh.bulges_removed} "
            f"bulges/{stats_mesh.ec_removed} EC) and "
            f"{len(contigs_mesh)} Monument contigs built over {n_devices} "
            f"ranks ({mesh.backend}, {mesh.device}), equal to one "
            f"device{twod_note}", replays)


def dryrun_multichip(n_devices: int, device="cuda",
                     backend: str | None = None):
    """Spawn ``n_devices`` ranks on ``device`` (NCCL for cards, gloo on
    the CPU, unless ``backend`` says) and run ``dryrun_rank`` on each.
    Returns its (summary line, replays), which every rank must agree
    on."""
    from .mesh import RankPool

    with RankPool(n_devices, device=device, backend=backend) as pool:
        out = pool.run(dryrun_rank)
    _check(len(set(out)) == 1, "the ranks' summaries differ")
    return out[0]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", type=int, nargs="?", default=2, help="ranks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (a card per rank over NCCL) or cpu (gloo)")
    ap.add_argument("--backend", default=None,
                    help="nccl or gloo; default: nccl on cards, gloo on "
                    "the CPU")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n, args.device, args.backend)[0])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
