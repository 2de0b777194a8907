"""The examples_torch/ mirrors of the bank, container, misc and fast k-mer
examples, each held to its JAX twin of examples/ (``assert_pair``); the
mirror list, the import scan and the masks of ``normalise``.
"""

import os

import pytest
from _torch_examples import (JAX_EXAMPLES, assert_pair,  # noqa: F401
                             db, runner)

NAMES = [
    "bank1_iterate.py",
    "bank2_filters.py",
    "bank3_album_composite.py",
    "bank4_binary_convert.py",
    "bank5_fastq_writer.py",
    "bank6_iterator_adaptors.py",
    "collections2_bags.py",
    "kmer1_model.py",
    "kmer4_minimizers.py",
    "kmer7_spans.py",
    "kmer8_bank_kmers.py",
    "kmer10_linear_counter.py",
    "misc1_properties.py",
    "misc2_system_info.py",
    "proto2_histo2d.py",
]


@pytest.mark.parametrize("name", NAMES)
def test_mirror_prints_what_jax_prints(name, db):
    assert_pair(name, db)


def test_mirror_file_list_equals_the_examples():
    """One mirror per JAX example, under the same name."""
    def scripts(folder):
        return sorted(f for f in os.listdir(folder)
                      if f.endswith(".py") and not f.startswith("_"))

    assert scripts(runner.HERE) == scripts(JAX_EXAMPLES)
    assert len(scripts(runner.HERE)) == 44


def test_mirrors_import_neither_jax_nor_the_jax_package():
    import ast

    paths = [os.path.join(runner.HERE, f)
             for f in os.listdir(runner.HERE) if f.endswith(".py")]
    assert len(paths) == 46
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                mods = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for mod in mods:
                assert mod.split(".")[0] not in (
                    "jax", "jaxlib", "gatb_core_tpu"), f"{path}: {mod}"


# lines of counts, k-mers, sequences, checksums, decisions and sizes that
# the examples print (from the JAX examples' output on the fixture)
KEPT = """\
nodes: 9944 branching: 4 checksum: 8c64779d75d52b6b
node: AAAAAAACCAAGAGATATAGGCATATCACAA out: 1 in: 1 abundance: 9
distinct: 14617 solid: 9808 auto cutoff: 5
histogram head: [   0 4662   11   67   69   46   61  101]
CATTGATAGTC minimizer_hash: 0x62
unitigs: 2 longest: 5365
simplify: SimplifyStats(tips_removed=0, bulges_removed=0, ec_removed=0, \
passes=12)
reloaded: 9944 state resumes after: 0xfe
compressed 12 reads, 2 anchors, 1328 payload bytes
lossless: ['ACGTACGTACGTGGCA', 'TTGACCGTAGGCATAT']
8-device mesh postsolid == single-device: adjacency=True cfp=True \
checksum=True
     <kmers_nb_solid>9944</kmers_nb_solid>
     <abundance_min>3</abundance_min>
checksumBranching  = 8c64779d75d52b6b
abundance          = 135316
state        : 0xfe [CONFIGURATION_DONE SORTING_COUNT_DONE BLOOM_DONE]
FOUND 3 WITH CHECKSUM 113
"""
# a line each mask is there for
MASKED = {
    "elapsed seconds": "timed: {'time': 0.05, 'time.work': 0.051}",
    "elapsed seconds in xml": "     <fillsolid_time.2.sort>67.549"
                              "</fillsolid_time.2.sort>",
    "elapsed seconds of dbgcheck": "time               = 0.604  ",
    "temporary paths": "graph        : /tmp/gatb_ex_zdzyn1ro/tmp468en7tl/"
                       "tour.h5",
    "library version": "library: 2.0-tpu",
    "counting info keys of one package": "     <parser>native</parser>\n",
}


@pytest.mark.parametrize("mask", [m[0] for m in runner.MASKS])
def test_mask_keeps_counts_and_kmers(mask):
    """Each mask alone leaves the lines of counts, k-mers and checksums
    as they are, and changes the line it is there for."""
    _, pattern, repl, reason = next(m for m in runner.MASKS
                                    if m[0] == mask)
    assert reason
    assert pattern.sub(repl, KEPT) == KEPT
    assert pattern.sub(repl, MASKED[mask]) != MASKED[mask]
