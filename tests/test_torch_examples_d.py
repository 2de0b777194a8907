"""The examples_torch/ mirrors of the other graph examples and the contig
assembly, each held to its JAX twin of examples/ (``assert_pair``).
"""

import pytest
from _torch_examples import assert_pair, db  # noqa: F401 (db: a fixture)

NAMES = [
    "debruijn6_monument.py",
    "debruijn7_membership.py",
    "debruijn8_branching.py",
    "debruijn9_iterative_extensions.py",
    "debruijn10_node_state.py",
    "debruijn11_frontline.py",
    "traversal1_contigs.py",
]


@pytest.mark.parametrize("name", NAMES)
def test_mirror_prints_what_jax_prints(name, db):
    assert_pair(name, db)
