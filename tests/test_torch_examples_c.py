"""The examples_torch/ mirrors of the first five graph examples, each held
to its JAX twin of examples/ (``assert_pair``).
"""

import pytest
from _torch_examples import assert_pair, db  # noqa: F401 (db: a fixture)

NAMES = [
    "debruijn1_graph.py",
    "debruijn2_unitigs.py",
    "debruijn3_queries.py",
    "debruijn4_simplify.py",
    "debruijn5_gfa.py",
]


@pytest.mark.parametrize("name", NAMES)
def test_mirror_prints_what_jax_prints(name, db):
    assert_pair(name, db)
