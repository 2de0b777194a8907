"""The examples_torch/ mirrors of the mesh examples, each script in a
process of its own (JAX's virtual 8-device mesh, the port's 8 gloo
ranks), each held to its JAX twin of examples/ (``assert_pair``).
"""

import pytest
from _torch_examples import assert_pair, db  # noqa: F401 (db: a fixture)

NAMES = [
    "multichip1_exchange.py",
    "multichip2_distributed_count.py",
    "multichip3_postsolid.py",
]


@pytest.mark.parametrize("name", NAMES)
def test_mirror_prints_what_jax_prints(name, db):
    assert_pair(name, db)
