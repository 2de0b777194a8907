"""The examples_torch/ mirrors of Leon, the MicroSNP proto and the CLI tour,
each held to its JAX twin of examples/ (``assert_pair``).

The port's tools take no device flag (as in the JAX package), so for
``tools1_cli_tour`` the test hands the port's ``Graph.create`` and
``Graph.load`` the CPU, as tests/test_torch_dbgh5.py does.
"""

import pytest
from _torch_examples import assert_pair, db  # noqa: F401 (db: a fixture)

# The JAX twin of the CLI tour takes over a minute alone: its dbgh5 plans
# a 2^25-row superbatch from the default -max-memory whatever the bank's
# size (gatb_core_tpu/tools/dbgh5.py:134) and sorts it on the CPU
NAMES = [
    "leon1_interop.py",
    "leon2_roundtrip.py",
    "proto1_microsnp.py",
    pytest.param("tools1_cli_tour.py", marks=pytest.mark.slow),
]


@pytest.fixture
def tools_on_cpu(monkeypatch):
    """The port's graph tools build and load their graph on the CPU."""
    from gatb_core_tpu_torch.debruijn.graph import Graph

    create, load = Graph.create.__func__, Graph.load.__func__
    monkeypatch.setattr(Graph, "create", classmethod(
        lambda cls, *a, **kw: create(cls, *a, **kw, device="cpu")))
    monkeypatch.setattr(Graph, "load", classmethod(
        lambda cls, *a, **kw: load(cls, *a, **kw, device="cpu")))


@pytest.mark.parametrize("name", NAMES)
def test_mirror_prints_what_jax_prints(name, db, request):
    if name == "tools1_cli_tour.py":
        request.getfixturevalue("tools_on_cpu")
    assert_pair(name, db)
