"""What tests/test_torch_examples_*.py share: each examples_torch/ mirror
beside its JAX twin of examples/ on the same seeded stand-in for the
reference's test/db (the ``db`` fixture). ``assert_pair`` holds the two
to the same printed lines once ``runner.normalise`` has masked times,
temporary paths and the differences ROADMAP C lists (tolerance 0). The
JAX example runs on the CPU, the mirror with ``--device cpu`` (its
kernels' plain versions).
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = os.path.join(ROOT, "examples")
sys.path.insert(0, os.path.join(ROOT, "examples_torch"))
import _runner as runner  # noqa: E402


@pytest.fixture(scope="module")
def db(tmp_path_factory):
    return runner.fixture_db(str(tmp_path_factory.mktemp("db")), seed=1)


def pair(name: str, db: str) -> tuple[str, str]:
    """What the JAX example ``examples/<name>`` and its mirror
    ``examples_torch/<name>`` print on the same ``db``: the JAX one with
    ``JAX_PLATFORMS=cpu``, the mirror with ``--device cpu`` on one torch
    thread (the test suite's workers share the host's cores; torch's
    default of one thread a core spends several times the CPU on these
    small tensors for the same result)."""
    import torch

    twin = runner.run_example(os.path.join(JAX_EXAMPLES, name), db,
                              env={"JAX_PLATFORMS": "cpu"})
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mirror = runner.run_example(os.path.join(runner.HERE, name), db,
                                    argv=["--device", "cpu"])
    finally:
        torch.set_num_threads(threads)
    return twin, mirror


def assert_pair(name: str, db: str) -> None:
    """Both print something, and the same lines once normalised."""
    twin, mirror = pair(name, db)
    assert twin.strip() and mirror.strip()
    assert runner.normalise(mirror) == runner.normalise(twin)
