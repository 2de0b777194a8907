"""The examples_torch/ mirrors of the counting and storage examples, each
held to its JAX twin of examples/ (``assert_pair``).
"""

import pytest
from _torch_examples import assert_pair, db  # noqa: F401 (db: a fixture)

NAMES = [
    "kmer2_count.py",
    "kmer3_count_processor.py",
    "kmer5_histogram.py",
    "kmer6_repartition.py",
    "kmer9_multibank.py",
    "storage1_hdf5.py",
    "storage2_mphf_interop.py",
    "storage3_streams.py",
    "storage4_kff.py",
    "storage5_file_backend.py",
]


@pytest.mark.parametrize("name", NAMES)
def test_mirror_prints_what_jax_prints(name, db):
    assert_pair(name, db)
