"""The controls (the reference with 32-bit k-mer keys in the program's
place) come out not correct, at a size a test run holds."""

import pytest

from benchmark import harness

SIZE = {"genome_len": 60000}


@pytest.mark.parametrize("cell,fails", [
    ("ecoli_k31.dbg", "solid_kmers_diff"),
    ("chr14q_k31.query", "mask_diff")])
def test_control_is_not_correct(cell, fails):
    spec = harness.load_spec(cell)
    spec.config.update(SIZE)
    if spec.traffic["driver"] == "graph_query":
        spec.traffic.update(pool_batches=8, batch_reads=256)
    compared, failed = spec.driver.control(spec.config, spec.traffic,
                                           2**31 + 17, "cpu")
    assert failed >= 1
    assert compared[fails][0] > compared[fails][1] == 0
