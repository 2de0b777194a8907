"""Both cells at a small size on a CUDA card, through the harness."""

import pytest

from bench_small import run, spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ecoli_k31.dbg", "chr14q_k31.query"])
@pytest.mark.parametrize("trace", [False, True])
def test_cell_on_the_card(cuda_card, cell, trace):
    rc, line, err = run(spec(cell), trace=trace, device=cuda_card)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    if trace:
        assert line["device"]["busy_s"] > 0
        assert line["breakdown"]["device_ops"]
