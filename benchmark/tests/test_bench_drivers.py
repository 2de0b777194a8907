"""Each traffic driver at a small size on the CPU, through the whole
harness, against the plain reference."""

import pytest

from bench_small import run, spec


@pytest.mark.parametrize("cell", ["ecoli_k31.dbg", "chr14q_k31.query"])
def test_cell_runs_correct(cell):
    rc, line, err = run(spec(cell))
    assert rc == 0, err
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    names = {"ecoli_k31.dbg": {"bases_per_s", "setup_s"},
             "chr14q_k31.query": {"queries_per_s", "query_p95_ms",
                                  "setup_s"}}[cell]
    assert set(line["metrics"]) == names
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert list(line)[-1] == "compared"
    assert all(v["limit"] == 0 and v["value"] == 0
               for v in line["compared"].values())
    last = err.strip().splitlines()[-len(line["compared"]):]
    assert all(x.startswith("compared ") for x in last)


def test_repeats_laid_as_configured():
    """A family without divergence is laid over its share of the genome,
    never overlapping, so its consensus's 3' k-mer recurs once a copy."""
    import torch

    from benchmark import gen as G
    from benchmark.reference import kmers as K

    fam = {"name": "x", "copies": 1000, "mb": 0.2, "share": 0.4,
           "consensus_len": 300, "consensi": 1, "keep_3prime": True,
           "divergence": [0.0, 0.0]}
    cfg = {"genome_len": 100_000, "repeats": {"families": [fam]}}
    a = G.genome(G.generator(2**35 + 7, "cpu"), cfg, "cpu")
    b = G.genome(G.generator(2**35 + 7, "cpu"), cfg, "cpu")
    assert torch.equal(a, b)
    gen = G.generator(2**35 + 7, "cpu")
    torch.randint(0, 4, (cfg["genome_len"],), generator=gen)
    cons = torch.randint(0, 4, (300,), generator=gen, dtype=torch.uint8)
    tail = K.canonical_values(cons[None, -31:], 31)[0, 0]
    lens = torch.randint(100, 301, (int(1.5 * 40_000 / 200) + 16,),
                         generator=gen)
    lens = lens[:int((lens.cumsum(0) <= 40_000).sum())]
    seen = int((K.canonical_values(a[None, :], 31) == tail).sum())
    assert seen == lens.numel() and 39_700 < int(lens.sum()) <= 40_000
    plain = G.genome(G.generator(2**35 + 7, "cpu"),
                     {"genome_len": 100_000}, "cpu")
    assert int((plain != a).sum()) > 20_000


def test_same_seed_same_inputs():
    import torch

    from benchmark import gen as G

    cfg = spec("ecoli_k31.dbg").config
    a = torch.cat(list(G.bank_blocks(cfg, 2**33 + 1, "cpu")[2]))
    b = torch.cat(list(G.bank_blocks(cfg, 2**33 + 1, "cpu")[2]))
    c = torch.cat(list(G.bank_blocks(cfg, 2**33 + 2, "cpu")[2]))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert a.shape == (G.n_reads(cfg), cfg["read_len"])
    assert int(a.max()) <= 3


def test_fastq_layout(tmp_path):
    import torch

    from benchmark import gen as G

    codes = torch.tensor([[0, 1, 2, 3], [3, 3, 0, 0]], dtype=torch.uint8)
    cfg = {"genome_len": 4, "coverage": 2, "read_len": 4,
           "bank_format": "fastq", "quality": "I"}
    path = tmp_path / "r.fq"
    n = G.write_bank(str(path), cfg, [codes])
    text = path.read_text()
    assert text == "@r0\nACTG\n+\nIIII\n@r1\nGGAA\n+\nIIII\n"
    assert n == len(text)
