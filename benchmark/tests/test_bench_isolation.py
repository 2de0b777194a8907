"""What a run loads: no JAX and no JAX package in the harness, and
nothing of the program in the reference. Module names are compared by
their whole top-level name, so ``gatb_core_tpu_torch`` is not taken for
``gatb_core_tpu``."""

import json
import os
import subprocess
import sys

from benchmark import harness

ROOT = harness.ROOT


def loaded_after(code: str) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    top = loaded_after(
        "import sys\nsys.path.insert(0, 'benchmark/tests')\n"
        "import bench_small\n"
        "for c in ('ecoli_k31.dbg', 'chr14q_k31.query'):\n"
        "    rc, line, err = bench_small.run(bench_small.spec(c))\n"
        "    assert rc == 0 and line['correct'], err\n"
        "import benchmark.run, benchmark.control\n")
    assert "gatb_core_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    top = loaded_after(
        "import benchmark.reference.kmers, benchmark.reference.dbg, "
        "benchmark.reference.control, benchmark.gen, benchmark.work\n")
    assert not top & {"gatb_core_tpu_torch", *harness.FORBIDDEN}


def test_forbidden_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "gatb_core_tpu_torch_x", sys)
    assert "gatb_core_tpu_torch_x" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake", sys)
    assert "jaxlib.fake" in harness.forbidden_modules()


def test_harness_reads_no_jax_benchmark():
    """No module of the benchmark imports ``bench`` or ``chip_smoke``, or
    names their files outside a docstring."""
    import ast

    for dirpath, _, files in os.walk(harness.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(dirpath, f)).read())
            docs = {id(n.body[0].value) for n in ast.walk(tree)
                    if isinstance(n, (ast.Module, ast.FunctionDef,
                                      ast.ClassDef)) and n.body
                    and isinstance(n.body[0], ast.Expr)}
            for n in ast.walk(tree):
                if isinstance(n, ast.Import):
                    names = [a.name for a in n.names]
                elif isinstance(n, ast.ImportFrom):
                    names = [n.module or ""]
                else:
                    names = []
                assert not {x.split(".")[0] for x in names} & {
                    "bench", "chip_smoke", *harness.FORBIDDEN}, (f, names)
                if isinstance(n, ast.Constant) and isinstance(n.value, str) \
                        and id(n) not in docs and "tests" not in dirpath:
                    assert "chip_smoke" not in n.value, f
                    assert "bench.py" not in n.value, f
