"""Run an example script and compare what it prints.

Shared by ``tests/test_torch_examples_*.py`` (each mirror beside its JAX
twin of ``examples/`` on the CPU, through ``tests/_torch_examples.py``)
and ``chip_smoke.py`` phase 16 (each mirror on the card beside its own CPU
run). Three parts:

- ``fixture_db(dir, seed)`` writes seeded stand-ins for the reference's
  ``test/db`` files that the examples open (``reads1.fa``, ``reads2.fa``,
  ``microsnp.fa``);
- ``run_example(path, db, argv, env)`` runs one script with the
  reference's ``test/db`` prefix replaced by ``db`` in its text, in this
  process (``exec`` as ``__main__``, stdout captured) or, for the scripts
  whose ranks or virtual devices must be set up before anything else, as a
  process of its own;
- ``normalise(text)`` masks what cannot be equal between the two packages
  or between two runs (``MASKS``: each mask with its reason).

Imports neither jax nor the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import os
import re
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
REF_DB = "/root/reference/gatb-core/test/db"
# hard-coded output paths of the JAX examples (storage1, debruijn2,
# debruijn5): sent to the run's temporary directory like the mirrors'
TMP_LITERAL = '"/tmp/'
# scripts that must own their process: JAX's virtual 8-device mesh is set
# before JAX initialises, and RankPool's spawned ranks re-import the
# functions of the script they run, which an exec'd __main__ cannot give
SUBPROCESS = ("multichip1_exchange.py", "multichip2_distributed_count.py",
              "multichip3_postsolid.py")
# seconds a script run as a process may take
TIMEOUT = 900.0
NTS = np.array(list("ACGT"))

# (name, pattern, replacement, reason). Nothing else is masked: a count, a
# k-mer, a sequence, a checksum, a decision or a file's contents that
# differs is a fault of the port.
MASKS = (
    ("elapsed seconds", re.compile(r"('time(?:\.\w+)?': )\d+(?:\.\d+)?"),
     r"\1<s>",
     "TimeInfo stopwatch readings (misc1_properties) vary from run to "
     "run"),
    ("elapsed seconds in xml", re.compile(
        r"<(\w*time[\w.]*)>[^<]*</\1>"), r"<\1><s></\1>",
     "the stage times of the counting configuration that dbginfo prints "
     "(tools1_cli_tour: exec_time, fillsolid_time.*, time.*, time_fill, "
     "time_merge)"),
    ("elapsed seconds of dbgcheck", re.compile(r"(?m)^(time +=) \S+"),
     r"\1 <s>", "the wall time dbgcheck prints (tools1_cli_tour)"),
    ("temporary paths", re.compile(r"\S*/gatb_ex_\w+(?:/[\w.-]+)*"),
     "<tmp>",
     "a run's files lie in its own temporary directory (run_example's "
     "gatb_ex_* prefix); dbginfo prints the graph's path"),
    ("library version", re.compile(r"\b2\.0-(?:tpu|torch-cuda)\b"),
     "<library version>",
     "library_info()['version'] is '2.0-tpu' in JAX and "
     "'2.0-torch-cuda' in the port (ROADMAP C, the host tail)"),
    ("counting info keys of one package", re.compile(
        r"(?m)^ *<(?:nb_device_programs|parser|device)>[^<]*"
        r"</(?:nb_device_programs|parser|device)>\n"), "",
     "the counting info has nb_device_programs in JAX and parser and "
     "device in the port (ROADMAP C, counting); dbginfo prints the info "
     "as xml lines (tools1_cli_tour)"),
)


def normalise(text: str) -> str:
    """``text`` with every mask of ``MASKS`` applied, in order."""
    for _, pattern, repl, _ in MASKS:
        text = pattern.sub(repl, text)
    return text


def _reads(genome: str, n: int, length: int, rng, err_rate: float):
    """``n`` reads of ``length`` bases at uniform starts; a read carries
    one substitution with probability ``err_rate``."""
    starts = rng.integers(0, len(genome) - length + 1, size=n)
    errs = rng.random(n) < err_rate
    pos = rng.integers(0, length, size=n)
    sub = rng.integers(1, 4, size=n)
    out = []
    for s, e, p, d in zip(starts, errs, pos, sub):
        r = genome[s:s + length]
        if e:
            b = NTS[("ACGT".index(r[p]) + d) % 4]
            r = r[:p] + b + r[p + 1:]
        out.append(r)
    return out


def fixture_db(dir: str, seed: int = 1) -> str:
    """Write ``reads1.fa`` and ``reads2.fa`` (2,000 x 100 bp reads each of
    one 10 kbp genome, 20x, one substitution in a read of ten, so that
    k=31 and abundance-min 3 keep a graph with unitigs, contigs and a few
    error k-mers below the cut) and ``microsnp.fa`` (two 1 kbp haplotypes
    that differ at one base: a fork at k=7) into ``dir``; return
    ``dir``."""
    rng = np.random.default_rng(seed)
    os.makedirs(dir, exist_ok=True)
    genome = "".join(rng.choice(NTS, size=10_000))
    for name in ("reads1.fa", "reads2.fa"):
        with open(os.path.join(dir, name), "w") as f:
            for i, r in enumerate(_reads(genome, 2000, 100, rng, 0.1)):
                f.write(f">read{i}\n{r}\n")
    hap = "".join(rng.choice(NTS, size=1000))
    snp = hap[:500] + NTS[("ACGT".index(hap[500]) + 1) % 4] + hap[501:]
    with open(os.path.join(dir, "microsnp.fa"), "w") as f:
        f.write(f">hap1\n{hap}\n>hap2\n{snp}\n")
    return dir


def script_text(path: str, db: str, tmp: str) -> str:
    """The script's source with the reference's test/db prefix replaced by
    ``db`` and its hard-coded "/tmp/..." outputs sent to ``tmp``."""
    with open(path) as f:
        src = f.read()
    return src.replace(TMP_LITERAL, f'"{tmp}/').replace(REF_DB, db)


@contextlib.contextmanager
def _environ(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _tempdir(tmp: str):
    """tempfile's directory set to ``tmp`` for the run (and put back)."""
    old = tempfile.tempdir
    tempfile.tempdir = tmp
    try:
        yield
    finally:
        tempfile.tempdir = old


def run_example(path: str, db: str, argv=(), env=None) -> str:
    """Run the script at ``path`` with ``db`` in place of the reference's
    test/db and return what it printed. ``argv`` follows the script's
    name in ``sys.argv``; ``env`` is set for the run. A script that fails
    raises (``subprocess.CalledProcessError`` for a process, else its own
    exception)."""
    env = dict(env or {})
    name = os.path.basename(path)
    with tempfile.TemporaryDirectory(prefix="gatb_ex_") as tmp:
        src = script_text(path, db, tmp)
        if name in SUBPROCESS:
            script = os.path.join(tmp, name)
            with open(script, "w") as f:
                f.write(src)
            paths = [ROOT, HERE, os.environ.get("PYTHONPATH", "")]
            proc = subprocess.run(
                [sys.executable, script, *argv], capture_output=True,
                text=True, timeout=TIMEOUT, cwd=tmp,
                env={**os.environ, **env, "TMPDIR": tmp,
                     "PYTHONPATH": os.pathsep.join(p for p in paths if p)})
            if proc.returncode:
                raise subprocess.CalledProcessError(
                    proc.returncode, proc.args, proc.stdout, proc.stderr)
            return proc.stdout
        code = compile(src, path, "exec")
        out = io.StringIO()
        old_argv, old_path = sys.argv, list(sys.path)
        sys.argv = [path, *argv]
        sys.path.insert(0, HERE)
        try:
            with _environ(env), _tempdir(tmp), \
                    contextlib.redirect_stdout(out):
                exec(code, {"__name__": "__main__", "__file__": path})
        finally:
            sys.argv = old_argv
            sys.path[:] = old_path
        return out.getvalue()

