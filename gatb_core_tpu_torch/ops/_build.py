"""Build and load the port's CUDA kernels (``nvcc`` + ``ctypes``).

Each ``.cu`` source under ``ops/csrc/`` compiles with a plain C interface
into a shared library under ``gatb_core_tpu_torch/_build/`` (listed in
``.gitignore``), named by a hash of the source and the flags, at first use.
Nothing is compiled when a module is imported, and nothing falls back:
a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
CSRC_DIR = os.path.join(PKG_DIR, "ops", "csrc")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_lock = threading.Lock()           # guards the two dictionaries below
_libs: dict[str, ctypes.CDLL] = {}
_build_locks: dict[str, threading.Lock] = {}
# seconds spent compiling, by source name (0.0 when the library was cached)
build_seconds: dict[str, float] = {}


def source_hash(paths, flags) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def compile_shared(cmd_prefix: list[str], src: str, flags: list[str],
                   stem: str, extra_args: list[str] = ()) -> str:
    """Compile ``src`` into ``_build/<stem>-<hash>.so`` unless that file
    exists; returns its path. Concurrent builders each write a private
    temporary file and rename it into place."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR,
                      f"{stem}-{source_hash([src], cmd_prefix + flags)}.so")
    if os.path.exists(so):
        build_seconds.setdefault(stem, 0.0)
        return so
    tmp = f"{so}.{os.getpid()}.{threading.get_ident()}.tmp"
    t0 = time.time()
    proc = subprocess.run(cmd_prefix + flags + ["-o", tmp, src]
                          + list(extra_args),
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {os.path.basename(src)} failed:\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_seconds[stem] = time.time() - t0
    return so


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def load_cuda(stem: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build (if needed) and load ``ops/csrc/<stem>.cu``. ``defines`` are
    ``-D`` macros (``NAME=VALUE``) of a variant build, which is a library
    of its own. Each library has a lock of its own, so threads that ask
    for different sources compile at the same time."""
    key = " ".join((stem,) + tuple(defines))
    with _lock:
        build_lock = _build_locks.setdefault(key, threading.Lock())
    with build_lock:
        lib = _libs.get(key)
        if lib is None:
            flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
            so = compile_shared([nvcc_path()],
                                os.path.join(CSRC_DIR, f"{stem}.cu"),
                                flags, stem)
            lib = ctypes.CDLL(so)
            _libs[key] = lib
        return lib
