"""Build and load the port's CUDA kernels (``repro_torch/csrc``).

``nvcc`` compiles each ``.cu`` file for ``sm_90a`` (all started at
once), links the objects into one shared library with a plain C
interface, and ``ctypes`` loads it.  The library lands in
``build/repro_torch_kernels/`` at the repository root, named by a hash
of the sources and flags, so a checkout builds its own kernels at first
use and an edited source rebuilds.  Nothing here runs when the package
is imported: the wrappers call :func:`load` only for CUDA tensors.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import List

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
#: No --use_fast_math: the fast forms must match their plain versions.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _sources() -> List[Path]:
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "repro_torch are built from source at first use")


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"librepro_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library if this source hash has none yet; returns
    its path.  The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills per kernel) is kept beside it as ``<name>.log``."""
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    work = BUILD_DIR / f"tmp-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in _sources():
        if src.suffix != ".cu":
            continue
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp_lib = work / lib.name
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp_lib), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    log.append(f"== build took {time.perf_counter() - t0:.2f} s")
    lib.with_suffix(".log").write_text("\n".join(log))
    os.replace(tmp_lib, lib)
    shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, declare the C interface."""
    lib = ctypes.CDLL(str(build()))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_fused_matmul.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i,
                                       ctypes.c_float, i, i, i, i, p, p, p]
    lib.repro_fused_matmul.restype = i
    lib.repro_fused_matmul_q8.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                          ctypes.c_float, i, ctypes.c_float,
                                          i, i, i, i, i, i, i, i, p, p, i, p]
    lib.repro_fused_matmul_q8.restype = i
    lib.repro_fast_act.argtypes = [p, p, ctypes.c_longlong, i, i, p]
    lib.repro_fast_act.restype = i
    lib.repro_decode_attention.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                           ctypes.c_float, i, i, p, p, p, p,
                                           p, p]
    lib.repro_decode_attention.restype = i
    lib.repro_error_string.argtypes = [i]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc:
        msg = lib.repro_error_string(rc).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({msg})")
