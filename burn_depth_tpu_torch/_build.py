"""Builds the port's CUDA kernels from ``csrc/*.cu`` and counts their launches.

Each source compiles with ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``.  Builds happen on
first use into ``_kernels_build/`` beside this file (git-ignored), keyed by a
hash of the source and the flags, so an edited source rebuilds and an
unchanged one is loaded as it is.  All sources compile in parallel, one
``nvcc`` process each.  A failed build raises with the compiler's output.

Launch counts: every kernel wrapper calls :func:`count_launch` exactly where
it launches its kernel, so a run can show which kernels its path went
through (``reset_launch_counts`` before, ``LAUNCH_COUNTS`` after).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_kernels_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

LAUNCH_COUNTS: dict[str, int] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}


def count_launch(name: str) -> None:
    LAUNCH_COUNTS[name] = LAUNCH_COUNTS.get(name, 0) + 1


def reset_launch_counts() -> None:
    for name in list(LAUNCH_COUNTS):
        LAUNCH_COUNTS[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> dict[str, float]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library, all at
    once.  Returns ``{kernel: seconds}`` for the sources compiled in this
    call; their ``-Xptxas -v`` reports land in ``BUILD_LOGS``."""
    sources = sorted(CSRC.glob("*.cu"))
    todo = [s for s in sources if not _target(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for src in todo:
        tmp = _target(src).with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[src] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    seconds, errors = {}, []
    for src, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        seconds[src.stem] = time.perf_counter() - t0
        BUILD_LOGS[src.stem] = out
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name} (exit {proc.returncode}):\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _target(src))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        src = CSRC / f"{name}.cu"
        if not src.exists():
            raise FileNotFoundError(src)
        if not _target(src).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(src)))
        _LIBS[name] = lib
    return lib
