"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, under ``build/kernels/`` at the
root of the checkout, on first use; the libraries are loaded with
``ctypes``.  Sources are built in parallel (one ``nvcc`` per file, all
started together), and a library is named by the hash of its source and
flags, so an edited source rebuilds and an unchanged one loads at once.
Nothing here runs at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "library", "check"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the CUDA kernels are built on "
            "first use and need the CUDA toolkit"
        )
    return str(path)


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all(extra_flags: tuple[str, ...] = ()) -> dict[str, float]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{source stem: seconds}`` for the sources compiled by this
    call.  ``extra_flags`` are appended to the nvcc command line (for
    example ``("-Xptxas", "-v")`` to print register and spill counts).
    Raises with nvcc's output if any compilation fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for src in sorted(CSRC.glob("*.cu")):
        target = _target(src)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs[src.stem] = (proc, tmp, target, time.perf_counter())
    times, failures = {}, []
    for stem, (proc, tmp, target, t0) in jobs.items():
        out, _ = proc.communicate()
        times[stem] = time.perf_counter() - t0
        if out.strip():
            print(f"[nvcc {stem}]\n{out.rstrip()}")
        if proc.returncode != 0:
            failures.append(f"{stem}: nvcc exited {proc.returncode}\n{out}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, target)  # atomic: concurrent builds agree
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return times


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built if needed)."""
    lib = _LIBS.get(stem)
    if lib is None:
        src = CSRC / f"{stem}.cu"
        if not _target(src).exists():
            build_all()
        lib = ctypes.CDLL(str(_target(src)))
        _LIBS[stem] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error for its launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {err}")
