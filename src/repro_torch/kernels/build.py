"""Builds the CUDA sources in ``repro_torch/csrc/`` and loads them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes``. Libraries go to
``build/repro_torch/`` at the repository root (ignored by git), named by a
digest of their source, the flags and the compiler's version, so an edited
source or a new toolchain is rebuilt and an unchanged one is built once. :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for every one of them.

Nothing here runs at import: a library is built at its first use.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels cannot be built")


@functools.lru_cache(maxsize=None)
def nvcc_version() -> str:
    """``nvcc --version`` of the compiler that builds the libraries."""
    return subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` lives, keyed by its source,
    the shared headers it may include, the flags and the compiler."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(nvcc_version().encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def kernel_names() -> List[str]:
    """One kernel per ``csrc/<name>.cu``."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(names: Optional[Sequence[str]] = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/``) whose library
    is missing, in parallel.

    Raises with the compiler's output if any build fails. The ``ptxas``
    report (registers, shared memory, spills) of each build is kept beside
    its library as ``<library>.log``.
    """
    targets = {n: library_path(n) for n in (names or kernel_names())}
    missing = {n: p for n, p in targets.items() if not p.exists()}
    if not missing:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, out in missing.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            tmp.unlink(missing_ok=True)
            continue
        out = missing[name]
        Path(f"{out}.log").write_text(log)
        os.replace(tmp, out)             # atomic: never a half-written .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return targets


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = ctypes.CDLL(str(build([name])[name]))
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


#: a C entry point returns this plus the CUresult of a failed
#: ``cuTensorMapEncodeTiled`` (``csrc/tensor_map.cuh``'s ``tma::kError``)
TMAP_ERROR = 100000


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point reported an error: its return value is
    ``cudaGetLastError()`` right after the launch, or :data:`TMAP_ERROR`
    plus the CUresult of a tensor map it could not encode."""
    if err >= TMAP_ERROR:
        raise RuntimeError(f"{what}: cuTensorMapEncodeTiled failed with "
                           f"CUresult {err - TMAP_ERROR}")
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
