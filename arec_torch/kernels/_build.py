"""Build and load the port's CUDA kernels.

Each kernel is one source `arec_torch/csrc/<name>.cu` with a plain C entry
point (and may include the headers `arec_torch/csrc/*.cuh`). It is
compiled with nvcc for sm_90a (Hopper) into a shared library under
`arec_torch/_build/` (git-ignored) at first use, and loaded with ctypes.
The library's file name carries a hash of the source, the headers and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.

Nothing here runs at import time: the CPU-only test environment imports
every module and has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit (CUDA_HOME or PATH)")
    return found


def library_path(name: str) -> Path:
    parts = [(SRC_DIR / f"{name}.cu").read_bytes()]
    parts += [h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh"))]
    digest = hashlib.sha256(
        b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> dict[str, str]:
    """Compile every kernel in `names` that is not built yet, one nvcc per
    source, all started together. Returns {name: ptxas report} for the
    kernels compiled by this call; raises with nvcc's output on failure."""
    procs = {}
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so)
    reports, failed = {}, []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (rc {proc.returncode}):\n"
                          f"{out}")
            continue
        os.replace(tmp, so)      # atomic publish: a reader sees all or none
        reports[name] = out
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The kernel library `name`, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
