"""Build the native batch packer (`packer.cpp`, host C++) with g++.

The library goes to `arec_torch/_build/` (git-ignored) at first use, under
a file name that carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded. It is published
atomically (a temporary file, then `os.replace`): several processes, such
as pytest-xdist workers, may build it at once.

Unlike arec's `arec/native/build.py`, a failed build raises with g++'s
output; there is no numpy fallback. Nothing here runs at import time.
No `-march=native`: the build directory may be copied to a machine with
another CPU, and the packer only copies int32 and float32 values.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import threading
from pathlib import Path

SRC = Path(__file__).resolve().with_name("packer.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libarecio-{digest}.so"


def build() -> Path:
    """The library's path, compiled first if it is not built yet; raises
    RuntimeError with g++'s output when the compile fails."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(
        f"{so.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except FileNotFoundError as e:
        raise RuntimeError(
            "g++ not found: the native batch packer is built with g++") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed to build {SRC} (rc {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)          # atomic publish: a reader sees all or none
    return so
