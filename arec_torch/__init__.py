"""arec_torch — the PyTorch / CUDA (Hopper) port of `arec`.

The package mirrors `arec/`'s module paths and names. It imports torch and
numpy only: never `jax`, and nothing of `arec/` (the pure-Python pieces it
needs — config, schema, synthetic data, prep I/O — are its own copies).

Every TPU kernel on a ported path is a kernel written by hand for sm_90a
under `arec_torch/csrc/`, built at first use into `arec_torch/_build/`.
Each wrapper launches its kernel for CUDA tensors and takes the plain
PyTorch version only for CPU tensors.

Entry points run on `cuda` unless the caller passes `device="cpu"`; with no
CUDA device and no explicit device they raise instead of running on the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else `cuda`.
    Raises when `cuda` is wanted and absent — never a silent CPU run."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev
