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
Under a launcher (`torchrun`: LOCAL_RANK set) a rank's default is
`cuda:{LOCAL_RANK}`; ranks that outnumber the cards must be given their
device.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: `device` when given, else the
    rank's card (`dist.mesh.rank_device`: `cuda`, or `cuda:{LOCAL_RANK}`
    under a launcher). Raises when `cuda` is wanted and absent — never a
    silent CPU run."""
    from arec_torch.dist.mesh import rank_device

    dev = rank_device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the port on the CPU")
    return dev
