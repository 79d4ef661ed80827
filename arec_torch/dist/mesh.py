"""Process group and device mesh (port of `arec/dist/mesh.py`).

arec reaches every cross-chip collective through jit / shard_map over a
named mesh. The port is SPMD in PyTorch's idiom: one process per rank,
each holding its own shard, and every collective issued explicitly
through `torch.distributed` over a sub-group of the mesh. The backend is
NCCL for ranks on CUDA devices and gloo for ranks on the CPU (gloo also
takes CUDA tensors for the collectives it supports, staged through the
host).

Mesh axes ("data", "model"), data-major as arec's `make_mesh` reshapes
its devices: rank r sits at (r // model, r % model).
  * "data"  — each rank takes its slab of every batch.
  * "model" — tables are row-sharded over it (replicated over "data"),
              and so is the item matrix of the sharded top-k.

Launch contract: `torchrun` (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), or a caller that initialises the process group itself
(the tests: an explicit `file://` init_method). Every rank runs the SAME
program and issues every collective of a group in the same order at the
same shapes; a rank that skips one, or sends another shape, hangs the
group.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist


def _env_int(name: str):
    v = os.environ.get(name)
    return int(v) if v not in (None, "") else None


def _pin(dev: torch.device) -> None:
    """Make a CUDA rank's device the current one (`cuda` with no index:
    the current device)."""
    if dev.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if dev.index is None else dev.index)


def multihost_init(device=None) -> None:
    """Join the process group when launched by `torchrun` (WORLD_SIZE in
    the environment); a no-op in a single process or when the group is
    already up (e.g. a second Trainer in the same process, or a caller
    that initialised it with its own init_method). The backend follows the
    rank's device: NCCL for CUDA, gloo otherwise.

    A rank that cannot join raises with the coordinates and the timeout;
    it never falls back to a single process, which would serve a model
    that holds 1/model of each table."""
    if dist.is_initialized():
        return
    world = _env_int("WORLD_SIZE")
    if world is None:
        return
    rank = _env_int("RANK")
    addr = (f"{os.environ.get('MASTER_ADDR', '?')}:"
            f"{os.environ.get('MASTER_PORT', '?')}")
    timeout = int(os.environ.get("AREC_INIT_TIMEOUT_S", "300"))
    dev = torch.device("cpu" if device is None else device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    try:
        _pin(dev)
        dist.init_process_group(
            backend, init_method="env://", rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout))
    except Exception as e:
        raise RuntimeError(
            f"process-group bring-up failed (backend={backend}, "
            f"master={addr}, rank={rank}/{world}, timeout={timeout}s — all "
            f"ranks must start within it; set AREC_INIT_TIMEOUT_S to "
            f"extend): {e}") from e


def is_primary() -> bool:
    """True on the rank that owns singleton side effects (the submission
    file, the metrics stream)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device(device=None) -> torch.device:
    """This rank's device: `device` when given; else `cuda:{LOCAL_RANK}`
    under a launcher, when the host has a card for every local rank; else
    `cuda` in a single process. Ranks that outnumber the cards (several
    ranks sharing one card) must be given their device explicitly."""
    if device is not None:
        return torch.device(device)
    local = _env_int("LOCAL_RANK")
    if local is None:
        return torch.device("cuda")
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n:
        raise RuntimeError(
            f"local rank {local} has no card of its own ({n} CUDA "
            f"device(s)): pass device= explicitly (e.g. device='cuda:0' "
            f"for ranks that share a card, or 'cpu')")
    return torch.device(f"cuda:{local}")


def make_mesh(data: int, model: int, device=None):
    """The ("data", "model") DeviceMesh over the process group's ranks,
    data-major. Raises unless the world holds exactly data × model ranks.
    `device` is this rank's device; a CUDA rank is pinned to it first, so
    DeviceMesh's own device guess (LOCAL_RANK) never overrides it."""
    from torch.distributed.device_mesh import init_device_mesh

    need = data * model
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(
            f"mesh ({data}×{model}) needs {need} ranks, the process group "
            f"has {world}: launch data × model ranks (torchrun "
            f"--nproc-per-node {need})")
    if not dist.is_initialized():
        raise ValueError(f"mesh ({data}×{model}) needs a process group")
    _pin(torch.device("cpu" if device is None else device))
    # the mesh's device type is the backend's: NCCL meshes are CUDA's, and
    # gloo ranks (on the CPU, or sharing one card) take the CPU type
    mesh_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(mesh_type, (data, model),
                            mesh_dim_names=("data", "model"))
