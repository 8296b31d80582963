"""The process group and the (data, model) mesh over it.

Port of ``realtime_whisper_asr_tpu/parallel/mesh.py``. The JAX package
factors the visible devices into a ``jax.sharding.Mesh``; the port's ranks
are processes of one ``torch.distributed`` world, one per device:

- ``init_distributed(device)`` joins the world ``torchrun`` describes
  (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``/``PORT``) or
  the caller names: NCCL on the card, rank r on ``cuda:LOCAL_RANK``, its
  communicator created at once (``device_id=``) so that no collective
  creates it later inside a CUDA graph's capture; gloo on the CPU
  (``device="cpu"``). There is no fallback from one to the other.
- ``make_mesh`` factors the world as (data, model), rank = data index ·
  model + model index (the JAX package's row-major reshape), and makes a
  process group for each row (a model group: the ranks of one tensor-parallel
  replica) and each column (a data group). Each of this rank's groups runs
  one all-reduce before it is handed out: NCCL creates a subgroup's
  communicator at its first collective, which must not fall inside a
  capture.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from realtime_whisper_asr_tpu_torch.device import resolve_device

#: gloo's timeout: a collective that one rank never joins fails after it
GLOO_TIMEOUT_S = 60


def init_distributed(device="cuda", rank: Optional[int] = None,
                     world_size: Optional[int] = None, store=None) -> torch.device:
    """Join the process group and return this rank's device: NCCL on
    ``cuda:LOCAL_RANK`` (the default; raises without CUDA), or gloo on the
    CPU for ``device="cpu"``, whose collectives time out after
    ``GLOO_TIMEOUT_S``. ``rank``, ``world_size`` and the rendezvous default to
    what ``torchrun`` sets (``env://``); ``store`` replaces the rendezvous (a
    world of one process needs no more than
    ``store=torch.distributed.HashStore()``, ranks of one machine may share a
    ``torch.distributed.FileStore``). A process that has joined already gets
    its device back."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", 0 if dev.index is None else dev.index))
        dev = torch.device("cuda", local)
    if dist.is_initialized():
        return dev
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("init_distributed needs rank and world_size, or RANK and "
                             "WORLD_SIZE as torchrun sets them")
        rank, world_size = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    kw = dict(rank=rank, world_size=world_size)
    if store is not None:
        kw["store"] = store
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", timeout=datetime.timedelta(seconds=GLOO_TIMEOUT_S), **kw)
    return dev


def world_device() -> torch.device:
    """This rank's device in the joined world: its card under NCCL, the
    CPU under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def mesh_shape(n: int, model_parallel: Optional[int] = None) -> tuple[int, int]:
    """(data, model) of n ranks: ``model_parallel`` defaults to 4, else 2,
    else 1, whichever divides n (the JAX package's rule)."""
    if model_parallel is None:
        model_parallel = next((c for c in (4, 2) if n % c == 0), 1)
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return n // model_parallel, model_parallel


def warm_up(group, device: torch.device) -> None:
    """One all-reduce on ``group``: its NCCL communicator exists afterwards."""
    dist.all_reduce(torch.zeros(1, device=device), group=group)


@dataclasses.dataclass(eq=False)
class Mesh:
    """This rank's place in a (data, model) mesh and its two groups."""

    shape: dict  # {"data": d, "model": t}
    rank: int
    device: torch.device
    data_group: dist.ProcessGroup
    model_group: dist.ProcessGroup

    @property
    def data(self) -> int:
        return self.shape["data"]

    @property
    def model(self) -> int:
        return self.shape["model"]

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model


def make_mesh(n_devices: Optional[int] = None, model_parallel: Optional[int] = None) -> Mesh:
    """The (data, model) mesh over the joined world (``init_distributed``).
    ``n_devices`` defaults to the world's size, and must equal it."""
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} devices in a world of {world} ranks")
    d, t = mesh_shape(n, model_parallel)
    rank = dist.get_rank()
    device = world_device()
    model_group = data_group = None
    for i in range(d):  # every rank makes every group, in one order
        g = dist.new_group(list(range(i * t, (i + 1) * t)))
        if rank // t == i:
            model_group = g
    for j in range(t):
        g = dist.new_group(list(range(j, n, t)))
        if rank % t == j:
            data_group = g
    for g in (model_group, data_group):
        warm_up(g, device)
    return Mesh({"data": d, "model": t}, rank, device, data_group, model_group)
