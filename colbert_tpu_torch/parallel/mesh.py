"""Device mesh and process-group setup: counterpart of ``colbert_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` with two axes and lets XLA
insert the collectives.  The port has two kinds of data parallelism, each
over the ``data`` axis:

* single-controller (one process, several devices): the corpus encoder
  splits each batch over :attr:`Mesh.devices`, one model replica a device,
  and ``ranking/sharded.py`` keeps one corpus shard a device;
* one process a GPU (``torch.distributed``): the trainers split each global
  batch over the ranks of the process group that :func:`init_distributed`
  joins (``parallel/collectives.py`` has the collectives they use).

``model`` (tensor parallelism over heads and the MLP,
``colbert_tpu/models/sharding.py``) is not ported: :func:`make_mesh`
refuses ``model > 1``.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch

#: the process group's timeout for every collective (``init_distributed``)
DIST_TIMEOUT_S = 600.0
TENSOR_PARALLEL = ("mesh.model > 1 (tensor parallelism over attention heads and the MLP, "
                   "colbert_tpu/models/sharding.py) is not ported: ROADMAP.md Queue 1 step 10, "
                   "its tensor-parallel item")


@dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"


AXES = MeshAxes()


@dataclass(frozen=True)
class Mesh:
    """The ``data`` axis: the device of each data position (one device may
    hold several positions, when the caller lists it several times)."""
    devices: Tuple[torch.device, ...]

    @property
    def data(self) -> int:
        return len(self.devices)


def local_devices() -> Tuple[torch.device, ...]:
    """The GPUs this process may use: its own one under a process group with
    NCCL (one process a GPU), else every visible GPU."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return (torch.device("cuda", torch.cuda.current_device()),)
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A mesh of ``data`` positions.  ``data=-1`` takes every device
    (:func:`local_devices`, or ``devices``).  Without ``devices``, ``data``
    may not exceed the GPUs present; with them, ``data`` is -1 or their
    count, and a device listed twice holds two positions (how a test puts
    four shards on one device).  ``model > 1`` is refused."""
    if model <= 0:
        raise ValueError("model axis size must be >= 1")
    if model > 1:
        raise NotImplementedError(TENSOR_PARALLEL)
    if data == 0 or data < -1:
        raise ValueError(f"mesh.data must be -1 or >= 1, got {data}")
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if not devs or data not in (-1, len(devs)):
            raise ValueError(f"mesh.data={data} but {len(devs)} devices were given")
        return Mesh(devs)
    devs = local_devices()
    if not devs:
        raise RuntimeError("no CUDA device for the mesh: pass devices=[...] to run elsewhere (e.g. the CPU)")
    if data > len(devs):
        raise ValueError(f"mesh.data={data} exceeds the {len(devs)} GPUs of this process; pass devices=[...] "
                         "to put several positions on one device")
    return Mesh(devs if data == -1 else devs[:data])


def local_shard_bounds(total: int, shard: int, num_shards: int) -> Tuple[int, int]:
    """Contiguous [start, end) bounds of ``shard`` when ``total`` rows are
    split as evenly as possible over ``num_shards``."""
    base = total // num_shards
    rem = total % num_shards
    start = shard * base + min(shard, rem)
    end = start + base + (1 if shard < rem else 0)
    return start, end


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def init_distributed(coordinator: str, num_processes: int, process_id: int, device: str = "cuda",
                     timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group of a launch (the JAX package's
    ``init_distributed``, the reference's ``init_dist``): rank
    ``process_id`` of ``num_processes``, rendezvous at
    ``tcp://<coordinator>`` (host:port of rank 0), NCCL for ``device``
    "cuda" and gloo for "cpu".  Returns this rank's device: rank r takes
    ``cuda:{r % device_count}``, and a launch that puts two ranks on one GPU
    is refused.  ``timeout_s`` (default :data:`DIST_TIMEOUT_S`) bounds
    every collective.  Call once a process, before any device use."""
    import torch.distributed as dist

    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in [0, {num_processes})")
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("a launch on cuda needs a GPU; pass --device cpu for gloo on the CPU")
        dev = torch.device("cuda", process_id % n)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"a launch runs on cuda or cpu, not {device!r}")
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}", world_size=num_processes,
                            rank=process_id, timeout=timedelta(seconds=timeout_s or DIST_TIMEOUT_S))
    if backend == "nccl":
        places = [None] * num_processes
        dist.all_gather_object(places, (socket.gethostname(), dev.index))
        if len(set(places)) != num_processes:
            dist.destroy_process_group()
            raise RuntimeError(f"two ranks of the launch share one GPU ({places}): one process a GPU")
    return dev
