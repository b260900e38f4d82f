"""Device mesh and process-group setup: counterpart of ``colbert_tpu/parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` with two axes and lets XLA
insert the collectives.  The port's :class:`Mesh` is the same ``(data,
model)`` grid of device positions, driven two ways:

* single-controller (one process, several positions): the corpus encoder
  splits each batch over the ``data`` positions, one model replica each,
  and ``ranking/sharded.py`` keeps one corpus shard a ``data`` position;
  the ``model`` positions of a data position hold one tensor-parallel
  replica (``models/sharding.py``: the Megatron split of each BERT layer,
  its collectives in ``parallel/collectives.py``), so every entry point
  runs at ``model > 1`` in one process, as JAX runs one program over its
  mesh;
* one process a data position (``torch.distributed``): the trainers split
  each global batch over the ranks of the process group that
  :func:`init_distributed` joins, and each rank holds its own ``model``
  positions (rank r the GPUs ``[r * model, (r + 1) * model)``), so ``data
  x model`` is the launch's GPU count, as in JAX.

One device may hold several positions (a device listed twice): how the
CPU tests, and one card, run ``model = 2``.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch

#: the process group's timeout for every collective (``init_distributed``)
DIST_TIMEOUT_S = 600.0


@dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"


AXES = MeshAxes()


@dataclass(frozen=True)
class Mesh:
    """``grid[i][j]``: the device of data position i, model position j (one
    device may hold several positions)."""
    grid: Tuple[Tuple[torch.device, ...], ...]

    @classmethod
    def of(cls, devices: Sequence[torch.device | str], model: int = 1) -> "Mesh":
        """The mesh of ``devices`` listed data-major, ``model`` a data position."""
        devs = tuple(torch.device(d) for d in devices)
        if model <= 0 or not devs or len(devs) % model:
            raise ValueError(f"{len(devs)} devices do not make whole model groups of {model}")
        return cls(tuple(devs[i : i + model] for i in range(0, len(devs), model)))

    @property
    def data(self) -> int:
        return len(self.grid)

    @property
    def model(self) -> int:
        return len(self.grid[0])

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """Each data position's first device: where its replicated parameters,
        its inputs and its outputs live."""
        return tuple(g[0] for g in self.grid)


def local_devices() -> Tuple[torch.device, ...]:
    """The GPUs this process may use: under a process group with NCCL, its
    own (from the device :func:`init_distributed` made current on, the first
    of the rank's model group), else every visible GPU."""
    import torch.distributed as dist

    n = torch.cuda.device_count()
    if dist.is_available() and dist.is_initialized() and dist.get_backend() == "nccl":
        return tuple(torch.device("cuda", i) for i in range(torch.cuda.current_device(), n))
    return tuple(torch.device("cuda", i) for i in range(n))


def make_mesh(data: int = -1, model: int = 1, devices: Optional[Sequence[torch.device | str]] = None) -> Mesh:
    """A ``data x model`` mesh (JAX ``make_mesh``).  ``data=-1`` takes every
    device after the model axis.  With ``devices`` (listed data-major; a
    device listed twice holds two positions, how a test puts a mesh on one
    device), ``data x model`` must be their count; without them, the first
    ``data x model`` of :func:`local_devices`."""
    if model <= 0:
        raise ValueError("model axis size must be >= 1")
    if data == 0 or data < -1:
        raise ValueError(f"mesh.data must be -1 or >= 1, got {data}")
    if devices is not None:
        devs = tuple(torch.device(d) for d in devices)
        if data == -1:
            if not devs or len(devs) % model:
                raise ValueError(f"{len(devs)} devices not divisible by model={model}")
            data = len(devs) // model
        if data * model != len(devs):
            raise ValueError(f"mesh {data}x{model} != {len(devs)} devices")
        return Mesh.of(devs, model)
    devs = local_devices()
    if not devs:
        raise RuntimeError("no CUDA device for the mesh: pass devices=[...] to run elsewhere (e.g. the CPU)")
    if data == -1:
        data = len(devs) // model
    if data < 1 or data * model > len(devs):
        raise ValueError(f"mesh {data}x{model} exceeds the {len(devs)} GPUs of this process; pass devices=[...] "
                         "to put several positions on one device")
    return Mesh.of(devs[: data * model], model)


def device_mesh(device: str | torch.device, data: int = 1, model: int = 1) -> Mesh:
    """The mesh of an entry point given one ``device``: a bare ``cuda`` takes
    this process's GPUs (:func:`make_mesh`, ``data`` -1 for all of them);
    a named device (``cpu``, ``cuda:0``) holds every position, ``data`` -1
    counting as 1.  One position is ``device`` itself."""
    dev = torch.device(device)
    if data == 1 and model == 1:
        return Mesh.of([dev])
    if dev.type == "cuda" and dev.index is None:
        return make_mesh(data, model)
    return make_mesh(data, model, devices=[dev] * (max(data, 1) * model))


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
                     timeout_s: Optional[float] = None, model: int = 1) -> torch.device:
    """Join the process group of a launch (the JAX package's
    ``init_distributed``, the reference's ``init_dist``): rank
    ``process_id`` of ``num_processes``, rendezvous at
    ``tcp://<coordinator>`` (host:port of rank 0), NCCL for ``device``
    "cuda" and gloo for "cpu".  Returns this rank's device, made current:
    rank r holds ``model`` GPUs from ``cuda:{r * model % device_count}``
    (its model group; :func:`local_devices` lists them from there), and a
    launch that puts two ranks on one GPU is refused.  ``timeout_s``
    (default :data:`DIST_TIMEOUT_S`) bounds every collective.  Call once a
    process, before any device use."""
    import torch.distributed as dist

    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is not in [0, {num_processes})")
    if model <= 0:
        raise ValueError("model axis size must be >= 1")
    dev = torch.device(device)
    if dev.type == "cuda":
        n = torch.cuda.device_count()
        if n == 0:
            raise RuntimeError("a launch on cuda needs a GPU; pass --device cpu for gloo on the CPU")
        first = process_id * model % n
        if first + model > n:
            raise RuntimeError(f"rank {process_id} needs GPUs {first}..{first + model - 1} for mesh.model={model}, "
                               f"but {n} are visible: a launch at data x model needs that many GPUs")
        dev = torch.device("cuda", first)
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
