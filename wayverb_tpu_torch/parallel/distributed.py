"""Several processes: ``torch.distributed`` initialisation and a mesh whose
shards span processes.

Port of ``wayverb_tpu.parallel.distributed``.  The reference runs one SPMD
program over a global device mesh that spans hosts.  Here every process
runs the same Python program over a ``DeviceMesh`` whose ``owners`` name the
process of each shard: a process steps its own shards, and the halo rows,
the receiver taps, the replicated inputs' cotangents and ``stable`` cross
between processes through ``torch.distributed`` (``sharding.shard_comm``).
The results (receiver outputs, ``stable``, gradients of replicated inputs)
are whole on every process.

Usage, one process per card, under ``torchrun`` (which sets
``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
``LOCAL_RANK``):

    from wayverb_tpu_torch.parallel import distributed as dist
    dist.initialize()                                  # nccl on the cards
    mesh = dist.global_device_mesh()                   # one shard a card
    out = box_sharded.run_waveguide_box_sharded(mesh, ...)

or without ``torchrun``, each process with its own rank:

    dist.initialize("10.0.0.1:29500", num_processes=2, process_id=rank,
                    backend="gloo", timeout=120)
    mesh = dist.global_device_mesh(devices=["cuda:0"] * 2)   # two shards

Several processes on one card (NCCL refuses two ranks on one device) and
processes on the CPU use ``backend="gloo"``, which stages device tensors
through host buffers.  ``Engine(..., device_mesh=global_device_mesh())``
runs on every process; its ray leg and image sources run whole on each,
as the reference's SPMD program leaves them unsharded.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch

from wayverb_tpu_torch.parallel.sharding import DeviceMesh

_LOCAL_DEVICE_IDS: Optional[tuple] = None


def _env(name: str, what: str) -> str:
    value = os.environ.get(name)
    if not value:
        raise ValueError(f"initialize: no {what} given and ${name} is not "
                         "set (torchrun sets it)")
    return value


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, *, backend: Optional[str] = None,
               timeout=None) -> None:
    """``torch.distributed.init_process_group`` on
    ``tcp://<coordinator_address>``.

    Defaults come from the environment ``torchrun`` sets:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, and
    ``LOCAL_RANK`` for ``local_device_ids`` (the CUDA devices this process
    shards over; ``global_device_mesh`` uses them).  ``backend``: "nccl"
    by default, which needs a CUDA device; pass "gloo" for processes on
    the CPU or several processes on one card.  The backend is never changed
    after a failure.  ``timeout``: seconds (or a ``timedelta``) after which
    a collective that waits on a process that failed raises.
    """
    global _LOCAL_DEVICE_IDS
    import torch.distributed as dist
    if coordinator_address is None:
        coordinator_address = (f"{_env('MASTER_ADDR', 'coordinator_address')}"
                               f":{_env('MASTER_PORT', 'coordinator_address')}")
    if num_processes is None:
        num_processes = int(_env("WORLD_SIZE", "num_processes"))
    if process_id is None:
        process_id = int(_env("RANK", "process_id"))
    if local_device_ids is None and os.environ.get("LOCAL_RANK"):
        local_device_ids = [int(os.environ["LOCAL_RANK"])]
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: the default backend nccl needs "
                               "a CUDA device and none is available; pass "
                               "backend='gloo' to run the processes on the "
                               "CPU")
        backend = "nccl"
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = timeout if isinstance(
            timeout, datetime.timedelta) else datetime.timedelta(
                seconds=float(timeout))
    if backend == "nccl" and local_device_ids:
        torch.cuda.set_device(int(list(local_device_ids)[0]))
    dist.init_process_group(backend,
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id), **kwargs)
    _LOCAL_DEVICE_IDS = None if local_device_ids is None \
        else tuple(int(i) for i in local_device_ids)


def _initialized() -> bool:
    import torch.distributed as dist
    return dist.is_available() and dist.is_initialized()


def global_device_mesh(axis_name: str = "x",
                       devices: Optional[Sequence] = None) -> DeviceMesh:
    """A 1-D mesh over every process's devices, in rank order: each
    process's ``devices`` (default: its ``local_device_ids``, else every
    CUDA device it sees) are consecutive shards it owns, so with k shards
    on each process shard i lives on process i // k.  A device may repeat
    (``["cuda:0"] * 2``: two shards on one card; ``["cpu"]``).  Without
    ``initialize`` this process owns every shard, as the reference's mesh
    spans one process's devices then."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("global_device_mesh: no CUDA device; pass "
                               "devices=['cpu'] to shard over the CPU")
        ids = _LOCAL_DEVICE_IDS if _LOCAL_DEVICE_IDS is not None \
            else range(torch.cuda.device_count())
        devices = [torch.device("cuda", i) for i in ids]
    devices = [torch.device(d) for d in devices]
    if not devices:
        raise ValueError("global_device_mesh: a process needs a device")
    if not _initialized():
        return DeviceMesh(tuple(devices), (axis_name,))
    import torch.distributed as dist
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, [str(d) for d in devices])
    owners = tuple(rank for rank, devs in enumerate(every) for _ in devs)
    return DeviceMesh(tuple(d for devs in every for d in devs), (axis_name,),
                      owners=owners, rank=dist.get_rank())


def process_count() -> int:
    """The number of processes (1 without ``initialize``)."""
    import torch.distributed as dist
    return dist.get_world_size() if _initialized() else 1


def is_coordinator() -> bool:
    """Whether this is process 0 (always, without ``initialize``)."""
    import torch.distributed as dist
    return dist.get_rank() == 0 if _initialized() else True
