"""Meshes over the ranks of a ``torch.distributed`` process group.

A JAX mesh is laid over the devices one process sees; a torch mesh
(``DeviceMesh``) is laid over ranks, one device each, and every rank of
the group builds it (its sub-groups are collective).  The axis names are
the JAX package's: ``("data", "model")``, and ``("pod", "data",
"model")`` for two pods.

``make_host_mesh`` starts a group of one when none is initialised (NCCL
on the card, gloo on the CPU), so a single process needs no launcher.
``init_fake_world`` starts a fake group of any size instead, whose
collectives move nothing (the multi-pod dry run).
``spawn`` runs a function on N local ranks joined over gloo (the CPU
tests; several ranks sharing one card, where NCCL refuses a second rank
on the same GPU).
"""

from __future__ import annotations

import datetime
import math
import os
import time
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

#: how long a collective may wait for a peer before the group gives up
TIMEOUT_S = 300


def _start(device) -> torch.device:
    """The mesh's device (the card unless ``device`` is the CPU, resolved as
    the entry points resolve it: no silent fallback), with a group of one
    started if none is initialised."""
    from repro_torch.deploy.api import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized():
        backend = "nccl" if dev.type == "cuda" else "gloo"
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def init_fake_world(world_size: int) -> None:
    """Starts a fake process group of ``world_size`` ranks in which this
    process is rank 0 (the dry run's world: ``make_production_mesh`` builds
    its real ``DeviceMesh`` there).  Its collectives move no data and
    return at once: with ``FakeTensorMode`` a rank runs its share of a
    step on shapes alone."""
    import torch.testing._internal.distributed.fake_pg as fake_pg  # registers "fake"

    dist.init_process_group("fake", store=fake_pg.FakeStore(), rank=0, world_size=world_size)


def make_mesh(shape, axis_names, *, device=None, ranks=None) -> DeviceMesh:
    """A mesh of ``shape`` named ``axis_names`` over ``ranks`` (default:
    the first ``prod(shape)`` ranks of the group).  Every rank of the
    default group must call it."""
    dev = _start(device)
    n = math.prod(shape)
    grid = torch.arange(n) if ranks is None else torch.as_tensor(list(ranks)[:n])
    if grid.numel() != n or n > dist.get_world_size():
        raise ValueError(f"a mesh of shape {tuple(shape)} needs {n} ranks; the group has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(dev.type, grid.reshape(tuple(shape)), mesh_dim_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """16x16 single pod (256 ranks), or 2x16x16 (two pods, 512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    _start(device)
    if dist.get_world_size() != math.prod(shape):
        raise ValueError(f"the production mesh {shape} {axes} needs a world of "
                         f"{math.prod(shape)} ranks; this group has {dist.get_world_size()}")
    return make_mesh(shape, axes, device=device)


def make_host_mesh(data: int = 1, model: int = 1, *, device=None) -> DeviceMesh:
    """Small ``(data, model)`` mesh over whatever ranks exist (tests /
    examples), clamped by the world size."""
    _start(device)
    n = dist.get_world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return make_mesh((data, model), ("data", "model"), device=device)


# -- local ranks --------------------------------------------------------------


def _rank_main(rank: int, fn, world_size: int, store_path: str, args: tuple) -> None:
    os.environ["LOCAL_WORLD_SIZE"] = str(world_size)  # one host: see data.pipeline
    # the host's cores shared out, as torchrun does, not each rank taking all
    torch.set_num_threads(max((os.cpu_count() or 1) // world_size, 1))
    dist.init_process_group("gloo", init_method=f"file://{store_path}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        fn(rank, world_size, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn, world_size: int, *args, workdir, timeout: float = 600) -> None:
    """Run ``fn(rank, world_size, *args)`` on ``world_size`` new local
    processes joined in one gloo group (rendezvous through a file in
    ``workdir``, no port).  ``fn`` must be importable by name.  Raises if
    any rank fails or the ranks outlive ``timeout`` seconds; every process
    is stopped before it returns."""
    import torch.multiprocessing as mp

    store = Path(workdir) / "store"
    store.unlink(missing_ok=True)
    ctx = mp.start_processes(_rank_main, args=(fn, world_size, str(store), args),
                             nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world_size} ranks of {fn.__name__} ran past {timeout}s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
