"""Process groups of the port's (pods, data, model) mesh (port of
``repro.launch.mesh``).

JAX runs one controller over a device mesh; the port runs one process per
mesh coordinate. ``init_ranks`` joins this process to the world (torchrun's
``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` or explicit arguments), builds the
process groups once and returns a frozen :class:`RankLayout`. ``spawn``
starts a whole world on this host with ``torch.multiprocessing`` — what the
tests, ``chip_smoke.py`` and ``python -m repro_torch.launch.train`` use when
no launcher started the ranks.

The backend and the device are the caller's choice, never guessed: NCCL with
one rank per card, or gloo (also when several ranks share one card through
``ranks_per_device``, which NCCL refuses). The collectives of
``repro_torch.dist.collectives`` move CUDA tensors through pinned host
buffers under gloo.
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from repro_torch.dist.sharding import RankLayout


def _env_int(name: str, default: Optional[int]) -> Optional[int]:
    v = os.environ.get(name)
    return default if v is None else int(v)


def check_world(world_size: int, device: str, backend: str, ranks_per_device: int) -> None:
    """Raise for a world this host cannot hold: more ranks than cards times
    ``ranks_per_device``, NCCL with several ranks on one card, or NCCL on the
    CPU."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend must be 'gloo' or 'nccl', got {backend!r}")
    if ranks_per_device < 1:
        raise ValueError("ranks_per_device must be >= 1")
    if torch.device(device).type == "cuda":
        n_dev = torch.cuda.device_count()
        if world_size > n_dev * ranks_per_device:
            raise RuntimeError(
                f"a world of {world_size} ranks needs {world_size} device slots, this host "
                f"has {n_dev} CUDA device(s) x ranks_per_device={ranks_per_device}")
        if backend == "nccl" and ranks_per_device > 1:
            raise ValueError("NCCL refuses two ranks on one device: use backend='gloo' "
                             "with ranks_per_device > 1")
    elif backend == "nccl":
        raise ValueError("NCCL needs CUDA devices; the CPU runs gloo")


def _groups(pods: int, data: int, model: int) -> dict:
    """Every rank creates every group, in one order (torch.distributed's
    rule); groups of one rank are not created (their collectives are the
    identity). ``"dp"`` is the data-parallel group of JAX's
    ``dp_axes(multi_pod)``: the (pod, data) ranks of one model index, the
    batch's split; with one pod it is the ``"data"`` group itself."""
    rank = lambda p, d, m: (p * data + d) * model + m
    world = pods * data * model
    spans = {"world": [list(range(world))],
             "ring": [[rank(p, d, m) for d in range(data) for m in range(model)]
                      for p in range(pods)],
             "data": [[rank(p, d, m) for d in range(data)]
                      for p in range(pods) for m in range(model)],
             "model": [[rank(p, d, m) for m in range(model)]
                       for p in range(pods) for d in range(data)],
             "pod": [[rank(p, d, m) for p in range(pods)]
                     for d in range(data) for m in range(model)],
             "dp": [[rank(p, d, m) for p in range(pods) for d in range(data)]
                    for m in range(model)]}
    me = dist.get_rank()
    out, data_groups = {}, {}
    for name, lists in spans.items():
        for ranks in lists:
            if name == "world":
                group = dist.group.WORLD if world > 1 else None
            elif name == "dp" and pods == 1:
                group = data_groups[tuple(ranks)]
            else:
                group = dist.new_group(ranks) if len(ranks) > 1 else None
            if name == "data":
                data_groups[tuple(ranks)] = group
            if me in ranks:
                out[name] = (group, ranks)
    return out


def init_ranks(pods: int = 1, data: int = 1, model: int = 1, backend: str = "gloo",
               device: str = "cuda", ranks_per_device: int = 1,
               init_method: Optional[str] = None, rank: Optional[int] = None,
               world_size: Optional[int] = None, timeout_s: float = 1800.0) -> RankLayout:
    """Join the (pods, data, model) world and build its groups.

    ``rank``/``world_size`` default to torchrun's ``RANK``/``WORLD_SIZE``;
    the device slot is ``LOCAL_RANK // ranks_per_device`` on CUDA.
    ``init_method`` defaults to ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).
    """
    rank = _env_int("RANK", 0) if rank is None else rank
    world_size = _env_int("WORLD_SIZE", 1) if world_size is None else world_size
    if world_size != pods * data * model:
        raise ValueError(f"world_size {world_size} is not pods*data*model = "
                         f"{pods}*{data}*{model}")
    local_rank = _env_int("LOCAL_RANK", rank)
    check_world(_env_int("LOCAL_WORLD_SIZE", world_size), device, backend, ranks_per_device)
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank // ranks_per_device)
        torch.cuda.set_device(dev)
    if world_size > 1 and not dist.is_initialized():
        dist.init_process_group(backend, init_method=init_method or "env://", rank=rank,
                                world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
    groups = (_groups(pods, data, model) if world_size > 1
              else {name: (None, [0]) for name in ("world", "ring", "data", "model", "pod", "dp")})
    return RankLayout(pods=pods, data=data, model=model, rank=rank, backend=backend,
                      device=str(dev), ranks_per_device=ranks_per_device, groups=groups)


def relayout(layout: RankLayout, pods: int, data: int, model: int) -> RankLayout:
    """The same world seen as another (pods, data, model) mesh of the same
    size, with its own groups (a collective: every rank calls it)."""
    if pods * data * model != layout.world_size:
        raise ValueError(f"a {pods}x{data}x{model} mesh is not a world of "
                         f"{layout.world_size} ranks")
    import dataclasses

    return dataclasses.replace(layout, pods=pods, data=data, model=model,
                               groups=_groups(pods, data, model))


def _child(rank: int, fn: Callable, kw: dict, init_method: str, out_dir: str,
           threads: Optional[int]) -> None:
    world = kw["pods"] * kw["data"] * kw["model"]
    with open(os.path.join(out_dir, "args.pkl"), "rb") as f:
        args, kwargs = pickle.load(f)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    if threads:
        torch.set_num_threads(threads)
    layout = init_ranks(**kw, init_method=init_method, rank=rank, world_size=world)
    out = fn(layout, *args, **kwargs)
    with open(os.path.join(out_dir, f"rank_{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    if world > 1:
        from repro_torch.dist import collectives

        collectives.release_card_workspaces()
        dist.barrier()
        dist.destroy_process_group()


def spawn(fn: Callable, *, pods: int = 1, data: int = 1, model: int = 1,
          backend: str = "gloo", device: str = "cuda", ranks_per_device: int = 1,
          args: tuple = (), kwargs: Optional[dict] = None,
          threads: Optional[int] = None, timeout_s: float = 1800.0) -> List[Any]:
    """Run ``fn(layout, *args, **kwargs)`` in one fresh process per rank of the world
    and return the ranks' results in rank order (``fn`` must be importable,
    its result picklable; return host data). A rank that raises fails the
    call and stops the others. The ranks meet through a ``file://`` store in
    a fresh temporary directory, so concurrent worlds never collide; a
    collective that waits longer than ``timeout_s`` fails its rank. The
    arguments reach the ranks through a file there: a pickle larger than a
    pipe's buffer passed to ``mp.spawn`` holds the parent until each child
    has imported torch, so the ranks would start one after another.

    On CUDA the kernels are built here, once, before the ranks start."""
    world = pods * data * model
    check_world(world, device, backend, ranks_per_device)
    if torch.device(device).type == "cuda":
        from repro_torch import kernels

        kernels.build()
    import torch.multiprocessing as mp

    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        kw = dict(pods=pods, data=data, model=model, backend=backend, device=device,
                  ranks_per_device=ranks_per_device, timeout_s=timeout_s)
        with open(os.path.join(tmp, "args.pkl"), "wb") as f:
            pickle.dump((args, kwargs or {}), f)
        mp.spawn(_child, args=(fn, kw, f"file://{tmp}/store", tmp, threads), nprocs=world,
                 join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"rank_{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
