"""Process groups as device meshes, and the SPMD launcher.

PyTorch counterpart of ``multiviewstitch_tpu/parallel/mesh.py``. JAX runs
one program over a ``jax.sharding.Mesh`` of devices (``shard_map``); here
every device is driven by its own process, and a ``Mesh`` is that
process's view of the group: the ``torch.distributed`` process group, its
rank and size, its device and the axis name ('views', the frames, edges
and point blocks the parallel modules split).

  - ``make_mesh`` uses NCCL on ``cuda:<local rank>`` unless the caller asks
    for ``device="cpu"``, which uses gloo. A missing GPU or NCCL raises: no
    path falls back to gloo or to the CPU.
  - ``init_distributed`` joins a multi-process launch (torchrun's
    environment) when ``MVS_NUM_PROCESSES`` > 1, as the JAX package's
    ``jax.distributed.initialize`` bootstrap does.
  - ``run_spmd`` spawns ``world`` ranks over a ``file://`` store and
    returns each rank's result: multi-process torch standing in for
    ``shard_map``'s single-process SPMD. Its ranks are NCCL on the cards
    unless the caller asks for ``device="cpu"`` (gloo, as the tests run
    it).
  - ``shard_along`` / ``replicated`` / ``gather_along``: a rank's block of
    an axis, the whole array on the rank's device, and the blocks of every
    rank concatenated back (one ``all_gather``).

Every collective here is one that gloo and NCCL both take: ``all_reduce``,
``all_gather`` (list form) and ``batch_isend_irecv``. They run at every
world size, one included, so a world-size-1 group makes each call the
layer makes.
"""

from __future__ import annotations

import datetime
import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

# the process group's timeout: a hang fails one call instead of a whole run
TIMEOUT = datetime.timedelta(seconds=60)


@dataclass
class Mesh:
    """One rank's view of a 1-D device mesh over the default process
    group."""
    rank: int
    size: int
    device: torch.device
    axis_name: str = "views"
    # the file store's directory when make_mesh started the group itself
    _owned_store: Optional[str] = None

    @property
    def shape(self) -> dict:
        """{axis name: size}, as ``jax.sharding.Mesh.shape``."""
        return {self.axis_name: self.size}

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def close(self):
        """Tear down the process group if ``make_mesh`` started it."""
        if self._owned_store is not None:
            dist.destroy_process_group()
            shutil.rmtree(self._owned_store, ignore_errors=True)
            self._owned_store = None


def _backend_for(device: torch.device) -> str:
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): no CUDA device "
                               "(ask for device='cpu' to use gloo)")
        if not dist.is_nccl_available():
            raise RuntimeError("make_mesh(device='cuda'): this torch has no "
                               "NCCL")
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"make_mesh: unsupported device {device}")


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda":
        return device
    local = int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count()))
    return torch.device("cuda", local)


def init_distributed(num_processes: Optional[int] = None,
                     device: str = "cuda"):
    """Join a multi-process launch (no-op for a single process): reads
    ``MVS_NUM_PROCESSES`` when ``num_processes`` is omitted, then
    ``init_process_group`` from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE): NCCL for ``device="cuda"``, gloo only
    for ``device="cpu"``."""
    if num_processes is None:
        num_processes = int(os.environ.get("MVS_NUM_PROCESSES", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return
    dev = torch.device(device)
    backend = _backend_for(dev)
    if dev.type == "cuda":
        torch.cuda.set_device(_rank_device(dev, int(os.environ["RANK"])))
    dist.init_process_group(backend, init_method="env://",
                            world_size=num_processes, timeout=TIMEOUT)


def make_mesh(n_devices: Optional[int] = None,
              axis_names: Tuple[str, ...] = ("views",),
              device: str = "cuda") -> Mesh:
    """This rank's 1-D mesh over the process group.

    With a group already running (``init_distributed``, ``run_spmd``) the
    mesh spans it. Without one, a single process makes a world-size-1 group
    over a ``file://`` store in a temporary directory (``Mesh.close`` tears
    it down); more devices than that need one process each."""
    if len(axis_names) != 1:
        raise ValueError(f"make_mesh: the port's meshes are 1-D, got axes "
                         f"{axis_names}")
    dev = torch.device(device)
    backend = _backend_for(dev)
    store = None
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise ValueError(f"make_mesh: {n_devices} devices need one "
                             "process each (run_spmd or torchrun)")
        store = tempfile.mkdtemp(prefix="mvs_store_")
        if dev.type == "cuda":
            torch.cuda.set_device(_rank_device(dev, 0))
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(store, 'store')}",
            rank=0, world_size=1, timeout=TIMEOUT)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"make_mesh(device={device!r}) needs {backend}, "
                           f"the running group is {dist.get_backend()}")
    size = dist.get_world_size()
    if n_devices not in (None, size):
        raise ValueError(f"make_mesh: {n_devices} devices asked, the group "
                         f"has {size}")
    rank = dist.get_rank()
    return Mesh(rank, size, _rank_device(dev, rank), axis_names[0], store)


def pad_to_multiple(x: np.ndarray, multiple: int, axis: int = 0, fill=0):
    """Pad ``axis`` of x so its length divides by ``multiple``. Returns
    (padded, original length)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x, n
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, pad)
    return np.pad(x, widths, constant_values=fill), n


def block_range(mesh: Mesh, n: int) -> Tuple[int, int]:
    """[start, stop) of this rank's contiguous block of an axis of length
    n, which must divide by the mesh size."""
    if n % mesh.size:
        raise ValueError(f"an axis of {n} does not divide over "
                         f"{mesh.size} ranks (pad_to_multiple)")
    b = n // mesh.size
    return mesh.rank * b, (mesh.rank + 1) * b


def shard_along(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of x's leading axis, on the rank's
    device (the counterpart of a ``NamedSharding(mesh, P('views'))``
    array)."""
    s, e = block_range(mesh, x.shape[0])
    return x[s:e].to(mesh.device)


def replicated(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The whole array on the rank's device (``P()``)."""
    return x.to(mesh.device)


def gather_along(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's block (equal shapes) concatenated along the leading
    axis in rank order: one ``all_gather``."""
    flag = x.dtype == torch.bool         # sent as bytes (gloo has no bool)
    x = (x.view(torch.uint8) if flag else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(parts, x)
    out = torch.cat(parts)
    return out.view(torch.bool) if flag else out


def all_reduce_sum(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks (every rank gets the same values; x is
    reduced in place)."""
    dist.all_reduce(x)
    return x


# ---------------------------------------------------------------------------
# the SPMD launcher
# ---------------------------------------------------------------------------

def _to_cpu(x):
    """Tensors anywhere in a result moved to the CPU (what a rank sends
    back)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to_cpu(v) for v in x))
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return type(x)(**{k: _to_cpu(getattr(x, k))
                          for k in x.__dataclass_fields__ if k[0] != "_"})
    return x


def spmd_calls(calls, *, mesh: Mesh) -> List:
    """Run the calls [(fn, args, kwargs), ...] in order on this rank's mesh,
    each as fn(*args, mesh=mesh, **kwargs); returns their results. Through
    ``run_spmd(spmd_calls, world, calls)`` several sharded calls share one
    start of the ranks."""
    return [fn(*args, mesh=mesh, **kwargs) for fn, args, kwargs in calls]


def _rank_main(rank: int, world: int, store: str, device: str,
               payload: bytes, results):
    """One spawned rank: join the group, run fn(*args, mesh=mesh,
    **kwargs), send back (rank, ok, pickled result or traceback)."""
    try:
        torch.set_num_threads(1)
        dev = torch.device(device)
        backend = _backend_for(dev)
        if dev.type == "cuda":
            torch.cuda.set_device(_rank_device(dev, rank))
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world, timeout=TIMEOUT)
        try:
            fn, args, kwargs = pickle.loads(payload)
            out = fn(*args, mesh=make_mesh(world, device=device), **kwargs)
            results.put((rank, True, pickle.dumps(_to_cpu(out))))
        finally:
            dist.destroy_process_group()
    except BaseException:      # report every failure, then let the rank end
        results.put((rank, False, traceback.format_exc()))


def run_spmd(fn: Callable, world: int, *args, device: str = "cuda",
             **kwargs) -> List:
    """Run ``fn(*args, mesh=<rank's Mesh>, **kwargs)`` on ``world`` spawned
    ranks (NCCL, one card a rank; gloo on the CPU only for
    ``device="cpu"``) and return the ranks' results in rank order, tensors on the CPU.

    ``fn`` must be importable by the ranks (a module-level function of this
    package); the ranks import torch and this package and nothing of the
    caller's. Each rank uses one CPU thread. A rank that raises raises
    here with its traceback, and a run that outlasts the group's timeout
    by 30 s raises too; every rank is ended before the call returns."""
    import multiprocessing as mp
    _backend_for(torch.device(device))        # no card, no NCCL: raise here
    ctx = mp.get_context("spawn")
    payload = pickle.dumps((fn, args, kwargs))
    tmp = tempfile.mkdtemp(prefix="mvs_spmd_")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, os.path.join(tmp, "store"), device,
                               payload, results), daemon=True)
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        limit = TIMEOUT.total_seconds() + 30.0
        got, deadline, grace = {}, time.monotonic() + limit, 0
        while len(got) < world:
            try:
                rank, ok, data = results.get(timeout=0.5)
            except queue.Empty:
                missing = sorted(set(range(world)) - set(got))
                dead = [r for r in missing if procs[r].exitcode is not None]
                grace = grace + 1 if dead else 0  # a last put may be in flight
                if grace > 4 or time.monotonic() > deadline:
                    raise RuntimeError(
                        f"run_spmd: ranks {missing} gave no result (ended: "
                        f"{[(r, procs[r].exitcode) for r in dead]}; limit "
                        f"{limit} s)") from None
                continue
            if not ok:
                raise RuntimeError(f"run_spmd: rank {rank} failed:\n{data}")
            got[rank] = pickle.loads(data)
        for p in procs:
            p.join(timeout=10.0)
        return [got[r] for r in range(world)]
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
