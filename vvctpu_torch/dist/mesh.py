"""Process mesh of the port: a (gop, tile) mesh of torch.distributed ranks.

Twin of vvctpu/dist/mesh.py.  The ``gop`` axis is data-parallel over
closed-GOP segments (dist/gop.py); the ``tile`` axis shards each wave's
tiles (dist/shard.py).  Each rank is one process; it computes on
``cuda:{local rank % device count}`` (or on the CPU when the caller asks
for it), and the ranks exchange through the backend the caller chooses:

* ``gloo`` moves host copies; several ranks may share one card, and the
  CPU tests run on it;
* ``nccl`` needs a card per rank (NCCL refuses two ranks on one device),
  so a host with more ranks than cards raises here on every rank, before
  the first collective.

Unlike the reference, which falls back to virtual CPU devices, the port
never moves to the CPU on its own: a mesh larger than the ranks raises.
"""
from __future__ import annotations

import collections
import datetime
import multiprocessing
import os
import pickle
import queue as _queue
import socket
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

# seconds a collective waits for its peers before it fails (set by
# init_distributed; also the tile and gop groups' timeout)
_TIMEOUT_S = 600.0
# (ranks of a mesh row or column) -> its process group, with _TIMEOUT_S
_GROUPS: dict = {}


def _cards() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def _refuse_nccl(host: str, n: int, cards: int) -> None:
    raise ValueError(
        f"nccl needs a card per rank: {n} ranks on host {host}, {cards} "
        "cards (NCCL refuses two ranks on one device); use backend='gloo' "
        "for ranks that share a card")


def _check_nccl_local() -> None:
    """Before the group exists: this host's cards against its ranks, as
    the launcher gives them (LOCAL_WORLD_SIZE, set by torchrun), else
    against this one rank."""
    n = int(os.environ.get("LOCAL_WORLD_SIZE", 1))
    if n > _cards():
        _refuse_nccl(socket.gethostname(), n, _cards())


def _check_nccl_hosts() -> None:
    """Once the group exists: every rank's host name and card count,
    gathered over gloo, so that every rank raises alike when any host
    runs more ranks than it has cards."""
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, (socket.gethostname(), _cards()),
                           group=dist.new_group(backend="gloo"))
    ranks = collections.Counter(host for host, _ in got)
    for host, cards in dict(got).items():
        if ranks[host] > cards:
            _refuse_nccl(host, ranks[host], cards)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str = "gloo",
                     timeout_s: float = 600.0) -> int:
    """Join ``num_processes`` ranks at ``coordinator`` (``host:port``, or
    an init URL such as ``tcp://host:port`` or ``file:///path``) as rank
    ``process_id``; with one process, or in a process that has joined
    already, it does nothing.  Returns this process's rank.  ``backend``
    is the caller's: ``gloo`` or ``nccl`` (checked against each host's
    cards, before the rendezvous as far as this host tells, then over
    every rank's host); collectives fail after ``timeout_s`` seconds
    without their peers."""
    global _TIMEOUT_S
    if dist.is_initialized():
        return dist.get_rank()
    if num_processes is None or num_processes <= 1:
        return 0
    if backend == "nccl":
        _check_nccl_local()
    if not coordinator:
        raise ValueError(f"{num_processes} processes need a coordinator "
                         "address to meet at")
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    _TIMEOUT_S = float(timeout_s)
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl":
        try:
            _check_nccl_hosts()
        except ValueError:
            dist.destroy_process_group()
            raise
    return dist.get_rank()


def rank_device(device_type: str = "cuda") -> torch.device:
    """The device this rank computes on: ``cuda:{local rank % cards}``, or
    the CPU when ``device_type`` is "cpu"."""
    if device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; make the mesh with "
                           "device_type='cpu' to run the ranks on the CPU")
    rank = dist.get_rank() if dist.is_initialized() else 0
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def make_mesh(n_devices: int | None = None, gop: int | None = None,
              device_type: str = "cuda"):
    """A (gop, tile) DeviceMesh over every rank (``n_devices``, by
    default the world size); ``gop`` rows, by default 2 when the count is
    even and above 1, as in the reference.  Every rank calls it.  The
    tile rows and gop columns get process groups of their own with the
    ranks' collective timeout (dist/shard.py, dist/gop.py)."""
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = n_devices or world
    if n > world:
        raise ValueError(f"need {n} ranks, have {world} (start them with "
                         "init_distributed; the port does not fall back "
                         "to CPU devices)")
    if n < world:
        raise ValueError(f"the mesh spans every rank: {n} asked, {world} "
                         "running")
    if gop is None:
        gop = 2 if n % 2 == 0 and n > 1 else 1
    if n % gop:
        raise ValueError(f"{n} ranks do not split into {gop} gop rows")
    if not dist.is_initialized():
        # one rank: a group of its own, so that the mesh exists
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_backend() == "nccl":
        _check_nccl_hosts()
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    grid = torch.arange(n).reshape(gop, n // gop)
    mesh = DeviceMesh(device_type, grid, mesh_dim_names=("gop", "tile"))
    timeout = datetime.timedelta(seconds=_TIMEOUT_S)
    for ranks in [r.tolist() for r in grid] + [c.tolist() for c in grid.T]:
        if len(ranks) > 1 and tuple(ranks) not in _GROUPS:
            # every rank creates every group, in the same order
            _GROUPS[tuple(ranks)] = dist.new_group(ranks, timeout=timeout)
    return mesh


def axis(mesh, name: str):
    """(process group, global ranks) of this rank's ``name`` axis of a
    (gop, tile) mesh or of a 1-D mesh named ``name``: the group
    make_mesh made, with the ranks' timeout."""
    sub = mesh if mesh.mesh_dim_names == (name,) else mesh[name]
    ranks = [int(r) for r in sub.mesh.flatten().tolist()]
    return _GROUPS.get(tuple(ranks)) or sub.get_group(), ranks


def _rank_main(rank, n, init, timeout_s, fn, args_path, out):
    """One spawned rank: join the group, run fn(*args) (the arguments
    pickled at ``args_path``), put (rank, "ok", result) or (rank, "error",
    traceback) on ``out``."""
    try:
        with open(args_path, "rb") as f:
            args = pickle.load(f)
        init_distributed(init, n, rank, "gloo", timeout_s)
        out.put((rank, "ok", fn(*args)))
    except BaseException:
        out.put((rank, "error", traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n: int, args=(), timeout_s: float = 600.0):
    """Run fn(*args) in ``n`` spawned processes, ranks 0..n-1 of one gloo
    group that meets through a ``file://`` rendezvous in a fresh
    temporary directory; ``fn`` must be importable by name.  Returns
    the ranks' results in rank order.  When a rank fails, once every
    rank has ended it raises with each failed rank's traceback; a rank
    that dies, or ranks not done within ``timeout_s`` seconds, stop every
    rank and raise."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="vvctpu_ranks_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    # the arguments go through a file: a large argument of a spawned
    # process would hold each start until the process before has imported
    # its main module
    args_path = os.path.join(tmp, "args.pkl")
    with open(args_path, "wb") as f:
        pickle.dump(tuple(args), f, protocol=pickle.HIGHEST_PROTOCOL)
    out = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(
        r, n, init_method, timeout_s, fn, args_path, out))
        for r in range(n)]
    for p in procs:
        p.start()
    res, errors, deadline = {}, {}, time.monotonic() + timeout_s
    try:
        while len(res) + len(errors) < n:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"{n - len(res) - len(errors)} of {n} "
                                   f"ranks not done after {timeout_s} s")
            try:
                rank, status, val = out.get(timeout=min(left, 5.0))
            except _queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in res and r not in errors
                        and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"ranks {dead} exited without a "
                                       "result") from None
                continue
            (errors if status == "error" else res)[rank] = val
        if errors:
            raise RuntimeError("".join(f"rank {r} failed:\n{errors[r]}"
                                       for r in sorted(errors)))
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for f in os.listdir(tmp):
            os.unlink(os.path.join(tmp, f))
        os.rmdir(tmp)
    return [res[r] for r in range(n)]
