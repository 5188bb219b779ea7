"""Tile-sharded waves of the real encoder and decoder over a mesh's ranks.

Twin of vvctpu/dist/shard.py (``sharded_tile_scan``, a shard_map over the
mesh's ``tile`` axis: tiles sharded, references replicated, outputs
gathered).  Here the ranks are processes: rank 0 of each tile group is the
controller and runs the whole encoder or decoder; the group's other ranks
run ``serve``, which answers the controller's waves.  For each wave
(pipeline/encoder.py ``_wave``) tile ``t`` of every frame goes to rank
``t`` with its slot tables, planes, phase-A rows, reference offset, LMCS
LUTs and palette planes; the call's reference pictures and flags go to
every rank; each rank runs ``wave.frame_wave_batch`` on its members, and
their 11 output planes come back.  Every rank runs the computation the
unsharded wave runs on that tile, so bytes and recon are equal to the
one-rank encode.  Decisions, loop filters and entropy stay on the
controller.

    with use_mesh(mesh):
        if is_controller(mesh):
            data, recons, bits = encoder.encode_sequence(frames, cfg)
        else:
            serve(mesh)

(``run(mesh, fn, ...)`` does just this.)  ``serve`` returns when the
controller leaves its ``use_mesh`` block.  A rank whose wave fails sends
its traceback to the controller, which raises it; every rank then raises,
and the collectives' timeout (mesh.init_distributed) ends a wait on a rank
that died.
"""
from __future__ import annotations

import contextlib
import contextvars
import io
import pickle
import time
import traceback

import torch
import torch.distributed as dist

from . import mesh as dmesh

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "vvctpu_torch_mesh", default=None)

# the controller's record of its sharded waves since reset_stats():
# "calls", one dict per wave (frames, wall and own-wave seconds, each
# other rank's wave seconds, each rank's phase-B batches, bytes sent and
# received), and "ranks", per
# rank the sums of wave seconds, phase-B batches and kernel launches
# (me_sad, dq_trellis) and the peak device memory reported
stats: dict = {"calls": [], "ranks": {}}


def reset_stats() -> None:
    stats["calls"] = []
    stats["ranks"] = {}


def active_mesh():
    return _ACTIVE_MESH.get()


def is_controller(mesh) -> bool:
    """True on rank 0 of this rank's tile group."""
    return dist.get_rank() == dmesh.axis(mesh, "tile")[1][0]


def tile_ranks(mesh) -> int:
    return len(dmesh.axis(mesh, "tile")[1])


def _pack(obj) -> torch.Tensor:
    """obj pickled once, as a uint8 tensor over the pickle's own buffer."""
    buf = io.BytesIO()
    pickle.dump(obj, buf, protocol=pickle.HIGHEST_PROTOCOL)
    return torch.frombuffer(buf.getbuffer(), dtype=torch.uint8)


def _bcast(obj, src, group):
    """Broadcast obj from ``src`` (pickled once, its length first):
    (obj, its pickled bytes) on every rank."""
    mine = dist.get_rank() == src
    data = _pack(obj) if mine else None
    n = torch.tensor([data.numel() if mine else 0], dtype=torch.int64)
    dist.broadcast(n, src=src, group=group)
    if not mine:
        data = torch.empty(int(n), dtype=torch.uint8)
    dist.broadcast(data, src=src, group=group)
    return (obj if mine else pickle.loads(data.numpy())), int(n)


def _put(obj, dst, group) -> int:
    """Send obj to global rank ``dst`` (pickled once, its length first);
    returns its pickled bytes."""
    data = _pack(obj)
    dist.send(torch.tensor([data.numel()], dtype=torch.int64), dst,
              group=group)
    dist.send(data, dst, group=group)
    return data.numel()


def _take(src, group):
    """What global rank ``src`` sent with _put: (obj, its bytes)."""
    n = torch.zeros(1, dtype=torch.int64)
    dist.recv(n, src, group=group)
    data = torch.empty(int(n), dtype=torch.uint8)
    dist.recv(data, src, group=group)
    return pickle.loads(data.numpy()), int(n)


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate a mesh with a ``tile`` axis for the pipeline's waves; on
    the controller, leaving the block ends its group's serve loops (and
    collects their peak memory into ``stats``)."""
    tok = _ACTIVE_MESH.set(mesh)
    failed = True
    try:
        yield mesh
        failed = False
    finally:
        _ACTIVE_MESH.reset(tok)
        if (mesh is not None and tile_ranks(mesh) > 1
                and is_controller(mesh)):
            _stop(mesh, failed)


def _stop(mesh, failed: bool) -> None:
    group, ranks = dmesh.axis(mesh, "tile")
    _bcast(dict(cmd="stop", failed=failed), ranks[0], group)
    got = [None] * len(ranks)
    dist.gather_object(None, got, dst=ranks[0], group=group)
    for r, rep in zip(ranks[1:], got[1:]):
        stats["ranks"].setdefault(r, _zero())["peak_bytes"] = rep


def _zero():
    return dict(wave_s=0.0, batches=0, me_sad=0, dq_trellis=0,
                peak_bytes=0)


def run(mesh, fn, *args, **kw):
    """fn(*args, **kw) on the controller of this rank's tile group with
    ``mesh`` active; the group's other ranks serve its waves.  Returns
    fn's result on the controller, None on the others."""
    with use_mesh(mesh):
        if is_controller(mesh):
            return fn(*args, **kw)
        serve(mesh)
        return None


def _counts():
    from ..kernels import dq, me_sad
    from ..pipeline import wave
    return wave.batches, me_sad.launches, dq.launches


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def _timed_wave(members, dev, kw):
    """wave.frame_wave_batch on ``members``: (outputs, seconds, phase-B
    batches, me_sad and dq_trellis launches of the call)."""
    from ..pipeline import wave
    c0 = _counts()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    outs = wave.frame_wave_batch(members, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    b, m, q = (a - b for a, b in zip(_counts(), c0))
    return outs, dt, b, m, q


# the members' planes and LUTs, uploaded on the rank that runs them (slot
# tables and phase-A rows stay numpy, as frame_wave_batch takes them)
_PLANES = ("py", "pcb", "pcr", "fwd_lut", "crs_lut")


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.cpu().numpy()
    if isinstance(v, tuple):
        return tuple(_host(x) for x in v)
    return v


def _to_host(member, ref_ids):
    """A wave member for another rank: tensors as numpy arrays, its
    reference pictures as indices into the call's replicated list."""
    return {k: ref_ids if k == "refs" else _host(v)
            for k, v in member.items()}


def _to_device(member, refs, dev):
    out = dict(member)
    for k in _PLANES:
        if k in out:
            out[k] = torch.as_tensor(out[k], device=dev)
    if out.get("plt") is not None:
        out["plt"] = tuple(torch.as_tensor(p, device=dev) for p in out["plt"])
    if "refs" in out:
        out["refs"] = tuple(refs[i] for i in out["refs"])
    return out


def sharded_wave(mesh, frames_m, kw: dict) -> dict:
    """The controller's side of one wave over the tile group: tile ``t``
    of every frame of ``frames_m`` (lists of equal-size tile members,
    pipeline/encoder.py _wave_frame) on rank ``t``, the frames'
    reference pictures replicated, tile 0 here.  ``kw``:
    frame_wave_batch's keywords.  Returns {(frame, tile): the 11 output
    planes on this rank's device}."""
    group, ranks = dmesh.axis(mesh, "tile")
    ctl = ranks[0]
    t_start = time.perf_counter()
    # the references of every frame, each distinct tensor once
    refs, ref_ids = [], []
    seen: dict = {}
    for members in frames_m:
        ids = []
        for t in members[0].get("refs") or ():
            if id(t) not in seen:
                seen[id(t)] = len(refs)
                refs.append(t.cpu().numpy())
            ids.append(seen[id(t)])
        ref_ids.append(ids)
    sent = _bcast(dict(cmd="wave", kw=kw, refs=refs), ctl, group)[1]
    for t, r in enumerate(ranks[1:], start=1):
        sent += _put([dict(_to_host(members[t], ref_ids[i]), ref_idx=i)
                      for i, members in enumerate(frames_m)], r, group)
    dev = frames_m[0][0]["py"].device
    err = None
    try:
        own = _timed_wave([dict(members[0], ref_idx=i)
                           for i, members in enumerate(frames_m)], dev, kw)
    except Exception as e:      # answered after the group's replies
        err = e
    got = [_take(r, group) for r in ranks[1:]]
    if err is not None:
        raise err
    res = {(i, 0): out for i, out in enumerate(own[0])}
    call = dict(frames=len(frames_m), own_wave_s=own[1], rank_wave_s={},
                rank_batches={ctl: own[2]}, bytes_out=sent, bytes_in=0)
    _add(ctl, own[1:], 0)
    for t, (r, ((status, val), nbytes)) in enumerate(zip(ranks[1:], got),
                                                      start=1):
        call["bytes_in"] += nbytes
        if status == "error":
            raise RuntimeError(f"rank {r} failed in a sharded wave:\n{val}")
        outs, *nums, peak = val
        for i, planes in enumerate(outs):
            res[i, t] = tuple(torch.as_tensor(p, device=dev) for p in planes)
        call["rank_wave_s"][r] = nums[0]
        call["rank_batches"][r] = nums[1]
        _add(r, nums, peak)
    call["wall_s"] = time.perf_counter() - t_start
    stats["calls"].append(call)
    return res


def _add(rank, nums, peak) -> None:
    s = stats["ranks"].setdefault(rank, _zero())
    for k, v in zip(("wave_s", "batches", "me_sad", "dq_trellis"), nums):
        s[k] += v
    s["peak_bytes"] = max(s["peak_bytes"], peak)


def serve(mesh) -> int:
    """A tile group's non-controller rank: answer the controller's waves
    on this rank's device of the mesh's type until the controller leaves
    its ``use_mesh`` block; returns the number of waves answered, and
    raises if a wave failed here or the controller failed."""
    group, ranks = dmesh.axis(mesh, "tile")
    ctl = ranks[0]
    dev = dmesh.rank_device(mesh.device_type)
    failed, waves = None, 0
    while True:
        msg = _bcast(None, ctl, group)[0]
        if msg["cmd"] == "stop":
            dist.gather_object(_peak(dev), None, dst=ctl, group=group)
            break
        mine = _take(ctl, group)[0]
        waves += 1
        try:
            refs = [torch.as_tensor(r, device=dev) for r in msg["refs"]]
            members = [_to_device(m, refs, dev) for m in mine]
            outs, *nums = _timed_wave(members, dev, msg["kw"])
            reply = ("ok", ([[p.cpu().numpy() for p in o] for o in outs],
                            *nums, _peak(dev)))
        except Exception:
            failed = traceback.format_exc()
            reply = ("error", failed)
        _put(reply, ctl, group)
    if failed is not None:
        raise RuntimeError(f"a sharded wave failed on this rank:\n{failed}")
    if msg["failed"]:
        raise RuntimeError(f"the controller (rank {ctl}) failed")
    return waves
