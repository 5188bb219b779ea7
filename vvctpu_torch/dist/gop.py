"""GOP/segment-parallel encoding: the data-parallel axis.

Twin of vvctpu/dist/gop.py.  ``encode_gop_parallel`` splits the sequence
at closed-GOP boundaries, encodes each segment independently (the port's
engine or the spec model) and concatenates with the Parcat logic:
bit-exactly what N separate encoder runs plus ``parcat`` give.  Without a
mesh the segments run one after the other, or in threads, on the one
device.  With a (gop, tile) mesh (dist/mesh.py), gop row ``g`` encodes
segment ``g`` with its row's tile axis active (dist/shard.py: the row's
controller encodes, its other ranks serve the waves), and the segments'
results are gathered over the gop axis and concatenated; under
``torch.distributed`` a process started alone encodes
``segment_for_process``.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import torch.distributed as dist

from ..io.parcat import parcat
from ..spec import sequence as sseq
from . import mesh as dmesh
from . import shard


def segment_bounds(n_frames: int, n_segments: int, gop: int):
    """Closed-GOP segment [start, end) bounds: cut points are multiples of
    the GOP size (every segment starts with an IDR in this encoder)."""
    g = max(gop, 1)
    n_units = -(-n_frames // g)
    segs = min(n_segments, n_units)
    cuts = [round(k * n_units / segs) * g for k in range(segs)] + [n_frames]
    return [(cuts[i], min(cuts[i + 1], n_frames)) for i in range(segs)
            if cuts[i] < n_frames]


def segment_for_process(n_frames: int, n_segments: int, gop: int,
                        process_index: int | None = None):
    """The [start, end) this process encodes (its torch.distributed rank
    unless ``process_index`` is given)."""
    if process_index is None:
        process_index = dist.get_rank() if dist.is_initialized() else 0
    bounds = segment_bounds(n_frames, n_segments, gop)
    return bounds[process_index % len(bounds)]


def _encoder(engine: str, device):
    if engine == "spec":
        return sseq.encode_sequence
    if engine != "torch":
        raise ValueError(f"unknown engine {engine!r} (torch or spec)")
    from ..pipeline import encoder as tenc
    return lambda fr, cfg: tenc.encode_sequence(fr, cfg, device=device)


def encode_gop_parallel(frames, cfg: sseq.EncoderConfig, segments: int = 2,
                        engine: str = "torch", threads: bool = False,
                        device=None, mesh=None):
    """Encode ``frames`` as independent closed-GOP segments and
    concatenate them; returns (annex-B bytes, recon frames, bits per
    frame), as encode_sequence does, the stream equal to Parcat over the
    segments' encodes.  engine: "torch" (the port, on ``device``) or
    "spec" (the copied spec model).  With ``mesh`` every rank calls this:
    ``segments`` is the mesh's gop rows, and each row's controller returns
    the whole result; its other ranks serve its waves and return None."""
    enc = _encoder(engine, device)
    if mesh is not None:
        return _on_mesh(frames, cfg, enc, mesh)
    bounds = segment_bounds(len(frames), segments, cfg.gop)

    def one(se):
        s, e = se
        return enc(frames[s:e], cfg)

    if threads and len(bounds) > 1:
        with ThreadPoolExecutor(max_workers=min(4, len(bounds))) as ex:
            results = list(ex.map(one, bounds))
    else:
        results = [one(se) for se in bounds]
    return _concat(results)


def _concat(results):
    data = parcat([r[0] for r in results])
    recons = [f for r in results for f in r[1]]
    bits = [b for r in results for b in r[2]]
    return data, recons, bits


def _on_mesh(frames, cfg, enc, mesh):
    g = mesh.get_coordinate()[0]
    bounds = segment_bounds(len(frames), mesh.size(0), cfg.gop)
    row = mesh["tile"]
    mine = None
    if g < len(bounds):
        s, e = bounds[g]
        mine = shard.run(row, enc, frames[s:e], cfg)
    if not shard.is_controller(row):
        return None
    group, ranks = dmesh.axis(mesh, "gop")
    got = [None] * len(ranks)
    if len(ranks) > 1:
        dist.all_gather_object(got, mine, group=group)
    else:
        got = [mine]
    return _concat([r for r in got if r is not None])
