"""Subpictures: independently decodable rectangles of the picture.

Role of VVC subpictures (SPS subpic layout; VTM:App/SubpicMergeApp — see
SURVEY.md §2.8/§2.10 "SP with zero cross-talk"): each subpicture's
boundaries are treated exactly like picture edges (prediction, entropy and
loop filters never cross), so a subpicture can be extracted into — or
merged from — a standalone conformant stream.

TPU-first realization: each subpicture IS an independent encode of its
rectangle (the strongest form of the boundary rule), carried as one
``nuh_layer_id`` layer of a merged stream with a subpicture-layout SEI
(io/streamtools.py).  This is the spatial-parallel (SP) axis: subpictures
encode concurrently (thread pool here; one chip each on a pod slice), and
`extract` is a pure NAL filter.  The decoded-picture-hash SEI inside each
layer self-checks every subpicture.
"""
from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

import numpy as np

from ..io import streamtools
from ..spec import hls


def subpic_rects(width: int, height: int, cols: int, rows: int,
                 ctu: int = 64):
    """Pixel rects [(x0, y0, x1, y1), ...] of a uniform CTU-aligned
    subpicture grid over a (width x height) picture, subpic-raster order."""
    n_cx = -(-width // ctu)
    n_cy = -(-height // ctu)
    out = []
    for (cx0, cy0, cx1, cy1) in hls.tile_grid(n_cx, n_cy, cols, rows):
        out.append((cx0 * ctu, cy0 * ctu, min(cx1 * ctu, width),
                    min(cy1 * ctu, height)))
    return out


def encode_subpics(frames, cfg, encode_fn, threads: bool = True):
    """Encode every subpicture of every frame as an independent stream and
    merge (layers + layout SEI).  encode_fn(frames, cfg) -> (data, recons,
    bits) is either engine's encode_sequence.

    Returns (merged_data, recons [assembled, full-size], bits [summed])."""
    cols, rows = cfg.subpic_cols, cfg.subpic_rows
    h, w = frames[0][0].shape
    rects = subpic_rects(w, h, cols, rows, cfg.ctu)
    sub_cfg = replace(cfg, subpic_cols=1, subpic_rows=1)

    def sub_frames(rect):
        x0, y0, x1, y1 = rect
        return [[f[0][y0:y1, x0:x1],
                 f[1][y0 // 2:y1 // 2, x0 // 2:x1 // 2],
                 f[2][y0 // 2:y1 // 2, x0 // 2:x1 // 2]] for f in frames]

    def run(rect):
        return encode_fn(sub_frames(rect), sub_cfg)

    if threads and len(rects) > 1:
        with ThreadPoolExecutor(max_workers=len(rects)) as ex:
            results = list(ex.map(run, rects))
    else:
        results = [run(r) for r in rects]

    data = streamtools.subpic_merge([r[0] for r in results], cols, rows)
    recons = []
    for poc in range(len(frames)):
        fy = np.zeros((h, w), np.int32)
        fcb = np.zeros((h // 2, w // 2), np.int32)
        fcr = np.zeros((h // 2, w // 2), np.int32)
        for rect, (_, recs, _) in zip(rects, results):
            x0, y0, x1, y1 = rect
            fy[y0:y1, x0:x1] = recs[poc][0]
            fcb[y0 // 2:y1 // 2, x0 // 2:x1 // 2] = recs[poc][1]
            fcr[y0 // 2:y1 // 2, x0 // 2:x1 // 2] = recs[poc][2]
        recons.append([fy, fcb, fcr])
    bits = [sum(r[2][poc] for r in results) for poc in range(len(frames))]
    return data, recons, bits


def decode_subpics(data: bytes, layout, decode_fn, check_hash: bool = True):
    """Decode a merged subpicture stream: decode each layer independently
    and assemble by the layout grid.  decode_fn(data, check_hash) ->
    (frames, sps) is either engine's decode_sequence."""
    cols, rows = layout
    subs = []
    for k in range(cols * rows):
        sub = streamtools.subpic_extract(data, k)
        subs.append(decode_fn(sub, check_hash))
    widths = [subs[i][1].out_width for i in range(cols)]
    heights = [subs[j * cols][1].out_height for j in range(rows)]
    w, h = sum(widths), sum(heights)
    n_frames = len(subs[0][0])
    xs = np.cumsum([0] + widths)
    ys = np.cumsum([0] + heights)
    frames = []
    for poc in range(n_frames):
        fy = np.zeros((h, w), np.int32)
        fcb = np.zeros((h // 2, w // 2), np.int32)
        fcr = np.zeros((h // 2, w // 2), np.int32)
        for j in range(rows):
            for i in range(cols):
                sub_frames, _ = subs[j * cols + i]
                x0, y0 = int(xs[i]), int(ys[j])
                sy, scb, scr = sub_frames[poc]
                fy[y0:y0 + sy.shape[0], x0:x0 + sy.shape[1]] = sy
                fcb[y0 // 2:y0 // 2 + scb.shape[0],
                    x0 // 2:x0 // 2 + scb.shape[1]] = scb
                fcr[y0 // 2:y0 // 2 + scr.shape[0],
                    x0 // 2:x0 // 2 + scr.shape[1]] = scr
        frames.append([fy, fcb, fcr])
    # a frame-level SPS view for callers that report dimensions
    sps = subs[0][1]
    sps = hls.SPS(width=w, height=h, bit_depth=sps.bit_depth,
                  log2_ctu=sps.log2_ctu)
    return frames, sps
