"""MCTF — motion-compensated temporal prefiltering of source pictures.

Role of VTM:EncoderLib/EncTemporalFilter.{h,cpp} (SURVEY.md §2.6): before
encoding, anchor pictures are denoised by blending motion-compensated
neighbour frames, weighted down where the motion match is poor.  Pure
encoder-side (no bitstream impact); shared verbatim by both engines so
streams stay byte-identical.

Simplifications vs the reference (documented): integer-pel block motion
(16x16, full search via the shared ME reference), per-block rather than
per-pixel weights, +-2 frame window.
"""
from __future__ import annotations

import numpy as np

from . import decide as sdecide

BLOCK = 16
BASE_W = 16          # weight of the original picture
MAX_NEI_W = 6        # cap per motion-compensated neighbour


def _mc_plane(plane: np.ndarray, mv: np.ndarray, block: int) -> np.ndarray:
    """Integer-MV block copy: mv (nby, nbx, 2) applies per block."""
    h, w = plane.shape
    r = int(np.abs(mv).max()) + 1
    pad = np.pad(plane, r, mode="edge")
    out = np.empty_like(plane)
    nby, nbx = h // block, w // block
    for by in range(nby):
        for bx in range(nbx):
            dx, dy = int(mv[by, bx, 0]), int(mv[by, bx, 1])
            out[by * block:(by + 1) * block,
                bx * block:(bx + 1) * block] = \
                pad[by * block + dy + r:(by + 1) * block + dy + r,
                    bx * block + dx + r:(bx + 1) * block + dx + r]
    return out


def _neighbour_weight(orig: np.ndarray, mc: np.ndarray,
                      block: int) -> np.ndarray:
    """Per-block weight from the SAD of the motion-compensated match."""
    h, w = orig.shape
    d = np.abs(orig.astype(np.int64) - mc)
    sad = d.reshape(h // block, block, w // block, block).sum((1, 3))
    sad_px = sad // (block * block)
    return np.clip(MAX_NEI_W - sad_px, 0, MAX_NEI_W)


def temporal_filter(frames, gop: int = 8, window: int = 2):
    """Filter anchor pictures (poc % max(gop,1) == 0) in place-copy."""
    out = [f for f in frames]
    step = max(gop, 1)
    for poc in range(0, len(frames), step):
        orig = frames[poc]
        h, w = orig[0].shape
        if h % BLOCK or w % BLOCK:
            continue
        acc = [orig[c].astype(np.int64) * BASE_W for c in range(3)]
        tot = np.full((h // BLOCK, w // BLOCK), BASE_W, np.int64)
        used = 0
        for off in range(-window, window + 1):
            if off == 0 or not 0 <= poc + off < len(frames):
                continue
            nei = frames[poc + off]
            _, mv = sdecide.me_size_pass(orig[0], nei[0], BLOCK, lam=0)
            mc_y = _mc_plane(nei[0], mv, BLOCK)
            wgt = _neighbour_weight(orig[0], mc_y, BLOCK)
            if not wgt.any():
                continue
            used += 1
            wpx = np.kron(wgt, np.ones((BLOCK, BLOCK), np.int64))
            acc[0] += wpx * mc_y
            tot += wgt
            cw = np.kron(wgt, np.ones((BLOCK // 2, BLOCK // 2), np.int64))
            for c in (1, 2):
                mc_c = _mc_plane(nei[c], mv // 2, BLOCK // 2)
                acc[c] += cw * mc_c
        if not used:
            continue
        tpx = np.kron(tot, np.ones((BLOCK, BLOCK), np.int64))
        tpc = np.kron(tot, np.ones((BLOCK // 2, BLOCK // 2), np.int64))
        out[poc] = [((acc[0] + tpx // 2) // tpx).astype(np.int32),
                    ((acc[1] + tpc // 2) // tpc).astype(np.int32),
                    ((acc[2] + tpc // 2) // tpc).astype(np.int32)]
    return out
