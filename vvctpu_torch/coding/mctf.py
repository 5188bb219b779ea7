"""MCTF on the device — twin of spec/mctf.py ``temporal_filter``.

Anchor pictures (poc % gop == 0) are blended with motion-compensated
neighbours up to ``window`` frames away, each neighbour weighted per
16x16 block by the SAD of its match.  The spec model finds each block's
integer motion with ``spec/decide.py me_size_pass`` (the dense +-16
search and the +-64 coarse-to-fine stage, lambda 0); here that is
``coding/me.py me_pass`` at key 16, whose dense stage is the ``me_sad``
kernel.  The kernel takes frames whose sides are multiples of 64, so the
anchor and its neighbour are extended by edge replication to the next
multiple of 64: every reference sample either search reads is then the
neighbour at clamped coordinates, as in the spec model, whose padded
reference clamps once, and the blocks of the extension are dropped.  The
motion copies, the weights and the rounded division are int64 tensor
arithmetic, as the spec model's.
"""
from __future__ import annotations

import torch

from .. import device as devmod
from ..spec.inter import REF_MARGIN
from ..spec.mctf import BASE_W, BLOCK, MAX_NEI_W
from . import me as tme


def _clamped(plane, y0: int, h: int, x0: int, w: int):
    """plane[clamp(y0 + i), clamp(x0 + j)] for i < h, j < w: an edge
    extension (or crop) of a 2-D tensor."""
    ph, pw = plane.shape
    dev = plane.device
    iy = (torch.arange(h, device=dev) + y0).clamp(0, ph - 1)
    ix = (torch.arange(w, device=dev) + x0).clamp(0, pw - 1)
    return plane[iy[:, None], ix[None, :]]


def block_motion(orig_y, nei_y):
    """Integer motion [dx, dy] of each 16x16 block of ``orig_y`` in
    ``nei_y`` ((h, w) int32 device planes, sides multiples of 16): what
    me_size_pass(orig, nei, 16, lam=0) gives, as (h/16, w/16, 2) int32."""
    h, w = orig_y.shape
    H, W = -(-h // 64) * 64, -(-w // 64) * 64
    o64 = _clamped(orig_y, 0, H, 0, W).contiguous()
    refp80 = _clamped(nei_y, -REF_MARGIN, H + 2 * REF_MARGIN, -REF_MARGIN,
                      W + 2 * REF_MARGIN).contiguous()
    _, mv = tme.me_pass(o64, refp80, 0, frame_w=W, frame_h=H,
                        ext=True)[BLOCK]
    return mv[:h // BLOCK, :w // BLOCK]


def mc_plane(plane, mv, block: int):
    """Integer-MV block copy (spec/mctf.py _mc_plane): each block x block
    block of the output is ``plane`` at its block's mv [dx, dy], at
    clamped coordinates (the spec model's edge-padded copy)."""
    h, w = plane.shape
    dev = plane.device
    dx = mv[..., 0].repeat_interleave(block, 0).repeat_interleave(block, 1)
    dy = mv[..., 1].repeat_interleave(block, 0).repeat_interleave(block, 1)
    iy = (torch.arange(h, device=dev)[:, None] + dy).clamp(0, h - 1)
    ix = (torch.arange(w, device=dev)[None, :] + dx).clamp(0, w - 1)
    return plane[iy.long(), ix.long()]


def neighbour_weight(orig, mc, block: int):
    """Per-block weight from the SAD of the motion-compensated match
    (spec/mctf.py _neighbour_weight), int64."""
    h, w = orig.shape
    sad = (orig.to(torch.int64) - mc).abs().reshape(
        h // block, block, w // block, block).sum((1, 3))
    return (MAX_NEI_W - sad // (block * block)).clamp(0, MAX_NEI_W)


def _kron(wgt, block: int):
    return wgt.repeat_interleave(block, 0).repeat_interleave(block, 1)


def temporal_filter(frames, gop: int = 8, window: int = 2, *, device=None,
                    motion_out=None):
    """Filter the anchor pictures of [[y, cb, cr], ...] numpy planes, as
    spec/mctf.py temporal_filter does, on ``device`` (CUDA by default).
    Frames whose sides are not multiples of 16 pass unchanged.  Returns a
    new list of frames; filtered anchors are int32 numpy planes.
    motion_out: optional list that receives each search's (h/16, w/16, 2)
    motion field, in the spec model's order (anchor by anchor, neighbours
    from the earliest)."""
    dev = devmod.resolve(device)
    n = len(frames)
    out = list(frames)
    up = {}

    def planes(poc):
        if poc not in up:
            up[poc] = [torch.as_tensor(p, device=dev).to(torch.int32)
                       for p in frames[poc]]
        return up[poc]

    for poc in range(0, n, max(gop, 1)):
        h, w = frames[poc][0].shape
        neis = [poc + o for o in range(-window, window + 1)
                if o != 0 and 0 <= poc + o < n]
        if h % BLOCK or w % BLOCK or not neis:
            continue
        orig = planes(poc)
        acc = [p.to(torch.int64) * BASE_W for p in orig]
        tot = torch.full((h // BLOCK, w // BLOCK), BASE_W, dtype=torch.int64,
                         device=dev)
        # a neighbour whose weights are all zero adds nothing, and an
        # anchor with no weight from any neighbour comes out unchanged:
        # (16 * x + 8) // 16 == x, so neither needs a branch on the host
        for q in neis:
            nei = planes(q)
            mv = block_motion(orig[0], nei[0])
            if motion_out is not None:
                motion_out.append(mv)
            mc_y = mc_plane(nei[0], mv, BLOCK)
            wgt = neighbour_weight(orig[0], mc_y, BLOCK)
            acc[0] += _kron(wgt, BLOCK) * mc_y
            tot += wgt
            cw = _kron(wgt, BLOCK // 2)
            for c in (1, 2):
                acc[c] += cw * mc_plane(nei[c], mv >> 1, BLOCK // 2)
        res = []
        for c, a in enumerate(acc):
            t = _kron(tot, BLOCK if c == 0 else BLOCK // 2)
            res.append(torch.div(a + t // 2, t, rounding_mode="floor")
                       .to(torch.int32))
        out[poc] = [r.cpu().numpy() for r in res]
    return out
