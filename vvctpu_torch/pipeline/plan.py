"""Leaf plan: flatten FrameDecisions into the global coding-order slot list.

The frame scan (pipeline/recon.py) runs one step per 8x8 luma granule in
coding order (CTU raster x Morton within CTU).  Each slot is either a no-op
(granule covered by an earlier leaf) or the origin of a leaf of size 8/16/32.
This is the static encoding of the QT traversal — the "finite static tree
template" of SURVEY.md §7.3.2.
"""
from __future__ import annotations

import numpy as np

from ..spec.codec import FrameDecisions

OP_SKIP, OP_LEAF8, OP_LEAF16, OP_LEAF32 = 0, 1, 2, 3
# rect (BT + TT) leaves: ops 10..15 intra, 16..21 inter (RECT_SHAPES idx);
# the TT mid stripes reuse the (32, 16) / (16, 32) shapes at offset
# positions, so only the (32, 8) / (8, 32) quarter stripes are new shapes
RECT_SHAPES = ((16, 8), (8, 16), (32, 16), (16, 32), (32, 8), (8, 32))
OP_RECT_INTRA0 = 10
OP_RECT_INTER0 = 16
OP_IBC0 = 22             # +0/1/2 for square IBC leaves 8/16/32
OP_PLT0 = 25             # +0/1/2 for square palette leaves 8/16/32
OP_MAX = 27
_SIZE_OF_OP = {OP_LEAF8: 8, OP_LEAF16: 16, OP_LEAF32: 32}


def _demorton(m: int, bits: int = 3) -> tuple[int, int]:
    gx = gy = 0
    for b in range(bits):
        gx |= ((m >> (2 * b)) & 1) << b
        gy |= ((m >> (2 * b + 1)) & 1) << b
    return gx, gy


def leaf_plan(dec: FrameDecisions, height: int, width: int,
              ctu: int = 64):
    """Returns (op, x, y, mode, mv0, mv1, dir) arrays, length n_ctu * 64.

    op: 0 skip, 1/2/3 intra leaf 8/16/32, 4/5/6 inter leaf 8/16/32,
    7/8/9 CIIP inter leaf 8/16/32 (sequential: reads recon neighbours),
    10..13 rect intra / 14..17 rect inter (BT leaves, RECT_SHAPES order);
    mv0/mv1: (n, 2) int32; dir: 0 = L0, 1 = L1, 2 = BI."""
    n_cx, n_cy = width // ctu, height // ctu
    ng = (ctu // 8) ** 2
    gbits = (ctu // 8 - 1).bit_length()
    n = n_cx * n_cy * ng
    op = np.zeros(n, np.int32)
    xs = np.zeros(n, np.int32)
    ys = np.zeros(n, np.int32)
    modes = np.zeros(n, np.int32)
    mv0 = np.zeros((n, 2), np.int32)
    mv1 = np.zeros((n, 2), np.int32)
    dirs = np.zeros(n, np.int32)
    bt32 = dec.bt32 if dec.bt32 is not None else None
    bt16 = dec.bt16 if dec.bt16 is not None else None
    i = 0
    for cy in range(n_cy):
        for cx in range(n_cx):
            for m in range(ng):
                gx, gy = _demorton(m, gbits)
                px, py = cx * ctu + gx * 8, cy * ctu + gy * 8
                rect = -1
                if not dec.split32[py // 32, px // 32]:
                    b = int(bt32[py // 32, px // 32]) if bt32 is not None \
                        else 0
                    if b == 1:
                        o = 1 if (px % 32 == 0 and py % 16 == 0) else 0
                        rect = 2
                    elif b == 2:
                        o = 1 if (px % 16 == 0 and py % 32 == 0) else 0
                        rect = 3
                    elif b == 3:     # TT-H: 32x8 / 32x16@+8 / 32x8@+24
                        r = (py % 32) // 8
                        if px % 32 == 0 and r in (0, 1, 3):
                            o, rect = 1, (4 if r != 1 else 2)
                        else:
                            o, rect = 0, 4
                    elif b == 4:     # TT-V: 8x32 / 16x32@+8 / 8x32@+24
                        c = (px % 32) // 8
                        if py % 32 == 0 and c in (0, 1, 3):
                            o, rect = 1, (5 if c != 1 else 3)
                        else:
                            o, rect = 0, 5
                    else:
                        o = OP_LEAF32 if (px % 32 == 0 and py % 32 == 0) \
                            else OP_SKIP
                elif not dec.split16[py // 16, px // 16]:
                    b = int(bt16[py // 16, px // 16]) if bt16 is not None \
                        else 0
                    if b == 1:
                        o = 1 if (px % 16 == 0 and py % 8 == 0) else 0
                        rect = 0
                    elif b == 2:
                        o = 1 if (px % 8 == 0 and py % 16 == 0) else 0
                        rect = 1
                    else:
                        o = OP_LEAF16 if (px % 16 == 0 and py % 16 == 0) \
                            else OP_SKIP
                else:
                    o = OP_LEAF8
                is_inter = (dec.inter8 is not None
                            and dec.inter8[py // 8, px // 8])
                if rect >= 0:
                    o = (OP_RECT_INTER0 + rect if (o and is_inter)
                         else OP_RECT_INTRA0 + rect if o else OP_SKIP)
                    if o != OP_SKIP and is_inter:
                        mv0[i] = dec.mv8[py // 8, px // 8]
                        if dec.mv8_l1 is not None:
                            mv1[i] = dec.mv8_l1[py // 8, px // 8]
                            dirs[i] = dec.dir8[py // 8, px // 8]
                elif o != OP_SKIP and is_inter:
                    o += 6 if (dec.ciip8 is not None
                               and dec.ciip8[py // 8, px // 8]) else 3
                    mv0[i] = dec.mv8[py // 8, px // 8]
                    if dec.mv8_l1 is not None:
                        mv1[i] = dec.mv8_l1[py // 8, px // 8]
                        dirs[i] = dec.dir8[py // 8, px // 8]
                elif (o in (OP_LEAF8, OP_LEAF16, OP_LEAF32)
                      and dec.ibc8 is not None
                      and dec.ibc8[py // 8, px // 8]):
                    mv0[i] = dec.bv8[py // 8, px // 8]
                    o = OP_IBC0 + (o - OP_LEAF8)
                elif (o in (OP_LEAF8, OP_LEAF16, OP_LEAF32)
                      and dec.plt8 is not None
                      and dec.plt8[py // 8, px // 8]):
                    o = OP_PLT0 + (o - OP_LEAF8)
                op[i] = o
                xs[i] = px
                ys[i] = py
                modes[i] = dec.modes8[py // 8, px // 8]
                i += 1
    return op, xs, ys, modes, mv0, mv1, dirs


def plan_leaves_list(dec: FrameDecisions, height: int, width: int,
                     ctu: int = 64):
    """Python list of (x, y, size, mode) leaves in coding order (host use)."""
    op, xs, ys, modes, _, _, _ = leaf_plan(dec, height, width, ctu)
    return [(int(x), int(y), _SIZE_OF_OP[(int(o) - 1) % 3 + 1], int(md))
            for o, x, y, md in zip(op, xs, ys, modes) if o != OP_SKIP]
