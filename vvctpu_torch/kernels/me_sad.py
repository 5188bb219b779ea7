"""Dense +-ME_RANGE integer motion search: the CUDA kernel and its plain twin.

Replaces the TPU kernel ``vvctpu/kernels/me_pallas.py:77 me_sad_pallas``
(``pl.pallas_call`` at its line 248).  The kernel (``csrc/me_sad.cu``)
gives each 64x64 tile one thread block with the tile's (64 + 32)^2
reference window in shared memory, and each 32x32 region of the tile
``SPLIT`` warps, each walking a contiguous share of the 33 dy rows:
lanes hold the original pixels and a sliding window of reference columns
in registers, differences run on the FP32 pipe (exact for
integer samples below 2^16), key sums come from warp shuffles, and the
warps' minima merge on the 64-bit key (cost, row-major offset index), so
ties break as in the reference.  Its bound is arithmetic: about 2.3 G
absolute differences per 1080p reference, against about 18 MB of memory
traffic.

``me_sad`` launches the kernel for CUDA tensors and takes the plain
PyTorch twin ``me_sad_reference`` only for CPU tensors.  The kernel is
built with nvcc at first use into ``vvctpu_torch/_build/`` and bound with
ctypes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spec.inter import ME_RANGE
from . import cuda_build

I32MAX = int(np.iinfo(np.int32).max)

# aggregation keys in kernel order: squares by int, BT rectangles by
# (w, h), TT stripes by name; geometry (block h, block w, stride y,
# stride x, offset y, offset x) in px -- csrc/me_sad.cu c_geom
KEYS = (8, 16, 32, (16, 8), (8, 16), (32, 16), (16, 32),
        (32, 8), (8, 32), "tth_mid", "ttv_mid")
KEY_GEOM = {
    8: (8, 8, 8, 8, 0, 0),
    16: (16, 16, 16, 16, 0, 0),
    32: (32, 32, 32, 32, 0, 0),
    (16, 8): (8, 16, 8, 16, 0, 0),
    (8, 16): (16, 8, 16, 8, 0, 0),
    (32, 16): (16, 32, 16, 32, 0, 0),
    (16, 32): (32, 16, 32, 16, 0, 0),
    (32, 8): (8, 32, 8, 32, 0, 0),
    (8, 32): (32, 8, 32, 8, 0, 0),
    "tth_mid": (16, 32, 32, 32, 8, 0),
    "ttv_mid": (32, 16, 32, 32, 0, 8),
}

# warps per 32x32 region in the kernel (csrc/me_sad.cu SPLIT)
SPLIT = 2

# kernel launches since the count was last set to 0
launches = 0

_LIB = None


def build(verbose: bool = False) -> str:
    """Compile csrc/me_sad.cu for sm_90a (once per source content) and
    load it.  Returns nvcc's output when it compiled now (with
    ``-Xptxas -v`` register/shared-memory report if ``verbose``)."""
    global _LIB
    if _LIB is not None:
        return ""
    lib, log = cuda_build.load("me_sad", verbose)
    lib.me_sad_launch.restype = ctypes.c_int
    lib.me_sad_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p]
    _LIB = lib
    return log


def _grid(key, H: int, W: int):
    bh, bw, sy, sx, oy, ox = KEY_GEOM[key]
    return (H - oy - bh) // sy + 1, (W - ox - bw) // sx + 1


def _check(orig, refp):
    if orig.dim() != 2 or refp.dim() != 2:
        raise ValueError("orig and refp must be 2-D")
    H, W = orig.shape
    if H % 64 or W % 64:
        raise ValueError(f"frame {H}x{W} is not a multiple of 64")
    if tuple(refp.shape) != (H + 2 * ME_RANGE, W + 2 * ME_RANGE):
        raise ValueError(f"refp shape {tuple(refp.shape)} != "
                         f"{(H + 2 * ME_RANGE, W + 2 * ME_RANGE)}")
    if orig.dtype != torch.int32 or refp.dtype != torch.int32:
        raise TypeError("orig and refp must be int32")
    if orig.device != refp.device:
        raise ValueError("orig and refp lie on different devices")
    if not (orig.is_contiguous() and refp.is_contiguous()):
        raise ValueError("orig and refp must be contiguous")


def me_sad(orig, refp, lam: int, *, tt: bool = False):
    """Per key of ``KEYS[:11 if tt else 7]``: (cost (nby, nbx) int32,
    mv (nby, nbx, 2) int32 [dx, dy]) of the dense +-ME_RANGE search.

    orig: (H, W) int32 samples in [0, 65535], H and W multiples of 64;
    refp: (H + 2R, W + 2R) int32 edge-padded reference; lam: the integer
    lambda."""
    global launches
    _check(orig, refp)
    if orig.device.type == "cpu":
        return me_sad_reference(orig, refp, lam, tt=tt)
    if orig.device.type != "cuda":
        raise ValueError(f"me_sad runs on cuda or cpu, not {orig.device}")
    build()
    H, W = orig.shape
    keys = KEYS[:11 if tt else 7]
    grids = [_grid(k, H, W) for k in keys]
    total = sum(a * b for a, b in grids)
    out = torch.empty((3, total), dtype=torch.int32, device=orig.device)
    with torch.cuda.device(orig.device):
        stream = torch.cuda.current_stream(orig.device).cuda_stream
        err = _LIB.me_sad_launch(orig.data_ptr(), refp.data_ptr(), H, W,
                                 int(lam), len(keys), out[0].data_ptr(),
                                 out[1].data_ptr(), out[2].data_ptr(),
                                 stream)
    if err != 0:
        raise RuntimeError(f"me_sad launch failed: cudaError {err}")
    launches += 1
    res, o = [], 0
    for nby, nbx in grids:
        blk = out[:, o:o + nby * nbx].reshape(3, nby, nbx)
        res.append((blk[0], torch.stack([blk[1], blk[2]], -1)))
        o += nby * nbx
    return tuple(res)


def _bitlen(v):
    """Threshold-sum bit length of |v|, saturating at 15."""
    v = v.abs()
    out = torch.zeros_like(v)
    for k in range(15):
        out += (v >= (1 << k)).to(v.dtype)
    return out


def _aggregate(sad8, key):
    """Sum the (..., n8y, n8x) granule SADs over each key block."""
    bh, bw, sy, sx, oy, ox = KEY_GEOM[key]
    gh, gw, gsy, gsx, gy0, gx0 = bh // 8, bw // 8, sy // 8, sx // 8, \
        oy // 8, ox // 8
    nby = (sad8.shape[-2] - gy0 - gh) // gsy + 1
    nbx = (sad8.shape[-1] - gx0 - gw) // gsx + 1
    out = None
    for r in range(gh):
        for c in range(gw):
            y0, x0 = gy0 + r, gx0 + c
            part = sad8[..., y0:y0 + (nby - 1) * gsy + 1:gsy,
                        x0:x0 + (nbx - 1) * gsx + 1:gsx]
            out = part if out is None else out + part
    return out


def me_sad_reference(orig, refp, lam: int, *, tt: bool = False):
    """Plain PyTorch twin of the kernel: the dense stage of
    vvctpu.coding.me._me_pass_impl(ext=False), one dy row of 33 offsets
    per step with a first-min argmin inside the row and a strict-less
    update of the running minimum."""
    H, W = orig.shape
    R = ME_RANGE
    n = 2 * R + 1
    dev = orig.device
    keys = KEYS[:11 if tt else 7]
    dxs = torch.arange(-R, R + 1, dtype=torch.int32, device=dev)
    xbits = 2 + 2 * _bitlen(dxs)
    state = []
    for k in keys:
        nby, nbx = _grid(k, H, W)
        state.append([torch.full((nby, nbx), I32MAX, dtype=torch.int32,
                                 device=dev),
                      torch.zeros((nby, nbx), dtype=torch.int32, device=dev),
                      torch.zeros((nby, nbx), dtype=torch.int32,
                                  device=dev)])
    for dyi in range(n):
        dy = dyi - R
        win = torch.stack([refp[dyi:dyi + H, dxi:dxi + W]
                           for dxi in range(n)])
        sad8 = (orig[None] - win).abs().reshape(
            n, H // 8, 8, W // 8, 8).sum((2, 4), dtype=torch.int32)
        bits = xbits + 2 * int(_bitlen(torch.tensor(dy)))
        for k, st in zip(keys, state):
            cb = (_aggregate(sad8, k) << 8) + lam * bits[:, None, None]
            bi = torch.argmin(cb, dim=0)
            c = torch.gather(cb, 0, bi[None])[0]
            better = c < st[0]
            st[0] = torch.where(better, c, st[0])
            st[1] = torch.where(better, dxs[bi], st[1])
            st[2] = torch.where(better, torch.full_like(st[2], dy), st[2])
    return tuple((c, torch.stack([x, y], -1)) for c, x, y in state)
