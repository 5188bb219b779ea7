"""Trellis dependent quantization: the CUDA kernel and its plain twin.

A main-path stage that earned a hand kernel (not a TPU kernel): the
reference runs it as a ``lax.scan`` Viterbi in
``vvctpu/kernels/transform.py:232 quantize_dq_j``, which eager PyTorch
would run as tens of small operations per coefficient position.  The
kernel (``csrc/dq_trellis.cu``) gives each transform block L lanes
(``lanes_for``: a warp per block at the main path's small batches, more
blocks per warp as the batch grows): the lanes compute a tile of
positions' step costs in parallel, run the four-state chain over the
tile with a few dependent integer operations per position, keep 4-bit
back-pointers in shared memory, trace back and write the signed levels.

Both take the signed raster coefficients of B blocks and the walk table
(the raster position of each walk step, ``transform.walk32``) and return
signed raster levels: the gather into walk order, the signs and the
scatter back are part of the one launch.

``dq_trellis`` launches the kernel for CUDA tensors and takes the plain
PyTorch twin ``dq_trellis_plain`` only for CPU tensors.  The kernel is
built with nvcc at first use into ``vvctpu_torch/_build/`` and bound with
ctypes.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spec.transform import DQ_TRANS
from . import cuda_build
from .transform import COEFF_MAX, COEFF_MIN, _bitlen15, _net_shift

_BIG = 1 << 28
_SENTINEL = 1 << 30

# kernel launches since the count was last set to 0
launches = 0
# None, or a list to which each launch appends its (h, w, B)
trace = None

_LIB = None

LANES = (32, 16, 8)
SMEM_LIMIT = 96 * 1024      # csrc/dq_trellis.cu kSmemLimit


def warp_smem(n: int, lanes: int) -> int:
    """Bytes of shared memory one warp of the kernel takes (csrc
    warp_smem): the tile's steps and costs (1 KiB), and per block n / 2
    bytes of bits, n + 1 words of coefficients and the trace back's 4
    copies of the bits (n / 8 + 1 words each)."""
    return 64 * 16 + 32 // lanes * (n // 8 + n + 1 + 4 * (n // 8 + 1)) * 4


def lanes_ok(n: int, lanes: int) -> bool:
    """Whether the kernel takes ``lanes`` lanes per block of n positions:
    at most n, and one warp's shared memory within the CTA's limit."""
    return lanes <= n and warp_smem(n, lanes) <= SMEM_LIMIT


def lanes_for(n: int, B: int) -> int:
    """Lanes per block for B blocks of n positions: a warp per block up to
    512 blocks, then the most lanes that keep the launch within 1024 warps
    (about two per warp scheduler of an H100), at least 8.  Fewer lanes
    put more blocks in a warp, which share its chain's instructions, at
    the cost of a longer walk per lane (chip_smoke.py dq_lanes_sweep
    times every lane count from 1 to 32640 blocks of 4x4 up to 64x64).
    Raised where a warp's shared memory would not fit."""
    lanes = 32 if B <= 512 else 16
    while lanes > 8 and B * lanes > 32768:
        lanes //= 2
    lanes = min(lanes, n)
    while not lanes_ok(n, lanes):
        lanes *= 2
    return lanes


def build(verbose: bool = False) -> str:
    """Compile csrc/dq_trellis.cu for sm_90a (once per source content) and
    load it; returns nvcc's output when it compiled now."""
    global _LIB
    if _LIB is not None:
        return ""
    lib, log = cuda_build.load("dq_trellis", verbose)
    lib.dq_trellis_launch.restype = ctypes.c_int
    lib.dq_trellis_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    _LIB = lib
    return log


def dq_trellis(coef, walk, qscale: int, q_bits: int, iq: int, net: int,
               lam: int, lanes: int = 0):
    """Signed levels (B, h, w) int32 of the trellis over B blocks.

    coef: (B, h, w) int32 signed coefficients (magnitudes at most 32768);
    walk: (h * w,) int32 raster position of each walk step
    (``transform.walk32``), on coef's device; qscale, q_bits: the forward
    quantizer's scale and shift; iq, net: the inverse scale and the net
    shift ``qp // 6 - (shift + 1)`` of the state-dependent dequantizer;
    lam: the lambda, already scaled and clamped to 2^22; lanes: lanes per
    block (one of LANES; 0: ``lanes_for``)."""
    global launches
    if coef.dim() != 3 or coef.dtype != torch.int32:
        raise TypeError("coef must be a 3-D int32 tensor")
    B, h, w = coef.shape
    n = h * w
    if walk.shape != (n,) or walk.dtype != torch.int32:
        raise TypeError(f"walk must be a ({n},) int32 tensor")
    if coef.device.type == "cpu":
        return dq_trellis_plain(coef, walk, qscale, q_bits, iq, net, lam)
    if coef.device.type != "cuda":
        raise ValueError(f"dq_trellis runs on cuda or cpu, not {coef.device}")
    if walk.device != coef.device:
        raise ValueError("walk must lie on coef's device")
    if n < 8 or n & (n - 1):
        raise ValueError(f"dq_trellis takes blocks of 2^k >= 8 positions, "
                         f"not {n}")
    build()
    coef, walk = coef.contiguous(), walk.contiguous()
    out = torch.empty_like(coef)
    if B == 0:
        return out
    lanes = lanes or lanes_for(n, B)
    with torch.cuda.device(coef.device):
        stream = torch.cuda.current_stream(coef.device).cuda_stream
        err = _LIB.dq_trellis_launch(coef.data_ptr(), walk.data_ptr(),
                                     out.data_ptr(), n, B, qscale, q_bits,
                                     iq, net, lam, lanes, stream)
    if err != 0:
        raise RuntimeError(f"dq_trellis launch failed: cudaError {err}")
    launches += 1
    if trace is not None:
        trace.append((h, w, B))
    return out


def dq_trellis_plain(coef, walk, qscale: int, q_bits: int, iq: int,
                     net: int, lam: int):
    """Plain PyTorch twin of the kernel: the absolute values gathered into
    walk order, ``quantize_dq_reference``, the signs and the scatter
    back (a level keeps its sign at a zero coefficient, as in
    quantize_dq_j)."""
    B, h, w = coef.shape
    c = coef.reshape(B, h * w)
    idx = walk.long()
    lev = quantize_dq_reference(c.abs().t()[idx], qscale, q_bits, iq, net,
                                lam)                      # (n, B) walk
    out = torch.empty_like(c)
    out[:, idx] = lev.t()
    return torch.where(c < 0, -out, out).reshape(B, h, w)


# per flattened candidate (state-major, then level 0 / lf / lf + 1): its
# source state
_SRC_STATE = np.repeat(np.arange(4), 3)
_TRANS = np.asarray(DQ_TRANS, np.int64)                   # (4, 2)


def quantize_dq_reference(a, qscale: int, q_bits: int, iq: int, net: int,
                          lam: int):
    """Levels (n, B) int32 of the trellis over B blocks of walk-ordered
    absolute coefficients a (n, B), position-major: the twin of the
    reference's quantize_dq_j scan (same candidate order and first-min
    tie-breaks) and an independent check of the kernel's reduction:
    every candidate's level, step cost and target state are computed for
    all positions at once; the loop over positions carries only the four
    running costs, each step a masked first minimum over the 12
    candidates per target state; then the trace back."""
    n, B = a.shape
    dev = a.device
    a = a.to(torch.int32)
    u = (a * qscale) >> (q_bits - 1)
    lf = torch.stack([(u >> 1), (u + 1) >> 1], 1).clamp(max=COEFF_MAX - 1)
    lev = torch.stack([torch.zeros_like(lf), lf, lf + 1], 2)  # (n,2,3,B)
    q1 = torch.tensor([0, 1], dtype=torch.int32, device=dev)[:, None,
                                                             None]
    deq = _net_shift((2 * lev - (q1 & (lev > 0).to(torch.int32))) * iq,
                     net).clamp(COEFF_MIN, COEFF_MAX)
    d = (a[:, None, None] - deq).abs().clamp(max=30000)
    rate = torch.where(lev > 0, 2 + 2 * _bitlen15(lev),
                       torch.zeros_like(lev))
    step = (d * d + lam * rate) >> 4
    # states 0/1 use Q0, states 2/3 Q1
    qsel = torch.tensor([0, 0, 1, 1], device=dev)
    step12 = step.index_select(1, qsel).reshape(n, 12, B)
    lv12 = lev.index_select(1, qsel).reshape(n, 12, B)
    src = torch.as_tensor(_SRC_STATE, device=dev)
    tgt = torch.as_tensor(_TRANS, device=dev)[src[None, :, None],
                                              (lv12 & 1).long()]
    masks = tgt[:, None] == torch.arange(4, device=dev)[None, :, None,
                                                        None]  # (n,4,12,B)
    cost = torch.tensor([0, _BIG, _BIG, _BIG], dtype=torch.int32,
                        device=dev)[:, None].expand(4, B)
    choice = torch.empty((n, 4, B), dtype=torch.int64, device=dev)
    sent = torch.full((), _SENTINEL, dtype=torch.int32, device=dev)
    for j in range(n):
        c12 = cost.index_select(0, src) + step12[j]
        ncost, idx = torch.where(masks[j], c12[None], sent).min(1)
        choice[j] = idx
        cost = (ncost - ncost.min(0).values).clamp(max=_BIG)
    s = cost.argmin(0)[None]                     # first-min final state
    out = torch.empty((n, B), dtype=torch.int32, device=dev)
    for j in range(n - 1, -1, -1):
        i = choice[j].gather(0, s)
        out[j] = lv12[j].gather(0, i)[0]
        s = i // 3
    return out
