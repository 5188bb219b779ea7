"""Trellis dependent quantization: the CUDA kernel and its plain twin.

A main-path stage that earned a hand kernel (not a TPU kernel): the
reference runs it as a ``lax.scan`` Viterbi in
``vvctpu/kernels/transform.py:232 quantize_dq_j``, which eager PyTorch
would run as tens of small operations per coefficient position.  The
kernel (``csrc/dq_trellis.cu``) gives each transform block one thread that
walks its positions in coding order with the four state costs in
registers and the back-pointers in a global scratch, then traces back.

Both take the absolute coefficients of B blocks of n positions each in
walk order, position-major ``(n, B)`` so that a warp reads consecutive
words, and return the levels in the same layout; the gather into walk
order, the signs and the scatter back stay in ``kernels/transform.py``.

``dq_trellis`` launches the kernel for CUDA tensors and takes the plain
PyTorch twin ``quantize_dq_reference`` only for CPU tensors.  The kernel is
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

_LIB = None


def build(verbose: bool = False) -> str:
    """Compile csrc/dq_trellis.cu for sm_90a (once per source content) and
    load it; returns nvcc's output when it compiled now."""
    global _LIB
    if _LIB is not None:
        return ""
    lib, log = cuda_build.load("dq_trellis", verbose)
    lib.dq_trellis_launch.restype = ctypes.c_int
    lib.dq_trellis_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    _LIB = lib
    return log


def dq_trellis(a, qscale: int, q_bits: int, iq: int, net: int, lam: int):
    """Levels (n, B) int32 of the trellis over B blocks.

    a: (n, B) int32 absolute coefficients (at most 32768), position-major
    in walk order; qscale, q_bits: the forward quantizer's scale and
    shift; iq, net: the inverse scale and the net shift
    ``qp // 6 - (shift + 1)`` of the state-dependent dequantizer; lam: the
    lambda, already scaled and clamped to 2^22."""
    global launches
    if a.dim() != 2 or a.dtype != torch.int32:
        raise TypeError("a must be a 2-D int32 tensor")
    if a.device.type == "cpu":
        return quantize_dq_reference(a, qscale, q_bits, iq, net, lam)
    if a.device.type != "cuda":
        raise ValueError(f"dq_trellis runs on cuda or cpu, not {a.device}")
    build()
    a = a.contiguous()
    n, B = a.shape
    out = torch.empty_like(a)
    scratch = torch.empty((n, 4, B), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _LIB.dq_trellis_launch(a.data_ptr(), out.data_ptr(),
                                     scratch.data_ptr(), n, B, qscale,
                                     q_bits, iq, net, lam, stream)
    if err != 0:
        raise RuntimeError(f"dq_trellis launch failed: cudaError {err}")
    launches += 1
    return out


# per flattened candidate (state-major, then level 0 / lf / lf + 1): its
# source state
_SRC_STATE = np.repeat(np.arange(4), 3)
_TRANS = np.asarray(DQ_TRANS, np.int64)                   # (4, 2)


def quantize_dq_reference(a, qscale: int, q_bits: int, iq: int, net: int,
                          lam: int):
    """Plain PyTorch twin of the kernel (twin of the reference's
    quantize_dq_j scan, same candidate order and first-min tie-breaks):
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
