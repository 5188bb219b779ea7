"""Film-grain characteristics SEI + grain synthesis post-processor.

Role of VTM:App/SEIFilmGrainApp (SURVEY.md §2.8): carry a film-grain model
in a prefix SEI (VVC FGC SEI, payload type 19) and synthesize grain on the
decoded pictures as a display-side post-process.  Simplified frame-based
model (documented): seeded Philox noise (numpy bit-generator streams are
platform-stable), [1 2 1] separable low-pass, per-intensity-interval gain
on luma, half gain on chroma; synthesis never feeds back into prediction.
"""
from __future__ import annotations

import numpy as np

from ..core import bitstream as bs

SEI_FGC = 19    # film grain characteristics (VVC SEI payload type)


def write_fgc_sei(log2_scale: int, seed: int,
                  intervals: list[tuple[int, int, int]]) -> bytes:
    """SEI payload: [type, size, log2_scale, seed u32, n, (lo, hi, gain)*]."""
    body = bytearray([log2_scale & 0xFF])
    body += int(seed & 0xFFFFFFFF).to_bytes(4, "big")
    body.append(len(intervals))
    for lo, hi, gain in intervals:
        body += bytes((lo & 0xFF, hi & 0xFF, gain & 0xFF))
    return bytes([SEI_FGC, len(body)]) + bytes(body)


def parse_fgc_sei(payload: bytes):
    """(log2_scale, seed, intervals) or None."""
    if len(payload) < 2 or payload[0] != SEI_FGC:
        return None
    body = payload[2:2 + payload[1]]
    log2_scale = body[0]
    seed = int.from_bytes(body[1:5], "big")
    n = body[5]
    intervals = [(body[6 + 3 * i], body[7 + 3 * i], body[8 + 3 * i])
                 for i in range(n)]
    return log2_scale, seed, intervals


def find_fgc(data: bytes):
    """First FGC SEI params in a stream, or None."""
    for nal in bs.read_annexb(data):
        if nal.nal_type == bs.NAL_PREFIX_SEI:
            p = parse_fgc_sei(nal.payload)
            if p is not None:
                return p
    return None


def add_fgc(data: bytes, log2_scale: int, seed: int,
            intervals: list[tuple[int, int, int]]) -> bytes:
    """Insert an FGC prefix SEI after the parameter sets."""
    nals = bs.read_annexb(data)
    sei = bs.NalUnit(bs.NAL_PREFIX_SEI,
                     write_fgc_sei(log2_scale, seed, intervals))
    out = []
    inserted = False
    for n in nals:
        if not inserted and n.nal_type not in (bs.NAL_VPS, bs.NAL_SPS,
                                               bs.NAL_PPS,
                                               bs.NAL_PREFIX_APS):
            out.append(sei)
            inserted = True
        out.append(n)
    if not inserted:
        out.append(sei)
    return bs.write_annexb(out)


def _grain_plane(h: int, w: int, seed: int, poc: int, comp: int):
    """Deterministic filtered grain field in about [-128, 128)."""
    key = (int(seed) << 32) ^ (int(poc) << 8) ^ int(comp)
    rng = np.random.Generator(np.random.Philox(key=key))
    g = rng.integers(-128, 128, (h + 2, w + 2)).astype(np.int32)
    # separable [1 2 1]/4 low-pass
    g = (g[:, :-2] + 2 * g[:, 1:-1] + g[:, 2:] + 2) >> 2
    g = (g[:-2] + 2 * g[1:-1] + g[2:] + 2) >> 2
    return g


def synthesize(frames, params, bit_depth: int = 8):
    """Apply grain to decoded frames ([Y, Cb, Cr] int planes).

    Luma gain: per-intensity interval lookup; chroma: half of the luma
    gain at the co-sited position.  Deterministic in (seed, poc)."""
    log2_scale, seed, intervals = params
    mx = (1 << bit_depth) - 1
    sh = max(bit_depth - 8, 0)
    out = []
    for poc, planes in enumerate(frames):
        y = planes[0].astype(np.int32)
        gain = np.zeros_like(y)
        for lo, hi, gv in intervals:
            m = ((y >> sh) >= lo) & ((y >> sh) <= hi)
            gain = np.where(m, gv, gain)
        gy = _grain_plane(*y.shape, seed=seed, poc=poc, comp=0)
        ny = np.clip(y + ((gy * gain) >> log2_scale), 0, mx)
        nc = []
        for ci in (1, 2):
            c = planes[ci].astype(np.int32)
            gc = _grain_plane(*c.shape, seed=seed, poc=poc, comp=ci)
            cgain = gain[0::2, 0::2] >> 1
            nc.append(np.clip(c + ((gc * cgain) >> log2_scale), 0, mx))
        out.append([ny, nc[0], nc[1]])
    return out
