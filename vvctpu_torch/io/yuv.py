"""Planar YUV I/O — role of VTM:Utilities/VideoIOYuv.{h,cpp}.

Reads/writes raw planar 4:2:0 (I420) 8-bit or little-endian 10/16-bit frames
as lists of [Y, Cb, Cr] int32 numpy planes.
"""
from __future__ import annotations

import numpy as np


def frame_size_bytes(w: int, h: int, bit_depth: int = 8) -> int:
    spp = 1 if bit_depth <= 8 else 2
    return (w * h + 2 * (w // 2) * (h // 2)) * spp


def read_yuv(path: str, w: int, h: int, num_frames: int | None = None,
             bit_depth: int = 8, skip: int = 0) -> list[list[np.ndarray]]:
    fsz = frame_size_bytes(w, h, bit_depth)
    dtype = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    cw, ch = w // 2, h // 2
    frames = []
    with open(path, "rb") as f:
        if skip:
            f.seek(skip * fsz)
        while num_frames is None or len(frames) < num_frames:
            raw = f.read(fsz)
            if len(raw) < fsz:
                break
            a = np.frombuffer(raw, dtype)
            y = a[:w * h].reshape(h, w).astype(np.int32)
            cb = a[w * h:w * h + cw * ch].reshape(ch, cw).astype(np.int32)
            cr = a[w * h + cw * ch:].reshape(ch, cw).astype(np.int32)
            frames.append([y, cb, cr])
    return frames


def write_yuv(path: str, frames: list[list[np.ndarray]],
              bit_depth: int = 8) -> None:
    dtype = np.uint8 if bit_depth <= 8 else np.dtype("<u2")
    with open(path, "wb") as f:
        for planes in frames:
            for p in planes:
                f.write(np.ascontiguousarray(p, dtype=dtype).tobytes())
