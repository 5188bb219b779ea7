"""LMCS's rate on chip_smoke.py's 1080p content, spec model against the
PyTorch port, on the CPU.

Crops the top-left SIZE x SIZE of the frames of chip_smoke.py's phases 7b
and 8b (``synth_frames(3, 1080, 1920, seed=4)``), encodes the crop with
7b's configuration and with 8b's (7b's with LMCS) in the spec model
(``vvctpu_torch.spec.sequence``) and in the port on the CPU, checks that
the two give the same bytes, and prints bits/frame, Y-PSNR and the LMCS
run's bit ratio.  It also prints each frame's LMCS model (codewords per
bin, 16 each for the identity) beside the luma histogram's share per bin,
and the histogram-weighted mean slope of the forward map (the factor by
which mapping stretches the luma residual on average), for the crop and
for the whole 1080p frame.

    python tools/lmcs_crop.py [--size 128] [--frames 3]
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import MTT, RA_TOOLS, synth_frames  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import lmcs as tlmcs  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402


def model_line(y: np.ndarray) -> str:
    """The LMCS model of luma plane ``y``, its histogram share per bin and
    the histogram-weighted mean forward slope."""
    cw = np.asarray(tlmcs.derive_model(y))
    hist = np.bincount((y.reshape(-1) * 16) >> 8, minlength=16)[:16]
    share = hist / hist.sum()
    slope = float((share * cw / 16).sum())
    return (f"codewords {cw.tolist()}, histogram % "
            f"{np.round(100 * share, 1).tolist()}, mean slope {slope:.4f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)
    n, s = args.frames, args.size
    full = synth_frames(n, 1080, 1920, seed=4)
    crop = [[p[:s, :s], c[:s // 2, :s // 2], r[:s // 2, :s // 2]]
            for p, c, r in full]
    for t in range(n):
        print(f"frame {t} whole 1080p: {model_line(full[t][0])}")
        print(f"frame {t} crop {s}x{s}: {model_line(crop[t][0])}")
    out = {}
    for lmcs in (False, True):
        cfg = tseq.EncoderConfig(qp=32, intra_period=32, gop=2, wpp=True,
                                 sbt=True, dq=True, alf=True, lmcs=lmcs,
                                 **MTT, **RA_TOOLS)
        t0 = time.time()
        sdata, srec, sbits = tseq.encode_sequence(crop, cfg)
        t1 = time.time()
        data, _, _ = tenc.encode_sequence(crop, cfg, device="cpu")
        t2 = time.time()
        if data != sdata:
            print(f"lmcs={lmcs}: the port's bytes differ from the spec "
                  "model's")
            return 1
        psnr = np.mean([tseq.psnr(crop[t][0], srec[t][0])
                        for t in range(n)])
        out[lmcs] = sum(sbits) / n
        print(f"lmcs={lmcs}: {s}x{s}, {n} frames: bytes equal (spec model "
              f"{t1 - t0:.1f} s, port {t2 - t1:.1f} s); {out[lmcs]:.1f} "
              f"bits/frame, Y {psnr:.4f} dB; bits per frame "
              f"{list(sbits)}")
    print(f"LMCS bits / no-LMCS bits: {out[True] / out[False]:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
