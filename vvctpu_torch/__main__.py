"""CLI: encode raw YUV to an Annex-B VVC bitstream and decode it back with
the PyTorch engine (all-intra, low-delay P or random access, with the
multi-type tree, VVC's intra and inter toolsets, dependent quantization
and ALF).

    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ip 32 --gop 16 --wpp -f 17 -b out.bin -o rec.yuv
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --mts --lfnst --isp --mip --mrl --cclm -f 3 -b ai.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ip 32 --gop 4 --wpp --mts --lfnst --cclm --mip --mmvd --bcw \\
        --amvr --smvd --ciip --gpm --affine --dmvr --bdof --sbt --dq --alf \\
        -f 5 -b ra.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ip 32 --gop 2 --wpp --mtt --tt --sbt --dq -f 3 -b mtt.bin
    python -m vvctpu_torch decode -b out.bin -o dec.yuv

Option names follow ``python -m vvctpu``; ``--device`` picks the torch
device (CUDA by default).
"""
from __future__ import annotations

import argparse
import sys
import time

# the tool flags of the slice, with the reference CLI's help
_TOOLS = {
    "mts": "explicit MTS (DST7/DCT8) for intra luma",
    "lfnst": "LFNST secondary transform for intra luma",
    "isp": "intra sub-partitions (stripe TBs, implicit DST7)",
    "mip": "matrix intra prediction (generated weights)",
    "mrl": "multi-reference-line intra (lines 0/1/2)",
    "cclm": "CCLM chroma-from-luma prediction",
    "mmvd": "merge with MVD (8 distances x 4 directions)",
    "dmvr": "decoder-side MV refinement (BI merge leaves)",
    "bdof": "bi-directional optical flow (BI leaves)",
    "bcw": "bi-prediction with CU weights {3,4,5}/8",
    "gpm": "geometric partitioning (64 blend masks, B leaves)",
    "affine": "4-parameter affine motion + PROF (16/32 leaves)",
    "amvr": "adaptive MVD resolution (1/4, 1, 4 pel)",
    "smvd": "symmetric MVD for BI leaves (symmetric refs)",
    "ciip": "combined inter-intra prediction (planar blend)",
    "sbt": "sub-block transform for inter luma residual",
    "dq": "dependent quantization (4-state trellis)",
    "alf": "adaptive loop filter (luma Wiener, CTU flags)",
    "mtt": "multi-type tree (binary splits at 16/32)",
    "tt": "ternary splits at 32 nodes (requires --mtt)",
}


def _enc(args) -> int:
    from .io import yuv
    from .pipeline import encoder as tenc
    from .spec import hls
    from .spec import sequence as seq
    frames = yuv.read_yuv(args.input, args.wdt, args.hgt, args.frames)
    if not frames:
        print("no frames read", file=sys.stderr)
        return 1
    cfg = seq.EncoderConfig(qp=args.qp, intra_period=args.intra_period,
                            gop=args.gop, wpp=args.wpp,
                            **{t: getattr(args, t) for t in _TOOLS})
    t0 = time.time()
    data, recons, bits = tenc.encode_sequence(frames, cfg,
                                              device=args.device)
    dt = time.time() - t0
    with open(args.bitstream, "wb") as f:
        f.write(data)
    plan = {p[0]: p for p in seq.gop_plan(len(frames), args.intra_period,
                                          args.gop)}
    letter = {hls.SLICE_I: "I", hls.SLICE_P: "P", hls.SLICE_B: "B"}
    for poc, planes in enumerate(frames):
        p = [seq.psnr(planes[c], recons[poc][c]) for c in range(3)]
        _, stype, _, qpd = plan[poc]
        print(f"POC {poc:4d} {letter[stype]}  QP {args.qp + qpd:2d}  "
              f"{bits[poc]:8d} bits  "
              f"Y {p[0]:6.3f} dB  U {p[1]:6.3f} dB  V {p[2]:6.3f} dB")
    if args.recon:
        yuv.write_yuv(args.recon, recons)
    n = len(frames)
    total = sum(bits)
    print(f"SUMMARY: {n} frames, {total} bits, {total / n:.0f} bits/frame, "
          f"{dt:.2f} s ({n / dt:.3f} fps)")
    return 0


def _dec(args) -> int:
    from .io import yuv
    from .pipeline import encoder as tenc
    with open(args.bitstream, "rb") as f:
        data = f.read()
    t0 = time.time()
    frames, sps = tenc.decode_sequence(data, check_hash=not args.no_hash,
                                       device=args.device)
    dt = time.time() - t0
    yuv.write_yuv(args.output, frames, sps.bit_depth)
    print(f"decoded {len(frames)} frames "
          f"{frames[0][0].shape[1]}x{frames[0][0].shape[0]} in {dt:.2f} s "
          f"({len(frames) / max(dt, 1e-9):.3f} fps)"
          + ("" if args.no_hash else "; all picture hashes verified"))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vvctpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("encode", help="encode raw YUV to Annex-B bitstream")
    e.add_argument("-i", "--input", required=True, help="input .yuv (I420)")
    e.add_argument("-b", "--bitstream", required=True, help="output .bin")
    e.add_argument("-o", "--recon", help="optional recon .yuv")
    e.add_argument("--wdt", type=int, required=True, help="source width")
    e.add_argument("--hgt", type=int, required=True, help="source height")
    e.add_argument("-q", "--qp", type=int, default=32)
    e.add_argument("-f", "--frames", type=int, default=None)
    e.add_argument("--ip", "--intra-period", dest="intra_period", type=int,
                   default=1, help="1 = all-intra, 0 = first frame only, "
                   "N = every N frames")
    e.add_argument("--gop", type=int, default=1,
                   help="GOP size: 1 = I/P only, N > 1 = hierarchical-B "
                   "random access with anchors every N frames")
    e.add_argument("--wpp", action="store_true",
                   help="wavefront entropy lanes (one per CTU row)")
    for tool, text in _TOOLS.items():
        e.add_argument(f"--{tool}", action="store_true", help=text)
    e.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    d = sub.add_parser("decode", help="decode Annex-B bitstream to YUV")
    d.add_argument("-b", "--bitstream", required=True)
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--no-hash", action="store_true",
                   help="skip decoded-picture-hash verification")
    d.add_argument("--device", default=None,
                   help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.cmd == "encode" and args.tt and not args.mtt:
        e.error("--tt requires --mtt")
    return _enc(args) if args.cmd == "encode" else _dec(args)


if __name__ == "__main__":
    sys.exit(main())
