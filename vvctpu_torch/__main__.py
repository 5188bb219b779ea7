"""CLI: encode raw YUV to an Annex-B VVC bitstream and decode it back with
the PyTorch engine (all-intra, low-delay P or random access, with the
multi-type tree, VVC's intra and inter toolsets, intra block copy and
palette, dependent quantization, transform skip, joint Cb-Cr residuals,
LMCS and ALF, the MCTF prefilter and rate control, at CTU 64 or 128),
and the reference's stream tools (parcat, sei-remove, extract, merge,
subpic-extract, subpic-merge, filmgrain, info).

    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ip 32 --gop 16 --wpp -f 17 -b out.bin -o rec.yuv
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --mts --lfnst --isp --mip --mrl --cclm --lmcs -f 3 -b ai.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ip 32 --gop 4 --wpp --mts --lfnst --cclm --mip --mmvd --bcw \\
        --amvr --smvd --ciip --gpm --affine --dmvr --bdof --sbt --dq --alf \\
        -f 5 -b ra.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ip 32 --gop 2 --wpp --mtt --tt --sbt --dq --lmcs -f 3 -b mtt.bin
    python -m vvctpu_torch encode -i in10.yuv --wdt 3840 --hgt 2160 -q 32 \\
        --bit-depth 10 --ip 32 --gop 2 --tiles 2x2 -f 3 -b c5.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --subpics 2x1 -f 3 -b sp.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ip 32 --gop 2 --wpp --mtt --tt --sbt --dq --lmcs --tskip --jccr \\
        --mctf --rc-bpf 600000 -f 3 -b ctc.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --wpp --ibc --plt --mts --lfnst --isp --mip --mrl --cclm -f 3 \\
        -b scc.bin
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --ctu 128 --ip 32 --gop 2 --wpp --mtt --tt --sbt --dq --lmcs \\
        --tskip --jccr --mctf -f 3 -b ctc128.bin
    python -m vvctpu_torch encode -c encoder_randomaccess.cfg -c seq.cfg
    python -m vvctpu_torch decode -b out.bin -o dec.yuv
    python -m vvctpu_torch info -b out.bin

Option names follow ``python -m vvctpu``; ``--device`` picks the torch
device (CUDA by default).  RDOQ off (from a cfg file) is outside the
port and refused with the encoder's ValueError, and so is what the spec
model refuses: IBC or palette at CTU 128, IBC with tiles, and tiles
with WPP on a picture of more than one CTU row.  A cfg file's
RateControl with TargetBitrate and FrameRate sets the rate controller's
bits per frame where --rc-bpf is not given (the reference CLI reads
those keys and does not apply them).
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
    "lmcs": "LMCS luma mapping (reshaper)",
    "tskip": "transform skip (unified tx candidate index 5)",
    "jccr": "joint Cb-Cr residual coding",
    "mctf": "motion-compensated temporal source prefilter",
    "ibc": "intra block copy (I slices, square leaves)",
    "plt": "palette mode (I slices, square leaves)",
}
_HASH = {"md5": 0, "crc": 1, "checksum": 2}


def _apply_cfg(args, defaults) -> dict:
    """Fill the encode arguments from the layered cfg files ``args.cfg``,
    as the reference CLI does: a file's value applies where the command
    line left the option at its default (rate control's bits per frame
    from RateControl, TargetBitrate and FrameRate where --rc-bpf is 0).
    Returns the files' options that have no flag here (RDOQ), for
    EncoderConfig as they are: check_config refuses RDOQ off."""
    from .io.cfg import load_layered, rc_bits_per_frame
    fc = load_layered(args.cfg)
    args.input = args.input or fc.input_file
    args.bitstream = args.bitstream or fc.bitstream_file
    args.recon = args.recon or (fc.recon_file or None)
    args.wdt = args.wdt or fc.width
    args.hgt = args.hgt or fc.height
    if args.frames is None:
        args.frames = fc.frames
    for a in ("qp", "intra_period", "gop", "bit_depth", "wpp", *_TOOLS):
        if defaults[a] == getattr(args, a):
            setattr(args, a, getattr(fc, a))
    if defaults["rc_bpf"] == args.rc_bpf:
        args.rc_bpf = rc_bits_per_frame(fc)
    # a file's TileColumns and TileRows are read and not applied, as in
    # the reference CLI: only --tiles sets the tile grid
    return dict(rdoq=fc.rdoq)


def _enc(args) -> int:
    from .io import yuv
    from .pipeline import encoder as tenc
    from .spec import hls
    from .spec import sequence as seq
    if not (args.input and args.bitstream and args.wdt and args.hgt):
        print("missing input/bitstream/wdt/hgt (flags or cfg)",
              file=sys.stderr)
        return 2
    tc, tr = (int(v) for v in args.tiles.split("x"))
    sc, sr = (int(v) for v in args.subpics.split("x"))
    cfg = seq.EncoderConfig(
        qp=args.qp, bit_depth=args.bit_depth, ctu=args.ctu,
        intra_period=args.intra_period, gop=args.gop, wpp=args.wpp,
        tile_cols=tc, tile_rows=tr, subpic_cols=sc, subpic_rows=sr,
        rc_bits_per_frame=args.rc_bpf, hash_type=_HASH[args.hash],
        **args.from_cfg,
        **{t: getattr(args, t) for t in _TOOLS})
    tenc.check_config(cfg)
    frames = yuv.read_yuv(args.input, args.wdt, args.hgt, args.frames,
                          args.bit_depth)
    if not frames:
        print("no frames read", file=sys.stderr)
        return 1
    t0 = time.time()
    data, recons, bits = tenc.encode_sequence(frames, cfg,
                                              device=args.device)
    dt = time.time() - t0
    with open(args.bitstream, "wb") as f:
        f.write(data)
    plan = {p[0]: p for p in seq.gop_plan(len(frames), args.intra_period,
                                          args.gop)}
    letter = {hls.SLICE_I: "I", hls.SLICE_P: "P", hls.SLICE_B: "B"}
    qps = tenc.slice_qps(data)
    for poc, planes in enumerate(frames):
        p = [seq.psnr(planes[c], recons[poc][c], args.bit_depth)
             for c in range(3)]
        print(f"POC {poc:4d} {letter[plan[poc][1]]}  QP {qps[poc]:2d}  "
              f"{bits[poc]:8d} bits  "
              f"Y {p[0]:6.3f} dB  U {p[1]:6.3f} dB  V {p[2]:6.3f} dB")
    if args.recon:
        yuv.write_yuv(args.recon, recons, args.bit_depth)
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


def _read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _write(path, data: bytes) -> None:
    with open(path, "wb") as f:
        f.write(data)


def _parcat(args) -> int:
    from .io.parcat import parcat
    out = parcat([_read(p) for p in args.inputs])
    _write(args.output, out)
    print(f"parcat: {len(args.inputs)} segments -> {args.output} "
          f"({len(out)} bytes)")
    return 0


def _sei_remove(args) -> int:
    from .io.streamtools import remove_sei
    data = _read(args.bitstream)
    out = remove_sei(data, keep_hash=args.keep_hash)
    _write(args.output, out)
    print(f"sei-remove: {len(data)} -> {len(out)} bytes")
    return 0


def _extract(args) -> int:
    from .io.streamtools import extract_layer, extract_sublayer
    data = _read(args.bitstream)
    out = (extract_layer(data, args.layer) if args.layer is not None
           else extract_sublayer(data, args.tid))
    _write(args.output, out)
    print(f"extract: {len(data)} -> {len(out)} bytes")
    return 0


def _merge(args) -> int:
    from .io.streamtools import merge_layers
    out = merge_layers([_read(p) for p in args.inputs])
    _write(args.output, out)
    print(f"merge: {len(args.inputs)} layers -> {args.output} "
          f"({len(out)} bytes)")
    return 0


def _subpic_extract(args) -> int:
    from .io.streamtools import subpic_extract
    data = _read(args.bitstream)
    out = subpic_extract(data, args.idx)
    _write(args.output, out)
    print(f"subpic-extract: {len(data)} -> {len(out)} bytes")
    return 0


def _subpic_merge(args) -> int:
    from .io.streamtools import subpic_merge
    cols, rows = (int(v) for v in args.grid.split("x"))
    out = subpic_merge([_read(p) for p in args.inputs], cols, rows)
    _write(args.output, out)
    print(f"subpic-merge: {len(args.inputs)} subpics -> {args.output} "
          f"({len(out)} bytes)")
    return 0


def _filmgrain(args) -> int:
    from .io import filmgrain as fg
    data = _read(args.bitstream)
    if args.add:
        _write(args.output, fg.add_fgc(data, args.scale, args.seed,
                                       [(0, 255, args.gain)]))
        print(f"filmgrain: FGC SEI added -> {args.output}")
        return 0
    params = fg.find_fgc(data)
    if params is None:
        print("no film-grain SEI in stream", file=sys.stderr)
        return 1
    from .io import yuv
    from .pipeline import encoder as tenc
    frames, sps = tenc.decode_sequence(data, check_hash=True,
                                       device=args.device)
    yuv.write_yuv(args.output, fg.synthesize(frames, params, sps.bit_depth),
                  sps.bit_depth)
    print(f"filmgrain: {len(frames)} frames grained -> {args.output}")
    return 0


def _info(args) -> int:
    from .io.streamtools import stream_info
    data = _read(args.bitstream)
    rows = stream_info(data)
    for i, r in enumerate(rows):
        print(f"{i:4d}  {r['type']:12s} layer {r['layer']} tid {r['tid']} "
              f"{r['bytes']:8d} bytes")
    print(f"total: {len(rows)} NAL units, {len(data)} bytes")
    return 0


def _device_arg(p) -> None:
    p.add_argument("--device", default=None,
                   help="torch device (default cuda)")


def _tool_parsers(sub) -> None:
    """The reference CLI's stream tools, option for option."""
    pc = sub.add_parser("parcat",
                        help="concatenate segment bitstreams (Parcat)")
    pc.add_argument("inputs", nargs="+")
    pc.add_argument("-o", "--output", required=True)
    pc.set_defaults(fn=_parcat)
    sr = sub.add_parser("sei-remove",
                        help="strip SEI NAL units (SEIRemovalApp)")
    sr.add_argument("-b", "--bitstream", required=True)
    sr.add_argument("-o", "--output", required=True)
    sr.add_argument("--keep-hash", action="store_true",
                    help="keep decoded-picture-hash suffix SEIs")
    sr.set_defaults(fn=_sei_remove)
    ex = sub.add_parser("extract",
                        help="extract temporal sublayer or layer "
                             "(BitstreamExtractorApp)")
    ex.add_argument("-b", "--bitstream", required=True)
    ex.add_argument("-o", "--output", required=True)
    ex.add_argument("--tid", type=int, default=0,
                    help="max temporal_id to keep (default 0 = anchors)")
    ex.add_argument("--layer", type=int, default=None,
                    help="extract this nuh_layer_id from a merged stream")
    ex.set_defaults(fn=_extract)
    mg = sub.add_parser("merge",
                        help="merge streams into layers (StreamMergeApp)")
    mg.add_argument("inputs", nargs="+")
    mg.add_argument("-o", "--output", required=True)
    mg.set_defaults(fn=_merge)
    se = sub.add_parser("subpic-extract",
                        help="extract one subpicture as a standalone "
                        "stream (BitstreamExtractorApp subpic role)")
    se.add_argument("-b", "--bitstream", required=True)
    se.add_argument("-o", "--output", required=True)
    se.add_argument("--idx", type=int, required=True,
                    help="subpicture index (raster order)")
    se.set_defaults(fn=_subpic_extract)
    sm = sub.add_parser("subpic-merge",
                        help="merge per-subpicture streams into one "
                        "(SubpicMergeApp role)")
    sm.add_argument("inputs", nargs="+")
    sm.add_argument("-o", "--output", required=True)
    sm.add_argument("--grid", required=True, help="CxR grid")
    sm.set_defaults(fn=_subpic_merge)
    fg = sub.add_parser("filmgrain",
                        help="film-grain SEI tool (SEIFilmGrainApp role): "
                        "--add inserts an FGC SEI; default decodes and "
                        "synthesizes grain to YUV")
    fg.add_argument("-b", "--bitstream", required=True)
    fg.add_argument("-o", "--output", required=True)
    fg.add_argument("--add", action="store_true",
                    help="insert FGC SEI instead of synthesizing")
    fg.add_argument("--scale", type=int, default=6,
                    help="log2 grain scale divisor")
    fg.add_argument("--seed", type=int, default=1)
    fg.add_argument("--gain", type=int, default=16)
    _device_arg(fg)
    fg.set_defaults(fn=_filmgrain)
    nf = sub.add_parser("info", help="list NAL units in a stream")
    nf.add_argument("-b", "--bitstream", required=True)
    nf.set_defaults(fn=_info)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="vvctpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    e = sub.add_parser("encode", help="encode raw YUV to Annex-B bitstream")
    e.add_argument("-c", "--cfg", action="append", default=[],
                   help="VTM-style cfg file (repeatable; later wins)")
    e.add_argument("-i", "--input", help="input .yuv (I420)")
    e.add_argument("-b", "--bitstream", help="output .bin")
    e.add_argument("-o", "--recon", help="optional recon .yuv")
    e.add_argument("--wdt", type=int, help="source width")
    e.add_argument("--hgt", type=int, help="source height")
    e.add_argument("--hash", default="md5", choices=tuple(_HASH),
                   help="decoded-picture-hash SEI type")
    e.add_argument("-q", "--qp", type=int, default=32)
    e.add_argument("-f", "--frames", type=int, default=None)
    e.add_argument("--bit-depth", type=int, default=8, choices=(8, 10))
    e.add_argument("--ctu", type=int, default=64, choices=(64, 128),
                   help="CTU size")
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
    e.add_argument("--rc-bpf", type=int, default=0,
                   help="rate control: target bits per frame (0 = off)")
    e.add_argument("--tiles", default="1x1", help="tile grid CxR")
    e.add_argument("--subpics", default="1x1", help="subpicture grid CxR")
    _device_arg(e)
    e.set_defaults(fn=_enc)
    d = sub.add_parser("decode", help="decode Annex-B bitstream to YUV")
    d.add_argument("-b", "--bitstream", required=True)
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--no-hash", action="store_true",
                   help="skip decoded-picture-hash verification")
    _device_arg(d)
    d.set_defaults(fn=_dec)
    _tool_parsers(sub)
    args = ap.parse_args(argv)
    if args.cmd == "encode":
        args.from_cfg = (_apply_cfg(args, {a: e.get_default(a)
                                           for a in vars(args)})
                         if args.cfg else {})
        if args.tt and not args.mtt:
            e.error("--tt requires --mtt")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
