"""CLI: encode raw YUV to an Annex-B VVC bitstream and decode it back with
the PyTorch engine (all-intra, low-delay P or random access, with the
multi-type tree, VVC's intra and inter toolsets, intra block copy and
palette, dependent quantization, transform skip, joint Cb-Cr residuals,
LMCS and ALF, the MCTF prefilter and rate control, at CTU 64 or 128,
with RDOQ or the plain quantizer; closed-GOP segments in threads or over
processes), and the reference's stream tools (parcat, sei-remove,
extract, merge, subpic-extract, subpic-merge, filmgrain, info).

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
    python -m vvctpu_torch encode -i in.yuv --wdt 1920 --hgt 1080 -q 32 \\
        --no-rdoq --gop-parallel 2 --ip 32 --gop 4 -f 8 -b gp.bin
    python -m vvctpu_torch encode ... --distributed --coordinator \\
        localhost:29500 --num-processes 2 --process-id 0   (and 1)
    python -m vvctpu_torch parcat out.bin.seg0 out.bin.seg1 -o out.bin
    python -m vvctpu_torch decode -b out.bin -o dec.yuv --bitstats \\
        --trace-file dec.trc

Option names follow ``python -m vvctpu``; ``--device`` picks the torch
device (CUDA by default) and ``--engine`` the encoder: ``torch``, the
port (the default), or ``spec``, the copied spec model (the reference
CLI's default engine).  ``--no-rdoq`` (or a cfg file's RDOQ : 0) turns
RDOQ off.  ``--distributed`` joins ``--num-processes`` processes through
torch.distributed (gloo) at ``--coordinator``; each, on its card of its
host unless ``--device`` says otherwise, encodes its closed-GOP segment
and writes ``<bitstream>.seg<rank>``, which ``parcat`` joins, as the
reference's segments.  ``--gop-parallel N`` encodes N segments in
threads on the one device and concatenates them.
``--trace-file`` and ``--trace-rule`` write the syntax trace of the
encode or the decode; the decoder's ``--bitstats`` prints the spec
model's bin tally of the stream.  ``--checkpoint`` resumes the spec
model's encode (``--engine spec``); the torch engine has no checkpoint
and refuses it (the reference CLI ignores it there).  What the spec
model refuses raises the encoder's ValueError: IBC or palette at CTU
128, IBC with tiles, and tiles with WPP on a picture of more than one
CTU row.  A cfg file's RateControl with TargetBitrate and FrameRate sets
the rate controller's bits per frame where --rc-bpf is not given (the
reference CLI reads those keys and does not apply them).
"""
from __future__ import annotations

import argparse
import sys
import time

from .core import trace as _trace

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


def _apply_cfg(args, defaults) -> None:
    """Fill the encode arguments from the layered cfg files ``args.cfg``,
    as the reference CLI does: a file's value applies where the command
    line left the option at its default (rate control's bits per frame
    from RateControl, TargetBitrate and FrameRate where --rc-bpf is 0),
    and a file's RDOQ : 0 turns RDOQ off."""
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
    if not fc.rdoq:
        args.no_rdoq = True
    # a file's TileColumns and TileRows are read and not applied, as in
    # the reference CLI: only --tiles sets the tile grid


def _segment(args, frames, gop: int):
    """--distributed: join the processes (one process: nothing to join)
    and keep this process's closed-GOP segment of ``frames``; returns
    (frames, the bitstream's suffix).  Without --device each process
    computes on its card of its host, cuda:{local rank % cards}."""
    import torch

    from .dist.gop import segment_for_process
    from .dist.mesh import dist, init_distributed, rank_device
    pi = init_distributed(args.coordinator, args.num_processes,
                          args.process_id)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n == 1:
        return frames, ""
    if args.device is None:
        args.device = rank_device("cuda")
        torch.cuda.set_device(args.device)
    s, e = segment_for_process(len(frames), n, gop, pi)
    print(f"distributed: process {pi}/{n} encodes frames [{s}, {e}); "
          "concatenate segments with 'python -m vvctpu_torch parcat'")
    return frames[s:e], f".seg{pi}"


def _enc(args) -> int:
    from .io import yuv
    from .pipeline import encoder as tenc
    from .spec import hls
    from .spec import sequence as seq
    if not (args.input and args.bitstream and args.wdt and args.hgt):
        print("missing input/bitstream/wdt/hgt (flags or cfg)",
              file=sys.stderr)
        return 2
    if args.checkpoint and args.engine == "torch":
        raise ValueError("--checkpoint is outside the torch engine (the "
                         "spec model's encoder resumes from checkpoints: "
                         "--engine spec)")
    tc, tr = (int(v) for v in args.tiles.split("x"))
    sc, sr = (int(v) for v in args.subpics.split("x"))
    cfg = seq.EncoderConfig(
        qp=args.qp, bit_depth=args.bit_depth, ctu=args.ctu,
        intra_period=args.intra_period, gop=args.gop, wpp=args.wpp,
        tile_cols=tc, tile_rows=tr, subpic_cols=sc, subpic_rows=sr,
        rc_bits_per_frame=args.rc_bpf, hash_type=_HASH[args.hash],
        rdoq=not args.no_rdoq, **{t: getattr(args, t) for t in _TOOLS})
    if args.engine == "torch":
        tenc.check_config(cfg)
    frames = yuv.read_yuv(args.input, args.wdt, args.hgt, args.frames,
                          args.bit_depth)
    if not frames:
        print("no frames read", file=sys.stderr)
        return 1
    suffix = ""
    if args.distributed:
        frames, suffix = _segment(args, frames, cfg.gop)
    if args.trace_file:
        _trace.open_trace(args.trace_file, args.trace_rule)
    t0 = time.time()
    try:
        if args.gop_parallel > 1:
            from .dist.gop import encode_gop_parallel
            data, recons, bits = encode_gop_parallel(
                frames, cfg, segments=args.gop_parallel, engine=args.engine,
                threads=True, device=args.device)
        elif args.engine == "spec":
            data, recons, bits = seq.encode_sequence(
                frames, cfg, checkpoint_path=args.checkpoint)
        else:
            data, recons, bits = tenc.encode_sequence(frames, cfg,
                                                      device=args.device)
    finally:
        if args.trace_file:
            _trace.close_trace()
    dt = time.time() - t0
    with open(args.bitstream + suffix, "wb") as f:
        f.write(data)
    if suffix:
        from .dist.mesh import dist
        dist.destroy_process_group()
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
    if args.trace_file:
        _trace.open_trace(args.trace_file, args.trace_rule)
    t0 = time.time()
    try:
        frames, sps = tenc.decode_sequence(
            data, check_hash=not args.no_hash, device=args.device)
    finally:
        if args.trace_file:
            _trace.close_trace()
    dt = time.time() - t0
    yuv.write_yuv(args.output, frames, sps.bit_depth)
    print(f"decoded {len(frames)} frames "
          f"{frames[0][0].shape[1]}x{frames[0][0].shape[0]} in {dt:.2f} s "
          f"({len(frames) / max(dt, 1e-9):.3f} fps)"
          + ("" if args.no_hash else "; all picture hashes verified"))
    if args.bitstats:
        # the bin tally of the spec model's parser, as the reference
        # CLI's (the port's parse is the copied entropy walker, which
        # keeps none)
        from .spec import sequence as seq
        stats = {}
        seq.decode_sequence(data, check_hash=False, stats=stats)
        total = sum(stats.values())
        print(f"bin statistics ({total} bins):")
        for name, cnt in sorted(stats.items(), key=lambda kv: -kv[1]):
            print(f"  {name:28s} {cnt:10d}  {100.0 * cnt / total:5.1f}%")
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


def _trace_args(p) -> None:
    p.add_argument("--trace-file", help="syntax trace output (dtrace equiv)")
    p.add_argument("--trace-rule", default="D_SYNTAX,D_MODE,D_RESID:poc>=0")


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
    e.add_argument("--no-rdoq", action="store_true",
                   help="disable the RDOQ quantizer")
    e.add_argument("--engine", choices=("torch", "spec"), default="torch",
                   help="torch: the port; spec: the copied spec model "
                   "(the reference CLI's default)")
    e.add_argument("--checkpoint",
                   help="encoder checkpoint .npz path (--engine spec)")
    e.add_argument("--distributed", action="store_true",
                   help="join --num-processes processes (torch.distributed,"
                   " gloo); each encodes its closed-GOP segment to "
                   "<bitstream>.seg<rank> (parcat to combine)")
    e.add_argument("--coordinator", default=None,
                   help="rendezvous address host:port (or tcp:// or file://"
                   " URL)")
    e.add_argument("--num-processes", type=int, default=None)
    e.add_argument("--process-id", type=int, default=None)
    e.add_argument("--gop-parallel", type=int, default=1, metavar="N",
                   help="encode N closed-GOP segments independently (in "
                   "threads) and concatenate")
    _trace_args(e)
    _device_arg(e)
    e.set_defaults(fn=_enc)
    d = sub.add_parser("decode", help="decode Annex-B bitstream to YUV")
    d.add_argument("-b", "--bitstream", required=True)
    d.add_argument("-o", "--output", required=True)
    d.add_argument("--no-hash", action="store_true",
                   help="skip decoded-picture-hash verification")
    d.add_argument("--bitstats", action="store_true",
                   help="print CABAC bin counts per syntax class "
                   "(DecoderAnalyser role; the spec model's parse)")
    _trace_args(d)
    _device_arg(d)
    d.set_defaults(fn=_dec)
    _tool_parsers(sub)
    args = ap.parse_args(argv)
    if args.cmd == "encode":
        if args.cfg:
            _apply_cfg(args, {a: e.get_default(a) for a in vars(args)})
        if args.tt and not args.mtt:
            e.error("--tt requires --mtt")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
