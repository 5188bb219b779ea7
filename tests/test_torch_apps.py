"""The port's CLI against the reference CLI (test_apps.py's,
test_streamtools.py's and test_filmgrain.py's expectations) on streams
that the port's CLI writes, 64x64 and 1-3 frames: the stream tools give
the reference's bytes and their outputs decode in the port with the
hashes verified; cfg files, the hash SEI types, and options outside the
slice refused."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vvctpu.__main__ import main as ref_main  # noqa: E402
from vvctpu.io import cfg as ref_cfg  # noqa: E402
from vvctpu_torch import __main__ as tcli  # noqa: E402
from vvctpu_torch.core import bitstream as tbs  # noqa: E402
from vvctpu_torch.io import cfg as tcfg  # noqa: E402
from vvctpu_torch.io import filmgrain as tfg  # noqa: E402
from vvctpu_torch.io import yuv  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402

from test_inter_parity import motion_frames  # noqa: E402

torch.set_num_threads(1)


def _port_stream(tmp_path, name, n=2, seed=60, extra=()):
    """Encode n 64x64 frames with the port's CLI on the CPU; returns (the
    stream's path, the frames, the recon read back)."""
    frames = motion_frames(n, 64, 64, seed=seed)
    src = tmp_path / f"{name}.yuv"
    yuv.write_yuv(str(src), frames)
    out, rec = tmp_path / f"{name}.bin", tmp_path / f"{name}_rec.yuv"
    assert tcli.main(["encode", "-i", str(src), "--wdt", "64", "--hgt", "64",
                      "-q", "32", "-b", str(out), "-o", str(rec),
                      "--device", "cpu", *extra]) == 0
    return out, frames, yuv.read_yuv(str(rec), 64, 64)


def _decode(data):
    return tenc.decode_sequence(data, check_hash=True, device="cpu")[0]


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


def _both(tmp_path, args):
    """Run a stream tool in the port's CLI and in the reference's, each
    writing its own output (the argument after -o); returns both
    outputs' bytes."""
    i = args.index("-o") + 1
    outs = []
    for tag, fn in (("port", tcli.main), ("ref", ref_main)):
        path = tmp_path / f"{tag}_{args[0]}.out"
        assert fn(args[:i] + [str(path)] + args[i + 1:]) == 0
        outs.append(path.read_bytes())
    return outs


def test_parcat(tmp_path):
    """Two segments concatenate to a 4-frame stream that decodes to both
    segments' recon."""
    a, _, ra = _port_stream(tmp_path, "a", seed=80, extra=["--ip", "0"])
    b, _, rb = _port_stream(tmp_path, "b", seed=81, extra=["--ip", "0"])
    got, want = _both(tmp_path, ["parcat", str(a), str(b), "-o", ""])
    assert got == want
    assert _same(_decode(got), ra + rb)


@pytest.mark.parametrize("keep", [False, True])
def test_sei_remove(tmp_path, keep):
    p, _, rec = _port_stream(tmp_path, "s", extra=["--ip", "0"])
    args = ["sei-remove", "-b", str(p), "-o", ""] + (["--keep-hash"]
                                                      if keep else [])
    got, want = _both(tmp_path, args)
    size = p.stat().st_size
    assert got == want
    assert len(got) <= size if keep else len(got) < size
    suffix = [n for n in tbs.read_annexb(got)
              if n.nal_type == tbs.NAL_SUFFIX_SEI]
    assert bool(suffix) == keep
    assert _same(_decode(got), rec)


def test_extract_sublayer(tmp_path):
    """A GOP2 stream (I0 P2 B1) keeps its temporal layer 0 pictures."""
    p, _, rec = _port_stream(tmp_path, "g", n=3,
                             extra=["--ip", "0", "--gop", "2"])
    got, want = _both(tmp_path, ["extract", "-b", str(p), "--tid", "0",
                                 "-o", ""])
    assert got == want
    assert _same(_decode(got), [rec[0], rec[2]])


def test_merge_and_extract_layer(tmp_path):
    a, _, ra = _port_stream(tmp_path, "a", n=1, seed=63)
    b, _, _ = _port_stream(tmp_path, "b", n=1, seed=64, extra=["-q", "35"])
    got, want = _both(tmp_path, ["merge", str(a), str(b), "-o", ""])
    assert got == want
    merged = tmp_path / "m.bin"
    merged.write_bytes(got)
    for layer, src in ((0, a), (1, b)):
        out, ref = _both(tmp_path, ["extract", "-b", str(merged), "--layer",
                                    str(layer), "-o", ""])
        assert out == ref == src.read_bytes()
    assert _same(_decode(a.read_bytes()), ra)


def test_subpic_merge_and_extract(tmp_path):
    """Two streams merged as a 2x1 subpicture grid extract back to
    themselves; the port decodes the merged stream (the two pictures side
    by side) and each extracted one."""
    a, _, ra = _port_stream(tmp_path, "a", n=1, seed=65)
    b, _, rb = _port_stream(tmp_path, "b", n=1, seed=66)
    got, want = _both(tmp_path, ["subpic-merge", str(a), str(b), "--grid",
                                 "2x1", "-o", ""])
    assert got == want
    merged = tmp_path / "m.bin"
    merged.write_bytes(got)
    out = _decode(got)
    assert _same(out, [[np.concatenate([x[c], y[c]], 1) for c in range(3)]
                       for x, y in zip(ra, rb)])
    for idx, src, rec in ((0, a, ra), (1, b, rb)):
        out, ref = _both(tmp_path, ["subpic-extract", "-b", str(merged),
                                    "--idx", str(idx), "-o", ""])
        assert out == ref == src.read_bytes()
        assert _same(_decode(out), rec)


def test_info(tmp_path, capsys):
    p, _, _ = _port_stream(tmp_path, "i", n=1)
    capsys.readouterr()
    assert tcli.main(["info", "-b", str(p)]) == 0
    port = capsys.readouterr().out
    assert ref_main(["info", "-b", str(p)]) == 0
    assert port == capsys.readouterr().out
    assert "SPS" in port and "SUFFIX_SEI" in port


def test_filmgrain(tmp_path):
    """--add inserts the FGC SEI the reference inserts; synthesis decodes
    the port's stream in the port and grains it as the reference does."""
    p, _, rec = _port_stream(tmp_path, "f", n=1, seed=31)
    got, want = _both(tmp_path, ["filmgrain", "-b", str(p), "--add",
                                 "--seed", "7", "-o", ""])
    assert got == want and tfg.find_fgc(got) == (6, 7, [(0, 255, 16)])
    assert tfg.find_fgc(p.read_bytes()) is None
    grained = tmp_path / "g.bin"
    grained.write_bytes(got)
    yp, yr = tmp_path / "port.yuv", tmp_path / "ref.yuv"
    assert tcli.main(["filmgrain", "-b", str(grained), "-o", str(yp),
                      "--device", "cpu"]) == 0
    assert ref_main(["filmgrain", "-b", str(grained), "-o", str(yr)]) == 0
    assert yp.read_bytes() == yr.read_bytes()
    g = yuv.read_yuv(str(yp), 64, 64)
    assert not np.array_equal(g[0][0], rec[0][0])
    assert tcli.main(["filmgrain", "-b", str(p), "-o", str(yp),
                      "--device", "cpu"]) == 1


@pytest.mark.parametrize("htype", ["md5", "crc", "checksum"])
def test_hash_types(tmp_path, htype):
    """Each hash SEI type gives the reference CLI's bytes, verifies in the
    port's decoder and fails it when corrupted."""
    p, frames, rec = _port_stream(tmp_path, "h", n=1, seed=33,
                                  extra=["--hash", htype])
    src = tmp_path / "h.yuv"
    ref = tmp_path / "r.bin"
    assert ref_main(["encode", "-i", str(src), "--wdt", "64", "--hgt", "64",
                     "-q", "32", "-b", str(ref), "--hash", htype]) == 0
    assert p.read_bytes() == ref.read_bytes()
    assert _same(_decode(p.read_bytes()), rec)
    nals = tbs.read_annexb(p.read_bytes())
    for n in nals:
        if n.nal_type == tbs.NAL_SUFFIX_SEI:
            n.payload = n.payload[:4] + bytes([n.payload[4] ^ 0xFF]) \
                + n.payload[5:]
    with pytest.raises(ValueError, match="hash"):
        _decode(tbs.write_annexb(nals))


def test_cfg_layered_parse(tmp_path):
    """The copied cfg parser reads test_apps.py's layered files as the
    reference's does."""
    base = tmp_path / "base.cfg"
    base.write_text("SourceWidth : 176   # comment\nSourceHeight: 144\n"
                    "QP          : 37\nIntraPeriod : -1\nGOPSize     : 8\n"
                    "EntropyCodingSyncEnabled : 1\n"
                    "UnknownFutureOption : 42\n")
    over = tmp_path / "seq.cfg"
    over.write_text("QP : 27\nFramesToBeEncoded : 9\nLMCSEnable : 1\n")
    got = tcfg.load_layered([str(base), str(over)])
    assert dataclasses.asdict(got) == dataclasses.asdict(
        ref_cfg.load_layered([str(base), str(over)]))
    assert (got.width, got.height, got.qp, got.frames) == (176, 144, 27, 9)
    assert got.intra_period == 0 and got.gop == 8 and got.wpp and got.lmcs


def test_cfg_driven_encode(tmp_path):
    """An encode driven by a cfg file (LMCS on, QP from the command line
    over the file's) gives the reference CLI's bytes."""
    frames = motion_frames(2, 64, 64, seed=84)
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), frames)
    cfgf = tmp_path / "e.cfg"
    outs = []
    for tag, fn in (("port", tcli.main), ("ref", ref_main)):
        out = tmp_path / f"{tag}.bin"
        cfgf.write_text(f"InputFile : {src}\nBitstreamFile : {out}\n"
                        "SourceWidth : 64\nSourceHeight : 64\nQP : 37\n"
                        "IntraPeriod : -1\nLMCSEnable : 1\n")
        args = ["encode", "-c", str(cfgf), "-q", "30"]
        assert fn(args + (["--device", "cpu"] if tag == "port" else [])) \
            == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert len(_decode(outs[0])) == 2


# the option outside the port: a checkpoint with the torch engine (the
# spec model's encoder resumes from one; the reference CLI ignores it with
# its JAX engine)
_OUTSIDE = {"checkpoint": ["--checkpoint", "ck.npz"]}


@pytest.mark.parametrize("opt", list(_OUTSIDE))
def test_options_outside_slice_raise(tmp_path, opt):
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), motion_frames(1, 64, 64, seed=1))
    extra = _OUTSIDE[opt]
    if isinstance(extra, str):
        cfgf = tmp_path / "o.cfg"
        cfgf.write_text(extra + "\n")
        extra = ["-c", str(cfgf)]
    with pytest.raises(ValueError, match="outside"):
        tcli.main(["encode", "-i", str(src), "--wdt", "64", "--hgt", "64",
                   "-b", str(tmp_path / "o.bin"), "--device", "cpu",
                   *extra])


# options that were outside the slice until 10-bit input, tiles and
# subpictures, then rate control, MCTF, TS and JCCR, then CTU 128, IBC
# and palette, then RDOQ off, the reference's --distributed (one process:
# a plain encode) and --gop-parallel were ported: a flag, or a cfg file's
# lines
_NOW_IN = {
    "rdoq": "RDOQ : 0", "no-rdoq": ["--no-rdoq"],
    "distributed": ["--distributed"], "gop-parallel": ["--gop-parallel", "2"],
    "bit-depth": ["--bit-depth", "10"], "tiles": ["--tiles", "2x1"],
    "subpics": ["--subpics", "2x1"], "cfg-tiles": "TileColumns : 2",
    "rc-bpf": "RateControl : 1\nTargetBitrate : 30000",
    "tskip": "TSM : 1", "jccr": "JointCbCr : 1",
    "mctf": "TemporalFilter : 1", "ctu": ["--ctu", "128"],
    "ibc": "IBC : 1", "plt": "PLT : 1", "ibc-plt": ["--ibc", "--plt"],
    "palettemode": "PaletteMode : 1"}
# the reference CLI reads a cfg file's RateControl and TargetBitrate and
# does not apply them; the port's CLI applies them (30000 bit/s at the
# default 30 frames/s), so the reference is given the same target
_REF_EXTRA = {"rc-bpf": ["--rc-bpf", "1000"]}


@pytest.mark.parametrize("opt", list(_NOW_IN))
def test_options_now_in_slice_encode(tmp_path, opt):
    """The CLI's --bit-depth 10, --tiles, --subpics, --ctu 128, --ibc with
    --plt, --no-rdoq, --distributed on one process, --gop-parallel 2 and
    a cfg file's RDOQ : 0, TileColumns, RateControl with TargetBitrate,
    TSM, JointCbCr, TemporalFilter, IBC, PLT and PaletteMode encode 2
    frames of 128x64 (IPPP) to the reference CLI's bytes (tolerance 0),
    and the port decodes them with the hashes verified; each stream's SPS
    has the option's CTU size, IBC and palette.  Both CLIs read a cfg
    file's TileColumns and do not apply it: its stream has no tiles."""
    frames = motion_frames(2, 64, 128, seed=2)
    extra = _NOW_IN[opt]
    bd = 10 if opt == "bit-depth" else 8
    if bd == 10:
        frames = [[(p << 2) | 1 for p in f] for f in frames]
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), frames, bd)
    if isinstance(extra, str):
        cfgf = tmp_path / "o.cfg"
        cfgf.write_text(extra + "\n")
        extra = ["-c", str(cfgf)]
    outs = []
    for tag, fn in (("port", tcli.main), ("ref", ref_main)):
        out = tmp_path / f"{tag}.bin"
        args = ["encode", "-i", str(src), "--wdt", "128", "--hgt", "64",
                "-q", "32", "--ip", "0", "-b", str(out), *extra]
        args += (["--device", "cpu"] if tag == "port"
                 else _REF_EXTRA.get(opt, []))
        assert fn(args) == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert len(_decode(outs[0])) == 2
    sps, pps_map, _ = tenc._parse(outs[0], True)
    assert sps.log2_ctu == (7 if opt == "ctu" else 6)
    assert sps.ibc_enabled == (opt in ("ibc", "ibc-plt"))
    assert sps.plt_enabled == (opt in ("plt", "ibc-plt", "palettemode"))
    assert {(p.num_tile_cols, p.num_tile_rows) for p in pps_map.values()} \
        == {(2, 1) if opt == "tiles" else (1, 1)}


def test_trace_files_equal_spec_model(tmp_path):
    """--trace-file on encode and decode (test_codec_roundtrip.py's
    tracing check): the port's encode and decode traces are equal, and
    equal to the reference CLI's spec-model encode trace."""
    from test_codec_roundtrip import synth_frame

    from vvctpu.core import trace as ref_trace
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), [synth_frame(64, 64, seed=13)])
    bit, rbit = tmp_path / "p.bin", tmp_path / "r.bin"
    tr = {k: tmp_path / f"{k}.trc" for k in ("enc", "dec", "ref")}
    args = ["-i", str(src), "--wdt", "64", "--hgt", "64", "-q", "32"]
    assert tcli.main(["encode", *args, "-b", str(bit), "--trace-file",
                      str(tr["enc"]), "--device", "cpu"]) == 0
    assert tcli.main(["decode", "-b", str(bit), "-o",
                      str(tmp_path / "d.yuv"), "--trace-file",
                      str(tr["dec"]), "--device", "cpu"]) == 0
    try:
        assert ref_main(["encode", *args, "-b", str(rbit), "--trace-file",
                         str(tr["ref"])]) == 0
    finally:
        ref_trace.close_trace()
    assert bit.read_bytes() == rbit.read_bytes()
    text = tr["enc"].read_text()
    assert text.startswith("D_") and text == tr["dec"].read_text() \
        == tr["ref"].read_text()


def test_bitstats_equal_reference_cli(tmp_path, capsys):
    """decode --bitstats (on test_apps.py's test_bitstats_accounting
    clip, an I and a P frame) prints the reference CLI's bin tally of the
    same stream; the port's decode is the recon."""
    rng = np.random.default_rng(7)
    frames = [[rng.integers(0, 255, (64, 64)).astype(np.int32),
               np.full((32, 32), 128, np.int32),
               np.full((32, 32), 128, np.int32)] for _ in range(2)]
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), frames)
    bit, rec = tmp_path / "p.bin", tmp_path / "rec.yuv"
    assert tcli.main(["encode", "-i", str(src), "--wdt", "64", "--hgt",
                      "64", "-q", "32", "--ip", "0", "-b", str(bit), "-o",
                      str(rec), "--device", "cpu"]) == 0
    capsys.readouterr()
    tallies = []
    for tag, fn in (("port", tcli.main), ("ref", ref_main)):
        out = tmp_path / f"{tag}.yuv"
        assert fn(["decode", "-b", str(bit), "-o", str(out), "--bitstats"]
                  + (["--device", "cpu"] if tag == "port" else [])) == 0
        text = capsys.readouterr().out
        tallies.append(text[text.index("bin statistics"):])
        assert out.read_bytes() == rec.read_bytes()
    assert tallies[0] == tallies[1]
    for key in ("sig_coeff_flag", "cu_skip_flag", "(bypass)"):
        assert f"  {key} " in tallies[0]


def test_checkpoint_with_spec_engine(tmp_path):
    """--checkpoint --engine spec writes the spec model's checkpoint and
    gives the reference CLI's bytes (whose default engine is the spec
    model)."""
    frames = motion_frames(3, 64, 64, seed=85)
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), frames)
    outs = []
    for tag, fn in (("port", tcli.main), ("ref", ref_main)):
        out, ck = tmp_path / f"{tag}.bin", tmp_path / f"{tag}_ck.npz"
        assert fn(["encode", "-i", str(src), "--wdt", "64", "--hgt", "64",
                   "-q", "32", "--ip", "0", "-b", str(out), "--checkpoint",
                   str(ck)] + (["--engine", "spec"] if tag == "port"
                               else [])) == 0
        assert ck.exists()
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    assert len(_decode(outs[0])) == 3
