"""MCTF (the motion-compensated temporal prefilter) and rate control in
the port, at tolerance 0: the port's temporal_filter (its motion search
through me_sad's plain twin on CPU tensors) against the copied spec
function, test_apps.py's rate-control and MCTF configurations against the
spec model (bytes, recon, whole-plane decisions) and the rate-control one
against a live vvctpu encode, the four tools of the slice together with
the multi-type tree and LMCS against the spec model, and the CLI's flags
against the reference CLI's bytes."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import chip_smoke  # noqa: E402
from vvctpu.__main__ import main as ref_main  # noqa: E402
from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu_torch import __main__ as tcli  # noqa: E402
from vvctpu_torch.coding import mctf as tmctf  # noqa: E402
from vvctpu_torch.io import yuv  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import decide as tsdecide  # noqa: E402
from vvctpu_torch.spec import mctf as tsmctf  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_inter_parity import motion_frames  # noqa: E402

torch.set_num_threads(1)


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


def pan_frames(n, h, w, step, seed=5):
    """A textured h x w clip panning ``step`` pixels left per frame, far
    beyond the dense +-16 window: only the +-64 coarse-to-fine stage finds
    the motion."""
    rng = np.random.default_rng(seed)
    W = w + step * n
    yy, xx = np.mgrid[0:h, 0:W]
    tex = (128 + 50 * np.sin(xx / 9.0) * np.cos(yy / 7.0)
           + 30 * np.sin((xx + 2 * yy) / 13.0))
    for _ in range(20):
        x0, y0 = rng.integers(0, W - 12), rng.integers(0, h - 12)
        tex[y0:y0 + 12, x0:x0 + 12] = rng.integers(0, 256)
    tex = (tex + rng.integers(-2, 3, tex.shape)).clip(0, 255).astype(np.int32)
    cb = (128 + 30 * np.sin(xx[::2, ::2] / 5.0)).astype(np.int32)
    cr = (128 - 30 * np.cos(yy[::2, ::2] / 6.0 + xx[::2, ::2] / 11.0)) \
        .astype(np.int32)
    return [[tex[:, step * t:step * t + w],
             cb[:, step * t // 2:(step * t + w) // 2],
             cr[:, step * t // 2:(step * t + w) // 2]] for t in range(n)]


# name -> (frames, gop)
_MCTF_CASES = {
    "64x64": (lambda: motion_frames(5, 64, 64, seed=98), 2),
    "240_rows": (lambda: motion_frames(3, 240, 64, seed=99), 2),
    "80_wide": (lambda: motion_frames(4, 48, 80, seed=97), 1),
    "10_bit": (lambda: [[p << 2 for p in f]
                        for f in motion_frames(3, 64, 128, seed=7)], 2),
    "ext_motion": (lambda: pan_frames(3, 128, 128, 40), 2),
    "unaligned": (lambda: motion_frames(3, 52, 100, seed=96), 1),
}


@pytest.mark.parametrize("case", list(_MCTF_CASES))
def test_temporal_filter_equals_spec(case):
    """The port's temporal_filter equals the copied spec function on every
    plane of every frame (tolerance 0), and the motion of the first
    anchor's first neighbour equals me_size_pass's: at 64x64, at 240
    rows, at a width that is not a multiple of 64 (the frames extended to
    64-multiples for me_sad), at 10 bits, under a 40-pixel pan that only
    the +-64 ext stage finds, and on sides that are not multiples of 16,
    which pass unchanged."""
    mk, gop = _MCTF_CASES[case]
    frames = mk()
    got = tmctf.temporal_filter(frames, gop, device="cpu")
    want = tsmctf.temporal_filter(frames, gop)
    assert _same(got, want)
    h, w = frames[0][0].shape
    if case == "unaligned":
        assert _same(got, frames)
        return
    assert not np.array_equal(got[0][0], frames[0][0])     # it filtered
    mv = tmctf.block_motion(torch.as_tensor(frames[0][0]),
                            torch.as_tensor(frames[1][0]))
    _, smv = tsdecide.me_size_pass(frames[0][0], frames[1][0],
                                   tsmctf.BLOCK, lam=0)
    np.testing.assert_array_equal(mv.numpy(), smv)
    if case == "ext_motion":
        assert (np.abs(smv[..., 0]) > 16).any()


# name -> (frames, EncoderConfig keywords)
_SPEC_CASES = {
    # test_apps.py:102-104: rate control, IPPP
    "rc": (lambda: motion_frames(4, 64, 64, seed=96),
           dict(qp=26, intra_period=0, rc_bits_per_frame=1200)),
    # rate control in all-intra: one frame per frame-batched wave
    "rc_ai": (lambda: motion_frames(3, 64, 64, seed=95),
              dict(qp=30, rc_bits_per_frame=800)),
    # test_apps.py:135-136: MCTF, GOP2
    "mctf": (lambda: motion_frames(4, 64, 64, seed=98),
             dict(qp=32, intra_period=0, gop=2, mctf=True)),
    # the four tools with the multi-type tree, LMCS and config #4's toolset
    "ctc": (lambda: chip_smoke.ctc_frames(),
            dict(qp=27, intra_period=0, gop=2, isp=True, mrl=True, sbt=True,
                 dq=True, alf=True, lmcs=True, tskip=True, jccr=True,
                 mctf=True, rc_bits_per_frame=4000, **chip_smoke.MTT,
                 **chip_smoke.RA_TOOLS)),
}


@pytest.mark.parametrize("case", list(_SPEC_CASES))
def test_mctf_rc_equal_spec_model(case):
    """The port's bytes, recon and whole-plane decisions equal the spec
    model's (tolerance 0); under rate control the slice QPs move off the
    configured QP; the port and the spec model decode the port's stream
    with the hashes verified."""
    mk, kw = _SPEC_CASES[case]
    frames = mk()
    cfg = tseq.EncoderConfig(**kw)
    decs, sdecs = [], []
    data, rec, bits = tenc.encode_sequence(frames, cfg, device="cpu",
                                           decisions_out=decs)
    sdata, srec, sbits = tseq.encode_sequence(frames, cfg,
                                              decisions_out=sdecs)
    assert data == sdata and bits == sbits and _same(rec, srec)
    assert len(decs) == len(sdecs)
    assert all(a.equal(b) for a, b in zip(decs, sdecs))
    qps = tenc.slice_qps(data)
    if kw.get("rc_bits_per_frame"):
        assert qps[0] == kw["qp"] and len(set(qps.values())) > 1
    if case == "ctc":
        assert any((d.mts8 == 5).any() for d in decs)
        assert any(d.jccr8.any() for d in decs)
        assert any(d.inter8.any() for d in decs)
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert _same(out, rec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)


def test_rate_control_equals_reference_engine():
    """test_apps.py's rate-control configuration (whose programs that test
    compiles for vvctpu too): the port's bytes and bits equal a live
    vvctpu encode (tolerance 0), and the port decodes vvctpu's stream
    with the hashes verified."""
    frames = motion_frames(4, 64, 64, seed=96)
    kw = dict(qp=26, intra_period=0, rc_bits_per_frame=1200)
    jdata, jrec, jbits = jenc.encode_sequence(frames,
                                              sseq.EncoderConfig(**kw))
    data, rec, bits = tenc.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                           device="cpu")
    assert data == jdata and bits == jbits and _same(rec, jrec)
    out, _ = tenc.decode_sequence(jdata, check_hash=True, device="cpu")
    assert _same(out, jrec)


def test_cli_flags_equal_reference_cli(tmp_path):
    """--tskip, --jccr, --mctf and --rc-bpf on 3 frames of 64x64 GOP2 give
    the reference CLI's bytes (tolerance 0), its per-frame QPs from the
    slice headers, and the port's decoder verifies the hashes."""
    frames = chip_smoke.ctc_frames()
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), frames)
    outs = []
    for tag, fn in (("port", tcli.main), ("ref", ref_main)):
        out = tmp_path / f"{tag}.bin"
        args = ["encode", "-i", str(src), "--wdt", "64", "--hgt", "64",
                "-q", "30", "--ip", "0", "--gop", "2", "--tskip", "--jccr",
                "--mctf", "--rc-bpf", "3000", "-b", str(out)]
        assert fn(args + (["--device", "cpu"] if tag == "port" else [])) \
            == 0
        outs.append(out.read_bytes())
    assert outs[0] == outs[1]
    qps = tenc.slice_qps(outs[0])
    assert qps[0] == 30 and len(set(qps.values())) > 1
    out, _ = tenc.decode_sequence(outs[0], check_hash=True, device="cpu")
    assert len(out) == 3
