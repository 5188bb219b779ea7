"""All-intra with the intra toolset (MTS, LFNST, ISP, MIP, MRL, CCLM) end
to end: the port's bitstreams equal the spec model's (each tool alone
and all six together) and, at one configuration, the reference engine's;
streams decode across engines both ways with hashes verified; the
frame-batched group equals one frame per wave; and the port decodes a
spec-model P-frame stream that uses ISP."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.spec import codec as scodec  # noqa: E402
from vvctpu.spec import decide as sdecide  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu_torch import __main__ as tcli  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402
from vvctpu_torch.io import yuv  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_isp import synth  # noqa: E402

torch.set_num_threads(1)

TOOLS = ("mts", "lfnst", "isp", "mip", "mrl", "cclm")
ALL = {t: True for t in TOOLS}


def _same(a, b):
    return all(np.array_equal(x[c], y[c]) for x, y in zip(a, b)
               for c in range(3))


def _decisions_equal_spec(frame, cfg):
    """The port's decision pass equals the spec model's on a frame."""
    sps = cfg.make_sps(frame[0].shape[1], frame[0].shape[0])
    kw = dict(mip=cfg.mip, mrl=cfg.mrl, isp=cfg.isp)
    y = scodec.pad_planes(frame, sps)[0]
    want = sdecide.decide_frame(y, cfg.qp, 8, **kw)
    got = tdecide.decide_frame(y, cfg.qp, 8, device="cpu", **kw)
    assert got.equal(want)


_CASES = {
    "all_64x96x3": (3, 64, 96, ALL),
    "all_52x100x1": (1, 52, 100, ALL),
    **{t: (1, 64, 96, {t: True}) for t in TOOLS},
}


@functools.lru_cache(maxsize=None)
def _encoded(case):
    """(frames, the port's bytes, recon, bits) of one case, encoded once
    per process for the tests that share it."""
    n, h, w, tools = _CASES[case]
    frames = synth(n, h, w, seed=7)
    return (frames,) + tenc.encode_sequence(
        frames, tseq.EncoderConfig(qp=32, **tools), device="cpu")


@pytest.mark.parametrize("case", sorted(_CASES))
def test_bytes_equal_spec_model(case):
    n, h, w, tools = _CASES[case]
    kw = dict(qp=32, **tools)
    frames, data, rec, bits = _encoded(case)
    sdata, srec, sbits = sseq.encode_sequence(frames,
                                              sseq.EncoderConfig(**kw))
    assert data == sdata
    assert bits == sbits and _same(rec, srec)
    # the decision pass takes only MIP, MRL and ISP; without them it is the
    # default pass, held to the reference's in test_torch_decide.py
    if {"mip", "mrl", "isp"} & set(tools):
        _decisions_equal_spec(frames[-1], sseq.EncoderConfig(**kw))
    out, sps = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert all(getattr(sps, f"{t}_enabled") for t in tools)
    assert _same(out, rec)
    if n == 1 and len(tools) > 1:     # the spec decoder reads the port's
        sout, _ = sseq.decode_sequence(data, check_hash=True)
        assert _same(sout, rec)


def test_reference_engine_parity():
    """The port's bytes equal vvctpu's own pipeline at the configuration
    of test_isp.py's test_isp_pipeline_parity (its compiled programs are
    shared with that test through the suite's compile cache), and the
    port decodes vvctpu's stream with hashes verified.  The bytes being
    equal, vvctpu's decoder reads the port's stream in that test."""
    frames = synth(1, 64, 128, seed=3)
    kw = dict(qp=30, isp=True, mts=True, lfnst=True, mip=True, mrl=True,
              cclm=True, deblock=False, sao=False)
    data_j, rec_j, _ = jenc.encode_sequence(frames, sseq.EncoderConfig(**kw))
    data, rec, _ = tenc.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                        device="cpu")
    assert data == data_j and _same(rec, rec_j)
    out, _ = tenc.decode_sequence(data_j, check_hash=True, device="cpu")
    assert _same(out, rec_j)


def test_batched_group_equals_one_frame_per_wave(monkeypatch):
    frames, data, rec, _ = _encoded("all_64x96x3")   # one 3-frame group
    monkeypatch.setattr(tenc, "_GROUP", 1)
    one, rec1, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(qp=32, **ALL), device="cpu")
    assert data == one and _same(rec, rec1)


def test_decodes_spec_ippp_stream_with_isp():
    """ISP in P frames (the decoder's phase B is shared by every slice
    type): the spec model's stream of test_isp.py's P-frame roundtrip."""
    frames = synth(3, 64, 64, seed=5)
    cfg = sseq.EncoderConfig(qp=30, isp=True, intra_period=0, gop=1,
                             deblock=False, sao=False)
    decs = []
    data, srec, _ = sseq.encode_sequence(frames, cfg, decisions_out=decs)
    assert any(d.isp8[d.inter8 == 0].any() for d in decs[1:])
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert _same(out, srec)


@pytest.mark.parametrize("tool", TOOLS)
def test_tools_outside_all_intra_raise(tool):
    """Outside all-intra the intra tools are in the slice: beside an
    option that is not (a CTU of 256; RDOQ off was until it was ported,
    IBC and JCCR until they were), only that option is refused."""
    frames = synth(1, 64, 64)
    with pytest.raises(ValueError, match="outside") as err:
        tenc.encode_sequence(frames, tseq.EncoderConfig(
            intra_period=0, ctu=256, **{tool: True}), device="cpu")
    assert str(err.value).endswith(": ctu=256")


def test_cli_intra_tools(tmp_path, capsys):
    frames, data, _, _ = _encoded("all_52x100x1")
    src = str(tmp_path / "in.yuv")
    yuv.write_yuv(src, frames)
    bit, rec, dec = (str(tmp_path / n) for n in ("a.bin", "r.yuv", "d.yuv"))
    assert tcli.main(["encode", "-i", src, "--wdt", "100", "--hgt", "52",
                      "-q", "32", "-b", bit, "-o", rec, "--device", "cpu"]
                     + [f"--{t}" for t in TOOLS]) == 0
    with open(bit, "rb") as f:
        assert f.read() == data
    assert tcli.main(["decode", "-b", bit, "-o", dec, "--device",
                      "cpu"]) == 0
    assert "all picture hashes verified" in capsys.readouterr().out
    with open(rec, "rb") as a, open(dec, "rb") as b:
        assert a.read() == b.read()
