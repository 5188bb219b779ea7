"""End to end: the port's bitstreams are byte-identical to the reference
engine's, decode across engines both ways with hashes verified, and
configurations outside the slice raise."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_codec_roundtrip import synth_frame  # noqa: E402
from test_inter_parity import motion_frames  # noqa: E402

torch.set_num_threads(1)


def _same(a, b):
    return all(np.array_equal(x[c], y[c]) for x, y in zip(a, b)
               for c in range(3))


def _cfg(**kw):
    return sseq.EncoderConfig(**kw), tseq.EncoderConfig(**kw)


@pytest.mark.parametrize("case", ["ippp", "ai_52x100"])
def test_bytes_equal_and_cross_decode(case):
    if case == "ippp":
        frames = motion_frames()
        jcfg, tcfg = _cfg(qp=32, intra_period=0)
    else:
        frames = [synth_frame(52, 100, seed=4)]
        jcfg, tcfg = _cfg(qp=32)
    jdata, jrec, jbits = jenc.encode_sequence(frames, jcfg)
    data, rec, bits = tenc.encode_sequence(frames, tcfg, device="cpu")
    assert data == jdata
    assert bits == jbits
    assert _same(rec, jrec)
    # port decodes the reference's stream, the reference the port's
    out, sps = tenc.decode_sequence(jdata, check_hash=True, device="cpu")
    assert _same(out, jrec)
    jout, _ = jenc.decode_sequence(data, check_hash=True)
    assert _same(jout, rec)


def test_wpp_stream_decodes_and_matches_spec():
    frames = motion_frames(n=2)
    cfg = tseq.EncoderConfig(qp=37, intra_period=0, wpp=True)
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu")
    sdata, _, _ = tseq.encode_sequence(frames, cfg)
    assert data == sdata
    out, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(out, rec)


def test_corrupt_stream_fails_hash():
    frames = motion_frames(n=1)
    data, _, _ = tenc.encode_sequence(frames, tseq.EncoderConfig(qp=32),
                                      device="cpu")
    bad = bytearray(data)
    bad[len(bad) // 2] ^= 0x10
    with pytest.raises(Exception):
        tenc.decode_sequence(bytes(bad), check_hash=True, device="cpu")


@pytest.mark.parametrize("kw", [dict(jccr=True), dict(tile_cols=2),
                                dict(subpic_cols=2), dict(lmcs=True),
                                dict(tskip=True), dict(mctf=True),
                                dict(rc_bits_per_frame=1000),
                                dict(ibc=True, intra_period=0),
                                dict(ctu=128)])
def test_config_outside_slice_raises(kw):
    frames = motion_frames(n=1)
    with pytest.raises(ValueError, match="outside"):
        tenc.encode_sequence(frames, tseq.EncoderConfig(**kw), device="cpu")


def test_default_device_is_cuda():
    frames = motion_frames(n=1)
    if torch.cuda.is_available():
        pytest.skip("this box has a card; the CPU-only behaviour is moot")
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.encode_sequence(frames, tseq.EncoderConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tenc.decode_sequence(b"")
