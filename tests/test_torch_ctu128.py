"""CTU 128 in the port at tolerance 0: test_ctu128.py's configs (all-intra
with MTS on a frame that pads to 256x256, the same frame at CTU 64 and at
128, GOP2, WPP, MTT with TT and ISP) against the spec model (bytes and
whole-plane decisions, each stream decoded by the other side with the
hashes verified), and the port refusing what the spec model refuses at
CTU 128 (IBC, palette) in the encoder's and the decoder's checks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import hls  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_ctu128 import _frames  # noqa: E402

torch.set_num_threads(1)

# test_ctu128.py's configs: (frames, EncoderConfig keywords)
_CASES = {
    "ai_mts": ((1, 140, 190, 9), dict(qp=32, ctu=128, mts=True)),
    "ai_64": ((1, 128, 192, 9), dict(qp=30, ctu=64)),
    "ai_128": ((1, 128, 192, 9), dict(qp=30, ctu=128)),
    "gop2": ((3, 128, 192, 11), dict(qp=32, ctu=128, intra_period=0,
                                     gop=2)),
    "wpp": ((1, 256, 192, 12), dict(qp=32, ctu=128, wpp=True)),
    "mtt_tt_isp": ((1, 128, 192, 13), dict(qp=32, ctu=128, mtt=True,
                                           tt=True, isp=True)),
}


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


def _run(case):
    """The port's and the spec model's encodes of ``case``, each stream
    decoded by the other side with the hashes verified; returns the
    port's bytes."""
    n, h, w, seed = _CASES[case][0]
    frames = _frames(n, h, w, seed=seed)
    cfg = tseq.EncoderConfig(**_CASES[case][1])
    sdecs, tdecs = [], []
    sdata, srec, _ = tseq.encode_sequence(frames, cfg, decisions_out=sdecs)
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu",
                                        decisions_out=tdecs)
    assert data == sdata
    assert len(tdecs) == len(sdecs) == n
    for a, b in zip(tdecs, sdecs):
        assert a.equal(b)
    assert _same(rec, srec)
    out, sps = tenc.decode_sequence(sdata, check_hash=True, device="cpu")
    assert sps.log2_ctu == cfg.ctu.bit_length() - 1
    assert _same(out, rec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)
    return data


@pytest.mark.parametrize("case", [c for c in _CASES
                                  if c not in ("ai_64", "ai_128")])
def test_ctu128_equals_spec_model(case):
    """Each CTU-128 config's stream and decisions equal the spec model's;
    both decoders verify the other's hashes."""
    _run(case)


def test_ctu_sizes_differ():
    """The same frame at CTU 64 and at CTU 128 gives two streams, each
    equal to the spec model's: the coding walk, WPP and SAO granularity
    follow the CTU size."""
    assert _run("ai_64") != _run("ai_128")


@pytest.mark.parametrize("kw", [dict(ibc=True), dict(plt=True),
                                dict(ibc=True, plt=True)],
                         ids=["ibc", "plt", "ibc_plt"])
def test_ctu128_screen_tools_refused(kw):
    """IBC or palette at CTU 128 raises in the encoder's config check, as
    in the spec model's make_sps, and a stream's SPS with either at
    log2_ctu 7 raises in the decoder's check."""
    cfg = tseq.EncoderConfig(qp=32, ctu=128, **kw)
    with pytest.raises(ValueError):
        cfg.make_sps(128, 128)
    with pytest.raises(ValueError, match="CTU 128|ctu 128"):
        tenc.check_config(cfg)
    sps = tseq.EncoderConfig(qp=32, ctu=64, **kw).make_sps(128, 128)
    sps.log2_ctu = 7
    with pytest.raises(ValueError, match="CTU 128"):
        tenc._check_sps(sps, hls.PPS(init_qp=32))
