"""Tiles and subpictures in the port: test_tiles.py's two configs and a
grid of unequal tiles (3 CTU columns in 2 tiles, with BCW, CIIP, DMVR,
BDOF, SBT and DQ) against the spec model, bytes, recon and whole-plane
decisions, cross-decoded with the hashes verified; the tile-batched
wave (every tile of every frame of a group one member of
frame_wave_batch, one call per tile size) equal to each tile run
alone; tiles with WPP refused; test_subpic.py's 2x1 and 2x2
non-multiple configs against the spec model (each subpicture's
decisions too); and config #5's shape in small, a 128x128 10-bit GOP2
clip with a 2x2 grid, against the reference engine (bytes, recon and
decisions)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu_torch.io import streamtools  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402
from vvctpu_torch.spec import hls  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

import chip_smoke  # noqa: E402
from test_inter_parity import motion_frames  # noqa: E402

torch.set_num_threads(1)

_CASES = {
    # test_tiles.py:55's two configs
    "tiles2x1": (lambda: motion_frames(3, 64, 128, seed=83),
                 dict(qp=32, tile_cols=2, tile_rows=1)),
    "tiles2x2_inter": (lambda: motion_frames(3, 64, 128, seed=83),
                       dict(qp=32, tile_cols=2, tile_rows=2, intra_period=0,
                            gop=2, mmvd=True, ciip=True, sbt=True,
                            lmcs=True)),
    # 3 CTU columns in 2 tiles of 64 and 128 px, each size a wave of its
    # own, with inter tools whose MC reads the reference at the tile's
    # offset
    "unequal": (lambda: motion_frames(3, 64, 192, seed=84),
                dict(qp=32, tile_cols=2, intra_period=0, gop=2, bcw=True,
                     ciip=True, dmvr=True, bdof=True, sbt=True, dq=True)),
    # test_subpic.py:12 and :49
    "subpic2x1": (lambda: motion_frames(3, 64, 128, seed=21),
                  dict(qp=32, subpic_cols=2, subpic_rows=1, intra_period=0)),
    "subpic2x2": (lambda: motion_frames(2, 100, 150, seed=24),
                  dict(qp=34, subpic_cols=2, subpic_rows=2)),
}


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


_WAVES: dict = {}


@functools.lru_cache(maxsize=None)
def _port(case):
    """The port's (frames, bytes, recon, decisions) of a case, and each
    frame_wave_batch call of its encode as (members, keywords, outputs)
    in _WAVES[case]."""
    mk, kw = _CASES[case]
    frames = mk()
    calls = _WAVES.setdefault(case, [])
    orig = twave.frame_wave_batch

    def spy(frames_in, **k):
        outs = orig(frames_in, **k)
        calls.append((frames_in, k, outs))
        return outs

    twave.frame_wave_batch = spy
    try:
        decs = []
        data, rec, _ = tenc.encode_sequence(
            frames, tseq.EncoderConfig(**kw), device="cpu",
            decisions_out=decs)
    finally:
        twave.frame_wave_batch = orig
    return frames, data, rec, decs


@pytest.mark.parametrize("case", list(_CASES))
def test_equals_spec_model(case):
    """Bytes, recon and whole-plane decisions (each subpicture's, one
    after the other, for a subpicture grid) equal the spec model's; each
    decoder decodes the other's stream with the hashes verified."""
    frames, data, rec, decs = _port(case)
    kw = _CASES[case][1]
    sdecs = []
    if "subpic_cols" in kw:
        sdata, srec, _ = chip_smoke._subpic_spec(frames, kw, sdecs)
        assert streamtools.subpic_layout(data) == (kw["subpic_cols"],
                                                   kw["subpic_rows"])
    else:
        sdata, srec, _ = tseq.encode_sequence(
            frames, tseq.EncoderConfig(**kw), decisions_out=sdecs)
    assert data == sdata and _same(rec, srec)
    assert len(decs) == len(sdecs) > 0
    assert all(a.equal(b) for a, b in zip(decs, sdecs))
    out, _ = tenc.decode_sequence(sdata, check_hash=True, device="cpu")
    assert _same(out, srec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)


@pytest.mark.parametrize("case,sizes", [
    ("tiles2x2_inter", {(64, 64)}), ("unequal", {(64, 64), (128, 64)})])
def test_tile_batched_wave_equals_tiles_alone(case, sizes):
    """Every wave of a tiled encode holds one tile size, every tile of
    every frame of its group (test_tiles.py's 2x2 grid on a 64x128
    picture is two tiles: hls.tile_grid clamps the rows to the one CTU
    row); each member's outputs equal that tile run alone."""
    frames, *_ = _port(case)
    kw = _CASES[case][1]
    h, w = frames[0][0].shape
    rects = hls.tile_grid(w // 64, h // 64, kw["tile_cols"],
                          kw.get("tile_rows", 1))
    calls = _WAVES[case]
    assert {64 * (x1 - x0) for x0, _, x1, _ in rects} == {
        s[0] for s in sizes}
    assert {(k["frame_w"], k["frame_h"]) for _, k, _ in calls} == sizes
    assert sum(len(m) for m, _, _ in calls) == len(frames) * len(rects)
    assert max(len(m) for m, _, _ in calls) == len(rects) // len(sizes)
    for members, kw, outs in calls:
        for fr, out in zip(members, outs):
            for a, b in zip(twave.frame_wave_batch([fr], **kw)[0], out):
                assert torch.equal(a, b)


def test_tiles_with_wpp_refused():
    """Tiles and WPP are exclusive where a picture has more than one CTU
    row, in the encoder and in the decoder's PPS check, as in the spec
    model."""
    frames = motion_frames(1, 128, 128, seed=82)
    cfg = tseq.EncoderConfig(qp=32, tile_cols=2, tile_rows=1, wpp=True)
    with pytest.raises(ValueError, match="WPP"):
        tenc.encode_sequence(frames, cfg, device="cpu")
    with pytest.raises(ValueError, match="WPP"):
        tseq.encode_sequence(frames, cfg)
    sps = cfg.make_sps(128, 128)
    with pytest.raises(ValueError, match="WPP"):
        tenc._check_sps(sps, hls.PPS(entropy_sync=True, num_tile_cols=2))
    tenc._check_sps(sps, hls.PPS(num_tile_cols=2, num_tile_rows=2))
    tenc._check_sps(cfg.make_sps(128, 64),
                    hls.PPS(entropy_sync=True, num_tile_cols=2))


def test_config5_shape_equals_reference_engine():
    """Config #5 in small: 3 frames of 128x128 10-bit samples (0..1023,
    the two low bits used), RA GOP2 (I0 P2 B1) with a 2x2 tile grid, on
    which the engines part from the spec model at 10 bits (its sub-pel
    refinement clamps at 8 bits): the port's bytes, recon and whole-plane
    decisions equal the reference engine's, and the port's and the spec
    model's decoders decode its stream to the port's recon, hashes
    verified."""
    frames = chip_smoke.synth_frames10(3, 128, 128, seed=5)
    assert min(f[0].min() for f in frames) == 0
    assert max(f[0].max() for f in frames) == 1023
    cfg = tseq.EncoderConfig(qp=32, bit_depth=10, intra_period=32, gop=2,
                             tile_cols=2, tile_rows=2)
    decs, jdecs = [], []
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu",
                                        decisions_out=decs)
    jdata, jrec, _ = jenc.encode_sequence(frames, cfg, decisions_out=jdecs)
    assert data == jdata and _same(rec, jrec)
    assert len(decs) == len(jdecs) == 3
    assert all(a.equal(b) for a, b in zip(decs, jdecs))
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(out, rec) and _same(sout, rec)
