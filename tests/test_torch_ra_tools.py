"""Random access with VVC's inter toolset (BCW, CIIP, GPM, affine with PROF,
DMVR, BDOF, MMVD, AMVR, SMVD) and the intra toolset in P and B frames:
the port's encoder against the reference engine (bytes and decisions) and
the spec model (bytes), cross-decoded with hashes verified; tools outside
the slice still raise."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.pipeline import plan as tplan  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_affine import synth_zoom  # noqa: E402
from test_amvr import moving_planes as amvr_planes  # noqa: E402
from test_gpm import synth_motion  # noqa: E402
from test_inter_parity import motion_frames  # noqa: E402
from test_isp import synth  # noqa: E402
from test_mip import smooth_planes  # noqa: E402
from test_mmvd import moving_planes as mmvd_planes  # noqa: E402
from test_smvd import sym_planes  # noqa: E402

torch.set_num_threads(1)

_RA = dict(intra_period=0, gop=4, deblock=False, sao=False)


def _same(a, b):
    return all(np.array_equal(x[c], y[c]) for x, y in zip(a, b)
               for c in range(3))


# test_gpm.py:86's refined-toolset config, whose programs that test
# compiles for the reference engine too (shared through the suite's
# compile cache)
_REFINED = dict(qp=30, gpm=True, ciip=True, sbt=True, dmvr=True, bdof=True,
                bcw=True, mmvd=True, **_RA)


# tool indices that the reference engine writes at a leaf's top-left 8x8
# granule only (the one the entropy coder reads); the port fills the
# leaf, as the spec model does
_AT_ORIGIN = ("mts8", "lfnst8", "cmode8", "sbt8", "jccr8")


def _assert_equal_to_reference(g, w, h: int, wd: int):
    """The port's FrameDecisions ``g`` equal the reference engine's ``w``:
    every field on whole planes, the _AT_ORIGIN fields on each leaf's
    top-left granule (and zero elsewhere in the reference's)."""
    w = state.decisions_from_numpy(w)
    for f in dataclasses.fields(w):
        if isinstance(getattr(w, f.name), np.ndarray) \
                and f.name not in _AT_ORIGIN:
            np.testing.assert_array_equal(getattr(g, f.name),
                                          getattr(w, f.name), f.name)
    op, xs, ys = tplan.leaf_plan(g, h, wd)[:3]
    origin = np.zeros_like(w.sbt8, bool)
    origin[ys[op > 0] // 8, xs[op > 0] // 8] = True
    for name in _AT_ORIGIN:
        a, b = getattr(g, name), getattr(w, name)
        np.testing.assert_array_equal(a[origin], b[origin], name)
        assert not b[~origin].any(), name


@functools.lru_cache(maxsize=None)
def _refined_port():
    """The port's encode of test_gpm.py's refined-toolset config (frames,
    bytes, recon, bits, decisions)."""
    frames = synth_motion(5, 64, 64, seed=4)
    decs = []
    data, rec, bits = tenc.encode_sequence(
        frames, tseq.EncoderConfig(**_REFINED), device="cpu",
        decisions_out=decs)
    return frames, data, rec, bits, decs


def test_refined_toolset_equals_reference_engine():
    """The port's bytes and FrameDecisions equal the reference engine's on
    the refined-toolset config, and the port decodes the reference's
    stream with the hashes verified.  The SBT, MTS, LFNST and CCLM
    indices are compared on each leaf's top-left granule, the only one
    the reference engine writes (the port writes every granule of the
    leaf, as the spec model does)."""
    frames, data, rec, bits, got_dec = _refined_port()
    want_dec = []
    jdata, jrec, jbits = jenc.encode_sequence(
        frames, sseq.EncoderConfig(**_REFINED), decisions_out=want_dec)
    assert data == jdata and bits == jbits and _same(rec, jrec)
    assert len(got_dec) == len(want_dec) == 5
    for g, w in zip(got_dec, want_dec):
        _assert_equal_to_reference(g, w, 64, 64)
    # BI with DMVR/BDOF, BCW weights and GPM are all on the path
    assert any((d.gpm8 > 0).any() for d in got_dec)
    assert any(((d.dir8 == 2) & (d.inter8 > 0)).any() for d in got_dec)
    assert any((d.bcw8 != 1).any() for d in got_dec)
    out, _ = tenc.decode_sequence(jdata, check_hash=True, device="cpu")
    assert _same(out, jrec)


def test_refined_toolset_reference_decodes_port_stream():
    """The reference engine's decoder reads the port's stream of the
    refined-toolset config with the hashes verified and gives the port's
    recon."""
    _, data, rec, _, _ = _refined_port()
    jout, _ = jenc.decode_sequence(data, check_hash=True)
    assert _same(jout, rec)


_SPEC_CASES = {
    # test_isp.py:54 and :91, the P- and B-frame ISP configs
    "isp_p": (lambda: synth(3, 64, 64, seed=5),
              dict(qp=30, isp=True, intra_period=0, gop=1, deblock=False,
                   sao=False)),
    "isp_b": (lambda: synth(5, 64, 64, seed=11),
              dict(qp=30, isp=True, **_RA)),
    # test_mip.py:99 and test_mrl.py:94 in random access, with CCLM
    "mip_mrl": (lambda: [smooth_planes(64, 64, seed=11 + t)
                         for t in range(5)],
                dict(qp=32, mip=True, mrl=True, mts=True, lfnst=True,
                     cclm=True, **_RA)),
    # test_affine.py:87
    "affine_b": (lambda: synth_zoom(5, 64, 64, seed=5),
                 dict(qp=30, affine=True, mmvd=True, sbt=True, dmvr=True,
                      bdof=True, **_RA)),
    # test_mmvd.py:113
    "mmvd": (lambda: mmvd_planes(3, 64, 128, seed=17, step=2),
             dict(qp=34, mmvd=True, intra_period=0, gop=2, deblock=False,
                  sao=False)),
    # test_amvr.py:130
    "amvr": (lambda: amvr_planes(5, 64, 128, seed=11, step=4),
             dict(qp=34, amvr=True, mmvd=True, bcw=True, **_RA)),
    # test_smvd.py:76
    "smvd": (lambda: sym_planes(5, 64, 128, seed=17, step=2),
             dict(qp=34, smvd=True, amvr=True, bcw=True, mmvd=True, **_RA)),
}


@pytest.mark.parametrize("case", list(_SPEC_CASES))
def test_tool_config_equals_spec_model(case):
    mk, kw = _SPEC_CASES[case]
    frames = mk()
    cfg = tseq.EncoderConfig(**kw)
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu")
    sdata, srec, _ = tseq.encode_sequence(frames, cfg)
    assert data == sdata
    assert _same(rec, srec)
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert _same(out, rec)


@pytest.mark.parametrize("kw", [dict(ibc=True, ctu=128),
                                dict(plt=True, ctu=128), dict(ctu=32),
                                dict(bit_depth=12)])
def test_tools_outside_slice_still_raise(kw):
    with pytest.raises(ValueError, match="outside"):
        tenc.check_config(tseq.EncoderConfig(intra_period=0, gop=4, **kw))


@pytest.mark.parametrize("kw", [dict(subpic_rows=2), dict(tile_rows=2),
                                dict(tile_cols=2), dict(bit_depth=10),
                                dict(mctf=True), dict(tskip=True),
                                dict(jccr=True)])
def test_tools_of_this_slice_accepted(kw):
    """Subpictures, tiles, 10-bit input, MCTF, transform skip and JCCR pass
    the config check, and a 2-frame IPPP encode with them (128x128 for
    the grids and 10 bits, 64x64 for the three tools ported after this
    test was written) decodes with the hashes verified; with MCTF, TS or
    JCCR its bytes and recon equal the spec model's (tolerance 0)."""
    cfg = tseq.EncoderConfig(intra_period=0, gop=1, **kw)
    tenc.check_config(cfg)
    tools = {"mctf", "tskip", "jccr"} & set(kw)
    frames = motion_frames(2, *((64, 64) if tools else (128, 128)),
                           seed=27)
    if cfg.bit_depth == 10:
        frames = [[p << 2 for p in f] for f in frames]
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu")
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert _same(out, rec)
    if tools:
        sdata, srec, _ = tseq.encode_sequence(frames, cfg)
        assert data == sdata and _same(rec, srec)


@pytest.mark.parametrize("field,value", [
    ("log2_ctu", 5), ("bit_depth", 12),
    ("ibc_enabled", True), ("plt_enabled", True), ("log2_ctu", 7)])
def test_stream_outside_slice_still_raises(field, value):
    """The decoder's SPS/PPS check refuses what the slice leaves out (CTU
    sizes other than 64 and 128, 12 bits, and as the spec model IBC or
    palette at CTU 128: a field of IBC or palette is set at CTU 128, CTU
    128 with IBC) and accepts the inter and intra toolsets, SBT, DQ, ALF,
    the multi-type tree, LMCS, transform skip, JCCR, IBC and palette at
    CTU 64, and CTU 128."""
    from vvctpu_torch.spec import hls
    tools = dict(mts=True, lfnst=True, isp=True, mip=True, mrl=True,
                 cclm=True, mmvd=True, dmvr=True, bdof=True, bcw=True,
                 gpm=True, affine=True, amvr=True, smvd=True, ciip=True,
                 sbt=True, dq=True, alf=True, mtt=True, tt=True, lmcs=True,
                 tskip=True, jccr=True)
    sps = tseq.EncoderConfig(intra_period=0, gop=4, **tools).make_sps(64, 64)
    tenc._check_sps(sps, hls.PPS())
    tenc._check_sps(dataclasses.replace(sps, ibc_enabled=True,
                                        plt_enabled=True), hls.PPS())
    tenc._check_sps(dataclasses.replace(sps, log2_ctu=7), hls.PPS())
    pps = hls.PPS()
    if field == "tiles":
        pps = dataclasses.replace(pps, num_tile_cols=2)
    elif field == "tile_rows":
        pps = dataclasses.replace(pps, num_tile_rows=2)
    else:
        sps = dataclasses.replace(sps, **{field: value})
    if field in ("ibc_enabled", "plt_enabled"):
        sps = dataclasses.replace(sps, log2_ctu=7)
    elif (field, value) == ("log2_ctu", 7):
        sps = dataclasses.replace(sps, ibc_enabled=True)
    with pytest.raises(ValueError, match="outside"):
        tenc._check_sps(sps, pps)


@pytest.mark.parametrize("field,value", [("tile_rows", None),
                                         ("bit_depth", 10), ("tiles", None),
                                         ("ts_enabled", True),
                                         ("jccr_enabled", True)])
def test_stream_of_this_slice_accepted(field, value):
    """The decoder's SPS/PPS check accepts 10-bit streams, tile grids,
    transform skip and JCCR, and refuses tiles with WPP where the picture
    has more than one CTU row, as the spec model does."""
    from vvctpu_torch.spec import hls
    sps = tseq.EncoderConfig(intra_period=0, gop=4).make_sps(128, 128)
    pps = hls.PPS()
    if field == "tiles":
        pps = dataclasses.replace(pps, num_tile_cols=2)
    elif field == "tile_rows":
        pps = dataclasses.replace(pps, num_tile_rows=2)
    else:
        sps = dataclasses.replace(sps, **{field: value})
    tenc._check_sps(sps, pps)
    if pps.num_tile_cols * pps.num_tile_rows > 1:
        with pytest.raises(ValueError, match="WPP"):
            tenc._check_sps(sps, dataclasses.replace(pps, entropy_sync=True))


@pytest.mark.parametrize("tools", [
    dict(mts=True, lfnst=True, isp=True, mip=True, mrl=True, cclm=True),
    dict(intra_period=0, gop=4, mmvd=True, dmvr=True, bdof=True, bcw=True,
         gpm=True, affine=True, amvr=True, smvd=True, ciip=True, sbt=True,
         dq=True)], ids=["intra", "inter"])
def test_stream_with_mtt_tt_accepted(tools):
    """The decoder's SPS check accepts the multi-type tree with BT and TT
    splits beside the intra toolset and beside the inter toolset."""
    from vvctpu_torch.spec import hls
    sps = tseq.EncoderConfig(mtt=True, tt=True, **tools).make_sps(64, 64)
    assert sps.mtt_enabled and sps.tt_enabled
    tenc._check_sps(sps, hls.PPS())
