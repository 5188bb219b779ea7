"""The multi-type tree (BT and TT splits) in the port against its JAX twins
in vvctpu at tolerance 0 on seeded inputs: the rect intra decision pass at
the 8 BT and TT geometries, the rect sub-pel refinement and BI cost, the
rect intra leaf class of the wave and phase A of rect inter leaves (with
and without dependent quantization); end to end against the spec model
on test_mtt.py's and test_tt.py's configs without LMCS and on a clip whose
inter frames choose every rect shape, cross-decoded with hashes
verified."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.cabac import estimate as jest  # noqa: E402
from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.coding import me as jme  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu.spec.decide import lambda_satd_fp  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402
from vvctpu_torch.coding import me as tme  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import plan as tplan  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_affine import synth_zoom  # noqa: E402
from test_gpm import synth_motion  # noqa: E402
from test_inter_parity import motion_frames  # noqa: E402
from test_torch_inter_tools import (H, LAM, QP, W, _LAM_RD,  # noqa: E402
                                    _carries, _check_carry, _clip, _eq,
                                    _mvs, _refs6)

torch.set_num_threads(1)
T = torch.as_tensor

# the 4 BT shapes and the 4 TT stripe geometries: name -> (bw, bh, sy, sx,
# oy, ox)
GEOMS = tdecide._rect_keys(True)


def _gid(name):
    return name if isinstance(name, str) else f"{name[0]}x{name[1]}"


# ---------------------------------------------------------------------------
# decisions: the rect intra pass, the rect refinement and BI cost
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(GEOMS), ids=_gid)
def test_rect_size_pass(name):
    """(cost, mode) per rect block at each BT and TT geometry on a 64x96
    plane, with an I frame's and a B frame's mode rates."""
    bw, bh, sy, sx, oy, ox = GEOMS[name]
    orig = motion_frames(1, 64, 96, seed=81)[0][0]
    buf = tdecide._pad_buf(orig, "cpu")
    for stype, qp in ((2, 32), (0, 27)):
        lam = lambda_satd_fp(qp)
        mfp = jest.decision_bits(stype, qp).mode_fp
        geo = dict(bw=bw, bh=bh, frame_w=96, frame_h=64, sy=sy, sx=sx,
                   oy=oy, ox=ox)
        wc, wm = jdecide.rect_size_pass(jnp.asarray(buf.numpy()),
                                        np.int32(lam), mfp=mfp, **geo)
        gc, gm = tdecide.rect_size_pass(buf, lam, mfp=mfp, **geo)
        _eq(gc, wc, f"cost qp {qp}")
        _eq(gm, wm, f"mode qp {qp}")
        assert len(np.unique(np.asarray(wm))) > 1


@functools.lru_cache(maxsize=None)
def _planes():
    """The quarter-phase planes of _clip's two references, JAX and port."""
    _, refs = _clip()
    return ([jme.quarter_phase_planes(jnp.asarray(r), 8) for r in refs],
            [tme.quarter_phase_planes(T(r)) for r in refs])


@pytest.mark.parametrize("name", list(GEOMS), ids=_gid)
def test_rect_refine_and_bi_cost(name):
    """Half/quarter-pel refinement of both lists' integer MVs and the
    equal-weight BI cost of the refined pair, at each BT and TT tiling:
    cost and MV equal."""
    bw, bh, sy, sx, oy, ox = GEOMS[name]
    padded, refs = _clip()
    jpl, tpl = _planes()
    nby, nbx, *_ = tme.tiling(W, H, bw, bh, sy, sx, oy, ox)
    rng = np.random.default_rng(bw * bh + oy + ox)
    orig = padded[2][0]
    geo = dict(s=bw, frame_w=W, frame_h=H, bh=bh, sy=sy, sx=sx, oy=oy,
               ox=ox)
    mvs = []
    for lst in (0, 1):
        imv = rng.integers(-16, 17, (nby, nbx, 2)).astype(np.int32)
        wc, wmv = jme.refine_pass(jnp.asarray(orig), jnp.asarray(refs[lst]),
                                  jnp.asarray(imv), np.int32(LAM),
                                  planes=jpl[lst], **geo)
        gc, gmv = tme.refine_pass(T(orig), T(refs[lst]), T(imv), LAM,
                                  planes=tpl[lst], **geo)
        _eq(gc, wc, f"refine cost L{lst}")
        _eq(gmv, wmv, f"refine mv L{lst}")
        mvs.append(np.array(wmv))
    wc, ww = jme.bi_cost_pass(jnp.asarray(orig), jnp.asarray(refs[0]),
                              jnp.asarray(refs[1]), jnp.asarray(mvs[0]),
                              jnp.asarray(mvs[1]), np.int32(LAM),
                              planes0=jpl[0], planes1=jpl[1], **geo)
    gc, gw = tme.bi_cost_pass(T(orig), T(mvs[0]), T(mvs[1]), LAM,
                              planes0=tpl[0], planes1=tpl[1], **geo)
    _eq(gc, wc, "bi cost")
    _eq(gw, ww, "bi weight index")


# ---------------------------------------------------------------------------
# reconstruction: the rect intra leaf class, phase A of rect inter leaves
# ---------------------------------------------------------------------------


def _positions(rng, name, k):
    """Up to k distinct corners of geometry ``name``'s tiling of the
    64x128 frame, in random order."""
    bw, bh, sy, sx, oy, ox = GEOMS[name]
    _, _, _, ys, xs = tme.tiling(W, H, bw, bh, sy, sx, oy, ox)
    pick = rng.permutation(ys.shape[0])[:k]
    return xs.numpy()[pick], ys.numpy()[pick]


# half of the geometries quantize with the trellis, the others with RDOQ,
# each half with horizontal and vertical shapes (all of them, with DQ,
# in test_mtt_equals_spec_model[rect_inter])
_DQ = {name: name in ((8, 16), (32, 16), (8, 32), "tth_mid")
       for name in GEOMS}
_JW: dict = {}


def _jitted(key, fn):
    if key not in _JW:
        _JW[key] = jax.jit(fn)
    return _JW[key]


@pytest.mark.parametrize("name", list(GEOMS), ids=_gid)
def test_rect_batch(name):
    """One level of rect intra leaves of a BT or TT geometry (the TT mid
    stripes at their offset positions), on recon buffers that hold random
    already reconstructed samples, against the reference's _rect_batch:
    recon and levels equal."""
    bw, bh = GEOMS[name][:2]
    dq = _DQ[name]
    rng = np.random.default_rng(bw + 3 * bh)
    xs, ys = _positions(rng, name, 10)
    rows = np.zeros((xs.size, 17), np.int32)
    rows[:, 0] = tplan.OP_RECT_INTRA0 + tplan.RECT_SHAPES.index((bw, bh))
    rows[:, 1], rows[:, 2] = xs, ys
    rows[:, 3] = rng.integers(0, 67, xs.size)
    tc, jc = _carries(bw + bh)
    want = _jitted(("rect", bw, bh, dq), functools.partial(
        jwave._rect_batch.__wrapped__, qp=QP, lam_rd=_LAM_RD, crs_lut=None,
        w=bw, h=bh, frame_w=W, frame_h=H, bd=8, encode=True, rdoq=True,
        dq=dq))(jc, jnp.asarray(rows))
    twave._rect_batch(tc, T(rows), QP, _LAM_RD, w=bw, h=bh, frame_w=W,
                      frame_h=H, log2_ctu=6, bd=8, encode=True, rdoq=True,
                      dq=dq)
    _check_carry(tc, want, f"rect {_gid(name)} dq={dq}")


@pytest.mark.parametrize("shape", tplan.RECT_SHAPES, ids=_gid)
def test_inter_batch_pass_rect(shape):
    """Phase A of a rect shape (L0, L1 and BI rows at quarter-pel MVs,
    padded rows at the end), encoding then decoding the port's levels,
    against the reference's _inter_batch_pass_rect: recon and levels
    equal."""
    bw, bh = shape
    dq = _DQ[shape]
    refs = _refs6()
    jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)
    trefs = [r[None] for r in refs]
    rng = np.random.default_rng(bw + 5 * bh)
    xs, ys = _positions(rng, shape, 12)
    k = xs.size
    rows = np.zeros((k + 2, 7), np.int32)
    rows[:k, 0], rows[:k, 1] = xs, ys
    rows[:k, 2:6] = _mvs(rng, 2 * k, 60).reshape(k, 4)
    rows[:k, 6] = rng.choice([0, 1, 2, 2], k)
    rows[k:, :2] = 1 << 20
    lev = None
    for encode in (True, False):
        tc, jc = _carries(bw * bh)
        if not encode:
            for c in ("ly", "lcb", "lcr"):
                tc["s" + c[1:]][:] = lev[c]
            jc = jc[:6] + tuple(jnp.asarray(lev[c][0].numpy())
                                for c in ("ly", "lcb", "lcr")) + jc[9:]
        want = _jitted(("inter", bw, bh, dq, encode), functools.partial(
            jrecon._inter_batch_pass_rect, w=bw, h=bh, qp=QP, bd=8,
            encode=encode, rdoq=True, lam_rd=_LAM_RD, dq=dq))(
                jc, jnp.asarray(rows), jrefs)
        trecon._inter_batch_pass_rect(
            tc, np.concatenate([rows, np.zeros((k + 2, 1), np.int32)], 1),
            trefs, bw, bh, QP, 8, encode, rdoq=True, lam_rd=_LAM_RD, dq=dq)
        _check_carry(tc, want, f"{bw}x{bh} dq={dq} encode={encode}")
        if encode:
            lev = {c: tc[c].clone() for c in ("ly", "lcb", "lcr")}
            assert lev["ly"].any()


# ---------------------------------------------------------------------------
# end to end against the spec model
# ---------------------------------------------------------------------------


def _gpm_zoom_frames(n):
    """test_torch_inter_tools.py's 64x128 clip (GPM-style occlusion beside
    a zooming pattern): its inter frames choose every rect shape."""
    a = synth_motion(5, H, 64, seed=4)
    b = synth_zoom(5, H, 64, seed=5)
    return [[np.concatenate([a[t][c], b[t][c]], 1) for c in range(3)]
            for t in range(n)]


_INTER = dict(intra_period=0, gop=4, mmvd=True, sbt=True, ciip=True,
              bcw=True, gpm=True, affine=True, dq=True)
# test_mtt.py's and test_tt.py's engine configs without LMCS (the spec
# model and the reference engine agree on them), and a clip whose inter
# frames reach phase A with all six rect shapes and TT-H and TT-V nodes
_CASES = {
    "bt_intra": (lambda: motion_frames(4, 64, 96, seed=72),
                 dict(qp=32, mtt=True, mip=True, mrl=True, isp=True)),
    "bt_inter": (lambda: motion_frames(4, 64, 96, seed=72),
                 dict(qp=32, mtt=True, **_INTER)),
    "tt_intra": (lambda: motion_frames(4, 64, 96, seed=81),
                 dict(qp=32, mtt=True, tt=True, mip=True, mrl=True,
                      isp=True)),
    "tt_inter": (lambda: motion_frames(4, 64, 96, seed=81),
                 dict(qp=32, mtt=True, tt=True, **_INTER)),
    "rect_inter": (lambda: _gpm_zoom_frames(3),
                   dict(qp=30, mtt=True, tt=True, intra_period=0, gop=2,
                        dq=True)),
}


@functools.lru_cache(maxsize=None)
def _spec(case):
    """The spec model's encode of a case: (frames, bytes, recon,
    decisions), shared by the tests that need it."""
    mk, kw = _CASES[case]
    frames = mk()
    decs = []
    data, rec, _ = tseq.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                        decisions_out=decs)
    return frames, data, rec, decs


def _same(a, b):
    return all(np.array_equal(x[c], y[c]) for x, y in zip(a, b)
               for c in range(3))


@pytest.mark.parametrize("case", list(_CASES))
def test_mtt_equals_spec_model(case):
    """The port's bytes, recon and decisions equal the spec model's; the
    port decodes its stream and the spec model decodes it, hashes
    verified."""
    frames, sdata, srec, sdecs = _spec(case)
    decs = []
    data, rec, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(**_CASES[case][1]), device="cpu",
        decisions_out=decs)
    assert data == sdata
    assert _same(rec, srec)
    assert len(decs) == len(sdecs)
    assert all(a.equal(b) for a, b in zip(decs, sdecs))
    assert any((d.bt16 > 0).any() for d in decs)
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert _same(out, rec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)
    if case == "rect_inter":
        inter_ops = {int(o) for d in decs
                     for o in tplan.leaf_plan(d, H, W)[0]}
        assert all(tplan.OP_RECT_INTER0 + i in inter_ops
                   for i in range(len(tplan.RECT_SHAPES)))
        assert any((d.bt32 == 3).any() for d in decs)
        assert any((d.bt32 == 4).any() for d in decs)


def test_cli_mtt_tt(tmp_path):
    """The CLI's --mtt --tt encode a clip that the port decodes with the
    hashes verified; --tt alone is refused."""
    from vvctpu_torch import __main__ as tcli
    from vvctpu_torch.io import yuv
    frames = motion_frames(2, 64, 64, seed=71)
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), frames)
    args = ["encode", "-i", str(src), "--wdt", "64", "--hgt", "64", "-q",
            "30", "--ip", "0", "-b", str(tmp_path / "o.bin"), "--device",
            "cpu"]
    assert tcli.main(args + ["--mtt", "--tt"]) == 0
    assert tcli.main(["decode", "-b", str(tmp_path / "o.bin"), "-o",
                      str(tmp_path / "d.yuv"), "--device", "cpu"]) == 0
    data, _, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(qp=30, intra_period=0, mtt=True, tt=True),
        device="cpu")
    assert (tmp_path / "o.bin").read_bytes() == data
    with pytest.raises(SystemExit):
        tcli.main(args + ["--tt"])
