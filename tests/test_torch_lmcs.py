"""LMCS (luma mapping with chroma residual scaling) in the port against its
JAX twins in vvctpu at tolerance 0 on seeded inputs: the scaled component
chain and chroma choice, the intra, ISP, rect and CIIP leaf classes of
the wave, phase A of square and rect inter leaves and the inverse
mapping before the loop filters, each with a CRS LUT whose scales reach
both clamps (512 and 8192) on residuals of both signs; a frame-batched
wave of frames with different models against the frames run alone; end
to end, test_lmcs.py's four configs against the spec model and the
reference engine, and test_mtt.py's and test_tt.py's LMCS configs
against the spec model (bytes and whole-plane decisions), each stream
cross-decoded with the hashes verified; the CLI's --lmcs."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.kernels import loopfilter as jlf  # noqa: E402
from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu.spec import lmcs as jlmcs  # noqa: E402
from vvctpu.spec import sequence as jseq  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.kernels import loopfilter as tlf  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import plan as tplan  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402
from vvctpu_torch.spec import lmcs as tlmcs  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_inter_parity import motion_frames  # noqa: E402
from test_torch_inter_tools import (H, QP, W, _LAM_RD, _carries,  # noqa: E402
                                    _check_carry, _mvs, _phase_a_rows,
                                    _refs6)

torch.set_num_threads(1)
T = torch.as_tensor

# a codeword model whose CRS LUT takes both clamps: mapped luma below 128
# scales by 4x (8192), 128-175 by 1/4x (512), the rest by 2.5x
CW = (64, 64) + (4,) * 12 + (40, 40)
FWD, INV = tlmcs.build_luts(CW)
CRS = tlmcs.build_crs_lut(CW)


def _port_luts(tc):
    """Give a port carry of one frame the model's LUTs."""
    tc["fwd"], tc["crs"] = T(FWD[None]), T(CRS[None])
    return tc


def _scales(tc, xs, ys, w: int, h: int):
    """The CRS scales of the leaves at (xs, ys), from the port's luma
    recon in the carry."""
    by = tc["by"][0].numpy()
    shift = (w.bit_length() - 1) + (h.bit_length() - 1)
    return {int(CRS[by[y + 1:y + 1 + h, x + 1:x + 1 + w].sum() >> shift])
            for x, y in zip(xs, ys)}


def test_model_luts_reach_both_clamps():
    assert sum(CW) == 256 and set(CRS) == {512, 8192, 5120}
    np.testing.assert_array_equal(FWD, jlmcs.build_luts(CW)[0])
    np.testing.assert_array_equal(CRS, jlmcs.build_crs_lut(CW))


@pytest.mark.parametrize("sc", [512, 777, 2048, 8192])
def test_crs_scaling_floors(sc):
    """Forward scaling floors negative residuals (as the spec model's
    int64 crs_fwd does) and the inverse is the spec model's crs_inv."""
    r = np.arange(-255, 256, dtype=np.int32).reshape(1, 1, -1)
    s = T(np.array([sc], np.int32))
    np.testing.assert_array_equal(trecon.crs_fwd(T(r), s).numpy(),
                                  tlmcs.crs_fwd(r, sc))
    if 2048 % sc:       # a truncating division would differ here
        assert (tlmcs.crs_fwd(r, sc) != np.trunc(r * 2048 / sc)).any()
    big = np.arange(-4096, 4096, 3, dtype=np.int32).reshape(1, 1, -1)
    np.testing.assert_array_equal(trecon.crs_inv(T(big), s).numpy(),
                                  tlmcs.crs_inv(big, sc))


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_component_and_chroma_rd_scaled(cs):
    """The scaled component chain (encode, then decode of its levels) and
    the DM/CCLM chroma choice with a scale per row, against the
    reference's _comp_local and chroma_rd_j under jax.vmap."""
    rng = np.random.default_rng(cs)
    n = 8
    sc = np.array([512, 8192] * (n // 2), np.int32)
    src = rng.integers(0, 256, (2, n, cs, cs)).astype(np.int32)
    pred = [rng.integers(0, 256, (n, cs, cs)).astype(np.int32)
            for _ in range(4)]
    zero = T(np.zeros(n, np.int32))
    rec, lev = trecon._component(T(src[0]), T(pred[0]),
                                 T(np.arange(n)), zero, zero, cs, cs, QP, 8,
                                 True, True, _LAM_RD, crs_sc=T(sc))
    jone = jax.jit(jax.vmap(lambda s_, p, c, e: jwave._comp_local(
        s_, p, 0, 0, cs, cs, QP, 8, e, True, jnp.int32(_LAM_RD), False,
        crs_sc=c), in_axes=(0, 0, 0, None)), static_argnums=3)
    want = jone(src[0], pred[0], sc, True)
    np.testing.assert_array_equal(rec.numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(lev.numpy(), np.asarray(want[1]))
    dec, _ = trecon._component(lev, T(pred[0]), T(np.arange(n)),
                               zero, zero, cs, cs, QP, 8, False, crs_sc=T(sc))
    np.testing.assert_array_equal(dec.numpy(), rec.numpy())
    got = trecon.chroma_rd(T(src[0]), T(src[1]), [(T(pred[0]), T(pred[1])),
                                                  (T(pred[2]), T(pred[3]))],
                           cs, QP, 8, True, _LAM_RD, crs_sc=T(sc))
    want = jax.jit(jax.vmap(lambda a, b, c, d, e, f, g: jrecon.chroma_rd_j(
        a, b, [(c, d), (e, f)], g, cs, QP, 8, True, jnp.int32(_LAM_RD),
        False, False)))(*(jnp.asarray(v) for v in (*src, *pred, sc)))
    for k in range(5):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


def _grid_rows(rng, s_w: int, s_h: int, k: int, op: int):
    """(k, 17) phase-B rows at distinct positions of the s_w x s_h grid."""
    nb = (H // s_h) * (W // s_w)
    pos = rng.permutation(nb)[:k]
    rows = np.zeros((k, 17), np.int32)
    rows[:, 0] = op
    rows[:, 1] = pos % (W // s_w) * s_w
    rows[:, 2] = pos // (W // s_w) * s_h
    return rows


_JB: dict = {}


def _jb(key, fn):
    if key not in _JB:
        _JB[key] = jax.jit(fn)
    return _JB[key]


@pytest.mark.parametrize("s,dq", [(8, False), (16, True)])
def test_intra_batch_lmcs(s, dq):
    """Square intra leaves with MTS, LFNST, MIP and CCLM (the chroma
    choice on scaled residuals), encoding then decoding the port's
    levels and tool indices, against the reference's _intra_batch."""
    rng = np.random.default_rng(s)
    rows = _grid_rows(rng, s, s, 8, s.bit_length() - 3)
    rows[:, 3] = rng.integers(0, 67 + 16, 8)         # MIP ids above 66
    tools = dict(mts=True, lfnst=True, cclm=True, mip=True)
    lev = None
    for encode in (True, False):
        tc, jc = _carries(70 + s)
        _port_luts(tc)
        if not encode:
            for c in ("ly", "lcb", "lcr"):
                tc["s" + c[1:]][:] = lev[c]
            jc = jc[:6] + tuple(jnp.asarray(lev[c][0].numpy())
                                for c in ("ly", "lcb", "lcr")) + jc[9:]
        want = _jb(("intra", s, dq, encode), functools.partial(
            jwave._intra_batch.__wrapped__, s=s, frame_w=W, frame_h=H,
            bd=8, encode=encode, rdoq=True, tskip=False, jccr=False, dq=dq,
            **tools))(jc, jnp.asarray(rows), QP, _LAM_RD, jnp.asarray(CRS))
        tc.update(mtsp=T(np.zeros((1, H // 8, W // 8), np.int32)),
                  lfnstp=T(np.zeros((1, H // 8, W // 8), np.int32)),
                  cmodep=T(np.zeros((1, H // 8, W // 8), np.int32)))
        twave._intra_batch(tc, T(rows), rows, QP, _LAM_RD, s=s, frame_w=W,
                           frame_h=H, log2_ctu=6, bd=8, encode=encode,
                           rdoq=True, dq=dq, **tools)
        _check_carry(tc, want, f"intra {s} encode={encode}")
        if encode:
            lev = {c: tc[c].clone() for c in ("ly", "lcb", "lcr")}
            # the tool indices fill each leaf; the reference writes its
            # top-left granule, which the decode pass reads back
            at = (rows[:, 2] // 8, rows[:, 1] // 8)
            for c, j, col in (("mtsp", 9, 6), ("lfnstp", 10, 7),
                              ("cmodep", 11, 8)):
                g = tc[c][0].numpy()
                np.testing.assert_array_equal(g[at], np.asarray(want[j])[at],
                                              c)
                for (x, y), v in zip(rows[:, 1:3], g[at]):
                    assert (g[y // 8:(y + s) // 8, x // 8:(x + s) // 8]
                            == v).all()
                rows[:, col] = g[at]
    assert {512, 8192} <= _scales(tc, rows[:, 1], rows[:, 2], s, s)


@pytest.mark.parametrize("s,d", [(16, 1)])
def test_isp_batch_lmcs(s, d):
    """ISP leaves with CCLM: the CRS scale from the whole leaf's luma
    recon, against the reference's _isp_batch."""
    rng = np.random.default_rng(80 + s + d)
    rows = _grid_rows(rng, s, s, 8, s.bit_length() - 3)
    rows[:, 3] = rng.integers(0, 67, rows.shape[0])
    rows[:, 15] = d
    tc, jc = _carries(90 + s)
    _port_luts(tc)
    tc["cmodep"] = T(np.zeros((1, H // 8, W // 8), np.int32))
    want = _jb(("isp", s, d), functools.partial(
        jwave._isp_batch.__wrapped__, s=s, d=d, frame_w=W, frame_h=H, bd=8,
        encode=True, cclm=True, rdoq=True, jccr=False, dq=False))(
            jc, jnp.asarray(rows), QP, _LAM_RD, jnp.asarray(CRS))
    twave._isp_batch(tc, T(rows), rows, QP, _LAM_RD, s=s, d=d, frame_w=W,
                     frame_h=H, log2_ctu=6, bd=8, encode=True, rdoq=True,
                     cclm=True)
    _check_carry(tc, want, f"isp {s} d={d}")
    assert {512, 8192} <= _scales(tc, rows[:, 1], rows[:, 2], s, s)


@pytest.mark.parametrize("shape", [(16, 8), (8, 32)],
                         ids=lambda sh: f"{sh[0]}x{sh[1]}")
def test_rect_batch_lmcs(shape):
    """Rect (BT and TT) intra leaves: the CRS shift is log2 w + log2 h,
    against the reference's _rect_batch."""
    w, h = shape
    rng = np.random.default_rng(w + 7 * h)
    rows = _grid_rows(rng, w, h, 10,
                      tplan.OP_RECT_INTRA0 + tplan.RECT_SHAPES.index(shape))
    rows[:, 3] = rng.integers(0, 67, rows.shape[0])
    tc, jc = _carries(w * h)
    _port_luts(tc)
    want = _jb(("rect", w, h), functools.partial(
        jwave._rect_batch.__wrapped__, w=w, h=h, frame_w=W, frame_h=H,
        bd=8, encode=True, rdoq=True, dq=True))(
            jc, jnp.asarray(rows), QP, _LAM_RD, jnp.asarray(CRS))
    twave._rect_batch(tc, T(rows), QP, _LAM_RD, w=w, h=h, frame_w=W,
                      frame_h=H, log2_ctu=6, bd=8, encode=True, rdoq=True,
                      dq=True)
    _check_carry(tc, want, f"rect {w}x{h}")
    assert {512, 8192} <= _scales(tc, rows[:, 1], rows[:, 2], w, h)


@pytest.mark.parametrize("s", [16])
def test_ciip_batch_lmcs(s):
    """CIIP leaves: the MC prediction forward-mapped before the planar
    blend, then scaled chroma, against the reference's _ciip_batch."""
    rng = np.random.default_rng(60 + s)
    rows = _grid_rows(rng, s, s, 8, 7 + (s.bit_length() - 4))
    k = rows.shape[0]
    rows[:, 4:6] = _mvs(rng, k, 60)
    rows[:, 11:13] = _mvs(rng, k, 60)
    rows[:, 13] = np.arange(k) % 3
    rows[:, 14] = rng.integers(0, 3, k)
    tc, jc = _carries(40 + s)
    _port_luts(tc)
    refs = _refs6()
    want = jwave._ciip_batch(jc, jnp.asarray(rows),
                             tuple(jnp.asarray(r.numpy()) for r in refs),
                             QP, _LAM_RD, jnp.asarray(FWD),
                             jnp.asarray(CRS), 0, 0, s=s, frame_w=W,
                             frame_h=H, bd=8, encode=True, rdoq=True,
                             dq=False)
    twave._ciip_batch(tc, T(rows), [r[None] for r in refs], QP, _LAM_RD,
                      s=s, frame_w=W, frame_h=H, log2_ctu=6, bd=8,
                      encode=True, rdoq=True)
    _check_carry(tc, want, "ciip")
    assert {512, 8192} <= _scales(tc, rows[:, 1], rows[:, 2], s, s)


_PA = dict(dmvr=True, bdof=True, gpm=True, affine=True, sbt=True, dq=True)


def _phase_a(kind, shape, rows, flags):
    """Phase A of square s-leaves (kind "sq", shape s) or rect leaves
    ("rect", shape (w, h)) with the model's LUTs, encoding then decoding
    the port's levels, against the reference's pass; returns the port's
    carry of the encode."""
    refs = _refs6()
    jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)
    trefs = [r[None] for r in refs]
    trows = np.concatenate([rows, np.zeros((len(rows), 1), np.int32)], 1)
    lut = dict(fwd_lut=jnp.asarray(FWD), crs_lut=jnp.asarray(CRS))
    lev = enc = None
    for encode in (True, False):
        tc, jc = _carries(31 + len(rows))
        _port_luts(tc)
        tc["sbtp"] = T(np.zeros((1, H // 8, W // 8), np.int32))
        if not encode:
            for c in ("ly", "lcb", "lcr"):
                tc["s" + c[1:]][:] = lev[c]
            jc = jc[:6] + tuple(jnp.asarray(lev[c][0].numpy())
                                for c in ("ly", "lcb", "lcr")) + jc[9:]
        if kind == "sq":
            fn = functools.partial(
                jrecon._inter_batch_pass, s=shape, qp=QP, bd=8,
                encode=encode, frame_w=W, frame_h=H, rdoq=True,
                lam_rd=_LAM_RD, **flags)
        else:
            fn = functools.partial(
                jrecon._inter_batch_pass_rect, w=shape[0], h=shape[1],
                qp=QP, bd=8, encode=encode, rdoq=True, lam_rd=_LAM_RD,
                dq=True)
        want = _jb((kind, shape, encode), lambda c, r, rf, fl, cl, fn=fn:
                   fn(c, r, rf, fwd_lut=fl, crs_lut=cl))(
            jc, jnp.asarray(rows), jrefs, lut["fwd_lut"], lut["crs_lut"])
        if kind == "sq":
            trecon._inter_batch_pass(tc, trows, trefs, shape, QP, 8, encode,
                                     rdoq=True, lam_rd=_LAM_RD, **flags)
        else:
            trecon._inter_batch_pass_rect(tc, trows, trefs, *shape, QP, 8,
                                          encode, rdoq=True, lam_rd=_LAM_RD,
                                          dq=True)
        _check_carry(tc, want, f"{kind} {shape} encode={encode}")
        if encode:
            lev = {c: tc[c].clone() for c in ("ly", "lcb", "lcr")}
            enc = tc
            if kind == "sq":
                # the parsed SBT index is the one the encode chose
                live = rows[:, 0] < (1 << 20)
                rows[live, 8] = tc["sbtp"][0].numpy()[rows[live, 1] // 8,
                                                      rows[live, 0] // 8]
    return enc


@pytest.mark.parametrize("tool,s", [("mixed", 16)])
def test_inter_batch_pass_lmcs(tool, s):
    """Phase A of square leaves with every inter tool, SBT and DQ: the
    luma prediction forward-mapped after BCW, GPM, DMVR, BDOF and affine,
    the CRS scale from the (SBT) luma recon."""
    rows = _phase_a_rows(tool, s)
    tc = _phase_a("sq", s, rows, _PA)
    live = rows[:, 0] < (1 << 20)
    assert {512, 8192} <= _scales(tc, rows[live, 0], rows[live, 1], s, s)


@pytest.mark.parametrize("shape", [(32, 8)],
                         ids=lambda sh: f"{sh[0]}x{sh[1]}")
def test_inter_batch_pass_rect_lmcs(shape):
    """Phase A of rect (BT and TT) inter leaves with DQ: the mapped
    prediction and the w x h CRS average."""
    w, h = shape
    rng = np.random.default_rng(w + 11 * h)
    nb = (H // h) * (W // w)
    k = min(nb, 24)
    pos = rng.permutation(nb)[:k]
    rows = np.zeros((k + 2, 7), np.int32)
    rows[:k, 0] = pos % (W // w) * w
    rows[:k, 1] = pos // (W // w) * h
    rows[:k, 2:6] = _mvs(rng, 2 * k, 60).reshape(k, 4)
    rows[:k, 6] = rng.choice([0, 1, 2], k)
    rows[k:, :2] = 1 << 20
    tc = _phase_a("rect", shape, rows, {})
    assert {512, 8192} <= _scales(tc, rows[:k, 0], rows[:k, 1], w, h)


def test_finish_frame_inverse_maps():
    """finish_frame_j with the inverse LUT (luma inverse-mapped before
    deblocking, SAO decided against the unmapped source) against the
    reference's."""
    from test_torch_loopfilter import _frame_and_dec, _t
    orig, dec = _frame_and_dec(seed=5)
    rng = np.random.default_rng(5)
    recp = [np.clip(p + rng.integers(-6, 7, p.shape), 0, 255)
            .astype(np.int32) for p in orig]
    recp[0] = FWD[recp[0]]
    want = jlf.finish_frame_j(recp, dec, 32, 347, orig, inv_lut=INV)
    got = tlf.finish_frame_j(_t(recp), state.decisions_from_numpy(dec), 32,
                             347, orig, inv_lut=INV)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"output {i}")
    plain = tlf.finish_frame_j(_t(recp), state.decisions_from_numpy(dec),
                               32, 347, orig)
    assert not torch.equal(plain[0], got[0])


def test_batch_of_models_equals_frames_alone(monkeypatch):
    """Every multi-frame wave of an LMCS encode (the 2-frame all-intra
    group and the {B1, B3} layer of a GOP4 clip, each frame with its own
    model) equals its frames' waves run one at a time."""
    calls = []
    orig = twave.frame_wave_batch

    def spy(frames_in, **kw):
        outs = orig(frames_in, **kw)
        if len(frames_in) > 1:
            calls.append((frames_in, kw, outs))
        return outs

    monkeypatch.setattr(twave, "frame_wave_batch", spy)
    # a luma brightness ramp over time gives each frame its own model
    frames = [[np.clip(f[0] + 12 * t, 0, 255), f[1], f[2]]
              for t, f in enumerate(motion_frames(5, 64, 64, seed=74))]
    for n, kw in ((2, dict(qp=32, mts=True, cclm=True, isp=True)),
                  (5, dict(qp=30, intra_period=0, gop=4, ciip=True,
                           sbt=True, dq=True, gpm=True, bcw=True))):
        tenc.encode_sequence(frames[:n], tseq.EncoderConfig(lmcs=True, **kw),
                             device="cpu")
    assert [len(c[0]) for c in calls] == [2, 2]
    for frames_in, kw, outs in calls:
        assert not torch.equal(frames_in[0]["fwd_lut"],
                               frames_in[1]["fwd_lut"])
        for fr, out in zip(frames_in, outs):
            for a, b in zip(orig([fr], **kw)[0], out):
                assert torch.equal(a, b)


def test_batch_refuses_mixed_models():
    """A wave of frames with and without LMCS is refused: their leaves
    would share one frame-indexed LUT stack."""
    z = torch.zeros((64, 64), dtype=torch.int32)
    lut = T(FWD)
    with pytest.raises(ValueError, match="LMCS"):
        twave.frame_wave_batch([dict(py=z, fwd_lut=lut, crs_lut=lut),
                                dict(py=z)], frame_w=64, frame_h=64, qp=32,
                               bd=8, encode=True, log2_ctu=6)


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def _same(a, b):
    return all(np.array_equal(x[c], y[c]) for x, y in zip(a, b)
               for c in range(3))


_INTER = dict(intra_period=0, gop=4, mmvd=True, sbt=True, ciip=True,
              bcw=True, gpm=True, affine=True, lmcs=True, dq=True)
# test_lmcs.py's four configs (:52, :61, :72, :86) and the LMCS configs
# of test_mtt.py and test_tt.py, on the frames those tests use
_CASES = {
    "ai": (lambda: motion_frames(2, 64, 96, seed=70),
           dict(qp=32, intra_period=1, lmcs=True)),
    "gop2": (lambda: motion_frames(4, 64, 96, seed=71),
             dict(qp=32, intra_period=0, gop=2, lmcs=True)),
    "ippp": (lambda: motion_frames(3, 64, 96, seed=72),
             dict(qp=32, intra_period=0, gop=1, lmcs=True)),
    "all_on": (lambda: motion_frames(3, 64, 96, seed=73),
               dict(qp=35, intra_period=0, gop=2, lmcs=True, mts=True,
                    lfnst=True, cclm=True, alf=True, wpp=False)),
    "mtt": (lambda: motion_frames(4, 64, 96, seed=72),
            dict(qp=32, mtt=True, **_INTER)),
    "tt": (lambda: motion_frames(4, 64, 96, seed=81),
           dict(qp=32, mtt=True, tt=True, **_INTER)),
}
# the spec model's side of "ippp" and "all_on" is test_lmcs.py's own
# (the reference engine equals it there), so those two are held against
# the reference engine only; the other pre-port tests hold the reference
# engine on theirs


@functools.lru_cache(maxsize=None)
def _port(case):
    """The port's (frames, bytes, recon, decisions) of a case, shared by
    the tests against the spec model and the reference engine."""
    mk, kw = _CASES[case]
    frames = mk()
    decs = []
    data, rec, _ = tenc.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                        device="cpu", decisions_out=decs)
    return frames, data, rec, decs


@pytest.mark.parametrize("case", ["ai", "gop2", "mtt", "tt"])
def test_lmcs_equals_spec_model(case):
    """The port's bytes, recon and whole-plane decisions equal the spec
    model's; the port decodes the spec model's stream and the spec model
    decodes the port's, hashes verified."""
    frames, data, rec, decs = _port(case)
    sdecs = []
    sdata, srec, _ = tseq.encode_sequence(
        frames, tseq.EncoderConfig(**_CASES[case][1]), decisions_out=sdecs)
    assert data == sdata and _same(rec, srec)
    assert len(decs) == len(sdecs)
    assert all(a.equal(b) for a, b in zip(decs, sdecs))
    out, _ = tenc.decode_sequence(sdata, check_hash=True, device="cpu")
    assert _same(out, srec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)


@pytest.mark.parametrize("case", ["ai", "gop2", "ippp", "all_on"])
def test_lmcs_equals_reference_engine(case):
    """The port's bytes and recon equal the reference engine's, and the
    reference decoder decodes the port's stream, hashes verified."""
    frames, data, rec, _ = _port(case)
    jdata, jrec, _ = jenc.encode_sequence(
        frames, jseq.EncoderConfig(**_CASES[case][1]))
    assert data == jdata and _same(rec, jrec)
    jout, _ = jenc.decode_sequence(data, check_hash=True)
    assert _same(jout, rec)


def test_cli_lmcs(tmp_path):
    """The CLI's --lmcs encodes the bytes of encode_sequence with LMCS on,
    and the port decodes them with the hashes verified."""
    from vvctpu_torch import __main__ as tcli
    from vvctpu_torch.io import yuv
    frames = motion_frames(2, 64, 64, seed=75)
    src = tmp_path / "in.yuv"
    yuv.write_yuv(str(src), frames)
    out = tmp_path / "o.bin"
    assert tcli.main(["encode", "-i", str(src), "--wdt", "64", "--hgt",
                      "64", "-q", "30", "--ip", "0", "--lmcs", "--cclm",
                      "-b", str(out), "--device", "cpu"]) == 0
    data, _, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(qp=30, intra_period=0, lmcs=True,
                                   cclm=True), device="cpu")
    assert out.read_bytes() == data
    assert tcli.main(["decode", "-b", str(out), "-o",
                      str(tmp_path / "d.yuv"), "--device", "cpu"]) == 0
