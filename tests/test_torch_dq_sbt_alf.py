"""SBT, dependent quantization and ALF/CC-ALF in the port against their
twins in vvctpu at tolerance 0 on seeded inputs: the trellis (through its
plain twin, which the CUDA kernel is held against on the card), the state
walk and the state-dependent dequantizer, the SBT choice and residual,
phase A with SBT and DQ, the ALF classification and filters; end to end
against the spec model and, on one config with the three tools together,
against the reference engine, cross-decoded with hashes verified; the
CLI's three tool flags."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.core import rom  # noqa: E402,F401  (tables before kernels)
from vvctpu.kernels import loopfilter as jlf  # noqa: E402
from vvctpu.kernels import transform as jtf  # noqa: E402
from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.spec import alf as jalf  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu.spec.transform import lambda_rd_int  # noqa: E402
from vvctpu_torch import __main__ as tcli  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.io import yuv  # noqa: E402
from vvctpu_torch.kernels import dq as tdq  # noqa: E402
from vvctpu_torch.kernels import loopfilter as tlf  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import plan as tplan  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.spec import alf as talf  # noqa: E402
from vvctpu_torch.spec import codec as tcodec  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_codec_roundtrip import synth_frame  # noqa: E402
from test_depquant import rand_coef  # noqa: E402
from test_inter_parity import motion_frames  # noqa: E402
from test_sbt import half_residual_planes  # noqa: E402
from test_torch_inter_tools import (H, W, _carries, _check_carry,  # noqa: E402
                                    _phase_a_rows, _refs6)

torch.set_num_threads(1)
T = torch.as_tensor


def _same(a, b):
    return all(np.array_equal(x[c], y[c]) for x, y in zip(a, b)
               for c in range(3))


_JIT: dict = {}


def _jit(key, fn, in_axes=0):
    """jax.jit(jax.vmap(fn)), compiled once per key across tests."""
    if key not in _JIT:
        _JIT[key] = jax.jit(jax.vmap(fn, in_axes=in_axes))
    return _JIT[key]


# ---------------------------------------------------------------------------
# dependent quantization
# ---------------------------------------------------------------------------


def _dq_blocks(h, w, kind):
    """(4, h, w) coefficients: three seeded blocks (test_depquant's
    generator) and an all-zero one; "flat" a constant block, where the
    trellis ties everywhere; "max" the coefficient extremes; "sparse"
    blocks where the trellis gives a zero coefficient a nonzero level."""
    c = np.stack([rand_coef(h, w, seed=7 * h + w + k) for k in range(3)]
                 + [np.zeros((h, w), np.int32)])
    if kind == "sparse":
        rng = np.random.default_rng(4)
        c[:3] = (rng.integers(-3, 4, (3, h, w)) * rng.integers(0, 2, (3, h, w))
                 * rng.choice([40, 300], (3, 1, 1)))
    if kind == "flat":
        c[:3] = np.asarray([100, -37, 1])[:, None, None]
    elif kind == "max":
        c[0], c[1] = 32767, -32768
        c[2] = np.where(np.indices((h, w)).sum(0) % 2, 32767, -32768)
    return c.astype(np.int32)


@pytest.mark.parametrize("h,w,kind", [
    (4, 4, "seed"), (8, 8, "seed"), (16, 16, "seed"), (32, 32, "seed"),
    (8, 4, "seed"), (64, 64, "seed"), (16, 32, "seed"), (8, 8, "flat"),
    (16, 32, "max"), (8, 8, "sparse")])
def test_dq_equals_reference(h, w, kind):
    """quantize_dq (the trellis twin), dq_states and dequantize_dq on a
    batch of blocks equal quantize_dq_j, dq_states_j and dequantize_dq_j
    at qp 22 and 37: the shapes of test_depquant.py's twin test, 64x64,
    an SBT half, flat ties, saturated coefficients and a zero coefficient
    that takes a level."""
    coef = _dq_blocks(h, w, kind)

    def twins(c, v, qp, lam):
        # the trellis of the coefficients, and the state walk and the
        # dequantizer of the port's levels, in one program per shape
        return (jtf.quantize_dq_j(c, h, w, qp, lam), jtf.dq_states_j(v, h, w),
                jtf.dequantize_dq_j(v, h, w, qp))

    twins_j = _jit(("dq", h, w), twins, (0, 0, None, None))
    for qp in (22, 37):
        lam = lambda_rd_int(qp)
        got = ttf.quantize_dq(T(coef), h, w, qp, lam)
        want_q, want_st, want_dq = twins_j(coef, got.numpy(), qp, lam)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want_q))
        np.testing.assert_array_equal(ttf.dq_states(got, h, w).numpy(),
                                      np.asarray(want_st))
        np.testing.assert_array_equal(
            ttf.dequantize_dq(got, h, w, qp).numpy(), np.asarray(want_dq))
        if kind == "seed" and qp == 22:
            assert got[:3].abs().sum() > 0
        assert not got[3].any()


def test_dq_trellis_on_cpu_is_the_twin():
    """On a CPU tensor the wrapper takes the plain twin and launches
    nothing; the quantize/dequantize entry points route dq=True there."""
    coef = T(_dq_blocks(8, 8, "seed"))
    walk = T(ttf.walk32(8, 8))
    before = tdq.launches
    args = ttf.dq_params(8, 8, 27, lambda_rd_int(27))
    np.testing.assert_array_equal(tdq.dq_trellis(coef, walk, *args).numpy(),
                                  tdq.dq_trellis_plain(coef, walk,
                                                       *args).numpy())
    assert tdq.launches == before
    lam = lambda_rd_int(27)
    assert torch.equal(ttf.quantize(coef, 8, 8, 27, rdoq=True, lam_rd=lam,
                                    dq=True),
                       ttf.quantize_dq(coef, 8, 8, 27, lam))
    lev = ttf.quantize_dq(coef, 8, 8, 27, lam)
    assert torch.equal(ttf.dequantize(lev, 8, 8, 27, dq=True),
                       ttf.dequantize_dq(lev, 8, 8, 27))


# ---------------------------------------------------------------------------
# SBT
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,dq", [(8, True), (16, False), (32, False)])
def test_choose_sbt_and_resi(s, dq):
    """choose_sbt over a batch of residuals (zero, one half, the other
    half, noise) and sbt_resi of its choice equal choose_sbt_j and
    sbt_resi_j at phase A's sizes (8, 16 and 32; DQ at 8, where it runs
    the trellis on the 4x8 and 8x4 halves; test_dq_equals_reference holds
    the trellis on the 16x32 ones)."""
    rng = np.random.default_rng(s)
    resi = rng.integers(-40, 41, (6, s, s)).astype(np.int32)
    resi[0] = 0
    resi[1, :, :s // 2] = 0
    resi[2, :s // 2] = 0
    resi[3, :, s // 2:] = 0
    qp = 27
    lam = lambda_rd_int(qp)
    idx, lev, rec = ttf.choose_sbt(T(resi), s, qp, lam, rdoq=True, dq=dq)
    wi, wl, wr = _jit(("sbt", s), lambda r: jtf.choose_sbt_j(
        r, s, qp, lam, rdoq=True, dq=dq))(resi)
    for g, w_ in ((idx, wi), (lev, wl), (rec, wr)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert (idx[1:4] > 0).all() and idx[0] == 0
    got = ttf.sbt_resi(lev, idx.numpy(), s, qp, dq=dq)
    want = _jit(("sbt_resi", s), lambda lv, i: jtf.sbt_resi_j(
        lv, i, s, qp, dq=dq))(wl, wi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_inter_batch_pass_sbt_dq():
    """Phase A of 8x8 leaves at qp 37 with SBT and DQ (and BCW, GPM and
    BDOF; DMVR and affine act from 16x16), encoding then decoding the
    port's levels: recon, levels and the SBT index equal the reference's
    _inter_batch_pass; the port records the index on every granule of
    the leaf, as the spec model does (one granule at this size)."""
    s, qp = 8, 37
    lam = lambda_rd_int(qp)
    flags = dict(bdof=True, gpm=True, sbt=True, dq=True)
    rows = _phase_a_rows("mixed", s)
    refs = _refs6()
    jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)
    trows = np.concatenate([rows, np.zeros((len(rows), 1), np.int32)], 1)
    real = rows[:, 0] < (1 << 20)
    gy, gx = rows[real, 1] // 8, rows[real, 0] // 8
    lev = None
    for encode in (True, False):
        tc, jc = _carries(s)
        tc["sbtp"] = torch.zeros((1, H // 8, W // 8), dtype=torch.int32)
        if not encode:
            for k in ("ly", "lcb", "lcr"):
                tc["s" + k[1:]][:] = lev[k]
            jc = jc[:6] + tuple(jnp.asarray(lev[k][0].numpy())
                                for k in ("ly", "lcb", "lcr")) + jc[9:]
        want = jax.jit(functools.partial(
            jrecon._inter_batch_pass, s=s, qp=qp, bd=8, encode=encode,
            frame_w=W, frame_h=H, rdoq=True, lam_rd=lam, **flags))(
            jc, jnp.asarray(rows), jrefs)
        trecon._inter_batch_pass(tc, trows, [r[None] for r in refs], s, qp,
                                 8, encode, rdoq=True, lam_rd=lam, **flags)
        _check_carry(tc, want, f"encode={encode}")
        if encode:
            lev = {k: tc[k].clone() for k in ("ly", "lcb", "lcr")}
            sbtp = tc["sbtp"][0].numpy()
            np.testing.assert_array_equal(sbtp, np.asarray(want[13]))
            assert (sbtp > 0).any()
            # the decoder reads the index from slot column 8
            rows[real, 8] = trows[real, 8] = sbtp[gy, gx]


# ---------------------------------------------------------------------------
# ALF + CC-ALF
# ---------------------------------------------------------------------------


def _alf_params(luma: bool, chroma: bool, cc: bool, n_y: int, n_x: int,
                seed: int):
    """Random reference AlfParams with each part on or off: luma filters
    on half the classes, chroma 5x5 and CC-ALF coefficients, CTU flags
    mixed."""
    rng = np.random.default_rng(seed)
    p = jalf.AlfParams(ctu_on=(rng.random((n_y, n_x)) < 0.7).astype(
        np.uint8), ctu_on_c=(rng.random((2, n_y, n_x)) < 0.7).astype(
        np.uint8))
    p.ctu_on[0, 0] = p.ctu_on_c[:, 0, 0] = 1
    if luma:
        p.enabled = True
        p.coeff[:] = rng.integers(-60, 61, p.coeff.shape)
        p.present[:] = rng.random(jalf.N_CLASSES) < 0.5
    if chroma or cc:
        p.c_enabled[:] = 1
    if chroma:
        p.c_coeff[:] = rng.integers(-90, 91, p.c_coeff.shape)
    if cc:
        p.cc_present[:] = 1
        p.cc_coeff[:] = rng.integers(-jalf.CC_MAX, jalf.CC_MAX + 1,
                                     p.cc_coeff.shape)
    return p


@pytest.mark.parametrize("luma,chroma,cc", [
    (True, True, True), (True, False, False), (False, True, False),
    (False, False, True), (False, False, False)])
def test_alf_equals_reference(luma, chroma, cc):
    """classify_j and apply_alf_frame on a noisy reconstruction of
    128x192 equal the reference's classify_j and apply_alf_frame_j (and
    the spec model's apply_alf_frame), with luma ALF, chroma ALF and
    CC-ALF each on and off; the reference's parameters reach the port
    through state.alf_params_from_numpy."""
    rng = np.random.default_rng(9)
    src = synth_frame(128, 192, seed=104)
    rec = [np.clip(p + rng.integers(-9, 10, p.shape), 0, 255).astype(
        np.int32) for p in src]
    rec[0][:64, :64] = 255 * (rng.random((64, 64)) < 0.5)
    cls, tr = tlf.classify_j(T(rec[0]), 8)
    wc, wt = jlf.classify_j(jnp.asarray(rec[0]), 8)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(wt))
    params = _alf_params(luma, chroma, cc, 2, 3, seed=int(luma) + 2 * chroma
                         + 4 * cc)
    tparams = state.alf_params_from_numpy(params)
    assert isinstance(tparams, talf.AlfParams) and tparams.equal(params)
    got = tlf.apply_alf_frame([T(p) for p in rec], tparams)
    want = jlf.apply_alf_frame_j(rec, params)
    spec = talf.apply_alf_frame(rec, tparams)
    for c in range(3):
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(want[c]))
        np.testing.assert_array_equal(got[c].numpy(), spec[c])
    changed = [not np.array_equal(got[c].numpy(), rec[c]) for c in range(3)]
    assert changed == [luma, chroma or cc, chroma or cc]


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------

_SPEC_CASES = {
    # test_depquant.py:95, the all-intra config and the inter one without
    # LMCS
    "dq_ai": (lambda: motion_frames(3, 64, 64, seed=51),
              dict(qp=32, dq=True, mts=True, lfnst=True)),
    "dq_sbt_ciip": (lambda: motion_frames(3, 64, 64, seed=51),
                    dict(qp=32, dq=True, intra_period=0, gop=2, sbt=True,
                         ciip=True)),
    # test_alf.py:114 (chroma ALF and CC-ALF switch on)
    "alf": (lambda: [synth_frame(128, 128, seed=103)],
            dict(qp=37, alf=True)),
}


@pytest.mark.parametrize("case", list(_SPEC_CASES))
def test_config_equals_spec_model(case):
    """The port's bytes and recon equal the spec model's; the port decodes
    the stream with the hashes verified."""
    mk, kw = _SPEC_CASES[case]
    frames = mk()
    cfg = tseq.EncoderConfig(**kw)
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu")
    sdata, srec, _ = tseq.encode_sequence(frames, cfg)
    assert data == sdata
    assert _same(rec, srec)
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert _same(out, rec)


def test_sbt_gate_with_ciip_and_skip(monkeypatch):
    """SBT with MMVD and CIIP on the clip of test_sbt.py:65, where the SBT
    search fires (on test_sbt.py:84's clip it never does): SBT, CIIP and
    skip leaves occur together, and the port's sbt8 planes equal the spec
    model's, which records SBT only on signalled leaves (not skip, not
    CIIP, square); bytes equal, the spec model decodes the port's stream
    with the hashes verified."""
    frames = half_residual_planes(4, 64, 96, seed=9)
    cfg = tseq.EncoderConfig(qp=27, sao=False, deblock=False,
                             intra_period=0, gop=3, sbt=True, mmvd=True,
                             ciip=True)
    got, want = [], []
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu",
                                        decisions_out=got)
    sdata, _, _ = tseq.encode_sequence(frames, cfg, decisions_out=want)
    assert data == sdata
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.sbt8, w_.sbt8)
    assert any((d.sbt8 > 0).any() for d in got)
    assert any(d.ciip8.any() for d in got)
    skips = []
    inner = tcodec._code_inter_leaf

    def count(io, st, x, y, s, skip, *a, **kw):
        skips.append(skip)
        return inner(io, st, x, y, s, skip, *a, **kw)

    monkeypatch.setattr(tcodec, "_code_inter_leaf", count)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)
    assert any(skips) and not all(skips)


def zoom_fine(n, seed):
    """A 64x64 clip: a fine sine-product texture under a slow zoom with
    rotation and fine chroma texture, so that affine, SBT and ALF (in
    the P picture too, luma and chroma) are all chosen at qp 22."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:64, 0:64]
    frames = []
    for t in range(n):
        sc, th = 1.0 + 0.02 * t, 0.01 * t
        u = (np.cos(th) * (xx - 32) - np.sin(th) * (yy - 32)) * sc + 32
        v = (np.sin(th) * (xx - 32) + np.cos(th) * (yy - 32)) * sc + 32
        y = (128 + 90 * np.sin(u / 3.0) * np.cos(v / 4.0)
             + rng.integers(-3, 4, (64, 64))).clip(0, 255)
        frames.append([y.astype(np.int32),
                       (128 + 60 * np.sin(u[::2, ::2] / 5.0)).astype(np.int32),
                       (128 - 60 * np.cos(v[::2, ::2] / 4.0)).astype(np.int32)])
    return frames


_JAX_CFG = dict(qp=22, sbt=True, dq=True, alf=True, affine=True,
                intra_period=0, gop=2)


@functools.lru_cache(maxsize=None)
def _jax_encode():
    """The reference engine's encode of a 64x64 3-frame GOP2 clip with
    SBT, DQ, ALF and affine (frames, bytes, recon, bits, decisions;
    shared by the two tests below)."""
    frames = zoom_fine(3, seed=2)
    decs = []
    out = jenc.encode_sequence(frames, sseq.EncoderConfig(**_JAX_CFG),
                               decisions_out=decs)
    return (frames,) + out + (decs,)


@functools.lru_cache(maxsize=None)
def _port_encode():
    frames = zoom_fine(3, seed=2)
    decs = []
    out = tenc.encode_sequence(frames, tseq.EncoderConfig(**_JAX_CFG),
                               device="cpu", decisions_out=decs)
    return out + (decs,)


def _alf_on(data):
    """Per picture in decoding order: (luma CTUs, Cb CTUs, Cr CTUs) with
    ALF on."""
    on = []
    for e in tenc._parse(data, False)[2]:
        a = e["alf"]
        on.append((0, 0, 0) if a is None else (
            int(a.ctu_on.sum()) if a.enabled else 0,
            *(int(a.ctu_on_c[c].sum()) if a.c_enabled[c] else 0
              for c in (0, 1))))
    return on


def test_sbt_dq_alf_equals_reference_engine():
    """SBT, DQ, ALF and affine together: the port's bytes, bits, recon and
    FrameDecisions equal the reference engine's, with SBT and affine
    chosen and ALF on in the P picture (so the B picture predicts from
    an ALF-filtered DPB), and the port decodes the reference's stream
    with the hashes verified.  The SBT index is compared on each leaf's
    top-left granule, the only one the reference engine writes (the
    port writes every granule of the leaf, as the spec model does)."""
    _, jdata, jrec, jbits, want_dec = _jax_encode()
    data, rec, bits, got_dec = _port_encode()
    assert data == jdata and bits == jbits and _same(rec, jrec)
    assert len(got_dec) == len(want_dec) == 3
    for g, w in zip(got_dec, want_dec):
        w = state.decisions_from_numpy(w)
        for f in dataclasses.fields(w):
            if isinstance(getattr(w, f.name), np.ndarray) \
                    and f.name != "sbt8":
                np.testing.assert_array_equal(getattr(g, f.name),
                                              getattr(w, f.name), f.name)
        op, xs, ys = tplan.leaf_plan(g, 64, 64)[:3]
        origin = np.zeros_like(w.sbt8, bool)
        origin[ys[op > 0] // 8, xs[op > 0] // 8] = True
        np.testing.assert_array_equal(g.sbt8[origin], w.sbt8[origin])
        assert not w.sbt8[~origin].any()
    assert any((d.sbt8 > 0).any() for d in got_dec)
    assert any(d.aff8.any() for d in got_dec)
    # decoding order I, P, B: luma and both chroma ALF on in the P picture
    assert all(_alf_on(data)[1])
    out, _ = tenc.decode_sequence(jdata, check_hash=True, device="cpu")
    assert _same(out, jrec)


def test_sbt_dq_alf_spec_model_decodes_port_stream():
    """The spec model decodes the port's SBT+DQ+ALF stream with the
    hashes verified, to the reference engine's recon."""
    jrec = _jax_encode()[2]
    data = _port_encode()[0]
    sout, sps = tseq.decode_sequence(data, check_hash=True)
    assert sps.sbt_enabled and sps.dq_enabled and sps.alf_enabled
    assert _same(sout, jrec)


def test_cli_sbt_dq_alf(tmp_path, capsys):
    """--sbt --dq --alf (with --affine) on the CLI give encode_sequence's
    bytes, and the CLI decoder verifies the hashes."""
    frames = zoom_fine(3, seed=2)
    src = str(tmp_path / "in.yuv")
    yuv.write_yuv(src, frames)
    bit, rec, dec = (str(tmp_path / n) for n in ("a.bin", "r.yuv", "d.yuv"))
    assert tcli.main(["encode", "-i", src, "--wdt", "64", "--hgt", "64",
                      "-q", "22", "--ip", "0", "--gop", "2", "-f", "3",
                      "--sbt", "--dq", "--alf", "--affine", "-b", bit,
                      "-o", rec, "--device", "cpu"]) == 0
    with open(bit, "rb") as f:
        assert f.read() == _port_encode()[0]
    assert tcli.main(["decode", "-b", bit, "-o", dec, "--device",
                      "cpu"]) == 0
    assert "all picture hashes verified" in capsys.readouterr().out
    with open(rec, "rb") as a, open(dec, "rb") as b:
        assert a.read() == b.read()
