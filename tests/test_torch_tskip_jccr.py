"""Transform skip (TS) and joint Cb-Cr residual coding (JCCR) in the port,
at tolerance 0: the TS transforms, the MTS/TS/LFNST choice and the
chroma choice with the joint candidate against their JAX twins in vvctpu
(under jax.jit(jax.vmap(...))), test_tskip.py's and test_jccr.py's
configurations against the spec model (bytes, recon and whole-plane
decisions), and a TS + JCCR configuration against a live vvctpu
encode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.core import rom  # noqa: E402
from vvctpu.kernels import transform as jtf  # noqa: E402
from vvctpu.pipeline import encoder as jenc  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu.spec.transform import MTS_SET  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_jccr import corr_chroma_planes  # noqa: E402
from test_torch_ra_tools import _assert_equal_to_reference  # noqa: E402
from test_tskip import screen_planes  # noqa: E402

torch.set_num_threads(1)
T = torch.as_tensor
LAM = 347


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


# ---------------------------------------------------------------------------
# the TS transforms
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bd", [8, 10])
def test_ts_transforms_equal_reference(bd):
    """The TS forward (a shift by transform_shift, clipped) and inverse (a
    rounding shift) at every square size, and inverse_transform_rows with
    TS rows among the MTS rows, equal the JAX engine's (tolerance 0); at
    10 bits the 32x32 shift is 0."""
    rng = np.random.default_rng(bd)
    mx = (1 << bd) - 1
    for s in rom.TR_SIZES:
        if s > 32:
            continue
        resi = rng.integers(-mx, mx + 1, (6, s, s)).astype(np.int32)
        resi[0], resi[1] = mx, -mx
        coef = rng.integers(-32768, 32768, (6, s, s)).astype(np.int32)
        coef[0], coef[1] = 32767, -32768
        got_f = ttf.forward_transform(T(resi), s, s, rom.IDT, rom.IDT, bd)
        got_i = ttf.inverse_transform(T(coef), s, s, rom.IDT, rom.IDT, bd)
        for i in range(6):
            _eq(got_f[i], jtf.forward_transform(jnp.asarray(resi[i]), s, s,
                                                rom.IDT, rom.IDT, bd),
                f"forward s={s}")
            _eq(got_i[i], jtf.inverse_transform(jnp.asarray(coef[i]), s, s,
                                                rom.IDT, rom.IDT, bd),
                f"inverse s={s}")
        if s in rom.MTS_SIZES:
            midx = np.asarray([5, 0, 5, 1, 4, 5], np.int32)
            got = ttf.inverse_transform_rows(T(coef), s, T(midx), bd)
            for i, m in enumerate(midx):
                kh, kv = MTS_SET[m]
                _eq(got[i], jtf.inverse_transform(jnp.asarray(coef[i]), s,
                                                  s, kh, kv, bd),
                    f"rows s={s} idx={m}")


# ---------------------------------------------------------------------------
# the transform choice with TS
# ---------------------------------------------------------------------------


def _ts_resi(s, n, bd, seed):
    """Residuals where TS and the transforms both win: impulses and steps
    (screen content), noise, flat and all-zero rows, a saturated row."""
    rng = np.random.default_rng(seed)
    mx = (1 << bd) - 1
    r = rng.integers(-(mx >> 3), (mx >> 3) + 1, (n, s, s)).astype(np.int32)
    r[0] = 0
    r[1] = 1
    r[2] = mx
    for i in (3, 6, 7):             # sparse impulses on a zero ground
        r[i] = 0
        k = rng.integers(1, 4)
        r[i, rng.integers(0, s, k), rng.integers(0, s, k)] = \
            rng.choice([-mx, mx], k)
    r[4, :, s // 2:] = mx // 2      # a step
    return r


@pytest.mark.parametrize("s,mts,lfnst,dq,allow,bd", [
    (8, True, True, False, True, 8),
    (16, False, False, False, False, 8),
    (32, True, False, True, False, 8),
    (8, False, True, True, True, 10),
    (32, True, True, False, False, 10),
    (16, True, False, False, True, 10)])
def test_choose_tx_ts_equals_reference(s, mts, lfnst, dq, allow, bd):
    """choose_tx with transform skip (and with or without MTS, LFNST, DQ
    and MIP's ``allow`` mask, at 8 and 10 bits) equals choose_tx_j
    (tolerance 0): the index, the LFNST index, the levels and the
    reconstructed residual of every row; TS wins on some rows."""
    n = 8
    resi = _ts_resi(s, n, bd, s + bd)
    modes = np.asarray([0, 1, 2, 18, 34, 50, 66, 30], np.int32)
    al = np.asarray([True, False] * (n // 2))
    got = ttf.choose_tx(T(resi), s, 32, LAM, T(modes), bd, mts=mts,
                        lfnst=lfnst, rdoq=True, dq=dq,
                        allow=T(al) if allow else None, ts=True)
    want = jax.jit(jax.vmap(lambda r, m, a: jtf.choose_tx_j(
        r, s, 32, jnp.int32(LAM), m, bd, mts=mts, lfnst=lfnst, rdoq=True,
        dq=dq, allow=a if allow else None, ts=True)))(
        jnp.asarray(resi), jnp.asarray(modes), jnp.asarray(al))
    for k, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"output {k}")
    assert (got[0] == 5).any()


# ---------------------------------------------------------------------------
# the chroma choice with the joint candidate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cs,cclm,crs,dq", [
    (4, False, False, False), (8, True, True, False),
    (16, True, False, True), (8, False, True, True)])
def test_chroma_rd_jccr_equals_reference(cs, cclm, crs, dq):
    """chroma_rd with the joint candidate (with and without CCLM's second
    option, LMCS's CRS scales at both clamps and DQ) equals chroma_rd_j
    under jax.jit(jax.vmap(...)) (tolerance 0): levels, recon and both
    choices; the joint candidate wins on some rows and loses on
    others."""
    rng = np.random.default_rng(cs + 2 * cclm + 4 * crs + 8 * dq)
    n = 8
    base = rng.integers(-60, 61, (n, cs, cs))
    src_b = (128 + base).astype(np.int32)
    src_r = (128 - base + rng.integers(-3, 4, (n, cs, cs))).astype(np.int32)
    src_r[:2] = rng.integers(0, 256, (2, cs, cs))     # uncorrelated rows
    preds = [rng.integers(100, 157, (n, cs, cs)).astype(np.int32)
             for _ in range(4)]
    preds[2][4:] = src_b[4:] - base[4:] // 2          # closer CCLM rows
    preds[0][2:6] = preds[1][2:6] = 128               # anti-correlated
    sc = np.asarray([512, 8192] * (n // 2), np.int32)
    opts = [(preds[0], preds[1])] + ([(preds[2], preds[3])] if cclm else [])
    got = trecon.chroma_rd(T(src_b), T(src_r),
                           [(T(a), T(b)) for a, b in opts], cs, 32, 8, True,
                           LAM, dq, T(sc) if crs else None, jccr=True)
    P = len(opts)

    def ref(b, r, *a):
        p = [(a[2 * i], a[2 * i + 1]) for i in range(P)]
        return jrecon.chroma_rd_j(b, r, p, a[2 * P] if crs else None, cs,
                                  32, 8, True, jnp.int32(LAM), True, dq)
    want = jax.jit(jax.vmap(ref))(*(jnp.asarray(v) for v in (
        src_b, src_r, *[p for o in opts for p in o], sc)))
    for k, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"output {k}")
    assert got[5].any() and not got[5].all()


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


_SPEC_CASES = {
    # test_tskip.py:76 and :96 (TS with MTS, LFNST and MIP; TS alone)
    "ts_tools": (lambda: [screen_planes(64, 128, seed=6)],
                 dict(qp=32, sao=False, deblock=False, tskip=True, mts=True,
                      lfnst=True, mip=True)),
    "ts_alone": (lambda: [screen_planes(64, 128, seed=8)],
                 dict(qp=24, sao=False, deblock=False, tskip=True)),
    # test_jccr.py:59 with CCLM off and on
    "jccr": (lambda: [corr_chroma_planes(64, 128, seed=7)],
             dict(qp=32, sao=False, deblock=False, jccr=True, cclm=False,
                  mts=True, mip=True)),
    "jccr_cclm": (lambda: [corr_chroma_planes(64, 128, seed=7)],
                  dict(qp=32, sao=False, deblock=False, jccr=True, cclm=True,
                       mts=True, mip=True)),
}


@pytest.mark.parametrize("case", list(_SPEC_CASES))
def test_ts_jccr_equal_spec_model(case):
    """The port's bytes, recon and whole-plane decisions equal the spec
    model's (tolerance 0), with the tool chosen; the port and the spec
    model decode the port's stream with the hashes verified."""
    mk, kw = _SPEC_CASES[case]
    frames = mk()
    cfg = tseq.EncoderConfig(**kw)
    decs, sdecs = [], []
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu",
                                        decisions_out=decs)
    sdata, srec, _ = tseq.encode_sequence(frames, cfg, decisions_out=sdecs)
    assert data == sdata and _same(rec, srec)
    assert all(a.equal(b) for a, b in zip(decs, sdecs))
    if kw.get("tskip"):
        assert any((d.mts8 == 5).any() for d in decs)
    if kw.get("jccr"):
        assert any(d.jccr8.any() for d in decs)
    out, sps = tenc.decode_sequence(data, check_hash=True, device="cpu")
    assert sps.ts_enabled == bool(kw.get("tskip"))
    assert sps.jccr_enabled == bool(kw.get("jccr"))
    assert _same(out, rec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)


def test_ts_jccr_equals_reference_engine():
    """TS and JCCR together (with CCLM) on screen luma over
    anti-correlated chroma: the port's bytes, recon and decisions equal a
    live vvctpu encode (tolerance 0; the transform, LFNST, CCLM and JCCR
    indices on each leaf's top-left granule, the only one the reference
    engine writes), both tools chosen, and the port decodes vvctpu's
    stream with the hashes verified."""
    y = screen_planes(64, 64, seed=6)[0]
    _, cb, cr = corr_chroma_planes(64, 64, seed=7)
    frames = [[y, cb, cr]]
    kw = dict(qp=32, sao=False, deblock=False, tskip=True, jccr=True,
              cclm=True)
    jdecs, decs = [], []
    jdata, jrec, jbits = jenc.encode_sequence(
        frames, sseq.EncoderConfig(**kw), decisions_out=jdecs)
    data, rec, bits = tenc.encode_sequence(
        frames, tseq.EncoderConfig(**kw), device="cpu", decisions_out=decs)
    assert data == jdata and bits == jbits and _same(rec, jrec)
    _assert_equal_to_reference(decs[0], jdecs[0], 64, 64)
    assert (decs[0].mts8 == 5).any() and decs[0].jccr8.any()
    out, _ = tenc.decode_sequence(jdata, check_hash=True, device="cpu")
    assert _same(out, jrec)
