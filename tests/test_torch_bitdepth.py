"""10-bit input in the port against its JAX twins in vvctpu at tolerance 0
on seeded inputs whose samples reach 0 and 1023: the refinement clamp
that parts the reference engine from the spec model at 10 bits, the
motion search (quarter-pel planes, refinement, BI
costs, the dense stage's twin against the Pallas kernel interpreted),
the intra size pass with MIP, MRL and ISP, the
transforms at +-1023 residuals with RDOQ and the trellis, every leaf
class and phase A (every inter tool, SBT and DQ) with a 1024-entry LMCS
model, the loop filters (deblocking, SAO, ALF); end to end, the 10-bit
all-intra clip of test_codec_roundtrip.py and a GOP2 clip with every
tool of the slice at bit_depth=10 against the spec model (bytes, recon,
whole-plane decisions, both decoders)."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.cabac import estimate as jest  # noqa: E402
from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.coding import me as jme  # noqa: E402
from vvctpu.kernels import loopfilter as jlf  # noqa: E402
from vvctpu.kernels import transform as jtf  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu.spec import alf as jalf  # noqa: E402
from vvctpu.spec import decide as sdec  # noqa: E402
from vvctpu.spec.inter import REF_MARGIN  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402
from vvctpu_torch.coding import me as tme  # noqa: E402
from vvctpu_torch.core import rom as trom  # noqa: E402
from vvctpu_torch.kernels import loopfilter as tlf  # noqa: E402
from vvctpu_torch.kernels import me_sad as kme  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import plan as tplan  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402
from vvctpu_torch.spec import lmcs as tlmcs  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402
from vvctpu_torch.spec.transform import lambda_rd_int  # noqa: E402

import chip_smoke  # noqa: E402
from test_inter_parity import motion_frames  # noqa: E402

torch.set_num_threads(1)
T = torch.as_tensor
BD, MX = 10, 1023
H, W = 64, 128
QP = 30
LAM = 211
LAM_RD = lambda_rd_int(QP)
# a 1024-entry LMCS model whose CRS LUT takes both clamps (chip_smoke's
# 8-bit test model with four times the codewords)
FWD, INV = tlmcs.build_luts(chip_smoke.LMCS_CW10, BD)
CRS = tlmcs.build_crs_lut(chip_smoke.LMCS_CW10, BD)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


_JIT: dict = {}


def _jit(key, fn, **kw):
    """jax.jit(fn) (jax.jit(jax.vmap(fn)) with ``vmap``), compiled once per
    key across tests."""
    if key not in _JIT:
        vm = kw.pop("vmap", None)
        _JIT[key] = jax.jit(jax.vmap(fn, in_axes=vm) if vm is not None
                            else fn, **kw)
    return _JIT[key]


@functools.lru_cache(maxsize=None)
def _planes10():
    """Seeded 10-bit planes: a saturated one (every sample 0 or 1023), a
    noisy one over the whole range, and a smooth 10-bit clip's frames
    (chip_smoke.synth_frames10, 64x128)."""
    rng = np.random.default_rng(10)
    sat = rng.choice([0, MX], (H, W)).astype(np.int32)
    noisy = rng.integers(0, MX + 1, (H, W)).astype(np.int32)
    return sat, noisy, chip_smoke.synth_frames10(3, H, W, seed=7)


# ---------------------------------------------------------------------------
# the two engines' split at 10 bits: the spec model's refinement clamp
# ---------------------------------------------------------------------------


def test_refine_clamp_parts_engine_and_spec_model():
    """The half- and quarter-pel refinement clamps its interpolated
    prediction at (1 << bd) - 1 in the reference engine (coding/me.py
    quarter_phase_planes) and in the port, but at 255 in the spec model
    (spec/decide.py refine_size_pass calls spec/inter.py mc_luma without
    the bit depth): on a 10-bit block the port equals the reference
    engine and the spec model differs, and the spec model equals the
    reference engine run at 8 bits."""
    rng = np.random.default_rng(0)
    orig = rng.integers(0, 1024, (16, 16)).astype(np.int32)
    ref = rng.integers(0, 1024, (16, 16)).astype(np.int32)
    refp = np.pad(ref, REF_MARGIN, mode="edge")
    mv = np.zeros((1, 1, 2), np.int32)
    lam = sdec.lambda_satd_fp(32)

    def ref_engine(bd):
        return jme.refine_pass(
            jnp.asarray(orig), jnp.asarray(refp), jnp.asarray(mv),
            np.int32(lam), s=16, frame_w=16, frame_h=16, bd=bd,
            planes=jme.quarter_phase_planes(jnp.asarray(refp), bd))

    want = ref_engine(BD)
    got = tme.refine_pass(T(orig), T(refp), T(mv), lam, s=16, frame_w=16,
                          frame_h=16, bd=BD)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    spec = sdec.refine_size_pass(orig, refp, mv, 16, lam)
    assert int(spec[0][0, 0]) != int(got[0][0, 0])
    at8 = ref_engine(8)
    _eq(spec[0], at8[0])
    _eq(spec[1], at8[1])


# ---------------------------------------------------------------------------
# motion search and decisions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 16, 32])
def test_refine_and_bi_cost_10bit(s):
    """quarter_phase_planes, refine_pass and bi_cost_pass (with BCW) at
    bd=10 on saturated and noisy references, against the reference's."""
    sat, noisy, _ = _planes10()
    r0 = np.pad(sat, REF_MARGIN, mode="edge")
    r1 = np.pad(noisy, REF_MARGIN, mode="edge")
    pl = [tme.quarter_phase_planes(T(r), BD) for r in (r0, r1)]
    jpl = [jme.quarter_phase_planes(jnp.asarray(r), BD) for r in (r0, r1)]
    for a, b in zip(pl, jpl):
        _eq(a, b)
    rng = np.random.default_rng(s)
    g = (H // s, W // s, 2)
    imv = rng.integers(-16, 17, g).astype(np.int32)
    wc, wm = jme.refine_pass(jnp.asarray(noisy), jnp.asarray(r0),
                             jnp.asarray(imv), np.int32(LAM), s=s,
                             frame_w=W, frame_h=H, bd=BD, planes=jpl[0])
    gc, gm = tme.refine_pass(T(noisy), T(r0), T(imv), LAM, s=s, frame_w=W,
                             frame_h=H, bd=BD, planes=pl[0])
    _eq(gc, wc)
    _eq(gm, wm)
    m0 = (rng.integers(-60, 61, g) * 4).astype(np.int32)
    m1 = (rng.integers(-60, 61, g) * 4).astype(np.int32)
    bfp = jest.decision_bits(0, QP).bcw_fp
    want = jme.bi_cost_pass(
        jnp.asarray(sat), jnp.asarray(r0), jnp.asarray(r1), jnp.asarray(m0),
        jnp.asarray(m1), np.int32(LAM), jnp.asarray(np.asarray(bfp, np.int32)),
        s=s, frame_w=W, frame_h=H, bd=BD, bcw=True, planes0=jpl[0],
        planes1=jpl[1])
    got = tme.bi_cost_pass(T(sat), T(m0), T(m1), LAM, s=s, frame_w=W,
                           frame_h=H, bd=BD, bcw=True, bcw_fp=bfp,
                           planes0=pl[0], planes1=pl[1])
    for a, b in zip(got, want):
        _eq(a, b)


def test_me_sad_twin_10bit_equals_xla_and_pallas():
    """The dense stage's twin on 10-bit samples (the kernel's FP32
    differences are exact below 2^16) against the reference's XLA stage
    and its Pallas kernel in interpret mode."""
    _, noisy, _ = _planes10()
    ref = np.roll(noisy, (1, -2), (0, 1))
    ref[:8] = MX
    refp80 = jnp.asarray(np.pad(ref, REF_MARGIN, mode="edge"))
    xla = jme._me_pass_impl(jnp.asarray(noisy), refp80, jnp.int32(LAM),
                            frame_w=W, frame_h=H, tt=False, ext=False)
    pal = jme.me_pass_pallas_dense(jnp.asarray(noisy), refp80, LAM,
                                   frame_w=W, frame_h=H, tt=False,
                                   interpret=True)
    got = kme.me_sad(T(noisy), T(np.pad(ref, 16, mode="edge")), LAM)
    for k, (c, m), (xc, xm), (pc, pm) in zip(kme.KEYS, got, xla, pal):
        for a, b, b2 in ((c, xc, pc), (m, xm, pm)):
            _eq(a, b, f"key {k} vs XLA")
            _eq(a, b2, f"key {k} vs Pallas")


@pytest.mark.parametrize("s", [8, 16, 32])
def test_size_pass_10bit(s):
    """The intra size pass with MIP, MRL and ISP on a 10-bit frame with
    saturated corners, against the reference's."""
    _, _, frames = _planes10()
    plane = frames[0][0].copy()
    plane[:16, :16] = MX
    plane[-16:, -16:] = 0
    buf = np.zeros((H + 1 + trecon.MARGIN, W + 1 + trecon.MARGIN), np.int32)
    buf[1:H + 1, 1:W + 1] = plane
    B = jest.decision_bits(2, 30)
    flags = dict(mip=True, mrl=True, isp=True)
    got = tdecide.size_pass(T(buf), 700, s=s, frame_w=W, frame_h=H, bd=BD,
                            B=B, **flags)
    want = jdecide.size_pass(jnp.asarray(buf), np.int32(700), s=s,
                             frame_w=W, frame_h=H, bd=BD, B=B, **flags)
    for g, w_ in zip(got, want):
        _eq(g, w_)


# ---------------------------------------------------------------------------
# transforms, quantisation and the trellis
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_transforms_rdoq_dq_10bit(n):
    """Every transform pair at +-1023 residuals (float64 products stay
    below 2^27 there, far inside the 2^53 of exact integers), the RDOQ
    quantiser, the dequantiser, and the trellis with its dequantiser, at
    the 10-bit transform shift and q_bits, against the reference's."""
    rng = np.random.default_rng(n)
    x = rng.choice([-MX, MX], (6, n, n)).astype(np.int32)
    x[0], x[1] = MX, -MX
    x[2] = rng.integers(-MX, MX + 1, (n, n))
    kinds = [trom.DCT2] + ([trom.DST7, trom.DCT8] if n in trom.MTS_SIZES
                           else [])
    for kh in kinds:
        for kv in kinds:
            c = ttf.forward_transform(T(x), n, n, kh, kv, BD)
            _eq(c, jtf.forward_transform(jnp.asarray(x), n, n, kh, kv, BD))
            _eq(ttf.inverse_transform(c, n, n, kh, kv, BD),
                jtf.inverse_transform(jnp.asarray(c.numpy()), n, n, kh, kv,
                                      BD))
    coef = ttf.forward_transform(T(x), n, n, bd=BD)
    jc = jnp.asarray(coef.numpy())
    for qp in (22, 37):
        lam = lambda_rd_int(qp)
        lev = ttf.quantize(coef, n, n, qp, bd=BD, rdoq=True, lam_rd=lam)
        _eq(lev, jtf.quantize(jc, n, n, qp, bd=BD, rdoq=True,
                              lam_rd=jnp.int32(lam)))
        _eq(ttf.dequantize(lev, n, n, qp, BD),
            jtf.dequantize(jnp.asarray(lev.numpy()), n, n, qp, BD))
        dq = ttf.quantize_dq(coef, n, n, qp, lam, BD)
        want = _jit(("dq", n), lambda c, q, la: jtf.quantize_dq_j(
            c, n, n, q, la, BD), vmap=(0, None, None))(jc, qp, lam)
        _eq(dq, want)
        _eq(ttf.dequantize_dq(dq, n, n, qp, BD),
            _jit(("ddq", n), lambda v, q: jtf.dequantize_dq_j(v, n, n, q, BD),
                 vmap=(0, None))(jnp.asarray(dq.numpy()), qp))
        assert dq.abs().sum() > 0


@pytest.mark.parametrize("s", [8, 16])
def test_choose_tx_10bit(s):
    """The MTS/LFNST choice with RDOQ and with DQ on 10-bit residuals,
    against the reference's choose_tx_j."""
    rng = np.random.default_rng(40 + s)
    r = rng.integers(-MX, MX + 1, (6, s, s)).astype(np.int32)
    r[0], r[1] = MX, -MX
    md = rng.integers(0, 67, 6).astype(np.int32)
    for dq in (False, True):
        got = ttf.choose_tx(T(r), s, QP, LAM_RD, T(md), BD, mts=True,
                            lfnst=True, rdoq=True, dq=dq)
        want = _jit(("tx", s, dq), lambda a, m: jtf.choose_tx_j(
            a, s, QP, jnp.int32(LAM_RD), m, BD, mts=True, lfnst=True,
            rdoq=True, dq=dq), vmap=(0, 0))(jnp.asarray(r), jnp.asarray(md))
        for a, b in zip(got, want):
            _eq(a, b)


# ---------------------------------------------------------------------------
# the leaf classes of the wave and phase A, with a 1024-entry LMCS model
# ---------------------------------------------------------------------------


def _carries10(seed: int):
    """The port's carry (frame axis of 1, Cb and Cr stacked, the LMCS
    LUTs) and the reference's 14-tuple: 10-bit recon buffers holding
    'already reconstructed' samples (half saturated), zero level planes,
    the mapped source of the 10-bit clip's frame 1."""
    _, _, frames = _planes10()
    rng = np.random.default_rng(seed)
    m = trecon.MARGIN
    by = rng.integers(0, MX + 1, (H + 1 + m, W + 1 + m)).astype(np.int32)
    by[:, ::2] = rng.choice([0, MX], by[:, ::2].shape)
    bc = rng.integers(0, MX + 1, (2, H // 2 + 1 + m,
                                  W // 2 + 1 + m)).astype(np.int32)
    src = [FWD[frames[1][0]], frames[1][1], frames[1][2]]
    z = np.zeros
    jc = (by, bc[0], bc[1], z((H, W), np.int32),
          z((H // 2, W // 2), np.int32), z((H // 2, W // 2), np.int32),
          *src) + (z((H // 8, W // 8), np.int32),) * 5
    tc = dict(by=T(by[None].copy()), bc=T(bc.copy()),
              ly=T(z((1, H, W), np.int32)),
              lc=T(z((2, H // 2, W // 2), np.int32)),
              sy=T(src[0][None].copy()),
              sc=T(np.stack(src[1:]).astype(np.int32)),
              fwd=T(FWD[None]), crs=T(CRS[None]))
    for k in ("b", "l", "s"):
        tc[k + "cb"], tc[k + "cr"] = tc[k + "c"].split(1)
    for k in ("mtsp", "lfnstp", "cmodep", "sbtp"):
        tc[k] = T(z((1, H // 8, W // 8), np.int32))
    return tc, tuple(jnp.asarray(a) for a in jc)


@functools.lru_cache(maxsize=None)
def _refs10():
    """The padded (l0 y, cb, cr, l1 y, cb, cr) references of a picture
    twice the tile's width: saturated on the left, the clip's frame 0 and
    2 on the right (a tile at x = 128 reads the right half)."""
    sat, noisy, frames = _planes10()
    out = []
    for left, fr in ((sat, frames[0]), (noisy, frames[2])):
        planes = [np.concatenate([left, fr[0]], 1),
                  np.concatenate([left[::2, ::2], fr[1]], 1),
                  np.concatenate([left[1::2, 1::2], fr[2]], 1)]
        out += list(trecon.pad_refs_dev([T(p) for p in planes]))
    return out


def _check_carry(tc, jc, what):
    _eq(tc["by"][0], jc[0], f"{what} by")
    for i, k in enumerate(("bcb", "bcr", "ly", "lcb", "lcr")):
        _eq(tc[k][0], jc[1 + i], f"{what} {k}")


def _grid_rows(rng, s_w: int, s_h: int, k: int, op: int):
    nb = (H // s_h) * (W // s_w)
    pos = rng.permutation(nb)[:k]
    rows = np.zeros((k, 17), np.int32)
    rows[:, 0] = op
    rows[:, 1] = pos % (W // s_w) * s_w
    rows[:, 2] = pos // (W // s_w) * s_h
    return rows


_GEO = dict(frame_w=W, frame_h=H, bd=BD, encode=True, rdoq=True)


@pytest.mark.parametrize("kind", ["intra8", "isp16", "rect16x8", "ciip16"])
def test_leaf_classes_10bit(kind):
    """The phase-B leaf classes at bd=10 with the 1024-entry model: square
    intra with MTS, LFNST, MIP, MRL, CCLM and DQ; ISP; a rect shape; CIIP
    at a tile's reference offset (x = 128 of the reference picture),
    against the reference's batches."""
    rng = np.random.default_rng(len(kind))
    tc, jc = _carries10(70 + len(kind))
    crs = jnp.asarray(CRS)
    if kind == "intra8":
        rows = _grid_rows(rng, 8, 8, 16, 1)
        rows[:, 3] = rng.integers(0, 67 + 16, 16)
        rows[:, 9] = rng.integers(0, 3, 16) * (rows[:, 3] < 67)
        tools = dict(mts=True, lfnst=True, cclm=True, mip=True, dq=True)
        want = _jit(kind, functools.partial(
            jwave._intra_batch.__wrapped__, s=8, tskip=False, jccr=False,
            **tools, **_GEO))(jc, jnp.asarray(rows), QP, LAM_RD, crs)
        twave._intra_batch(tc, T(rows), rows, QP, LAM_RD, s=8, log2_ctu=6,
                           **tools, **_GEO)
    elif kind == "isp16":
        rows = _grid_rows(rng, 16, 16, 8, 2)
        rows[:, 3] = rng.integers(0, 67, 8)
        rows[:, 15] = 2
        want = _jit(kind, functools.partial(
            jwave._isp_batch.__wrapped__, s=16, d=2, cclm=True, jccr=False,
            dq=False, **_GEO))(jc, jnp.asarray(rows), QP, LAM_RD, crs)
        twave._isp_batch(tc, T(rows), rows, QP, LAM_RD, s=16, d=2,
                         log2_ctu=6, cclm=True, **_GEO)
    elif kind == "rect16x8":
        op = tplan.OP_RECT_INTRA0 + tplan.RECT_SHAPES.index((16, 8))
        rows = _grid_rows(rng, 16, 8, 12, op)
        rows[:, 3] = rng.integers(0, 67, 12)
        want = _jit(kind, functools.partial(
            jwave._rect_batch.__wrapped__, w=16, h=8, dq=True, **_GEO))(
                jc, jnp.asarray(rows), QP, LAM_RD, crs)
        twave._rect_batch(tc, T(rows), QP, LAM_RD, w=16, h=8, log2_ctu=6,
                          dq=True, **_GEO)
    else:
        rows = _grid_rows(rng, 16, 16, 8, 8)
        rows[:, 4:6] = rng.integers(-200, 201, (8, 2)) * 4
        rows[:, 11:13] = rng.integers(-200, 201, (8, 2)) * 4
        rows[:, 13] = np.arange(8) % 3
        rows[:, 14] = rng.integers(0, 3, 8)
        refs = _refs10()
        want = jwave._ciip_batch(
            jc, jnp.asarray(rows), tuple(jnp.asarray(r.numpy()) for r in refs),
            QP, LAM_RD, jnp.asarray(FWD), crs, 128, 0, s=16, dq=True,
            **_GEO)
        tc["roff"] = T(np.array([[0, 128, 0]], np.int32))
        twave._ciip_batch(tc, T(rows), [r[None] for r in refs], QP, LAM_RD,
                          s=16, log2_ctu=6, dq=True, **_GEO)
    _check_carry(tc, want, kind)


def _phase_a_rows(s: int):
    """(B, 13) phase-A rows with every inter tool's columns mixed; padded
    rows at the end."""
    rng = np.random.default_rng(s)
    nb = (H // s) * (W // s)
    k = nb - 2
    pos = rng.permutation(nb)[:k]
    rows = np.zeros((nb, 13), np.int32)
    rows[:k, 0] = pos % (W // s) * s
    rows[:k, 1] = pos // (W // s) * s
    rows[:k, 2:6] = (rng.integers(-60, 61, (k, 4)) * 4).astype(np.int32)
    rows[:k, 6] = rng.choice([0, 1, 2, 2], k)
    rows[:, 7] = 1
    rows[:k, 7] = rng.integers(0, 3, k)
    rows[:k, 9] = np.where(rows[:k, 6] == 2, rng.integers(0, 65, k), 0)
    uni = rows[:k, 6] < 2
    rows[:k, 10] = uni
    rows[:k, 11:13] = np.where(uni[:, None],
                               rng.choice([-8, 4, 8, -24, 36], (k, 2)), 0)
    rows[k:, :2] = 1 << 20
    return rows


@pytest.mark.parametrize("kind,rox", [("sq16", 128), ("rect32x8", 128)])
def test_phase_a_10bit(kind, rox):
    """Phase A at bd=10 with the 1024-entry model: square leaves with
    BCW, GPM, DMVR, BDOF, affine with PROF, SBT and DQ, and rect leaves
    with DQ, at a tile's reference offset (rox), against the reference's
    passes with ref_off."""
    refs = _refs10()
    jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)
    tc, jc = _carries10(30 + rox)
    if rox:
        tc["roff"] = T(np.array([[0, rox, 0]], np.int32))
    lut = (jnp.asarray(FWD), jnp.asarray(CRS))
    if kind == "sq16":
        rows = _phase_a_rows(16)
        flags = dict(dmvr=True, bdof=True, gpm=True, affine=True, sbt=True,
                     dq=True)
        fn = functools.partial(jrecon._inter_batch_pass, s=16, qp=QP, bd=BD,
                               encode=True, frame_w=W, frame_h=H, rdoq=True,
                               lam_rd=LAM_RD, rox=rox, roy=0, **flags)
        trecon._inter_batch_pass(
            tc, np.concatenate([rows, np.zeros((len(rows), 1), np.int32)],
                               1), [r[None] for r in refs], 16, QP, BD, True,
            rdoq=True, lam_rd=LAM_RD, **flags)
    else:
        rng = np.random.default_rng(5)
        k = 20
        pos = rng.permutation((H // 8) * (W // 32))[:k]
        rows = np.zeros((k, 7), np.int32)
        rows[:, 0] = pos % (W // 32) * 32
        rows[:, 1] = pos // (W // 32) * 8
        rows[:, 2:6] = rng.integers(-200, 201, (k, 4)) * 4
        rows[:, 6] = np.arange(k) % 3
        fn = functools.partial(jrecon._inter_batch_pass_rect, w=32, h=8,
                               qp=QP, bd=BD, encode=True, rdoq=True,
                               lam_rd=LAM_RD, dq=True, rox=rox, roy=0)
        trecon._inter_batch_pass_rect(
            tc, np.concatenate([rows, np.zeros((k, 1), np.int32)], 1),
            [r[None] for r in refs], 32, 8, QP, BD, True, rdoq=True,
            lam_rd=LAM_RD, dq=True)
    want = _jit((kind, rox), lambda c, r, rf, fl, cl, fn=fn: fn(
        c, r, rf, fwd_lut=fl, crs_lut=cl))(jc, jnp.asarray(rows), jrefs,
                                           *lut)
    _check_carry(tc, want, f"{kind} rox={rox}")
    assert tc["ly"].any()


# ---------------------------------------------------------------------------
# loop filters
# ---------------------------------------------------------------------------


def _recon10(seed):
    """A 10-bit source (the clip's frame 0), a noisy reconstruction of it
    with saturated runs, and its intra decisions."""
    _, _, frames = _planes10()
    rng = np.random.default_rng(seed)
    rec = [np.clip(p + rng.integers(-40, 41, p.shape), 0, MX).astype(
        np.int32) for p in frames[0]]
    rec[0][:, :16] = MX * (rng.random((H, 16)) < 0.5)
    return frames[0], rec, sdec.decide_frame(frames[0][0], 32, BD)


@pytest.mark.parametrize("qp", [27])
def test_deblock_sao_10bit(qp):
    """Deblocking (beta and tc scaled by << (bd - 8)), the SAO decision
    (band shift at bd) and apply, and the LMCS inverse map before them,
    against the reference's finish_frame_j at bd=10."""
    orig, rec, dec = _recon10(qp)
    tdec = state.decisions_from_numpy(dec)
    _eq(tlf.deblock_frame_j([T(p) for p in rec], tdec, qp, BD)[0],
        jlf.deblock_frame_j(rec, dec, qp, BD)[0])
    lam = int(round(0.57 * (2.0 ** ((qp - 12) / 3.0)) * 256.0))
    mapped = [FWD[rec[0]], rec[1], rec[2]]
    for inv in (None, INV):
        src = rec if inv is None else mapped
        want = jlf.finish_frame_j(src, dec, qp, lam, orig, inv_lut=inv,
                                  bd=BD)
        got = tlf.finish_frame_j([T(p) for p in src], tdec, qp, lam, orig,
                                 inv_lut=inv, bd=BD)
        for i, (a, b) in enumerate(zip(got, want)):
            _eq(a, b, f"output {i} inv={inv is not None}")
    assert (got[3] > 0).any()


def test_alf_10bit():
    """ALF with CC-ALF at bd=10: the host derivation (copied spec/alf.py)
    gives the reference's parameters, and the filters on them equal the
    reference's apply_alf_frame_j (clipping at bd)."""
    orig, rec, _ = _recon10(3)
    from vvctpu_torch.spec import alf as talf
    tp = talf.derive_alf_frame(orig, rec, 27, 64, BD)
    jp = jalf.derive_alf_frame(orig, rec, 27, 64, BD)
    assert tp.equal(jp) and tp.enabled
    got = tlf.apply_alf_frame([T(p) for p in rec], tp, 64, BD)
    want = jlf.apply_alf_frame_j(rec, jp, 64, BD)
    for c in range(3):
        _eq(got[c], want[c], f"component {c}")


# ---------------------------------------------------------------------------
# end to end against the spec model
# ---------------------------------------------------------------------------


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


_ALL = dict(mts=True, lfnst=True, cclm=True, mip=True, mrl=True, isp=True,
            mmvd=True, bcw=True, amvr=True, smvd=True, ciip=True, gpm=True,
            affine=True, dmvr=True, bdof=True, sbt=True, dq=True, alf=True,
            lmcs=True, mtt=True, tt=True)
# test_codec_roundtrip.py:146's clip; a GOP2 clip of 8-bit amplitude coded
# at bit_depth=10 with every tool of the slice, on which the reference
# engine equals the spec model (no refinement reaches the clamp)
_CASES = {
    "ai": (chip_smoke.ai10_frames, dict(qp=32, bit_depth=10)),
    "gop2_all_tools": (lambda: motion_frames(3, 64, 64, seed=85),
                       dict(qp=30, bit_depth=10, intra_period=0, gop=2,
                            **_ALL)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_10bit_equals_spec_model(case):
    """The port's bytes, recon and whole-plane decisions equal the spec
    model's at bit_depth=10; each decoder decodes the other's stream,
    hashes verified."""
    mk, kw = _CASES[case]
    frames = mk()
    cfg = tseq.EncoderConfig(**kw)
    decs, sdecs = [], []
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu",
                                        decisions_out=decs)
    sdata, srec, _ = tseq.encode_sequence(frames, cfg, decisions_out=sdecs)
    assert data == sdata and _same(rec, srec)
    assert len(decs) == len(sdecs)
    assert all(a.equal(b) for a, b in zip(decs, sdecs))
    out, sps = tenc.decode_sequence(sdata, check_hash=True, device="cpu")
    assert sps.bit_depth == 10 and _same(out, srec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)
