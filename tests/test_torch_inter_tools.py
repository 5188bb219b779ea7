"""VVC's inter-prediction toolset in the port against its JAX twins in
vvctpu, at tolerance 0 on seeded inputs: bi_cost_pass with BCW, the DMVR,
BDOF and affine (PROF) predictors, the CIIP, GPM and affine decision
passes, the P- and B-frame decisions with every tool, phase A with each
tool and the CIIP leaf class of the wave."""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.cabac import estimate as jest  # noqa: E402
from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.coding import me as jme  # noqa: E402
from vvctpu.kernels import mc as jmc  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu.spec import codec as scodec  # noqa: E402
from vvctpu.spec import sequence as sseq  # noqa: E402
from vvctpu.spec.inter import REF_MARGIN  # noqa: E402
from vvctpu.spec.transform import lambda_rd_int  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402
from vvctpu_torch.coding import me as tme  # noqa: E402
from vvctpu_torch.kernels import mc as tmc  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402

from test_affine import synth_zoom  # noqa: E402
from test_gpm import synth_motion  # noqa: E402

torch.set_num_threads(1)
T = torch.as_tensor
H, W = 64, 128
QP = 30
LAM = 211


def _i32(a):
    return T(np.asarray(a, np.int32))


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


@functools.lru_cache(maxsize=None)
def _clip():
    """Five 64x128 frames: GPM-style occlusion content beside a zooming
    pattern, 64 columns each, so that affine, BCW and BI win blocks;
    their padded planes and the REF_MARGIN-padded luma of POC 0 and
    POC 4."""
    a = synth_motion(5, H, 64, seed=4)
    b = synth_zoom(5, H, 64, seed=5)
    frames = [[np.concatenate([a[t][c], b[t][c]], 1) for c in range(3)]
              for t in range(5)]
    sps = sseq.EncoderConfig().make_sps(W, H)
    padded = [scodec.pad_planes(f, sps) for f in frames]
    refs = [np.pad(padded[i][0], REF_MARGIN, mode="edge") for i in (0, 4)]
    return padded, refs


def _mvs(rng, n, lim=270):
    """Quarter-pel MVs in 1/16 pel, both signs, up to the ext stage's
    reach."""
    return rng.integers(-lim, lim + 1, (n, 2)).astype(np.int32) * 4


_JIT: dict = {}


def _vmap(key, fn, in_axes=0):
    """jax.jit(jax.vmap(fn)), compiled once per key across tests."""
    if key not in _JIT:
        _JIT[key] = jax.jit(jax.vmap(fn, in_axes=in_axes))
    return _JIT[key]


# ---------------------------------------------------------------------------
# motion search and the MC predictors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 16, 32])
def test_bi_cost_pass_bcw(s):
    padded, (r0, r1) = _clip()
    rng = np.random.default_rng(s)
    shape = (H // s, W // s, 2)
    mv0 = _mvs(rng, shape[0] * shape[1]).reshape(shape)
    mv1 = _mvs(rng, shape[0] * shape[1]).reshape(shape)
    bfp = jest.decision_bits(0, QP).bcw_fp
    wc, ww = jme.bi_cost_pass(
        jnp.asarray(padded[2][0]), jnp.asarray(r0), jnp.asarray(r1),
        jnp.asarray(mv0), jnp.asarray(mv1), np.int32(LAM),
        jnp.asarray(np.asarray(bfp, np.int32)), s=s, frame_w=W, frame_h=H,
        bcw=True, planes0=jme.quarter_phase_planes(jnp.asarray(r0), 8),
        planes1=jme.quarter_phase_planes(jnp.asarray(r1), 8))
    gc, gw = tme.bi_cost_pass(
        T(padded[2][0]), T(mv0), T(mv1), LAM, s=s, frame_w=W, frame_h=H,
        bcw=True, bcw_fp=bfp, planes0=tme.quarter_phase_planes(T(r0)),
        planes1=tme.quarter_phase_planes(T(r1)))
    _eq(gc, wc)
    _eq(gw, ww)


@pytest.mark.parametrize("flat", [False, True])
def test_dmvr_offset(flat):
    """Mirrored-SAD offsets per 16x16 sub-block, negative MVs and windows
    past the padded plane included; on a flat reference every offset
    ties and the first (row-major) minimum wins."""
    _, (r0, r1) = _clip()
    if flat:
        r0 = r1 = np.full_like(r0, 77)
    rng = np.random.default_rng(3)
    n = 40
    x = rng.integers(0, W // 16, n).astype(np.int32) * 16
    y = rng.integers(0, H // 16, n).astype(np.int32) * 16
    m0, m1 = _mvs(rng, n), _mvs(rng, n)
    m0[:4] = [[-16 * 95, 0], [0, 16 * 90], [16 * 200, -16 * 200], [3, -5]]
    fn = _vmap("dmvr", lambda p, q, *v: jnp.stack(
        jmc.dmvr_offset_j(p, q, v[0], v[1], 16, *v[2:])),
        in_axes=(None, None, 0, 0, 0, 0, 0, 0))
    want = fn(jnp.asarray(r0), jnp.asarray(r1), x, y, m0[:, 0], m0[:, 1],
              m1[:, 0], m1[:, 1])
    got = tmc.dmvr_offset(T(r0), T(r1), _i32(x), _i32(y), 16,
                          _i32(m0[:, 0]), _i32(m0[:, 1]), _i32(m1[:, 0]),
                          _i32(m1[:, 1]))
    _eq(got, want)
    if flat:
        assert (got.numpy() == [-2, -2]).all()


@pytest.mark.parametrize("s", [8, 16])
def test_bdof_blend(s):
    """Random, saturated (0/255 checkerboard) and flat extended
    predictions."""
    rng = np.random.default_rng(s)
    n = 24
    p0 = rng.integers(0, 256, (n, s + 2, s + 2)).astype(np.int32)
    p1 = np.clip(p0 + rng.integers(-40, 41, p0.shape), 0, 255).astype(
        np.int32)
    yy, xx = np.mgrid[0:s + 2, 0:s + 2]
    p0[0] = 255 * ((yy + xx) % 2)
    p1[0] = 255 - p0[0]
    p0[1] = p1[1] = 128
    p0[2], p1[2] = 255, 0
    want = _vmap(("bdof", s), lambda a, b: jmc.bdof_blend_j(a, b, 8))(
        jnp.asarray(p0), jnp.asarray(p1))
    _eq(tmc.bdof_blend(T(p0), T(p1), 8), want)


@pytest.mark.parametrize("s", [16, 32])
def test_affine_predictors(s):
    """Luma with and without PROF, chroma and the granule MVs, over
    negative CPMVs, the AFF_DELTAS grid and MVs past the padded plane,
    from a two-plane stack (``f``) against each plane alone."""
    padded, (r0, r1) = _clip()
    rng = np.random.default_rng(7 + s)
    n = 30
    x = rng.integers(0, W // s, n).astype(np.int32) * s
    y = rng.integers(0, H // s, n).astype(np.int32) * s
    b = _mvs(rng, n)
    b[:3] = [[-16 * 90, 4], [16 * 85, -16 * 88], [-7, 13]]
    dm = rng.choice([-8, -4, 0, 4, 8, -13, 29], (n, 2)).astype(np.int32)
    f = rng.integers(0, 2, n).astype(np.int32)
    stack = T(np.stack([r0, r1]))
    cref = [np.pad(padded[i][1], REF_MARGIN // 2, mode="edge")
            for i in (0, 4)]
    args = [_i32(v) for v in (x, y, b[:, 0], b[:, 1], dm[:, 0], dm[:, 1])]
    got = {p: tmc.affine_pred_luma(stack, *args[:2], s, *args[2:], 8,
                                   prof=p, f=_i32(f)).numpy()
           for p in (False, True)}
    gotc = tmc.affine_pred_chroma(T(np.stack(cref)), args[0] // 2,
                                  args[1] // 2, s // 2, *args[2:], s, 8,
                                  f=_i32(f)).numpy()
    gotg = tmc.affine_granule_mvs(*args[2:], s).numpy()
    ax = (None, 0, 0, 0, 0, 0, 0)
    for plane in (0, 1):
        m = f == plane
        a = [jnp.asarray(v[m]) for v in (x, y, b[:, 0], b[:, 1], dm[:, 0],
                                         dm[:, 1])]
        for p in (False, True):
            want = _vmap(("aff", s, p), lambda r, *v, p=p:
                         jmc.affine_pred_luma_j(r, v[0], v[1], s, *v[2:], 8,
                                                prof=p), ax)(
                jnp.asarray((r0, r1)[plane]), *a)
            _eq(got[p][m], want, f"prof={p}")
        wantc = _vmap(("affc", s), lambda r, *v: jmc.affine_pred_chroma_j(
            r, v[0] // 2, v[1] // 2, s // 2, *v[2:], s, 8), ax)(
            jnp.asarray(cref[plane]), *a)
        _eq(gotc[m], wantc, "chroma")
    wantg = _vmap(("affg", s), lambda *v: jmc.affine_granule_mvs_j(
        *v, s))(*[jnp.asarray(v) for v in (b[:, 0], b[:, 1], dm[:, 0],
                                           dm[:, 1])])
    _eq(gotg, wantg)


# ---------------------------------------------------------------------------
# decision passes
# ---------------------------------------------------------------------------


def _buf(y):
    h, w = y.shape
    buf = np.zeros((h + 1 + tdecide.intra_pred.MARGIN,
                    w + 1 + tdecide.intra_pred.MARGIN), np.int32)
    buf[1:h + 1, 1:w + 1] = y
    return buf


@pytest.mark.parametrize("s", [8, 16, 32])
def test_ciip_pass(s):
    padded, (r0, r1) = _clip()
    rng = np.random.default_rng(20 + s)
    nb = (H // s) * (W // s)
    shape = (H // s, W // s)
    kind = rng.integers(0, 4, shape).astype(np.int32)
    mv0 = _mvs(rng, nb).reshape(shape + (2,))
    mv1 = _mvs(rng, nb).reshape(shape + (2,))
    bw = rng.integers(0, 3, shape).astype(np.int32)
    buf = _buf(padded[2][0])
    want = jdecide.ciip_pass(jnp.asarray(buf), jnp.asarray(r0),
                             jnp.asarray(r1), jnp.asarray(kind),
                             jnp.asarray(mv0), jnp.asarray(mv1),
                             jnp.asarray(bw), s=s, frame_w=W, frame_h=H)
    got = tdecide.ciip_pass(T(buf), T(r0), T(r1), T(kind), T(mv0), T(mv1),
                            T(bw), s=s, frame_w=W, frame_h=H)
    for g, w_ in zip(got, want):
        _eq(g, w_)


@pytest.mark.parametrize("s", [8, 16, 32])
def test_gpm_pass(s):
    padded, (r0, r1) = _clip()
    rng = np.random.default_rng(30 + s)
    shape = (H // s, W // s, 2)
    mv0 = _mvs(rng, shape[0] * shape[1]).reshape(shape)
    mv1 = _mvs(rng, shape[0] * shape[1]).reshape(shape)
    mv0[0, 0] = mv1[0, 0] = 0     # equal predictions: every mask ties
    want = jdecide.gpm_pass(jnp.asarray(padded[2][0]), jnp.asarray(r0),
                            jnp.asarray(r0), jnp.asarray(mv0),
                            jnp.asarray(mv1), s=s, frame_w=W, frame_h=H)
    got = tdecide.gpm_pass(T(padded[2][0]), T(r0), T(r0), T(mv0), T(mv1),
                           s=s, frame_w=W, frame_h=H)
    _eq(got[0], want[0])
    _eq(got[1], want[1])
    assert got[1][0, 0] == 0


@pytest.mark.parametrize("s", [16, 32])
def test_affine_pass(s):
    padded, (r0, _) = _clip()
    rng = np.random.default_rng(40 + s)
    shape = (H // s, W // s, 2)
    base = _mvs(rng, shape[0] * shape[1], 70).reshape(shape)
    aff_fp = jest.decision_bits(0, QP).aff_fp
    want = jdecide.affine_pass(jnp.asarray(padded[2][0]), jnp.asarray(r0),
                               jnp.asarray(base), np.int32(LAM),
                               np.int32(aff_fp), s=s, frame_w=W, frame_h=H)
    got = tdecide.affine_pass(T(padded[2][0]), T(r0), T(base), LAM, aff_fp,
                              s=s, frame_w=W, frame_h=H)
    _eq(got[0], want[0])
    _eq(got[1], want[1])


_ALL_P = dict(mip=True, mrl=True, isp=True, ciip=True, affine=True)
_ALL_B = dict(_ALL_P, bcw=True, gpm=True)


@functools.lru_cache(maxsize=None)
def _decide(kind: str):
    """(port, reference) decisions with every tool: P frame POC 4 from
    POC 0, or B frame POC 2 between POC 0 and POC 4."""
    padded, (r0, r1) = _clip()
    if kind == "p":
        want = jdecide.decide_frame_p(padded[4][0], jnp.asarray(r0), QP, 8,
                                      prepadded=True, me_ext=True, **_ALL_P)
        got = tdecide.decide_frame_p(padded[4][0], T(r0), QP, 8,
                                     device="cpu", me_ext=True, **_ALL_P)
    else:
        want = jdecide.decide_frame_b(padded[2][0], jnp.asarray(r0),
                                      jnp.asarray(r1), QP, 8, prepadded=True,
                                      me_ext=True, **_ALL_B)
        got = tdecide.decide_frame_b(padded[2][0], T(r0), T(r1), QP, 8,
                                     device="cpu", me_ext=True, **_ALL_B)
    return got, state.decisions_from_numpy(want)


@pytest.mark.parametrize("kind", ["p", "b"])
def test_decide_frame_with_tools(kind):
    got, want = _decide(kind)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            _eq(a, b, f.name)
    assert got.equal(want)
    inter = got.inter8 > 0
    assert inter.any() and (~inter).any()
    if kind == "p":
        assert got.aff8.any()
    else:
        assert (got.dir8[inter] == 2).any()


# ---------------------------------------------------------------------------
# reconstruction: phase A with each tool, the CIIP leaf class
# ---------------------------------------------------------------------------

_LAM_RD = lambda_rd_int(QP)


def _carries(seed: int):
    """The same buffers as the port's carry dict (frame axis of 1, Cb and
    Cr stacked) and the reference's single-frame 14-tuple: recon buffers
    holding random 'already reconstructed' samples, zero level planes,
    the source planes of POC 2."""
    padded, _ = _clip()
    rng = np.random.default_rng(seed)
    m = trecon.MARGIN
    by = rng.integers(0, 256, (H + 1 + m, W + 1 + m)).astype(np.int32)
    bc = rng.integers(0, 256, (2, H // 2 + 1 + m,
                               W // 2 + 1 + m)).astype(np.int32)
    z = np.zeros
    jc = (by, bc[0], bc[1], z((H, W), np.int32),
          z((H // 2, W // 2), np.int32), z((H // 2, W // 2), np.int32),
          *padded[2]) + (z((H // 8, W // 8), np.int32),) * 5
    tc = dict(by=T(by[None].copy()), bc=T(bc.copy()),
              ly=T(z((1, H, W), np.int32)),
              lc=T(z((2, H // 2, W // 2), np.int32)),
              sy=T(padded[2][0][None].copy()),
              sc=T(np.stack(padded[2][1:]).astype(np.int32)))
    for k in ("b", "l", "s"):
        tc[k + "cb"], tc[k + "cr"] = tc[k + "c"].split(1)
    return tc, tuple(jnp.asarray(a) for a in jc)


def _refs6():
    """The padded (l0 y, cb, cr, l1 y, cb, cr) references, POCs 0 and 4."""
    padded, _ = _clip()
    return [trecon.pad_refs_dev([T(p) for p in padded[i]])[c]
            for i in (0, 4) for c in range(3)]


def _check_carry(tc, jc, what):
    for i, k in enumerate(("bcb", "bcr")):
        _eq(tc[k][0], jc[1 + i], f"{what} {k}")
    _eq(tc["by"][0], jc[0], f"{what} by")
    for i, k in enumerate(("ly", "lcb", "lcr")):
        _eq(tc[k][0], jc[3 + i], f"{what} {k}")


def _phase_a_rows(tool: str, s: int):
    """(B, 13) phase-A rows on the s-grid of the frame: random positions
    and quarter-pel MVs, BI by default, with ``tool``'s columns forced (a
    random BCW weight, GPM mask or affine dmv on uni rows; "mixed" all of
    them); padded rows (x = y = 2^20) at the end."""
    rng = np.random.default_rng(s + len(tool))
    nb = (H // s) * (W // s)
    k = nb - 2
    pos = rng.permutation(nb)[:k]
    rows = np.zeros((nb, 13), np.int32)
    rows[:k, 0] = pos % (W // s) * s
    rows[:k, 1] = pos // (W // s) * s
    rows[:k, 2:6] = _mvs(rng, 2 * k, 60).reshape(k, 4)
    rows[:k, 6] = rng.choice([0, 1, 2, 2, 2], k)
    rows[:, 7] = 1
    if tool in ("bcw", "mixed"):
        rows[:k, 7] = rng.integers(0, 3, k)
    if tool in ("gpm", "mixed"):
        rows[:k, 9] = np.where(rows[:k, 6] == 2,
                               rng.integers(0, 65, k), 0)
    if tool in ("affine", "mixed"):
        uni = rows[:k, 6] < 2
        rows[:k, 10] = uni
        rows[:k, 11:13] = np.where(
            uni[:, None], rng.choice([-8, -4, 4, 8, -24, 36], (k, 2)), 0)
    rows[k:, :2] = 1 << 20
    return rows


_A_ALL = dict(dmvr=True, bdof=True, gpm=True, affine=True)
_JA: dict = {}


@pytest.mark.parametrize("tool,s,flags", [
    ("bcw", 8, _A_ALL), ("gpm", 16, _A_ALL), ("affine", 32, _A_ALL),
    ("mixed", 16, _A_ALL), ("dmvr", 16, dict(dmvr=True)),
    ("bdof", 8, dict(bdof=True)), ("bdof", 32, dict(bdof=True)),
])
def test_inter_batch_pass_tool(tool, s, flags):
    """Phase A of one leaf size with BCW weights, GPM masks, affine with
    PROF, DMVR and BDOF (together and alone), encoding then decoding the
    port's levels: recon and levels equal the reference's."""
    rows = _phase_a_rows(tool, s)
    refs = _refs6()
    jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)
    trefs = [r[None] for r in refs]
    key = (s, tuple(sorted(flags)))
    for encode in (True, False):
        if (key, encode) not in _JA:
            _JA[key, encode] = jax.jit(functools.partial(
                jrecon._inter_batch_pass, s=s, qp=QP, bd=8, encode=encode,
                frame_w=W, frame_h=H, rdoq=True, lam_rd=_LAM_RD, **flags))
        tc, jc = _carries(s)
        if not encode:
            for k in ("ly", "lcb", "lcr"):
                tc["s" + k[1:]][:] = lev[k]
            jc = jc[:6] + (jnp.asarray(lev["ly"][0].numpy()),
                           jnp.asarray(lev["lcb"][0].numpy()),
                           jnp.asarray(lev["lcr"][0].numpy())) + jc[9:]
        want = _JA[key, encode](jc, jnp.asarray(rows), jrefs)
        trecon._inter_batch_pass(
            tc, np.concatenate([rows, np.zeros((len(rows), 1), np.int32)],
                               1), trefs, s, QP, 8, encode, rdoq=True,
            lam_rd=_LAM_RD, **flags)
        _check_carry(tc, want, f"encode={encode}")
        if encode:
            lev = {k: tc[k].clone() for k in ("ly", "lcb", "lcr")}
            assert lev["ly"].any()


@pytest.mark.parametrize("s", [8, 16, 32])
def test_ciip_batch(s):
    """The CIIP leaf class (L0, L1 and BCW-weighted BI candidates blended
    with planar intra from the reconstructed neighbours) against the
    reference's _ciip_batch."""
    rng = np.random.default_rng(50 + s)
    nb = (H // s) * (W // s)
    k = min(nb, 6)
    pos = rng.permutation(nb)[:k]
    rows = np.zeros((k, 17), np.int32)
    rows[:, 0] = 7 + (s.bit_length() - 4)
    rows[:, 1] = pos % (W // s) * s
    rows[:, 2] = pos // (W // s) * s
    rows[:, 4:6] = _mvs(rng, k, 60)
    rows[:, 11:13] = _mvs(rng, k, 60)
    rows[:, 13] = np.arange(k) % 3
    rows[:, 14] = rng.integers(0, 3, k)
    tc, jc = _carries(60 + s)
    refs = _refs6()
    want = jwave._ciip_batch(jc, jnp.asarray(rows),
                             tuple(jnp.asarray(r.numpy()) for r in refs),
                             QP, _LAM_RD, None, None, 0, 0, s=s, frame_w=W,
                             frame_h=H, bd=8, encode=True, rdoq=True,
                             dq=False)
    twave._ciip_batch(tc, T(rows), [r[None] for r in refs], QP, _LAM_RD,
                      s=s, frame_w=W, frame_h=H, log2_ctu=6, bd=8,
                      encode=True, rdoq=True)
    _check_carry(tc, want, "ciip")
