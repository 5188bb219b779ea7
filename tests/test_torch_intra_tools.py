"""The intra toolset's functions in the port (MIP, MRL, the ISP
rectangular family, CCLM, the MTS/LFNST RD choice, the chroma choice,
the RD tables and the decision pass) against their JAX twins in
vvctpu, at tolerance 0, on seeded inputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.cabac import estimate as jest  # noqa: E402
from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.core import rom  # noqa: E402
from vvctpu.core import tables_spec as jtables  # noqa: E402
from vvctpu.kernels import intra_pred as jintra  # noqa: E402
from vvctpu.kernels import transform as jtf  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.spec.codec import isp_parts  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402
from vvctpu_torch.core import tables_spec as ttables  # noqa: E402
from vvctpu_torch.kernels import intra_pred as tintra  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402

torch.set_num_threads(1)
T = torch.as_tensor


def _i32(a):
    return T(np.asarray(a, np.int32))


def _buf(h, w, seed):
    """A margin-padded (+1 top/left offset) buffer of a textured plane."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    plane = (100 + 60 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
             + rng.integers(-20, 20, (h, w))).clip(0, 255).astype(np.int32)
    buf = np.zeros((h + 1 + tintra.MARGIN, w + 1 + tintra.MARGIN), np.int32)
    buf[1:h + 1, 1:w + 1] = plane
    return buf


_JIT: dict = {}


def _vmap(key, fn, in_axes=0):
    """jax.jit(jax.vmap(fn)), compiled once per key across tests."""
    if key not in _JIT:
        _JIT[key] = jax.jit(jax.vmap(fn, in_axes=in_axes))
    return _JIT[key]


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


# ---------------------------------------------------------------------------
# RD tables
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flat", [False, True])
def test_tx_tables(flat, monkeypatch):
    """The port's host tables and device level weights equal the JAX
    engine's device tables (tx_tables_j)."""
    if flat:
        monkeypatch.setenv("VVCTPU_FLAT_BITS", "1")
    for qp in (0, 17, 22, 32, 37, 51):
        want = jest.tx_tables_j(qp)
        tb = ttf.tx_bits(qp)
        got = (tb.mts_fp, tb.lfnst_fp, tb.sbt_fp,
               ttf.lvl_weights(qp, "cpu").numpy())
        for a, b in zip(got, want):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# MIP and MRL
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 16, 32])
def test_mip_every_id(s):
    rng = np.random.default_rng(s)
    top = rng.integers(0, 256, (16, 2 * s + 1)).astype(np.int32)
    left = rng.integers(0, 256, (16, 2 * s + 1)).astype(np.int32)
    top[0], left[0] = 255, 0          # saturating boundary
    ids = np.arange(16, dtype=np.int32)
    got = tintra.mip_predict(T(top), T(left), T(ids), s=s).numpy()
    f = jax.jit(jax.vmap(lambda t, l, m: jintra.mip_predict_j(t, l, m,
                                                             s=s)))
    np.testing.assert_array_equal(got, np.asarray(f(top, left, ids)))


@pytest.mark.parametrize("k", [1, 2])
def test_mrl_lines(k):
    """Reference lines 1 and 2 at every block of a 96x64 frame (frame
    edges, where the far line leaves the frame, included), coded-order
    and in-frame availability, every angular family."""
    w, h = 96, 64
    buf = _buf(h, w, k)
    rng = np.random.default_rng(10 + k)
    for s in (8, 16, 32):
        pts = [(x, y) for y in range(0, h, s) for x in range(0, w, s)]
        xs, ys = _i32([p[0] for p in pts]), _i32([p[1] for p in pts])
        modes = rng.integers(0, 67, len(pts)).astype(np.int32)
        kk = torch.full_like(xs, k)
        for iof in (False, True):
            geo = dict(s=s, is_luma=True, frame_w=w, frame_h=h, n_ctu_x=1,
                       in_frame_only=iof)
            top, left = tintra.build_references(T(buf), xs, ys, ref_line=kk,
                                                **geo)
            pred = tintra.predict(top, left, T(modes), s=s, is_luma=True,
                                  ref_line=kk)
            jt, jl = _vmap(("mrl", s, iof), lambda b, x, y, kk: (
                jintra.build_references(b, x, y, ref_line=kk, **geo)),
                (None, 0, 0, 0))(jnp.asarray(buf), jnp.asarray(xs.numpy()),
                                 jnp.asarray(ys.numpy()),
                                 jnp.full(len(pts), k, jnp.int32))
            _eq(top, jt)
            _eq(left, jl)
            jp = _vmap(("mrlp", s), lambda t, l, m, kk: jintra.predict(
                t, l, m, s=s, is_luma=True, ref_line=kk))(
                    jt, jl, jnp.asarray(modes), jnp.full(len(pts), k,
                                                         jnp.int32))
            _eq(pred, jp)


# ---------------------------------------------------------------------------
# the rectangular family (ISP stripes)
# ---------------------------------------------------------------------------

_STRIPES = sorted({(w_, h_) for s in (8, 16, 32) for d in (1, 2)
                   for (_, _, w_, h_) in isp_parts(s, d)})


@pytest.mark.parametrize("shape", _STRIPES)
def test_predict_rect_every_mode(shape):
    w, h = shape
    rng = np.random.default_rng(w * 100 + h)
    n = rom.NUM_LUMA_MODE
    top = rng.integers(0, 256, (n, 2 * w + 1)).astype(np.int32)
    left = rng.integers(0, 256, (n, 2 * h + 1)).astype(np.int32)
    left[:, 0] = top[:, 0]
    modes = np.arange(n, dtype=np.int32)
    for is_luma in (True, False):
        got = tintra.predict_rect(T(top), T(left), T(modes), w=w, h=h,
                                  is_luma=is_luma).numpy()
        f = jax.jit(jax.vmap(lambda t, l, m: jintra.predict_rect(
            t, l, m, w=w, h=h, is_luma=is_luma)))
        np.testing.assert_array_equal(got, np.asarray(f(top, left, modes)))


@pytest.mark.parametrize("s", [8, 16, 32])
def test_rect_references_and_windows(s):
    """build_references_rect (in-frame and coded-order availability, with
    the enclosing-leaf rule) and its per-row window twin on every ISP
    stripe of every leaf of a 96x64 frame."""
    w, h = 96, 64
    buf = _buf(h, w, s)
    wn = 2 * s + 2
    pts = [(x, y) for y in range(0, h, s) for x in range(0, w, s)]
    x0, y0 = _i32([p[0] for p in pts]), _i32([p[1] for p in pts])
    wins = np.stack([buf[y:y + wn, x:x + wn] for x, y in pts])
    geo = dict(is_luma=True, frame_w=w, frame_h=h, n_ctu_x=1)
    for d in (1, 2):
        for (dx, dy, ws, hs) in isp_parts(s, d):
            px, py = x0 + dx, y0 + dy
            jx, jy = jnp.asarray(x0.numpy()), jnp.asarray(y0.numpy())
            top, left = tintra.build_references_rect(
                T(buf), px, py, w=ws, h=hs, in_frame_only=True, **geo)
            jt, jl = _vmap(("rect", ws, hs), lambda b, x, y: (
                jintra.build_references_rect(b, x, y, w=ws, h=hs,
                                             in_frame_only=True, **geo)),
                (None, 0, 0))(jnp.asarray(buf), jx + dx, jy + dy)
            _eq(top, jt)
            _eq(left, jl)
            top, left = tintra.build_references_rect(
                T(buf), px, py, w=ws, h=hs, leaf_x=x0, leaf_y=y0, leaf_w=s,
                leaf_h=s, **geo)
            jt, jl = _vmap(("rect_leaf", s, ws, hs), lambda b, x, y, lx, ly: (
                jintra.build_references_rect(b, x, y, w=ws, h=hs, leaf_x=lx,
                                             leaf_y=ly, leaf_w=s, leaf_h=s,
                                             **geo)),
                (None, 0, 0, 0, 0))(jnp.asarray(buf), jx + dx, jy + dy, jx,
                                    jy)
            _eq(top, jt)
            _eq(left, jl)
            top, left = tintra.build_references_rect_win(
                T(wins), x0, y0, px, py, w=ws, h=hs, leaf_w=s, leaf_h=s,
                **geo)
            jt, jl = _vmap(("win", s, ws, hs), lambda wi, x, y, qx, qy: (
                jintra.build_references_rect_win(wi, x, y, qx, qy, w=ws,
                                                 h=hs, win_n=wn, leaf_w=s,
                                                 leaf_h=s, **geo)))(
                jnp.asarray(wins), jx, jy, jx + dx, jy + dy)
            _eq(top, jt)
            _eq(left, jl)


# ---------------------------------------------------------------------------
# CCLM
# ---------------------------------------------------------------------------


def _cclm_planes(case):
    """(luma buffer, chroma buffer, leaf luma recon) of a 128x128 frame
    whose neighbourhoods give the requested model."""
    rng = np.random.default_rng(7)
    h = w = 128
    y = rng.integers(0, 256, (h, w)).astype(np.int32)
    c = rng.integers(0, 256, (h // 2, w // 2)).astype(np.int32)
    if case == "flat_luma":           # lmax == lmin: slope 0
        y[:] = 90
    elif case == "negative_slope":    # chroma falls as luma rises
        y[:] = np.arange(h)[:, None] + np.arange(w)[None, :]
        c[:] = 250 - (np.arange(h // 2)[:, None]
                      + np.arange(w // 2)[None, :]) * 2
    by = np.zeros((h + 1 + tintra.MARGIN, w + 1 + tintra.MARGIN), np.int32)
    by[1:h + 1, 1:w + 1] = y
    bc = np.zeros((h // 2 + 1 + tintra.MARGIN, w // 2 + 1 + tintra.MARGIN),
                  np.int32)
    bc[1:h // 2 + 1, 1:w // 2 + 1] = c
    return by, bc


@pytest.mark.parametrize("case", ["random", "flat_luma", "negative_slope"])
def test_cclm_edges(case):
    """Every leaf of a 128x128 frame at s = 8, 16, 32: blocks with both
    neighbours, above only (left frame edge), left only (top frame edge),
    neither (the origin), a zero luma range and negative slopes."""
    by, bc = _cclm_planes(case)
    rng = np.random.default_rng(3)
    for s in (8, 16, 32):
        cs = s // 2
        pts = [(x, y) for y in range(0, 128, s) for x in range(0, 128, s)]
        recy = rng.integers(0, 256, (len(pts), s, s)).astype(np.int32)
        if case == "flat_luma":
            recy[:] = 90
        cx = np.asarray([p[0] // 2 for p in pts], np.int32)
        cy = np.asarray([p[1] // 2 for p in pts], np.int32)
        got = tintra.cclm_predict_local(T(by), T(bc), T(recy), T(cx), T(cy),
                                        cs=cs, n_ctu_x=2)
        want = _vmap(("cclm", cs), lambda b1, b2, r, x, y: (
            jintra.cclm_predict_local(b1, b2, r, x, y, cs=cs, frame_w=128,
                                      frame_h=128, n_ctu_x=2)),
            (None, None, 0, 0, 0))(jnp.asarray(by), jnp.asarray(bc),
                                   jnp.asarray(recy), jnp.asarray(cx),
                                   jnp.asarray(cy))
        _eq(got, want, f"s={s}")


def test_sort4():
    rng = np.random.default_rng(0)
    lu = rng.integers(0, 4, (64, 4)).astype(np.int32)     # many ties
    ch = rng.integers(0, 256, (64, 4)).astype(np.int32)
    gl, gc = tintra._sort4(T(lu), T(ch))
    for i in range(64):
        jl, jc = jintra._sort4_j(jnp.asarray(lu[i]), jnp.asarray(ch[i]))
        np.testing.assert_array_equal(gl[i].numpy(), np.asarray(jl))
        np.testing.assert_array_equal(gc[i].numpy(), np.asarray(jc))


# ---------------------------------------------------------------------------
# MTS / LFNST
# ---------------------------------------------------------------------------


def _resi(s, n, seed):
    """Residual batches with ties: all-zero rows (every candidate codes
    nothing), constant rows, saturating rows and noise."""
    rng = np.random.default_rng(seed)
    r = rng.integers(-40, 41, (n, s, s)).astype(np.int32)
    r[0] = 0
    r[1] = 1
    r[2] = 255
    r[3] = -255
    r[4, ::2] = 0
    return r


@pytest.mark.parametrize("mts,lfnst,allow", [
    (True, False, False), (False, True, False), (True, True, False),
    (True, True, True)])
def test_choose_tx(mts, lfnst, allow):
    for s in ((8, 16, 32) if allow else (8, 32)):
        n = 8
        resi = _resi(s, n, s)
        modes = np.asarray([0, 1, 2, 18, 34, 50, 66, 30], np.int32)
        al = np.asarray([True, False] * (n // 2)) if allow \
            else np.ones(n, bool)
        got = ttf.choose_tx(T(resi), s, 32, 347, T(modes), 8, mts=mts,
                            lfnst=lfnst, rdoq=True,
                            allow=T(al) if allow else None)
        want = _vmap(("tx", s, mts, lfnst, allow), lambda r, m, a: (
            jtf.choose_tx_j(r, s, 32, jnp.int32(347), m, 8, mts=mts,
                            lfnst=lfnst, rdoq=True,
                            allow=a if allow else None)))(
            jnp.asarray(resi), jnp.asarray(modes), jnp.asarray(al))
        for g, w_ in zip(got, want):
            _eq(g, w_, f"s={s}")


@pytest.mark.parametrize("installed", [True, False])
def test_choose_tx_follows_table_swap(installed):
    """The stacked primaries are read at call time: with the spec-literal
    DCT-II tables installed and removed, the choice equals the spec
    model's under the same tables."""
    from vvctpu_torch.spec import transform as tspec
    was = ttables.installed()
    try:
        for mod in (jtables, ttables):      # both packages alike
            (mod.install if installed else mod.uninstall)()
        resi = _resi(16, 6, 5)
        modes = np.asarray([0, 20, 40, 60, 2, 66], np.int32)
        qp = 27
        got = ttf.choose_tx(T(resi), 16, qp, tspec.lambda_rd_int(qp),
                            T(modes), mts=True, lfnst=True, rdoq=True)
        for i in range(6):
            midx, lidx, lev = tspec.choose_tx(resi[i], qp, int(modes[i]),
                                              mts=True, lfnst=True,
                                              rdoq=True)[:3]
            assert (int(got[0][i]), int(got[1][i])) == (midx, lidx)
            _eq(got[2][i], lev)
    finally:
        for mod in (jtables, ttables):
            (mod.install if was else mod.uninstall)()


def test_choose_mts():
    resi = _resi(8, 6, 2)
    got = ttf.choose_mts(T(resi), 8, 32, 347)
    want = _vmap("mts", lambda r: jtf.choose_mts_j(r, 8, 32,
                                                   jnp.int32(347)))(
        jnp.asarray(resi))
    for g, w_ in zip(got, want):
        _eq(g, w_)


def test_lfnst_forward_inverse_and_switch():
    rng = np.random.default_rng(4)
    n = 12
    coef = rng.integers(-2000, 2001, (n, 8, 8)).astype(np.int32)
    coef[0] = 32767
    coef[1] = -32768
    modes = np.asarray([0, 1, 2, 12, 13, 23, 24, 34, 35, 45, 56, 66],
                       np.int32)
    idx = np.asarray([0, 1, 2] * 4, np.int32)
    for kernel in (0, 1):
        fw = ttf.fwd_lfnst(T(coef), kernel, T(modes)).numpy()
        iv = ttf.inv_lfnst(T(coef), kernel, T(modes)).numpy()
        for i in range(n):
            np.testing.assert_array_equal(fw[i], np.asarray(jtf.fwd_lfnst_j(
                jnp.asarray(coef[i]), kernel, jnp.int32(modes[i]))))
            np.testing.assert_array_equal(iv[i], np.asarray(jtf.inv_lfnst_j(
                jnp.asarray(coef[i]), kernel, jnp.int32(modes[i]))))
    sw = ttf.inv_lfnst_switch(T(coef), T(idx), T(modes)).numpy()
    for i in range(n):
        np.testing.assert_array_equal(sw[i], np.asarray(
            jtf.inv_lfnst_switch_j(jnp.asarray(coef[i]), jnp.int32(idx[i]),
                                   jnp.int32(modes[i]))))


def test_inverse_transform_rows():
    rng = np.random.default_rng(6)
    for s in (4, 8, 16, 32):
        coef = rng.integers(-3000, 3001, (10, s, s)).astype(np.int32)
        midx = np.arange(10, dtype=np.int32) % 5
        got = ttf.inverse_transform_rows(T(coef), s, T(midx)).numpy()
        for i in range(10):
            kh, kv = jtf.MTS_SET[midx[i]]
            np.testing.assert_array_equal(got[i], np.asarray(
                jtf.inverse_transform(jnp.asarray(coef[i]), s, s, kh, kv)))


def test_level_rates_and_rd_cost():
    rng = np.random.default_rng(8)
    lev = rng.integers(-40, 41, (5, 16, 16)).astype(np.int32)
    lev[0] = 0
    lev[1, 0, 0] = 32767
    w = ttf.lvl_weights(32, "cpu")
    np.testing.assert_array_equal(
        ttf.level_rate_fp(T(lev), w, dims=(-2, -1)).numpy(),
        np.asarray(jtf.level_rate_fp_j(jnp.asarray(lev), jnp.asarray(
            w.numpy()), axes=(-2, -1))))
    np.testing.assert_array_equal(
        ttf.level_rate_est(T(lev), dims=(-2, -1)).numpy(),
        np.asarray(jtf.level_rate_est_j(jnp.asarray(lev), axes=(-2, -1))))
    dist = np.asarray([0, 1000, 2 ** 30, 2 ** 31 - 1], np.int32)
    rate = np.asarray([0, 255, 1 << 22, 1 << 23], np.int32)
    for lam in (0, 347, 1 << 12):      # the last wraps int32
        np.testing.assert_array_equal(
            ttf._rd_cost(T(dist), T(rate), lam).numpy(),
            np.asarray(jtf._rd_cost_j(jnp.asarray(dist), jnp.asarray(rate),
                                      jnp.int32(lam))))


# ---------------------------------------------------------------------------
# chroma choice (DM vs CCLM)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cs", [4, 8, 16])
def test_chroma_rd(cs):
    rng = np.random.default_rng(cs)
    n = 6
    src_b = rng.integers(0, 256, (n, cs, cs)).astype(np.int32)
    src_r = rng.integers(0, 256, (n, cs, cs)).astype(np.int32)
    dm = [rng.integers(0, 256, (n, cs, cs)).astype(np.int32)
          for _ in range(2)]
    lm = [p.copy() for p in dm]
    lm[0][2:] = src_b[2:] // 2 + 60      # closer options on some rows
    lm[1][2:] = src_r[2:]
    # rows 0, 1: DM == CCLM, a tie that the first option must win
    got = trecon.chroma_rd(T(src_b), T(src_r), [(T(dm[0]), T(dm[1])),
                                                (T(lm[0]), T(lm[1]))],
                           cs, 32, 8, True, 347)
    assert (got[4][:2] == 0).all()
    want = _vmap(("crd", cs), lambda a, b, c, d, e, f: jrecon.chroma_rd_j(
        a, b, [(c, d), (e, f)], None, cs, 32, 8, True, jnp.int32(347),
        False, False))(*(jnp.asarray(v) for v in (src_b, src_r, dm[0], dm[1],
                                                  lm[0], lm[1])))
    for k in range(5):
        _eq(got[k], want[k])


# ---------------------------------------------------------------------------
# the decision pass
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s", [8, 16])
def test_satd4_rect(s):
    rng = np.random.default_rng(s)
    for (_, _, w, h) in isp_parts(s, 1) + isp_parts(s, 2):
        d = rng.integers(-255, 256, (4, h, w)).astype(np.int32)
        got = tdecide._satd4_rect(T(d), w, h).numpy()
        want = [int(jdecide._satd4_rect(jnp.asarray(d[i]), w, h))
                for i in range(4)]
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s,flags", [
    (8, dict(mip=True)), (16, dict(mrl=True)), (32, dict(isp=True)),
    (8, dict(mip=True, mrl=True, isp=True))])
def test_size_pass(s, flags):
    """(cost, mode, mrl, isp) per block equal to the reference's pass
    with each tool flag on a 64x96 frame."""
    h, w = 64, 96
    buf = _buf(h, w, 21)
    B = jest.decision_bits(2, 30)
    lam = 700
    got = tdecide.size_pass(T(buf), lam, s=s, frame_w=w, frame_h=h, B=B,
                            **flags)
    want = jdecide.size_pass(jnp.asarray(buf), np.int32(lam), s=s,
                             frame_w=w, frame_h=h, B=B, **flags)
    for g, w_ in zip(got, want):
        _eq(g, w_)
    if s < 32:          # the tools win somewhere among the small blocks
        assert all(got[i].numpy().any() for i, t in ((2, "mrl"), (3, "isp"))
                   if flags.get(t))
        if flags.get("mip"):
            assert (got[1].numpy() >= rom.NUM_LUMA_MODE).any()
