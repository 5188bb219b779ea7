"""RDOQ off in the port (the plain quantizer, EncoderConfig(rdoq=False))
against its JAX twins in vvctpu at tolerance 0 on seeded inputs: the
quantizer at 8 and 10 bits, the MTS/TS/LFNST choice, the chroma choice
with the joint Cb-Cr candidate, the intra (with TS and JCCR), ISP, rect,
CIIP and IBC leaf classes of the wave, phase A of square leaves (every
inter tool, with SBT, and with SBT and DQ) and of rect leaves, each
encoding then decoding its levels; then test_rdoq.py's and test_isp.py's
RDOQ-off configs, test_rdoq.py's GOP2 config and test_palette.py's
palette and IBC config with RDOQ off end to end against the spec model
(bytes and whole-plane decisions), each stream cross-decoded with the
hashes verified.  Palette leaves have no quantizer: the last config runs
them beside IBC's."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.core import rom  # noqa: E402,F401  (before the kernels)
from vvctpu.kernels import transform as jtf  # noqa: E402
from vvctpu.pipeline import recon as jrecon  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import plan as tplan  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

import chip_smoke  # noqa: E402
import test_torch_ibc_plt as ibc  # noqa: E402
from test_isp import synth as isp_synth  # noqa: E402
from test_torch_inter_tools import (H, QP, W, _LAM_RD, _carries,  # noqa: E402
                                    _check_carry, _mvs, _phase_a_rows,
                                    _refs6)
from test_torch_lmcs import _grid_rows  # noqa: E402
from test_torch_tskip_jccr import _ts_resi  # noqa: E402

torch.set_num_threads(1)
T = torch.as_tensor
_JIT: dict = {}


def _jit(key, fn):
    if key not in _JIT:
        _JIT[key] = jax.jit(fn)
    return _JIT[key]


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


@pytest.mark.parametrize("bd", [8, 10])
def test_plain_quantizer(bd):
    """quantize(rdoq=False) of intra and inter blocks of every transform
    shape of the slice, coefficients at both clamps, equals the
    reference's."""
    rng = np.random.default_rng(bd)
    lim = 1 << (bd + 7)
    for h, w in ((4, 4), (8, 8), (16, 16), (32, 32), (8, 16), (32, 8),
                 (4, 16), (64, 64)):
        coef = rng.integers(-lim, lim, (6, h, w)).astype(np.int32)
        coef[0], coef[1] = 32767, -32768
        for intra in (True, False):
            got = ttf.quantize(T(coef), h, w, QP, intra=intra, bd=bd,
                               rdoq=False)
            want = jax.vmap(lambda c: jtf.quantize(
                c, h, w, QP, intra=intra, bd=bd, rdoq=False))(
                    jnp.asarray(coef))
            _eq(got, want, f"{h}x{w} intra={intra}")


@pytest.mark.parametrize("s,mts,lfnst,allow,bd", [
    (8, True, True, True, 8), (16, False, False, False, 10),
    (32, True, True, False, 8)])
def test_choose_tx(s, mts, lfnst, allow, bd):
    """choose_tx with transform skip at rdoq=False equals choose_tx_j: the
    index, LFNST index, levels and residual of every row."""
    n = 8
    resi = _ts_resi(s, n, bd, 3 * s + bd)
    modes = np.asarray([0, 1, 2, 18, 34, 50, 66, 30], np.int32)
    al = np.asarray([True, False] * (n // 2))
    got = ttf.choose_tx(T(resi), s, QP, _LAM_RD, T(modes), bd, mts=mts,
                        lfnst=lfnst, rdoq=False,
                        allow=T(al) if allow else None, ts=True)
    want = jax.jit(jax.vmap(lambda r, m, a: jtf.choose_tx_j(
        r, s, QP, jnp.int32(_LAM_RD), m, bd, mts=mts, lfnst=lfnst,
        rdoq=False, allow=a if allow else None, ts=True)))(
        jnp.asarray(resi), jnp.asarray(modes), jnp.asarray(al))
    for k, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"output {k}")


@pytest.mark.parametrize("cs,cclm,jccr", [(8, True, True), (16, False, False),
                                          (4, False, True)])
def test_chroma_rd(cs, cclm, jccr):
    """The DM/CCLM and separate/joint chroma choice at rdoq=False equals
    chroma_rd_j: levels, recon and both choices."""
    rng = np.random.default_rng(cs + 2 * cclm + 4 * jccr)
    n = 8
    base = rng.integers(-60, 61, (n, cs, cs))
    src_b = (128 + base).astype(np.int32)
    src_r = (128 - base + rng.integers(-3, 4, (n, cs, cs))).astype(np.int32)
    preds = [rng.integers(100, 157, (n, cs, cs)).astype(np.int32)
             for _ in range(4)]
    opts = [(preds[0], preds[1])] + ([(preds[2], preds[3])] if cclm else [])
    got = trecon.chroma_rd(T(src_b), T(src_r),
                           [(T(a), T(b)) for a, b in opts], cs, QP, 8, False,
                           _LAM_RD, jccr=jccr)
    P = len(opts)

    def ref(b, r, *a):
        p = [(a[2 * i], a[2 * i + 1]) for i in range(P)]
        return jrecon.chroma_rd_j(b, r, p, None, cs, QP, 8, False,
                                  jnp.int32(_LAM_RD), jccr, False)
    want = jax.jit(jax.vmap(ref))(*(jnp.asarray(v) for v in (
        src_b, src_r, *[p for o in opts for p in o])))
    for k, (g, w) in enumerate(zip(got, want)):
        # without JCCR the port gives no joint flags, the reference zeros
        _eq(np.zeros_like(w) if g is None and not jccr else g, w,
            f"output {k}")


def _levels_into(tc, jc, lev):
    """Load the port's encoded levels as both carries' decode input."""
    for c in ("ly", "lcb", "lcr"):
        tc["s" + c[1:]][:] = lev[c]
    return jc[:6] + tuple(jnp.asarray(lev[c][0].numpy())
                          for c in ("ly", "lcb", "lcr")) + jc[9:]


def _planes(tc):
    for k in ("mtsp", "lfnstp", "cmodep", "sbtp", "jccrp"):
        tc.setdefault(k, T(np.zeros((1, H // 8, W // 8), np.int32)))
    return tc


_INTRA = dict(mts=True, lfnst=True, cclm=True, mip=True, tskip=True,
              jccr=True)


@pytest.mark.parametrize("kind", ["intra16", "isp16", "rect16x8",
                                  "rect8x32", "ciip16"])
def test_leaf_class(kind):
    """A phase-B leaf class at rdoq=False, encoding then decoding the
    port's levels (and tool indices), against the reference's batch:
    square intra leaves with MTS, LFNST, MIP, CCLM, TS and JCCR; ISP
    stripes with CCLM and JCCR; rect (BT and TT) leaves; CIIP leaves."""
    rng = np.random.default_rng(len(kind))
    if kind == "intra16":
        s = 16
        rows = _grid_rows(rng, s, s, 8, s.bit_length() - 3)
        rows[:, 3] = rng.integers(0, 67 + 16, 8)
        jfn = functools.partial(jwave._intra_batch.__wrapped__, s=s,
                                frame_w=W, frame_h=H, bd=8, rdoq=False,
                                dq=False, **_INTRA)

        def port(tc, encode):
            twave._intra_batch(tc, T(rows), rows, QP, _LAM_RD, s=s,
                               frame_w=W, frame_h=H, log2_ctu=6, bd=8,
                               encode=encode, rdoq=False, **_INTRA)
    elif kind == "isp16":
        s, d = 16, 2
        rows = _grid_rows(rng, s, s, 8, s.bit_length() - 3)
        rows[:, 3] = rng.integers(0, 67, 8)
        rows[:, 15] = d
        jfn = functools.partial(jwave._isp_batch.__wrapped__, s=s, d=d,
                                frame_w=W, frame_h=H, bd=8, cclm=True,
                                rdoq=False, jccr=True, dq=False)

        def port(tc, encode):
            twave._isp_batch(tc, T(rows), rows, QP, _LAM_RD, s=s, d=d,
                             frame_w=W, frame_h=H, log2_ctu=6, bd=8,
                             encode=encode, rdoq=False, cclm=True,
                             jccr=True)
    elif kind.startswith("rect"):
        w, h = (int(v) for v in kind[4:].split("x"))
        rows = _grid_rows(rng, w, h, 10, tplan.OP_RECT_INTRA0
                          + tplan.RECT_SHAPES.index((w, h)))
        rows[:, 3] = rng.integers(0, 67, 10)
        jfn = functools.partial(jwave._rect_batch.__wrapped__, w=w, h=h,
                                frame_w=W, frame_h=H, bd=8, rdoq=False,
                                dq=False)

        def port(tc, encode):
            twave._rect_batch(tc, T(rows), QP, _LAM_RD, w=w, h=h, frame_w=W,
                              frame_h=H, log2_ctu=6, bd=8, encode=encode,
                              rdoq=False)
    else:
        s = 16
        rows = _grid_rows(rng, s, s, 6, 7 + (s.bit_length() - 4))
        rows[:, 4:6] = _mvs(rng, 6, 60)
        rows[:, 11:13] = _mvs(rng, 6, 60)
        rows[:, 13] = np.arange(6) % 3
        rows[:, 14] = rng.integers(0, 3, 6)
        refs = _refs6()
        jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)

        def jfn(c, r, qp, lam, _crs, encode):
            return jwave._ciip_batch(c, r, jrefs, qp, lam, None, None, 0, 0,
                                     s=s, frame_w=W, frame_h=H, bd=8,
                                     encode=encode, rdoq=False, dq=False)

        def port(tc, encode):
            twave._ciip_batch(tc, T(rows), [r[None] for r in refs], QP,
                              _LAM_RD, s=s, frame_w=W, frame_h=H,
                              log2_ctu=6, bd=8, encode=encode, rdoq=False)
    lev = None
    for encode in (True, False):
        tc, jc = _carries(17 + len(kind))
        _planes(tc)
        if not encode:
            jc = _levels_into(tc, jc, lev)
        if kind == "ciip16":
            want = jfn(jc, jnp.asarray(rows), QP, _LAM_RD, None, encode)
        else:
            want = _jit((kind, encode), functools.partial(
                jfn, encode=encode))(jc, jnp.asarray(rows), QP, _LAM_RD,
                                     None)
        port(tc, encode)
        _check_carry(tc, want, f"{kind} encode={encode}")
        if encode:
            lev = {c: tc[c].clone() for c in ("ly", "lcb", "lcr")}
            assert lev["ly"].any()
            if kind == "intra16":
                # the decode reads the chosen tool indices from the rows
                at = (rows[:, 2] // 8, rows[:, 1] // 8)
                for c, col in (("mtsp", 6), ("lfnstp", 7), ("cmodep", 8)):
                    rows[:, col] = tc[c][0].numpy()[at]
                rows[:, 10] = tc["jccrp"][0].numpy()[at]


def test_ibc_batch():
    """IBC 16-leaves of two member frames at rdoq=False, encoded then
    decoded, against the reference's _ibc_batch (nf = 2)."""
    s = 16
    rows = ibc._ibc_rows(np.random.default_rng(5), s)
    tc, jc = ibc._carries(5)
    for encode in (True, False):
        if not encode:
            lev = {k: tc[k].clone() for k in ("ly", "lc")}
            tc, jc = ibc._carries(5)
            tc["sy"], tc["sc"] = lev["ly"], lev["lc"]
            ibc._views(tc)
            jc = ibc._ref_carry(tc)
        want = _jit(("ibc", encode), functools.partial(
            jwave._ibc_batch.__wrapped__, s=s, frame_w=ibc.W, frame_h=ibc.H,
            bd=8, encode=encode, rdoq=False, dq=False, nf=ibc.F))(
                jc, jnp.asarray(rows), ibc.QP, ibc.LAM_RD)
        twave._ibc_batch(tc, T(rows), ibc.QP, ibc.LAM_RD, s=s, frame_w=ibc.W,
                         frame_h=ibc.H, bd=8, encode=encode, rdoq=False,
                         dq=False)
        ibc._check(tc, want, f"ibc{s} encode={encode}")
        if encode:
            assert tc["ly"].any()


_PA_ALL = dict(dmvr=True, bdof=True, gpm=True, affine=True, sbt=True)


@pytest.mark.parametrize("kind,shape,flags", [
    ("sq", 16, _PA_ALL), ("sq", 8, dict(sbt=True, dq=True)),
    ("rect", (16, 8), dict(dq=False)), ("rect", (8, 32), dict(dq=True))],
    ids=["sq16_tools_sbt", "sq8_sbt_dq", "rect16x8", "rect8x32_dq"])
def test_phase_a(kind, shape, flags):
    """Phase A at rdoq=False, encoding then decoding the port's levels
    (the SBT index the encode chose parsed back), against the
    reference's pass: square leaves with BCW, GPM, affine, DMVR, BDOF and
    SBT, and with SBT and DQ; rect (BT and TT) leaves."""
    if kind == "sq":
        rows = _phase_a_rows("mixed", shape)
    else:
        w, h = shape
        rng = np.random.default_rng(w * h)
        nb = (H // h) * (W // w)
        k = nb - 3
        pos = rng.permutation(nb)[:k]
        rows = np.zeros((nb, 7), np.int32)
        rows[:k, 0] = pos % (W // w) * w
        rows[:k, 1] = pos // (W // w) * h
        rows[:k, 2:6] = _mvs(rng, 2 * k, 60).reshape(k, 4)
        rows[:k, 6] = rng.choice([0, 1, 2], k)
        rows[k:, :2] = 1 << 20
    refs = _refs6()
    jrefs = tuple(jnp.asarray(r.numpy()) for r in refs)
    trefs = [r[None] for r in refs]
    lev = None
    for encode in (True, False):
        tc, jc = _carries(23 + len(rows))
        _planes(tc)
        if not encode:
            jc = _levels_into(tc, jc, lev)
        trows = np.concatenate([rows, np.zeros((len(rows), 1), np.int32)], 1)
        if kind == "sq":
            want = _jit(("sq", shape, encode), functools.partial(
                jrecon._inter_batch_pass, s=shape, qp=QP, bd=8,
                encode=encode, frame_w=W, frame_h=H, rdoq=False,
                lam_rd=_LAM_RD, **flags))(jc, jnp.asarray(rows), jrefs)
            trecon._inter_batch_pass(tc, trows, trefs, shape, QP, 8, encode,
                                     rdoq=False, lam_rd=_LAM_RD, **flags)
        else:
            want = _jit(("rect", shape, encode), functools.partial(
                jrecon._inter_batch_pass_rect, w=shape[0], h=shape[1],
                qp=QP, bd=8, encode=encode, rdoq=False, lam_rd=_LAM_RD,
                **flags))(jc, jnp.asarray(rows), jrefs)
            trecon._inter_batch_pass_rect(tc, trows, trefs, *shape, QP, 8,
                                          encode, rdoq=False,
                                          lam_rd=_LAM_RD, **flags)
        _check_carry(tc, want, f"{kind} {shape} encode={encode}")
        if encode:
            lev = {c: tc[c].clone() for c in ("ly", "lcb", "lcr")}
            assert lev["ly"].any()
            if kind == "sq":
                live = rows[:, 0] < (1 << 20)
                rows[live, 8] = tc["sbtp"][0].numpy()[rows[live, 1] // 8,
                                                      rows[live, 0] // 8]


# test_rdoq.py:70's and test_isp.py:33's RDOQ-off configs, test_rdoq.py:97's
# GOP2 config and test_palette.py's palette with IBC, each with RDOQ off
_CASES = {
    "rdoq_ai": (lambda: chip_smoke.motion_frames(2, 64, 96, seed=61),
                dict(qp=32, intra_period=1, rdoq=False)),
    "isp": (lambda: isp_synth(1, 64, 128, seed=3),
            dict(qp=30, isp=True, deblock=False, sao=False, rdoq=False)),
    "gop2_tools": (lambda: chip_smoke.motion_frames(3, 64, 96, seed=62),
                   dict(qp=32, intra_period=0, gop=2, rdoq=False, mts=True,
                        lfnst=True, cclm=True)),
    "plt_ibc": (chip_smoke._plt_pair, dict(qp=32, plt=True, ibc=True,
                                           rdoq=False)),
}


@pytest.mark.parametrize("case", list(_CASES))
def test_rdoq_off_equals_spec_model(case):
    make, kw = _CASES[case]
    frames = make()
    sdecs, decs = [], []
    sdata, srec, _ = tseq.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                          decisions_out=sdecs)
    data, rec, _ = tenc.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                        device="cpu", decisions_out=decs)
    assert data == sdata
    assert all(d.equal(s) for d, s in zip(decs, sdecs))
    out, _ = tenc.decode_sequence(data, check_hash=True, device="cpu")
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    for a, b, c in zip(rec, out, sout):
        for k in range(3):
            assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k])
