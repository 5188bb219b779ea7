"""IBC (intra block copy) and palette, the screen-content leaf classes of I
slices, in the port at tolerance 0: the block-vector search ibc_pass
against vvctpu's (under jax.jit) on a screen frame and a noisy one, with
a lambda whose int32 costs wrap; the IBC and palette leaf classes of the
frame-batched wave against the reference's batches with two member
frames (IBC encoding then decoding, with RDOQ and with the trellis, its
vectors into the current CTU row, above it and out of the frame);
test_ibc.py's two and test_palette.py's three engine configs end to end
against the spec model (bytes and whole-plane decisions, each stream
decoded by the other side with the hashes verified); the refusal of IBC
with tiles."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.coding import me as jme  # noqa: E402
from vvctpu.pipeline import wave as jwave  # noqa: E402
from vvctpu.spec.transform import lambda_rd_int  # noqa: E402
from vvctpu_torch.coding import me as tme  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.pipeline import plan as tplan  # noqa: E402
from vvctpu_torch.pipeline import recon as trecon  # noqa: E402
from vvctpu_torch.pipeline import wave as twave  # noqa: E402
from vvctpu_torch.spec import hls  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402

from test_ibc import screen_frame  # noqa: E402
from test_palette import screen_frame as palette_frame  # noqa: E402

torch.set_num_threads(1)
T = torch.as_tensor
H, W, F = 64, 128, 2
QP = 32
LAM_RD = lambda_rd_int(QP)


def _eq(got, want, msg=""):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                  err_msg=msg)


# ---------------------------------------------------------------------------
# the block-vector search
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["screen", "noise_wrap"])
def test_ibc_pass_equals_reference(case):
    """Cost and vector per 8/16/32 block equal the reference's ibc_pass
    on a 128x128 frame: test_ibc.py's tiled glyphs at the decision
    lambda of QP 32, and noise at a lambda whose int32 rate term wraps
    (negative costs win), where the first minimum in offset order
    decides between equal costs."""
    if case == "screen":
        y = screen_frame(seed=5)[0][0]
        lam, fp = 347, 256
    else:
        y = np.random.default_rng(1).integers(0, 256, (128, 128)).astype(
            np.int32)
        lam, fp = (1 << 28) + 3, 767
    got = tme.ibc_pass(T(y), lam, frame_w=128, frame_h=128, ibc_fp=fp)
    want = jax.jit(lambda o: jme.ibc_pass(
        o, np.int32(lam), frame_w=128, frame_h=128,
        ibc_fp=np.int32(fp)))(jnp.asarray(y))
    for s in (8, 16, 32):
        _eq(got[s][0], want[s][0], f"cost {s}")
        _eq(got[s][1], want[s][1], f"bv {s}")
    c8 = got[8][0].numpy()
    if case == "screen":
        # the glyph repeats every 16 pels: zero-SAD copies left and above
        assert (got[16][1].numpy() == [-16, 0]).all(-1).any()
    else:
        assert (c8 < 0).any()


# ---------------------------------------------------------------------------
# the leaf classes of the wave, two member frames
# ---------------------------------------------------------------------------


def _carries(seed: int):
    """The port's carry of F frames (frame axis first, Cb then Cr frames
    stacked) and the reference's 14-tuple of the same buffers (frames
    stacked along the rows): recon buffers of random 'already
    reconstructed' samples, random source planes, zero levels and tool
    planes."""
    rng = np.random.default_rng(seed)
    m = trecon.MARGIN
    h2, w2 = H // 2, W // 2

    def r(*shape):
        return rng.integers(0, 256, shape).astype(np.int32)

    by, bc = r(F, H + 1 + m, W + 1 + m), r(2 * F, h2 + 1 + m, w2 + 1 + m)
    sy, sc = r(F, H, W), r(2 * F, h2, w2)
    z = np.zeros
    tc = dict(by=T(by), bc=T(bc), ly=T(z((F, H, W), np.int32)),
              lc=T(z((2 * F, h2, w2), np.int32)), sy=T(sy), sc=T(sc))
    for k in ("mtsp", "lfnstp", "cmodep", "sbtp", "jccrp"):
        tc[k] = T(z((F, H // 8, W // 8), np.int32))
    _views(tc)
    return tc, _ref_carry(tc)


def _views(tc):
    for k in ("b", "l", "s"):
        tc[k + "cb"], tc[k + "cr"] = tc[k + "c"].split(F)


def _rows(a):
    """(F, h, w) -> the reference's (F * h, w) stacked frames."""
    a = np.asarray(a)
    return jnp.asarray(a.reshape(-1, a.shape[-1]))


def _ref_carry(tc):
    keys = ("by", "bcb", "bcr", "ly", "lcb", "lcr", "sy", "scb", "scr",
            "mtsp", "lfnstp", "cmodep", "jccrp", "sbtp")
    return tuple(_rows(tc[k].numpy()) for k in keys)


def _check(tc, want, what):
    for i, k in enumerate(("by", "bcb", "bcr", "ly", "lcb", "lcr")):
        _eq(_rows(tc[k].numpy()), want[i], f"{what} {k}")


def _ibc_rows(rng, s: int):
    """IBC s-leaves of both frames on the s-grid: in the right CTU with
    vectors into the left CTU of the same CTU row, and leaves with
    vectors above, past the frame's edges (clamped) and random."""
    out = []
    for f in range(F):
        seen = set()
        for x, y, bvx, bvy in (
                (64, 0, -64, 0), (64 + s, 32 - 32 % s, -64 - s, 0),
                (96, 64 - s, -96, -(64 - s)), (0, 64 - s, -200, -300),
                (128 - s, 64 - s, 40, 17),
                (int(rng.integers(0, W // s)) * s,
                 int(rng.integers(0, H // s)) * s,
                 int(rng.integers(-64, 65)), int(rng.integers(-64, 1)))):
            if (x, y) in seen:          # one leaf per position
                continue
            seen.add((x, y))
            out.append((tplan.OP_IBC0 + s.bit_length() - 4, x, y, bvx, bvy,
                        f))
    rows = np.zeros((len(out), 17), np.int32)
    for i, (op, x, y, bvx, bvy, f) in enumerate(out):
        rows[i, [0, 1, 2, 4, 5, 16]] = op, x, y, bvx, bvy, f
    return rows


_JW: dict = {}


@pytest.mark.parametrize("s,dq", [(8, False), (16, True), (32, True)])
def test_ibc_batch(s, dq):
    """One level of IBC s-leaves of two member frames, encoded then
    decoded from the port's levels, against the reference's _ibc_batch
    (nf = 2): recon and levels equal; the trellis quantizes with ``dq``
    (its plain twin here)."""
    rows = _ibc_rows(np.random.default_rng(s), s)
    tc, jc = _carries(s)
    for encode in (True, False):
        key = (s, dq, encode)
        if key not in _JW:
            _JW[key] = jax.jit(functools.partial(
                jwave._ibc_batch.__wrapped__, s=s, frame_w=W, frame_h=H,
                bd=8, encode=encode, rdoq=True, dq=dq, nf=F))
        if not encode:
            # decode from the levels the port's encode wrote
            lev = {k: tc[k].clone() for k in ("ly", "lc")}
            tc, jc = _carries(s)
            tc["sy"], tc["sc"] = lev["ly"], lev["lc"]
            _views(tc)
            jc = _ref_carry(tc)
        want = _JW[key](jc, jnp.asarray(rows), QP, LAM_RD)
        twave._ibc_batch(tc, T(rows), QP, LAM_RD, s=s, frame_w=W,
                         frame_h=H, bd=8, encode=encode, rdoq=True, dq=dq)
        _check(tc, want, f"ibc{s} dq={dq} encode={encode}")
        if encode:
            assert tc["ly"].any() and tc["lc"].any()


@pytest.mark.parametrize("s", [8, 16, 32])
def test_plt_batch(s):
    """Palette s-leaves of two member frames scatter each frame's palette
    planes into its recon buffers, levels untouched, as the reference's
    _plt_batch does (nf = 2)."""
    rng = np.random.default_rng(40 + s)
    tc, jc = _carries(40 + s)
    plty = rng.integers(0, 256, (F, H, W)).astype(np.int32)
    pltc = rng.integers(0, 256, (2 * F, H // 2, W // 2)).astype(np.int32)
    tc["plty"], tc["pltc"] = T(plty), T(pltc)
    nb = (H // s) * (W // s)
    rows = np.zeros((2 * (nb // 2), 17), np.int32)
    for f in range(F):
        pos = rng.permutation(nb)[:nb // 2]
        sl = slice(f * (nb // 2), (f + 1) * (nb // 2))
        rows[sl, 0] = tplan.OP_PLT0 + s.bit_length() - 4
        rows[sl, 1] = pos % (W // s) * s
        rows[sl, 2] = pos // (W // s) * s
        rows[sl, 16] = f
    want = jwave._plt_batch.__wrapped__(
        jc, jnp.asarray(rows), _rows(plty), _rows(pltc[:F]),
        _rows(pltc[F:]), s=s, nf=F, frame_h=H)
    twave._plt_batch(tc, T(rows), s=s)
    _check(tc, want, f"plt{s}")


# ---------------------------------------------------------------------------
# end to end against the spec model
# ---------------------------------------------------------------------------

# test_ibc.py's two engine configs (one 128x128 frame) and
# test_palette.py's three (two 64x96 frames)
_CASES = {
    "ibc": ("ibc", dict(qp=32, ibc=True)),
    "ibc_mtt_dq_mts": ("ibc", dict(qp=32, ibc=True, mtt=True, dq=True,
                                   mts=True)),
    "plt": ("plt", dict(qp=32, plt=True)),
    "plt_ibc_lmcs": ("plt", dict(qp=32, plt=True, ibc=True, lmcs=True)),
    "plt_tiles": ("plt", dict(qp=32, plt=True, tile_cols=2, tile_rows=1)),
}


def _frames(clip):
    if clip == "ibc":
        return screen_frame(seed=5)
    return [palette_frame(64, 96, seed=7), palette_frame(64, 96, seed=8)]


def _same(a, b):
    return len(a) == len(b) and all(
        np.array_equal(x[c], y[c]) for x, y in zip(a, b) for c in range(3))


def _ibc_after_source(dec, h: int, w: int):
    """Every IBC leaf of ``dec`` sits at a later dependency level than
    every leaf of its source region (the copied leveller); returns the
    number of IBC leaves whose source lies in their own CTU row."""
    slots = trecon.make_slots(dec, h, w, 64)
    lv = twave._levels_py(slots, h, w)
    lmap = np.zeros((h // 8, w // 8), np.int32)
    for row, v in zip(slots, lv):
        cls = twave._op_class(int(row[0]), int(row[15]))
        if cls is not None:
            x, y, cw, ch = int(row[1]), int(row[2]), cls[1], cls[2]
            lmap[y // 8:(y + ch) // 8, x // 8:(x + cw) // 8] = v
    same_row = 0
    for row, v in zip(slots, lv):
        cls = twave._op_class(int(row[0]), int(row[15]))
        if cls is None or cls[0] != "ibc":
            continue
        s, x, y = cls[1], int(row[1]), int(row[2])
        sx, sy = x + int(row[4]), y + int(row[5])
        assert lmap[sy // 8:(sy + s) // 8, sx // 8:(sx + s) // 8].max() < v
        same_row += (sy & ~63) == (y & ~63)
    return same_row


@pytest.mark.parametrize("case", list(_CASES))
def test_screen_content_equals_spec_model(case):
    """The port's stream and FrameDecisions equal the spec model's
    (tolerance 0), the port decodes the spec model's stream and the spec
    model the port's with the hashes verified, recon == decoded; the
    tool of the config is chosen on some granules, and every IBC leaf
    runs after its source region."""
    clip, kw = _CASES[case]
    frames = _frames(clip)
    cfg = tseq.EncoderConfig(**kw)
    sdecs, tdecs = [], []
    sdata, srec, _ = tseq.encode_sequence(frames, cfg, decisions_out=sdecs)
    data, rec, _ = tenc.encode_sequence(frames, cfg, device="cpu",
                                        decisions_out=tdecs)
    assert data == sdata
    assert len(tdecs) == len(sdecs)
    for a, b in zip(tdecs, sdecs):
        assert a.equal(b)
    assert _same(rec, srec)
    out, sps = tenc.decode_sequence(sdata, check_hash=True, device="cpu")
    assert _same(out, rec)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    assert _same(sout, rec)
    if kw.get("plt"):
        assert sum(int(d.plt8.sum()) for d in tdecs) > 0
    if kw.get("ibc"):
        assert sum(int(d.ibc8.sum()) for d in tdecs) > 0
        same_row = sum(_ibc_after_source(d, sps.height, sps.width)
                       for d in tdecs)
        if clip == "ibc":
            assert same_row > 0


def test_ibc_with_tiles_refused():
    """IBC with tiles raises in the encoder's config check, as in the spec
    model (test_ibc.py test_ibc_tiles_exclusive), and so does a stream's
    SPS and PPS with both in the decoder's check."""
    cfg = tseq.EncoderConfig(qp=32, ibc=True, tile_cols=2, tile_rows=1)
    with pytest.raises(ValueError, match="IBC"):
        tseq.encode_sequence(screen_frame(), cfg)
    with pytest.raises(ValueError, match="IBC"):
        tenc.encode_sequence(screen_frame(), cfg, device="cpu")
    sps = cfg.make_sps(128, 128)
    pps = hls.PPS(init_qp=32, num_tile_cols=2, num_tile_rows=1)
    with pytest.raises(ValueError, match="IBC"):
        tenc._check_sps(sps, pps)
