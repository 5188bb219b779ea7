"""The me_sad CUDA kernel's design premises, checked on the CPU.

The kernel (vvctpu_torch/csrc/me_sad.cu) cannot run here, so these tests
read its tables and its shuffle tree from the source and hold them
against the wrapper's geometry and the plain twin: every key block lies
in one aligned 32x32 region, the lane ownership table covers each block
once, the launch covers each output once, the window's shared-memory
loads are free of bank conflicts, and a NumPy model of the warps'
arithmetic (shuffle sums, slot picks, wrapping cost, per-warp strict-less
minimum, 64-bit merge across a split of the dy rows over 1-4 warps, the
kernel's own ``SPLIT`` among them) equals ``me_sad_reference``.
"""
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vvctpu_torch.kernels import me_sad as kme  # noqa: E402

torch.set_num_threads(1)
SRC = (Path(kme.__file__).resolve().parent.parent / "csrc" /
       "me_sad.cu").read_text()
R = 16
NOFF = 2 * R + 1
SHAPES = [(1088, 1920), (64, 128)]


def _table(name):
    body = re.search(name + r"\[[^=]*=\s*\{(.*?)\};", SRC, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [int(v) for v in re.findall(r"-?\d+", body)]


def _geom():
    vals = _table("c_geom")
    return [tuple(vals[i:i + 6]) for i in range(0, len(vals), 6)]


def _own():
    vals = _table("c_own")
    assert len(vals) == 64
    return np.array(vals).reshape(2, 32)


def _shuffles():
    """[(dst key, src key or 'part', xor mask), ...] in source order."""
    pat = (r"v\[(\d+)\] = (part|v\[\d+\]) \+ "
           r"__shfl_xor_sync\(FULL, (?:part|v\[\d+\]), (\d+)\)")
    out = []
    for dst, src, mask in re.findall(pat, SRC):
        out.append((int(dst), src if src == "part" else int(src[2:-1]),
                    int(mask)))
    return out


def _lane_granule(lane):
    return lane >> 3, (lane >> 1) & 3, lane & 1      # gy, gx, h


def _keys(tt):
    return kme.KEYS[:11 if tt else 7]


def test_c_geom_matches_key_geom():
    assert _geom() == [kme.KEY_GEOM[k] for k in kme.KEYS]


def test_split_matches_source():
    assert int(re.search(r"constexpr int SPLIT = (\d+);", SRC).group(1)) \
        == kme.SPLIT


@pytest.mark.parametrize("shape", SHAPES)
def test_every_block_inside_one_region(shape):
    H, W = shape
    for k in kme.KEYS:
        bh, bw, sy, sx, oy, ox = kme.KEY_GEOM[k]
        nby, nbx = kme._grid(k, H, W)
        ys = oy + sy * np.arange(nby)
        xs = ox + sx * np.arange(nbx)
        assert np.all(ys // 32 == (ys + bh - 1) // 32), k
        assert np.all(xs // 32 == (xs + bw - 1) // 32), k


@pytest.mark.parametrize("tt", [False, True])
def test_region_counts(tt):
    """One 32x32 region: 16 granules and 41 (51 with TT) key blocks."""
    n = sum(a * b for a, b in (kme._grid(k, 32, 32) for k in _keys(tt)))
    assert kme._grid(8, 32, 32) == (4, 4)
    assert n == (51 if tt else 41)


def _owned_blocks(own, tt):
    """{(key, block row in region, block col in region): [(slot, lane)]}
    and a check that each owner's granule lies inside its block."""
    keys = _keys(tt)
    blocks = {}
    for slot in range(2):
        for lane in range(32):
            k = int(own[slot, lane])
            if k < 0 or k >= len(keys):
                continue
            bh, bw, sy, sx, oy, ox = kme.KEY_GEOM[kme.KEYS[k]]
            gy, gx, _ = _lane_granule(lane)
            by, bx = (gy * 8 - oy) // sy, (gx * 8 - ox) // sx
            y0, x0 = oy + by * sy, ox + bx * sx
            assert y0 <= gy * 8 < y0 + bh and x0 <= gx * 8 < x0 + bw
            blocks.setdefault((k, by, bx), []).append((slot, lane))
    return blocks


@pytest.mark.parametrize("tt", [False, True])
def test_owner_table_covers_each_block_once(tt):
    blocks = _owned_blocks(_own(), tt)
    want = {(k, by, bx) for k, key in enumerate(_keys(tt))
            for by in range(kme._grid(key, 32, 32)[0])
            for bx in range(kme._grid(key, 32, 32)[1])}
    assert set(blocks) == want
    assert all(len(v) == 1 for v in blocks.values())


def _out_index(H, W, k, lane, ty, tx, region):
    """The kernel's output index for a lane's block (its write-back)."""
    geom = _geom()
    first = sum(((H - g[4] - g[0]) // g[2] + 1) * ((W - g[5] - g[1]) // g[3]
                                                   + 1) for g in geom[:k])
    bh, bw, sy, sx, oy, ox = geom[k]
    gy, gx, _ = _lane_granule(lane)
    nbx = (W - ox - bw) // sx + 1
    by = (ty * 64 + (region >> 1) * 32 + gy * 8 - oy) // sy
    bx = (tx * 64 + (region & 1) * 32 + gx * 8 - ox) // sx
    return first + by * nbx + bx


@pytest.mark.parametrize("tt", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_grid_matches_launch_coverage(shape, tt):
    """The launch (W/64 x H/64 blocks, 4 regions, the owner table) writes
    each entry of the wrapper's per-key grids exactly once."""
    H, W = shape
    own = _own()
    keys = _keys(tt)
    total = sum(a * b for a, b in (kme._grid(k, H, W) for k in keys))
    owners = [(s, ln, int(own[s, ln])) for s in range(2) for ln in range(32)
              if 0 <= own[s, ln] < len(keys)]
    seen = np.zeros(total, np.int64)
    for ty in range(H // 64):
        for tx in range(W // 64):
            for region in range(4):
                for _, lane, k in owners:
                    seen[_out_index(H, W, k, lane, ty, tx, region)] += 1
    assert np.all(seen == 1)
    per_key = [sum(1 for _, _, k2 in owners if k2 == k)
               for k in range(len(keys))]
    for k, key in enumerate(keys):
        nby, nbx = kme._grid(key, H, W)
        assert (H // 32) * (W // 32) * per_key[k] == nby * nbx


def test_window_loads_conflict_free():
    """For every region, dy row, pixel row and column step, the 32 lanes'
    shared-memory loads of the reference window fall in 32 banks."""
    stride = int(re.search(r"WSTRIDE = (\d+);", SRC).group(1))
    assert "return y * WSTRIDE + ((y >> 2) & 7);" in SRC
    lanes = np.arange(32)
    gy, gx, h = lanes >> 3, (lanes >> 1) & 3, lanes & 1
    for region in range(4):
        py = (region >> 1) * 32 + gy * 8 + h * 4
        px = (region & 1) * 32 + gx * 8
        for dyi in range(NOFF):
            for i in range(4):
                y = py + i + dyi
                base = y * stride + ((y >> 2) & 7) + px
                assert base.max() + 39 < (y.max() + 1) * stride
                for col in range(40):
                    assert len(set((base + col) % 32)) == 32


def _wrap32(x):
    return ((np.asarray(x, np.int64) + 2 ** 31) % 2 ** 32 - 2 ** 31)


def _bitlen(v):
    return int(abs(v)).bit_length()


def _emulate(orig, refp, lam, tt, split):
    """NumPy model of the kernel's warps on (H, W) int planes."""
    H, W = orig.shape
    keys = _keys(tt)
    own = _own()
    ny, nx = H // 32, W // 32
    lanes = np.arange(32)
    # per offset and lane: the lane's 4x8 partial SAD (float in the
    # kernel, exact integers here)
    part = np.empty((NOFF * NOFF, ny * nx, 32), np.int64)
    for dyi in range(NOFF):
        for dxi in range(NOFF):
            d = np.abs(orig.astype(np.int64)
                       - refp[dyi:dyi + H, dxi:dxi + W])
            d = d.reshape(ny, 4, 2, 4, nx, 4, 8).sum((3, 6))
            part[dyi * NOFF + dxi] = d.transpose(0, 3, 1, 4, 2).reshape(
                ny * nx, 32)
    v = {}
    for dst, src, mask in _shuffles():
        if dst >= len(keys):
            continue
        a = part if src == "part" else v[src]
        v[dst] = a + a[..., lanes ^ mask]
    assert sorted(v) == list(range(len(keys)))
    bits = np.array([2 + 2 * _bitlen(i // NOFF - R) + 2 * _bitlen(
        i % NOFF - R) for i in range(NOFF * NOFF)], np.int64)
    pen = _wrap32(lam * bits)[:, None, None]
    res = [None] * len(keys)
    for slot in range(2):
        k = own[slot]
        val = np.zeros_like(part)
        for j in range(len(keys)):
            val = np.where(k == j, v[j], val)
        cost = _wrap32(_wrap32(val << 8) + pen)
        merged = np.full(cost.shape[1:], 2 ** 64 - 1, np.uint64)
        for s in range(split):
            r0, r1 = s * NOFF // split, (s + 1) * NOFF // split
            c = cost[r0 * NOFF:r1 * NOFF]
            first = c.argmin(0)                     # strict-less walk
            best = np.take_along_axis(c, first[None], 0)[0]
            idx = np.where(best < 2 ** 31 - 1, 1 + r0 * NOFF + first, 0)
            key = (((best.astype(np.int64) ^ -2 ** 31) & 0xffffffff)
                   .astype(np.uint64) << np.uint64(32)) | idx.astype(
                       np.uint64)
            merged = np.minimum(merged, key)
        for lane in range(32):
            kk = int(k[lane])
            if kk < 0 or kk >= len(keys):
                continue
            for reg in range(ny * nx):
                ry, rx = divmod(reg, nx)
                region = 2 * (ry & 1) + (rx & 1)
                at = _out_index(H, W, kk, lane, ry // 2, rx // 2, region)
                b = int(merged[reg, lane])
                idx = b & 0xffffffff
                cst = int(_wrap32((b >> 32) ^ 0x80000000))
                mv = ((idx - 1) % NOFF - R, (idx - 1) // NOFF - R) if idx \
                    else (0, 0)
                if res[kk] is None:
                    nby, nbx = kme._grid(keys[kk], H, W)
                    res[kk] = (np.zeros(nby * nbx, np.int64),
                               np.zeros((nby * nbx, 2), np.int64))
                first_k = sum(a * b for a, b in (kme._grid(q, H, W)
                                                 for q in keys[:kk]))
                res[kk][0][at - first_k] = cst
                res[kk][1][at - first_k] = mv
    return res


def _case(kind, H=64, W=128):
    rng = np.random.default_rng(7)
    lam = 211
    if kind == "flat":
        orig = np.full((H, W), 90, np.int32)
        ref = orig.copy()
    else:
        base = rng.integers(0, 256, (H + 40, W + 40)).astype(np.int32)
        ref = base[16:16 + H, 16:16 + W]
        # the border case moves the best match into the edge padding
        orig = base[2:2 + H, 30:30 + W] if kind == "border" else \
            (base[19:19 + H, 11:11 + W] + rng.integers(-4, 5, (H, W))
             ).clip(0, 255).astype(np.int32)
        if kind == "wrap":
            lam = 2 ** 27
    return orig, np.pad(ref, R, mode="edge"), lam


@pytest.mark.parametrize("split", [1, 2, 3, 4])
@pytest.mark.parametrize("tt", [False, True])
@pytest.mark.parametrize("kind", ["noisy", "flat", "wrap", "border"])
def test_kernel_model_equals_twin(kind, tt, split):
    orig, refp, lam = _case(kind)
    want = kme.me_sad_reference(torch.as_tensor(orig),
                                torch.as_tensor(refp), lam, tt=tt)
    got = _emulate(orig, refp, lam, tt, split)
    for key, (wc, wm), (gc, gm) in zip(_keys(tt), want, got):
        np.testing.assert_array_equal(gc, wc.numpy().ravel(), err_msg=key)
        np.testing.assert_array_equal(gm, wm.numpy().reshape(-1, 2),
                                      err_msg=key)
