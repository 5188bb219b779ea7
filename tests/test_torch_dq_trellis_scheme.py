"""The dq_trellis CUDA kernel's scheme, checked on the CPU.

The kernel (vvctpu_torch/csrc/dq_trellis.cu) cannot run here, so a NumPy
model of its steps is held at tolerance 0 against the plain twin
(``dq_trellis_plain`` over ``quantize_dq_reference``, the 12-candidate
form) on chip_smoke's trellis cases with seeded signs, for every
transform-block shape of the main path and B in {1, 31, 33}: the four
step costs per position and the even-level choices kept beside the
coefficient, the chain over the running costs with one back-pointer bit
per target state taken from the costs entering the position, the bits
packed eight nibbles to a word as each lane count packs them with warp
shuffles, the trace back over the words (serial, and in chunks walked
from every end state as each lane count walks them), the level
recovered from (coefficient, target state, bit, choices), the sign, and
the blocks each warp's lane groups take (every block copied in and
written out once, a group past the batch running on zeros).  Also: the
shared-memory word that holds a coefficient and its choices, the lane
count chosen for each launch, and a zero coefficient keeping a level the
trellis gives it, as in quantize_dq_j.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import _dq_raster  # noqa: E402
from vvctpu_torch.kernels import dq as kdq  # noqa: E402
from vvctpu_torch.kernels import transform as ktf  # noqa: E402
from vvctpu_torch.spec.transform import lambda_rd_int  # noqa: E402

torch.set_num_threads(1)
BIG = 1 << 28
SHAPES = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (8, 4), (4, 8),
          (16, 8), (8, 16), (32, 16), (16, 32), (64, 32), (32, 64),
          (4, 16), (16, 4), (8, 32), (32, 8)]


def _deq(lv, q1, iq, net):
    t = (2 * lv - (q1 & (lv > 0))) * iq
    if net >= 0:
        c = np.clip(t, -(1 << (30 - net)), 1 << (30 - net)) << net
    else:
        c = (t + (1 << (-net - 1))) >> -net
    return np.clip(c, -32768, 32767)


def _step(a, lv, q1, p):
    qscale, q_bits, iq, net, lam = p
    d = np.minimum(np.abs(a - _deq(lv, q1, iq, net)), 30000)
    rate = np.where(lv > 0, 2 + 2 * np.frexp(np.maximum(lv, 1))[1], 0)
    return (d * d + lam * rate) >> 4


def _zero(a):
    """zero_cost: deq(0) = 0 and rate(0) = 0 in both quantizers."""
    return np.minimum(a, 30000) ** 2 >> 4


def _floor(a, q1, p):
    u = (a * p[0]) >> (p[1] - 1)
    return np.minimum((u + q1) >> 1, 32766)


def _steps(a, p):
    """step_costs: (4, ...) the best even and the odd level's step cost
    of Q0, then of Q1; and ``evens``, bit q set where quantizer q's best
    even level is not 0."""
    s0 = _zero(a)
    out, evens = [], 0
    for q1 in (0, 1):
        lf = _floor(a, q1, p)
        e = _step(a, lf + (lf & 1), q1, p)
        evens = evens | (e < s0).astype(np.int64) << q1
        out += [np.minimum(e, s0), _step(a, lf + 1 - (lf & 1), q1, p)]
    return np.stack(out), evens


def _bits(c, s):
    """choice_bits: bit t set when target t came from its higher state."""
    return ((c[1] + s[1] < c[0] + s[0]).astype(np.int64)
            | (c[3] + s[3] < c[2] + s[2]) << 1
            | (c[1] + s[0] < c[0] + s[1]) << 2
            | (c[3] + s[2] < c[2] + s[3]) << 3)


def _advance(c, s):
    """advance: the costs after a position, minus their minimum taken off
    the costs entering it, clamped at 2^28."""
    n = [np.minimum(c[0] + s[0], c[1] + s[1]),
         np.minimum(c[2] + s[2], c[3] + s[3]),
         np.minimum(c[0] + s[1], c[1] + s[0]),
         np.minimum(c[2] + s[3], c[3] + s[2])]
    negm = np.maximum(-np.minimum(c[0], c[1]) - np.minimum(s[0], s[1]),
                      -np.minimum(c[2], c[3]) - np.minimum(s[2], s[3]))
    return [np.minimum(x + negm, BIG) for x in n]


def _level(a, t, y, evens, p):
    """level_of: Q1 for odd targets, parity y ^ (t >> 1), the best even
    level from ``evens``."""
    lf = _floor(a, t & 1, p)
    even = np.where((evens >> (t & 1)) & 1, lf + (lf & 1), 0)
    return np.where((y ^ (t >> 1)) & 1, lf + 1 - (lf & 1), even)


def _pack(nib, lanes):
    """The kernel's bit words of one block per lane group, from the
    nibbles (n, G) in walk order: tiles of ``lanes`` positions, the
    nibbles of each 8 lanes gathered by __shfl_down_sync into the first
    of them, which stores the word."""
    n, G = nib.shape
    k = 32 // lanes
    words = np.full((n // 8, G), -1, np.int64)
    nwarp = -(-G // k)
    lane_g, lane_i = np.divmod(np.arange(32), lanes)
    for t in range(n // lanes):
        gi = np.arange(nwarp)[:, None] * k + lane_g            # (warp, lane)
        x = np.where(gi < G, nib[t * lanes + lane_i, np.minimum(gi, G - 1)],
                     0)
        for d in (1, 2, 4):
            src = np.arange(32) + d
            down = np.where(src < 32, x[:, np.minimum(src, 31)], x)
            x = x | down << (4 * d)
        st = (lane_i & 7) == 0
        w = (t * lanes + lane_i) >> 3
        keep = st[None, :] & (gi < G)
        words[np.broadcast_to(w, gi.shape)[keep], gi[keep]] = (
            x[keep] & 0xFFFFFFFF)
    return words


def _model(coef, walk, p):
    """(B, n) signed levels by the kernel's steps, and each block's bit
    words (n // 8, B)."""
    r = walk.astype(np.int64)
    v = coef.astype(np.int64)[:, r].T                     # (n, B) walk
    a = np.abs(v)
    s, evens = _steps(a, p)                               # (4, n, B)
    B = coef.shape[0]
    c = [np.zeros(B, np.int64)] + [np.full(B, BIG, np.int64)] * 3
    nib = np.empty_like(a)
    for j in range(a.shape[0]):
        nib[j] = _bits(c, s[:, j])
        c = _advance(c, s[:, j])
    words = (nib.reshape(-1, 8, B) << (4 * np.arange(8))[:, None]).sum(1)
    final = np.argmin(np.stack(c), 0)                     # first minimum
    walked, _ = _walk_words(words, final, len(words) - 1, 0)
    ts = (walked[:, None] >> (4 * np.arange(8))[:, None] & 15).reshape(-1, B)
    lev = _level(a, ts & 3, ts >> 2, evens, p)
    out = np.empty_like(coef, dtype=np.int64)
    out[:, r] = np.where(v < 0, -lev, lev).T
    return out, nib, words, walked, final


def _walk_words(words, st, hi, lo):
    """The trace back over words hi down to lo from the states ``st``
    after word hi: each word's (target state, bit) nibbles, and the
    states before word lo."""
    walked = np.zeros_like(words)
    for w in range(hi, lo - 1, -1):
        for k in range(7, -1, -1):
            y = (words[w] >> (4 * k + st)) & 1
            walked[w] |= (st | y << 2) << (4 * k)
            st = (st << 1 & 2) | y
    return walked, st


def _chunked(words, final, lanes):
    """The kernel's trace back: lanes / 4 chunks of whole words (fewer for short walks), each walked from each of the 4
    states it may end in; the true ends chained from the last chunk
    down; each word read from its chunk's true copy."""
    nw, B = words.shape
    nc = min(lanes // 4, nw)
    per = nw // nc
    copies = np.zeros((4, nw, B), np.int64)
    ends = np.zeros((nc, 4, B), np.int64)
    for c in range(nc):
        for h in range(4):
            walked, ends[c, h] = _walk_words(words, np.full(B, h),
                                             (c + 1) * per - 1, c * per)
            copies[h, c * per:(c + 1) * per] = walked[c * per:(c + 1) * per]
    s, starts = final, np.zeros((nc, B), np.int64)
    for c in range(nc - 1, -1, -1):
        starts[c] = s
        s = ends[c, s, np.arange(B)]
    return copies[starts[np.arange(nw) // per], np.arange(nw)[:, None],
                  np.arange(B)]


def _groups(B, lanes, n):
    """The block each (warp, lane group) of the launch copies in and
    writes out, from the kernel's launch arithmetic: -1 for a group past
    the batch, which runs on zeros and writes nothing."""
    k = 32 // lanes
    tb_warps = -(-B // k)
    warps = min(kdq.SMEM_LIMIT // kdq.warp_smem(n, lanes), 4, tb_warps)
    blocks = []
    for blk in range(-(-tb_warps // warps)):
        for wp in range(warps):
            b0 = (blk * warps + wp) * k
            if b0 < B:
                live = min(k, B - b0)
                blocks += [b0 + g if g < live else -1 for g in range(k)]
    return np.asarray(blocks)


@pytest.mark.parametrize("hw", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_kernel_scheme_equals_twin(hw):
    h, w = hw
    n = h * w
    rng = np.random.default_rng(h * 100 + w)
    coef = np.concatenate([_dq_raster(rng, h, w),
                           _dq_raster(rng, h, w)[:2]])    # 33 blocks
    walk = ktf.walk32(h, w)
    flat = coef.reshape(33, n)
    for qp in (22, 37):
        p = ktf.dq_params(h, w, qp, lambda_rd_int(qp))
        got, nib, words, walked, final = _model(flat, walk, p)
        want = kdq.dq_trellis_plain(torch.as_tensor(coef),
                                    torch.as_tensor(walk), *p).numpy()
        np.testing.assert_array_equal(got.reshape(want.shape), want)
        if qp == 22:
            assert np.abs(want[:24]).sum() > 0
            for lanes in kdq.LANES:     # the layout does not depend on qp
                if kdq.lanes_ok(n, lanes):
                    np.testing.assert_array_equal(_pack(nib, lanes), words)
                if lanes <= n:
                    np.testing.assert_array_equal(
                        _chunked(words, final, lanes), walked)
        for B in (1, 31, 33):
            for lanes in kdq.LANES:
                if not kdq.lanes_ok(n, lanes):
                    continue
                blocks = _groups(B, lanes, n)
                live = blocks[blocks >= 0]
                assert np.array_equal(np.sort(live), np.arange(B))
                # each group's levels are the model's on its block (blocks
                # are independent); the twin's on the first B blocks
                out = np.empty((B, n), np.int64)
                out[live] = got[live]
                np.testing.assert_array_equal(out, want[:B].reshape(B, n))


def test_coefficient_word_keeps_value_and_choices():
    """coef_of and the word steps_at writes: the value (any magnitude up
    to 32768) in bits 0-19 and the even-level choices in bits 20-21,
    read back alike after a second write."""
    v = np.arange(-32768, 32769, dtype=np.int64)
    for evens in range(4):
        w = ((v & 0xFFFFF) | evens << 20).astype(np.uint32).view(np.int32)
        back = (w.astype(np.uint32) << np.uint32(12)).view(np.int32) >> 12
        np.testing.assert_array_equal(back, v)
        np.testing.assert_array_equal(w.view(np.uint32) >> np.uint32(20),
                                      evens)
        np.testing.assert_array_equal(
            ((back.astype(np.int64) & 0xFFFFF) | evens << 20).astype(
                np.uint32).view(np.int32), w)


def test_lanes_for_takes_a_kernel_lane_count():
    """lanes_for picks a lane count the kernel takes (at most n, shared
    memory within its limit) for every shape and batch size; a warp per
    block for one block, four blocks per warp for a 1080p frame of 8x8."""
    for h, w in SHAPES:
        n = h * w
        for B in (1, 2, 31, 33, 100, 1000, 8160, 32640):
            lanes = kdq.lanes_for(n, B)
            assert lanes in kdq.LANES and kdq.lanes_ok(n, lanes)
        assert kdq.lanes_for(n, 1) == min(32, n)
    assert kdq.lanes_for(64, 32640) == 8


def test_zero_coefficient_keeps_its_level():
    """The trellis may give a zero coefficient a nonzero level (here in
    sparse 8x8 blocks at qp 22, where a level 1 moves the state); the
    model and the twin keep it positive, as quantize_dq_j and the spec
    model do (a multiply by the sign would zero it)."""
    rng = np.random.default_rng(4)
    coef = (rng.integers(-3, 4, (3, 8, 8)) * rng.integers(0, 2, (3, 8, 8))
            * rng.choice([40, 300], (3, 1, 1))).astype(np.int32)
    p = ktf.dq_params(8, 8, 22, lambda_rd_int(22))
    got = kdq.dq_trellis_plain(torch.as_tensor(coef),
                               torch.as_tensor(ktf.walk32(8, 8)), *p).numpy()
    assert ((got > 0) & (coef == 0)).any()
    model = _model(coef.reshape(3, 64), ktf.walk32(8, 8), p)[0]
    np.testing.assert_array_equal(model.reshape(coef.shape), got)
