"""Intra prediction and reference building: the port against the spec
model and the reference's JAX twins, all 67 modes, exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.core import rom  # noqa: E402
from vvctpu.kernels import intra_pred as jintra  # noqa: E402
from vvctpu.spec import intra as sintra  # noqa: E402
from vvctpu_torch.kernels import intra_pred as tintra  # noqa: E402

torch.set_num_threads(1)


def _refs(s, seed):
    rng = np.random.default_rng(seed)
    top = rng.integers(0, 256, 2 * s + 1).astype(np.int32)
    left = rng.integers(0, 256, 2 * s + 1).astype(np.int32)
    left[0] = top[0]
    return top, left


def _predict_all(top, left, s, is_luma):
    n = rom.NUM_LUMA_MODE
    return tintra.predict(torch.as_tensor(top)[None].repeat(n, 1),
                          torch.as_tensor(left)[None].repeat(n, 1),
                          torch.arange(n, dtype=torch.int32), s=s,
                          is_luma=is_luma).numpy()


class TestIntraParity:
    @pytest.mark.parametrize("s", [4, 8, 16, 32])
    def test_all_modes_luma(self, s):
        top, left = _refs(s, s)
        got = _predict_all(top, left, s, True)
        for mode in range(rom.NUM_LUMA_MODE):
            ref = sintra.predict(top, left, mode, s, s, False)
            assert np.array_equal(got[mode], ref), f"mode {mode} size {s}"
        jgot = np.asarray(jintra.predict(jnp.asarray(top), jnp.asarray(left),
                                         34, s=s, is_luma=True))
        assert np.array_equal(got[34], jgot)

    @pytest.mark.parametrize("s", [4, 8, 16])
    def test_all_modes_chroma(self, s):
        top, left = _refs(s, 100 + s)
        got = _predict_all(top, left, s, False)
        for mode in range(rom.NUM_LUMA_MODE):
            ref = sintra.predict(top, left, mode, s, s, True)
            assert np.array_equal(got[mode], ref), f"chroma {mode} size {s}"


def _morton_py(x, y, n_ctu_x, log2c):
    nb = log2c - 3
    ctu = (y >> log2c) * n_ctu_x + (x >> log2c)
    gx, gy = (x >> 3) & ((1 << nb) - 1), (y >> 3) & ((1 << nb) - 1)
    m = 0
    for b in range(nb):
        m |= ((gx >> b) & 1) << (2 * b) | ((gy >> b) & 1) << (2 * b + 1)
    return ctu * (1 << (2 * nb)) + m


@pytest.mark.parametrize("log2c", [6, 7])
def test_morton8_ctu_argument(log2c):
    xs, ys = np.meshgrid(np.arange(0, 256, 8), np.arange(0, 256, 8))
    xs, ys = xs.ravel().astype(np.int32), ys.ravel().astype(np.int32)
    n_ctu_x = 256 >> log2c
    got = tintra.morton8(torch.as_tensor(xs), torch.as_tensor(ys), n_ctu_x,
                         log2c).numpy()
    want = [_morton_py(int(x), int(y), n_ctu_x, log2c)
            for x, y in zip(xs, ys)]
    np.testing.assert_array_equal(got, want)
    if log2c == 6:     # the reference reads its module-global CTU size
        np.testing.assert_array_equal(
            got, np.asarray(jintra.morton8(jnp.asarray(xs), jnp.asarray(ys),
                                           n_ctu_x)))


class TestReferenceParity:
    CASES = [(0, 0, 8), (8, 0, 8), (0, 8, 8), (56, 56, 8), (32, 0, 32),
             (0, 32, 16), (120, 64, 8), (64, 64, 32)]

    def test_refs_match_jax_batched(self):
        """Geometric (z-order) availability for a batch of blocks == the
        reference's per-block build, luma and chroma."""
        w = h = 128
        rng = np.random.default_rng(4)
        plane = rng.integers(0, 256, (h, w)).astype(np.int32)
        buf = np.zeros((h + 1 + tintra.MARGIN, w + 1 + tintra.MARGIN),
                       np.int32)
        buf[1:h + 1, 1:w + 1] = plane
        for s in (8, 16, 32):
            cases = [(x, y) for x, y, cs in self.CASES if cs == s]
            xs = torch.as_tensor([c[0] for c in cases], dtype=torch.int32)
            ys = torch.as_tensor([c[1] for c in cases], dtype=torch.int32)
            for is_luma, sz in ((True, s), (False, s // 2)):
                fx = xs if is_luma else xs // 2
                fy = ys if is_luma else ys // 2
                fw = w if is_luma else w // 2
                top, left = tintra.build_references(
                    torch.as_tensor(buf), fx, fy, s=sz, is_luma=is_luma,
                    frame_w=fw, frame_h=fw, n_ctu_x=w // 64)
                for i, (x, y) in enumerate(cases):
                    jt, jl = jintra.build_references(
                        jnp.asarray(buf), int(fx[i]), int(fy[i]), s=sz,
                        is_luma=is_luma, frame_w=fw, frame_h=fw,
                        n_ctu_x=w // 64)
                    assert np.array_equal(top[i].numpy(), np.asarray(jt))
                    assert np.array_equal(left[i].numpy(), np.asarray(jl))

    @pytest.mark.parametrize("s", [8, 16])
    def test_in_frame_only_matches_spec(self, s):
        w, h = 64, 48
        rng = np.random.default_rng(s)
        plane = rng.integers(0, 256, (h, w)).astype(np.int32)
        buf = np.zeros((h + 1 + tintra.MARGIN, w + 1 + tintra.MARGIN),
                       np.int32)
        buf[1:h + 1, 1:w + 1] = plane
        valid = np.ones((h, w), bool)
        pts = [(x, y) for y in range(0, h - s + 1, s)
               for x in range(0, w - s + 1, s)]
        top, left = tintra.build_references(
            torch.as_tensor(buf), torch.as_tensor([p[0] for p in pts]),
            torch.as_tensor([p[1] for p in pts]), s=s, is_luma=True,
            frame_w=w, frame_h=h, n_ctu_x=1, in_frame_only=True)
        for i, (x, y) in enumerate(pts):
            rt, rl = sintra.build_references(plane, valid, x, y, s, s)
            assert np.array_equal(top[i].numpy(), rt)
            assert np.array_equal(left[i].numpy(), rl)
