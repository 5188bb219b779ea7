"""Motion compensation: the port's batched MC against the spec model and
the reference's JAX twin, every phase class, exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.kernels import mc as jmc  # noqa: E402
from vvctpu.spec import inter as sinter  # noqa: E402
from vvctpu_torch.kernels import mc as tmc  # noqa: E402

torch.set_num_threads(1)


def _i32(v):
    return torch.as_tensor(np.asarray(v, np.int32))


class TestMcParity:
    @pytest.mark.parametrize("s", [8, 16, 32])
    def test_luma_all_phase_classes(self, s):
        rng = np.random.default_rng(s)
        ref = rng.integers(0, 256, (96, 96)).astype(np.int32)
        refp = sinter.pad_reference(ref)
        mvs = [(0, 0), (16, -32), (5, 0), (0, -7), (13, 29), (-100, 50),
               (33, -33), (1, 1)]
        n = len(mvs)
        got = tmc.mc_luma_block(_i32(refp), _i32([16] * n), _i32([16] * n),
                                s, _i32([m[0] for m in mvs]),
                                _i32([m[1] for m in mvs])).numpy()
        for i, (mvx, mvy) in enumerate(mvs):
            want = sinter.mc_luma(refp, 16, 16, s, s, mvx, mvy)
            assert np.array_equal(got[i], want), (s, mvx, mvy)
            jw = np.asarray(jmc.mc_luma_block(jnp.asarray(refp), 16, 16, s,
                                              mvx, mvy))
            assert np.array_equal(got[i], jw), (s, mvx, mvy)

    @pytest.mark.parametrize("s", [4, 8, 16])
    def test_chroma_all_phase_classes(self, s):
        rng = np.random.default_rng(100 + s)
        ref = rng.integers(0, 256, (64, 64)).astype(np.int32)
        refp = sinter.pad_reference(ref, sinter.REF_MARGIN // 2)
        mvs = [(0, 0), (32, -64), (5, 0), (0, -7), (13, 29), (-50, 21)]
        n = len(mvs)
        got = tmc.mc_chroma_block(_i32(refp), _i32([8] * n), _i32([8] * n),
                                  s, _i32([m[0] for m in mvs]),
                                  _i32([m[1] for m in mvs])).numpy()
        for i, (mvx, mvy) in enumerate(mvs):
            want = sinter.mc_chroma(refp, 8, 8, s, s, mvx, mvy,
                                    margin=sinter.REF_MARGIN // 2)
            assert np.array_equal(got[i], want), (s, mvx, mvy)

    def test_window_clamped_like_dynamic_slice(self):
        """An MV reaching past the padded plane reads the clamped window,
        as jax.lax.dynamic_slice does."""
        rng = np.random.default_rng(1)
        refp = sinter.pad_reference(
            rng.integers(0, 256, (32, 32)).astype(np.int32))
        for mvx, mvy in [(-16 * 90, 0), (0, 16 * 95), (16 * 200, -16 * 200)]:
            got = tmc.mc_luma_block(_i32(refp), _i32([8]), _i32([8]), 8,
                                    _i32([mvx]), _i32([mvy])).numpy()[0]
            want = np.asarray(jmc.mc_luma_block(jnp.asarray(refp), 8, 8, 8,
                                                mvx, mvy))
            assert np.array_equal(got, want), (mvx, mvy)
