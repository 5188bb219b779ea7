"""Motion search: the port's me_sad twin against the reference's XLA dense
stage and its Pallas kernel (interpreted), and sub-pel refinement against
the reference; exact integer equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.coding import me as jme  # noqa: E402
from vvctpu.spec.inter import REF_MARGIN  # noqa: E402
from vvctpu_torch.coding import me as tme  # noqa: E402
from vvctpu_torch.kernels import me_sad as kme  # noqa: E402

torch.set_num_threads(1)
H, W = 64, 128
LAM = 211


def _pair(kind):
    rng = np.random.default_rng(3)
    if kind == "flat":      # every offset ties: first-min order decides
        orig = np.full((H, W), 90, np.int32)
        orig[20:30, 40:70] = 120
        return orig, orig.copy()
    orig = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = (np.roll(orig, (1, -2), (0, 1))
           + rng.integers(-4, 5, (H, W))).clip(0, 255).astype(np.int32)
    return orig, ref


def _twin(orig, ref, tt):
    refp = np.pad(ref, 16, mode="edge")
    return kme.me_sad(torch.as_tensor(orig), torch.as_tensor(refp), LAM,
                      tt=tt)


@pytest.mark.parametrize("tt", [False, True])
@pytest.mark.parametrize("kind", ["noisy", "flat"])
def test_twin_equals_xla_and_pallas(kind, tt):
    orig, ref = _pair(kind)
    refp80 = jnp.asarray(np.pad(ref, REF_MARGIN, mode="edge"))
    jorig = jnp.asarray(orig)
    xla = jme._me_pass_impl(jorig, refp80, jnp.int32(LAM), frame_w=W,
                            frame_h=H, tt=tt, ext=False)
    pal = jme.me_pass_pallas_dense(jorig, refp80, LAM, frame_w=W,
                                   frame_h=H, tt=tt, interpret=True)
    got = _twin(orig, ref, tt)
    assert len(got) == len(xla) == len(pal) == (11 if tt else 7)
    for k, (c, m), (xc, xm), (pc, pm) in zip(kme.KEYS, got, xla, pal):
        for a, b, c2 in ((c, xc, pc), (m, xm, pm)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"key {k} vs XLA")
            np.testing.assert_array_equal(a.numpy(), np.asarray(c2),
                                          err_msg=f"key {k} vs Pallas")


def test_me_pass_keys_and_ext_raises():
    """Both stages give the reference's keys; the ext stage, like the
    dense one, raises for a frame that is not a multiple of 64."""
    orig, ref = _pair("noisy")
    refp80 = torch.as_tensor(np.pad(ref, REF_MARGIN, mode="edge"))
    for ext in (False, True):
        maps = tme.me_pass(torch.as_tensor(orig), refp80, LAM, frame_w=W,
                           frame_h=H, ext=ext)
        assert list(maps) == list(jme._ME_KEYS)
    with pytest.raises(ValueError, match="multiple of 64"):
        tme.me_pass(torch.as_tensor(orig[:56]), refp80[:56 + 2 * REF_MARGIN],
                    LAM, frame_w=W, frame_h=56, ext=True)


def test_offsets_with_bits():
    np.testing.assert_array_equal(tme._offsets_with_bits(),
                                  jme._offsets_with_bits())


def test_quarter_phase_planes():
    rng = np.random.default_rng(11)
    refp = rng.integers(0, 256, (48 + 2 * REF_MARGIN, 64 + 2 * REF_MARGIN))
    refp = refp.astype(np.int32)
    want = np.asarray(jme.quarter_phase_planes(jnp.asarray(refp), 8))
    got = tme.quarter_phase_planes(torch.as_tensor(refp), 8).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("s", [8, 16, 32])
def test_refine_pass(s):
    orig, ref = _pair("noisy")
    refp80 = np.pad(ref, REF_MARGIN, mode="edge")
    rng = np.random.default_rng(s)
    int_mv = rng.integers(-16, 17, (H // s, W // s, 2)).astype(np.int32)
    wc, wm = jme.refine_pass(jnp.asarray(orig), jnp.asarray(refp80),
                             jnp.asarray(int_mv), np.int32(LAM), s=s,
                             frame_w=W, frame_h=H)
    gc, gm = tme.refine_pass(torch.as_tensor(orig), torch.as_tensor(refp80),
                             torch.as_tensor(int_mv), LAM, s=s, frame_w=W,
                             frame_h=H)
    np.testing.assert_array_equal(gc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_cpu_tensor_takes_twin_and_counts_no_launch():
    orig, ref = _pair("noisy")
    before = kme.launches
    _twin(orig, ref, False)
    assert kme.launches == before
