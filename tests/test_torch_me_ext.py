"""Extended-range motion search: the port's me_pass(ext=True) (dense
me_sad stage, then the +-ME_EXT coarse-to-fine stage) against the
reference's XLA path and the spec model, and P decisions with the ext
search against the reference; exact integer equality."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.coding import me as jme  # noqa: E402
from vvctpu.spec import decide as sdecide  # noqa: E402
from vvctpu.spec.inter import ME_EXT, REF_MARGIN  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402
from vvctpu_torch.coding import me as tme  # noqa: E402

from test_me_ext import _textured  # noqa: E402

torch.set_num_threads(1)
H, W = 64, 192
LAM = sdecide.lambda_satd_fp(32)


def _pair(kind):
    if kind == "pan":      # 40 px left: outside the dense +-16 window
        base = _textured(H, W + 64, seed=9)
        return base[:, 40:40 + W], base[:, :W]
    if kind == "flat":     # every offset ties: candidate order decides
        orig = np.full((H, W), 90, np.int32)
        orig[20:30, 40:70] = 120
        return orig, orig.copy()
    # wrapped shift (-7, +37): ext candidates on both axes, wrap seams
    rng = np.random.default_rng(5)
    orig = rng.integers(0, 256, (H, W)).astype(np.int32)
    return orig, np.roll(orig, (-7, 37), (0, 1))


def _maps(orig, ref, tt, ext=True):
    refp80 = np.pad(ref, REF_MARGIN, mode="edge")
    want = jme._me_pass_impl(jnp.asarray(orig), jnp.asarray(refp80),
                             jnp.int32(LAM), frame_w=W, frame_h=H, tt=tt,
                             ext=ext)
    want = dict(zip(jme._ME_KEYS + (jme._TT_KEYS if tt else ()), want))
    got = tme.me_pass(torch.as_tensor(orig), torch.as_tensor(refp80), LAM,
                      frame_w=W, frame_h=H, tt=tt, ext=ext)
    return got, want


@pytest.mark.parametrize("tt", [False, True])
@pytest.mark.parametrize("kind", ["pan", "flat", "shift"])
def test_ext_equals_xla(kind, tt):
    got, want = _maps(*_pair(kind), tt)
    assert list(got) == list(want)
    for k in want:
        for a, b in zip(got[k], want[k]):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f"key {k}")


def test_ext_finds_large_pan_as_spec():
    orig, ref = _pair("pan")
    got, _ = _maps(orig, ref, False)
    assert tuple(got[16][1][1, 4].tolist()) == (40, 0)
    for s in (8, 16, 32):
        scost, smv = sdecide.me_size_pass(orig, ref, s, LAM)
        np.testing.assert_array_equal(got[s][0].numpy(), scost)
        np.testing.assert_array_equal(got[s][1].numpy(), smv)


def test_ext_keeps_rect_keys_dense():
    orig, ref = _pair("pan")
    ext, _ = _maps(orig, ref, True)
    dense, _ = _maps(orig, ref, True, ext=False)
    for k in ext:
        same = all(torch.equal(a, b) for a, b in zip(ext[k], dense[k]))
        assert same == (k not in (8, 16, 32)), k
    assert int(ext[8][1].abs().max()) > 16 >= int(dense[8][1].abs().max())


def test_coarse_search_range():
    orig, ref = _pair("pan")
    refp80 = torch.as_tensor(np.pad(ref, REF_MARGIN, mode="edge"))
    coarse = tme._coarse_search(torch.as_tensor(orig), refp80, frame_w=W,
                                frame_h=H)
    assert sorted(coarse) == [8, 16, 32]
    for k, (dx, dy) in coarse.items():
        assert dx.shape == (H // k, W // k)
        assert int(dx.abs().max()) <= ME_EXT // 4
        assert int(dy.abs().max()) <= ME_EXT // 4
    assert int(coarse[16][0][1, 4]) == 10          # 40 px / 4


@pytest.mark.parametrize("me_ext", [False, True])
def test_p_decisions_with_ext_equal(me_ext):
    orig, ref = _pair("pan")
    refp80 = np.pad(ref, REF_MARGIN, mode="edge")
    want = jdecide.decide_frame_p(orig, jnp.asarray(refp80), 32, 8,
                                  prepadded=True, me_ext=me_ext)
    got = tdecide.decide_frame_p(orig, torch.as_tensor(refp80), 32, 8,
                                 device="cpu", me_ext=me_ext)
    assert got.equal(state.decisions_from_numpy(want))
    if me_ext:
        assert got.inter8.any()
        assert int(np.abs(got.mv8[got.inter8 > 0]).max()) > 16 * 16
