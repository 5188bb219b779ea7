"""Mode and partition decisions: the port against the reference's JAX
decision passes for I and P frames (FrameDecisions.equal), exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.coding import decide as jdecide  # noqa: E402
from vvctpu.spec import codec as scodec  # noqa: E402
from vvctpu.spec import sequence as seq  # noqa: E402
from vvctpu.spec.inter import REF_MARGIN  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.coding import decide as tdecide  # noqa: E402

from test_inter_parity import motion_frames  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("s", [8, 16, 32])
def test_satd(s):
    rng = np.random.default_rng(s)
    d = rng.integers(-255, 256, (5, s, s)).astype(np.int32)
    got = tdecide._satd(torch.as_tensor(d), s).numpy()
    want = [int(jdecide._satd(jnp.asarray(d[i]), s)) for i in range(5)]
    np.testing.assert_array_equal(got, want)


def _padded(frames, i):
    sps = seq.EncoderConfig().make_sps(96, 64)
    return scodec.pad_planes(frames[i], sps)[0]


@pytest.mark.parametrize("qp", [22, 37])
def test_i_frame_decisions_equal(qp):
    po = _padded(motion_frames(), 0)
    want = jdecide.decide_frame(po, qp, 8)
    got = tdecide.decide_frame(po, qp, 8, device="cpu")
    assert got.equal(state.decisions_from_numpy(want))


def test_p_frame_decisions_equal():
    frames = motion_frames()
    po, pr = _padded(frames, 1), _padded(frames, 0)
    refp80 = np.pad(pr, REF_MARGIN, mode="edge")
    want = jdecide.decide_frame_p(po, jnp.asarray(refp80), 32, 8,
                                  prepadded=True, me_ext=False)
    got = tdecide.decide_frame_p(po, torch.as_tensor(refp80), 32, 8,
                                 device="cpu")
    assert got.inter8.any() and (got.inter8 == 0).any()
    assert got.equal(state.decisions_from_numpy(want))
