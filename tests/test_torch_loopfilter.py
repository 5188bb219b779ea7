"""Loop filters: the port's deblocking, SAO decide and SAO apply against
the reference's JAX twins and the spec model, exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from vvctpu.kernels import loopfilter as jlf  # noqa: E402
from vvctpu.spec import deblock as sdb  # noqa: E402
from vvctpu.spec import decide as sdec  # noqa: E402
from vvctpu.spec import sao as ssao  # noqa: E402
from vvctpu_torch import state  # noqa: E402
from vvctpu_torch.kernels import loopfilter as tlf  # noqa: E402
from vvctpu_torch.spec import sao as tsao  # noqa: E402

torch.set_num_threads(1)


def _frame_and_dec(seed=21, h=64, w=128, qp=32):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    Y = (90 + 70 * np.sin(xx / 7.0) + 50 * np.cos(yy / 5.0)
         + rng.integers(-20, 20, (h, w))).clip(0, 255).astype(np.int32)
    cb = rng.integers(0, 255, (h // 2, w // 2)).astype(np.int32)
    cr = rng.integers(0, 255, (h // 2, w // 2)).astype(np.int32)
    return [Y, cb, cr], sdec.decide_frame(Y, qp, 8)


def _t(planes):
    return [torch.as_tensor(np.asarray(p, np.int32)) for p in planes]


@pytest.mark.parametrize("qp", [22, 32, 45])
def test_deblock_bit_identical(qp):
    planes, dec = _frame_and_dec(seed=qp)
    ref = sdb.deblock_frame([p.copy() for p in planes], dec, qp, 8)
    jgot = jlf.deblock_frame_j(planes, dec, qp, 8)
    got = tlf.deblock_frame_j(_t(planes), state.decisions_from_numpy(dec),
                              qp, 8)
    for a, b, c in zip(got, ref, jgot):
        assert np.array_equal(a.numpy(), b)
        assert np.array_equal(a.numpy(), np.asarray(c))


def test_sao_apply_bit_identical():
    planes, dec = _frame_and_dec(seed=9)
    rec = sdb.deblock_frame([p.copy() for p in planes], dec, 32, 8)
    params = ssao.decide_sao([p.copy() for p in planes], rec, 32, 64, 8)
    ref = ssao.apply_sao(rec, params, 64, 8)
    tparams = tsao.SaoParams(type=params.type, offsets=params.offsets,
                             band_pos=params.band_pos)
    got = tlf.apply_sao_j(_t(rec), tparams, 64, 8)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), b)


@pytest.mark.parametrize("qp", [27, 37])
def test_finish_frame_decide_and_apply(qp):
    """Deblock + SAO decide + SAO apply chain == the reference's."""
    orig, dec = _frame_and_dec(seed=qp + 1)
    rng = np.random.default_rng(qp)
    recp = [np.clip(p + rng.integers(-6, 7, p.shape), 0, 255)
            .astype(np.int32) for p in orig]
    lam = int(round(0.57 * (2.0 ** ((qp - 12) / 3.0)) * 256.0))
    want = jlf.finish_frame_j(recp, dec, qp, lam, orig)
    got = tlf.finish_frame_j(_t(recp), state.decisions_from_numpy(dec), qp,
                             lam, orig)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=f"output {i}")
    assert (got[3] > 0).any()       # some CTU chose an SAO type
