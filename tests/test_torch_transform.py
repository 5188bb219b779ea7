"""Transforms and quantisation: the port against the reference's JAX twins
and the spec model, with the spec-literal DCT tables installed (the
default) and removed at run time in both packages."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from vvctpu.core import rom  # noqa: E402
from vvctpu.core import tables_spec as ref_tables  # noqa: E402
from vvctpu.kernels import transform as jtf  # noqa: E402
from vvctpu.spec import transform as stf  # noqa: E402
from vvctpu_torch.core import rom as trom  # noqa: E402
from vvctpu_torch.core import tables_spec as port_tables  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(params=["installed", "uninstalled"])
def tables(request):
    if request.param == "uninstalled":
        port_tables.uninstall()
        ref_tables.uninstall()
    try:
        assert ref_tables.installed() == port_tables.installed()
        yield request.param
    finally:
        if not ref_tables.installed():
            port_tables.install()
            ref_tables.install()


def _t(a):
    return torch.as_tensor(np.asarray(a, np.int32))


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_fwd_inv_quant_parity(n, tables):
    assert np.array_equal(trom.tr_matrix(rom.DCT2, n),
                          rom.tr_matrix(rom.DCT2, n))
    rng = np.random.default_rng(n)
    x = rng.integers(-255, 256, (n, n)).astype(np.int32)
    for kh in (rom.DCT2, rom.DST7, rom.DCT8):
        for kv in (rom.DCT2, rom.DST7, rom.DCT8):
            c_ref = stf.forward_transform(x, kh, kv)
            c_jax = np.asarray(jtf.forward_transform(jnp.asarray(x), n, n,
                                                     kh, kv))
            c_port = ttf.forward_transform(_t(x), n, n, kh, kv).numpy()
            assert np.array_equal(c_port, c_ref), (n, kh, kv)
            assert np.array_equal(c_port, c_jax), (n, kh, kv)
            for qp in (0, 22, 37, 51, 63):
                l_ref = stf.quantize(c_ref, qp)
                l_port = ttf.quantize(_t(c_ref), n, n, qp).numpy()
                assert np.array_equal(l_port, l_ref), (n, qp)
                d_ref = stf.dequantize(l_ref, qp)
                d_port = ttf.dequantize(_t(l_ref), n, n, qp).numpy()
                assert np.array_equal(d_port, d_ref), (n, qp)
            x_ref = stf.inverse_transform(c_ref, kh, kv)
            x_port = ttf.inverse_transform(_t(c_ref), n, n, kh, kv).numpy()
            assert np.array_equal(x_port, x_ref), (n, kh, kv)


@pytest.mark.parametrize("h,w", [(4, 4), (8, 8), (16, 16), (32, 32)])
def test_rdoq_and_reconstruct_batched(h, w, tables):
    rng = np.random.default_rng(h * 7 + w)
    resi = rng.integers(-255, 256, (6, h, w)).astype(np.int32)
    pred = rng.integers(0, 256, (6, h, w)).astype(np.int32)
    for qp in (22, 32, 45):
        lam = int(stf.lambda_rd_int(qp))
        coef_j = jtf.forward_transform(jnp.asarray(resi), h, w)
        coef_p = ttf.forward_transform(_t(resi), h, w)
        np.testing.assert_array_equal(coef_p.numpy(), np.asarray(coef_j))
        lev_j = jtf.quantize_rdoq_j(coef_j, h, w, qp, lam)
        lev_p = ttf.quantize_rdoq_j(coef_p, h, w, qp, lam)
        np.testing.assert_array_equal(lev_p.numpy(), np.asarray(lev_j))
        rec_j = jtf.reconstruct(jnp.asarray(pred), lev_j, h, w, qp)
        rec_p = ttf.reconstruct(_t(pred), lev_p, h, w, qp)
        np.testing.assert_array_equal(rec_p.numpy(), np.asarray(rec_j))


@pytest.mark.parametrize("net", [-7, -1, 0, 3, 9])
def test_net_shift(net):
    rng = np.random.default_rng(net + 20)
    t = rng.integers(-(1 << 22), 1 << 22, 4096).astype(np.int32)
    want = np.asarray(jtf._net_shift(jnp.asarray(t), jnp.int32(net)))
    np.testing.assert_array_equal(ttf._net_shift(_t(t), net).numpy(), want)


def test_worst_case_inputs_exact():
    """Residual +-255 and coefficients at the int16 clip (the float64
    product must stay exact)."""
    rng = np.random.default_rng(9)
    for n in (4, 8, 16, 32):
        resi = rng.choice([-255, 255], (8, n, n)).astype(np.int32)
        resi[0] = 255
        coef = rng.choice([-32768, 32767], (8, n, n)).astype(np.int32)
        coef[0] = -32768
        np.testing.assert_array_equal(
            ttf.forward_transform(_t(resi), n, n).numpy(),
            np.asarray(jtf.forward_transform(jnp.asarray(resi), n, n)))
        np.testing.assert_array_equal(
            ttf.inverse_transform(_t(coef), n, n).numpy(),
            np.asarray(jtf.inverse_transform(jnp.asarray(coef), n, n)))
