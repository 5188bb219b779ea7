"""Tests that need the card: the hand-written kernel against its plain
twin, and the float64 transform products against the CPU path.  They
skip without CUDA; on the GPU machine (which has no JAX, so the JAX test
configuration is bypassed):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vvctpu_torch.core import rom  # noqa: E402
from vvctpu_torch.kernels import me_sad as kme  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("kind", ["noisy", "flat"])
@pytest.mark.parametrize("tt", [False, True])
def test_me_sad_kernel_equals_twin(cuda, tt, kind):
    rng = np.random.default_rng(5)
    if kind == "flat":
        orig = np.full((128, 192), 77, np.int32)
        ref = np.full((160, 224), 77, np.int32)
    else:
        orig = rng.integers(0, 256, (128, 192)).astype(np.int32)
        ref = np.pad(np.roll(orig, (2, 3), (0, 1)), 16, mode="edge")
    go = torch.as_tensor(orig, device=cuda)
    gr = torch.as_tensor(ref.astype(np.int32), device=cuda)
    before = kme.launches
    got = kme.me_sad(go, gr, 211, tt=tt)
    assert kme.launches == before + 1
    want = kme.me_sad_reference(go, gr, 211, tt=tt)
    for (a, b), (c, d) in zip(got, want):
        assert torch.equal(a, c) and torch.equal(b, d)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_transforms_card_equals_cpu_worst_case(cuda, n):
    rng = np.random.default_rng(n)
    resi = rng.choice([-255, 255], (16, n, n)).astype(np.int32)
    coef = rng.choice([-32768, 32767], (16, n, n)).astype(np.int32)
    for kh in (rom.DCT2, rom.DST7, rom.DCT8):
        for fn, x in ((ttf.forward_transform, resi),
                      (ttf.inverse_transform, coef)):
            cpu = fn(torch.as_tensor(x), n, n, kh, kh)
            gpu = fn(torch.as_tensor(x, device=cuda), n, n, kh, kh)
            assert torch.equal(gpu.cpu(), cpu), (fn.__name__, n, kh)
