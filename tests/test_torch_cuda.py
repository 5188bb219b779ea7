"""Tests that need the card: the hand-written kernels (motion search,
dependent-quantization trellis) against their plain twins, the float64
transform products against the CPU path, the random-access path (ext
motion search, B decisions, frame-batched wave), all-intra with the
intra toolset (the transform and chroma choices included), and SBT, DQ
and ALF on the card against the CPU.  They skip without CUDA; on the
GPU machine (which has no JAX, so the JAX test configuration is
bypassed):

    python -m pytest tests/test_torch_cuda.py -m cuda -q --noconftest
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vvctpu_torch.coding import me as tme  # noqa: E402
from vvctpu_torch.core import rom  # noqa: E402
from vvctpu_torch.kernels import me_sad as kme  # noqa: E402
from vvctpu_torch.kernels import transform as ttf  # noqa: E402
from vvctpu_torch.pipeline import encoder as tenc  # noqa: E402
from vvctpu_torch.spec import sequence as tseq  # noqa: E402
from vvctpu_torch.spec.inter import REF_MARGIN  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _me_case(kind, H, W):
    """(orig, edge-padded ref, lam): noisy motion, a flat frame where every
    offset ties, a lam whose lam * bits wraps int32, and motion into the
    edge-clamped border of the padded reference."""
    rng = np.random.default_rng(5)
    lam = 2 ** 27 if kind == "wrap" else 211
    if kind == "flat":
        orig = np.full((H, W), 77, np.int32)
        ref = orig.copy()
    else:
        base = rng.integers(0, 256, (H + 40, W + 40)).astype(np.int32)
        ref = base[16:16 + H, 16:16 + W]
        orig = base[2:2 + H, 30:30 + W] if kind == "border" else \
            (base[18:18 + H, 13:13 + W] + rng.integers(-6, 7, (H, W))
             ).clip(0, 255).astype(np.int32)
    return orig, np.pad(ref, 16, mode="edge").astype(np.int32), lam


@pytest.mark.parametrize("shape", [(64, 64), (128, 192), (1088, 1920)])
@pytest.mark.parametrize("kind", ["noisy", "flat", "wrap", "border"])
@pytest.mark.parametrize("tt", [False, True])
def test_me_sad_kernel_equals_twin(cuda, tt, kind, shape):
    orig, ref, lam = _me_case(kind, *shape)
    go = torch.as_tensor(orig, device=cuda)
    gr = torch.as_tensor(ref, device=cuda)
    before = kme.launches
    got = kme.me_sad(go, gr, lam, tt=tt)
    assert kme.launches == before + 1
    want = kme.me_sad_reference(go, gr, lam, tt=tt)
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


def _textured(h, w, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    return (96 + 60 * np.sin(xx / 9.0) + 40 * np.cos(yy / 7.0)
            + 25 * np.sin((xx + 2 * yy) / 4.0)
            + rng.integers(-6, 7, (h, w))).clip(0, 255).astype(np.int32)


@pytest.mark.parametrize("tt", [False, True])
def test_ext_search_card_equals_cpu(cuda, tt):
    base = _textured(128, 256, 9)
    orig, ref = base[:, 40:232], base[:, :192]      # a 40 px pan
    refp = np.pad(ref, REF_MARGIN, mode="edge")
    maps = [tme.me_pass(torch.as_tensor(orig, device=d),
                        torch.as_tensor(refp, device=d), 211, frame_w=192,
                        frame_h=128, tt=tt, ext=True)
            for d in (cuda, torch.device("cpu"))]
    assert tuple(maps[0][16][1][1, 4].tolist()) == (40, 0)
    for k in maps[1]:
        for a, b in zip(maps[0][k], maps[1][k]):
            assert torch.equal(a.cpu(), b), k


def test_ra_gop4_card_equals_cpu(cuda):
    """I0 P4 (ext) B2 (ext) and the batched {B1, B3}: same bytes and
    recon on the card as on the CPU; the card decodes its own stream."""
    frames = []
    for t in range(5):
        y = np.roll(_textured(64, 96, 30), (2 * t, 3 * t), (0, 1))
        c = np.full((32, 48), 128 + t, np.int32)
        frames.append([y, c, c.copy()])
    cfg = tseq.EncoderConfig(qp=32, intra_period=0, gop=4)
    data, rec, bits = tenc.encode_sequence(frames, cfg, device=cuda)
    cdata, crec, cbits = tenc.encode_sequence(frames, cfg, device="cpu")
    assert data == cdata and bits == cbits
    out, _ = tenc.decode_sequence(data, check_hash=True, device=cuda)
    for a, b, c in zip(rec, crec, out):
        for i in range(3):
            assert np.array_equal(a[i], b[i]) and np.array_equal(a[i], c[i])


AI_TOOLS = dict(mts=True, lfnst=True, isp=True, mip=True, mrl=True,
                cclm=True)


def test_ai_intra_tools_card_equals_cpu(cuda):
    """All-intra with the six intra tools on chip_smoke phase 5a's clip:
    same bytes and recon on the card as on the CPU, and the card decodes
    its own stream with hashes verified."""
    from chip_smoke import synth_frames
    frames = synth_frames(3, 64, 96, seed=2)
    cfg = tseq.EncoderConfig(qp=32, **AI_TOOLS)
    data, rec, bits = tenc.encode_sequence(frames, cfg, device=cuda)
    cdata, crec, cbits = tenc.encode_sequence(frames, cfg, device="cpu")
    assert data == cdata and bits == cbits
    out, _ = tenc.decode_sequence(data, check_hash=True, device=cuda)
    for a, b, c in zip(rec, crec, out):
        for i in range(3):
            assert np.array_equal(a[i], b[i]) and np.array_equal(a[i], c[i])


@pytest.mark.parametrize("s", [8, 16, 32])
def test_choose_tx_card_equals_cpu(cuda, s):
    """The stacked MTS/LFNST choice on a batch with all-zero, constant
    and saturated rows (ties) and the MIP penalty."""
    rng = np.random.default_rng(s)
    resi = rng.integers(-60, 61, (64, s, s)).astype(np.int32)
    resi[0], resi[1], resi[2], resi[3] = 0, 1, 255, -255
    mode = rng.integers(0, 67, 64).astype(np.int32)
    allow = np.arange(64) % 4 > 0
    outs = [ttf.choose_tx(torch.as_tensor(resi, device=d), s, 32, 347,
                          torch.as_tensor(mode, device=d), mts=True,
                          lfnst=True, rdoq=True,
                          allow=torch.as_tensor(allow, device=d))
            for d in (cuda, torch.device("cpu"))]
    for a, b in zip(*outs):
        assert torch.equal(a.cpu(), b)


@pytest.mark.parametrize("s", [8, 16, 32])
def test_cclm_card_equals_cpu(cuda, s):
    """CCLM over every leaf of a 128x128 frame: frame edges (one or no
    neighbour), a flat luma area (zero range) and noise."""
    from vvctpu_torch.kernels import intra_pred as kip
    rng = np.random.default_rng(s)
    h = w = 128
    by = np.zeros((1, h + 1 + kip.MARGIN, w + 1 + kip.MARGIN), np.int32)
    by[0, 1:h + 1, 1:w + 1] = rng.integers(0, 256, (h, w))
    by[0, 1:40, 1:40] = 90
    bc = np.zeros((1, h // 2 + 1 + kip.MARGIN, w // 2 + 1 + kip.MARGIN),
                  np.int32)
    bc[0, 1:h // 2 + 1, 1:w // 2 + 1] = rng.integers(0, 256,
                                                     (h // 2, w // 2))
    pts = [(x, y) for y in range(0, h, s) for x in range(0, w, s)]
    recy = rng.integers(0, 256, (len(pts), s, s)).astype(np.int32)
    cx = np.asarray([p[0] // 2 for p in pts], np.int32)
    cy = np.asarray([p[1] // 2 for p in pts], np.int32)
    outs = [kip.cclm_predict_local(
        *(torch.as_tensor(a, device=d) for a in (by, bc, recy, cx, cy)),
        cs=s // 2, n_ctu_x=2,
        f=torch.zeros(len(pts), dtype=torch.int32, device=d))
        for d in (cuda, torch.device("cpu"))]
    assert torch.equal(outs[0].cpu(), outs[1])


@pytest.mark.parametrize("hw", [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64),
                                (8, 16), (32, 8), (4, 16), (32, 16)])
def test_dq_trellis_kernel_equals_twin(cuda, hw):
    """The fused trellis kernel against its plain twin on signed noisy,
    all-zero, saturated and flat blocks at qp 22 and 37, for B in {1, 31,
    33} and every lane count the kernel takes (4x4 at 16 lanes is two
    blocks per warp; 0 is the launch's own choice); one launch per
    call."""
    from chip_smoke import _dq_raster
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.spec.transform import lambda_rd_int
    h, w = hw
    rng = np.random.default_rng(h + w)
    coef = np.concatenate([_dq_raster(rng, h, w), _dq_raster(rng, h, w)[:2]])
    walk = torch.as_tensor(ttf.walk32(h, w), device=cuda)
    for qp in (22, 37):
        p = ttf.dq_params(h, w, qp, lambda_rd_int(qp))
        for B in (1, 31, 33):
            c = torch.as_tensor(coef[:B], device=cuda)
            want = kdq.dq_trellis_plain(c, walk, *p)
            for lanes in (0,) + kdq.LANES:
                if lanes and not kdq.lanes_ok(h * w, lanes):
                    continue
                before = kdq.launches
                got = kdq.dq_trellis(c, walk, *p, lanes=lanes)
                assert kdq.launches == before + 1
                assert torch.equal(got, want), (qp, B, lanes)


def test_sbt_dq_alf_card_equals_cpu(cuda):
    """Random access GOP4 with SBT, DQ and ALF: same bytes and recon on
    the card as on the CPU; the card decodes its own stream."""
    from chip_smoke import tool_frames
    frames = tool_frames()
    cfg = tseq.EncoderConfig(qp=27, intra_period=0, gop=4, sbt=True,
                             dq=True, alf=True, mts=True, ciip=True)
    data, rec, bits = tenc.encode_sequence(frames, cfg, device=cuda)
    cdata, crec, cbits = tenc.encode_sequence(frames, cfg, device="cpu")
    assert data == cdata and bits == cbits
    out, _ = tenc.decode_sequence(data, check_hash=True, device=cuda)
    for a, b, c in zip(rec, crec, out):
        for i in range(3):
            assert np.array_equal(a[i], b[i]) and np.array_equal(a[i], c[i])
