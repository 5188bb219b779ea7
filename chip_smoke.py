"""Chip smoke test of the PyTorch/CUDA port (vvctpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build the hand-written kernels and hold each against its plain PyTorch
   twin on the card at the main path's shapes (1088x1920 dense motion
   search, 7 and 11 keys, noisy, flat and wrapping-lam inputs; the fused
   dependent-quantization trellis on signed raster blocks of every
   transform-block shape of the path, SBT halves and ISP stripes
   included, noisy, all-zero, saturated and flat, at qp 22 and 37 and
   every lane count it takes), with the compiler's register report, the
   kernel's dy split and timings (the trellis eager and in CUDA graphs
   at a 1080p frame's worth of blocks, beside its bound and the chain
   floor of its serial recurrence);
2. exactness at a small size: a 3-frame 64x96 IPPP clip encoded on the
   card must equal the copied spec model's bitstream, decode on the card
   with hashes verified, and decode in the spec model; the transforms on
   the card must equal the CPU path on worst-case inputs;
2b. random access at a small size: a 5-frame 64x96 GOP4 clip (P at
   distance 4 and B2 with the +-64 ext search, then the frame-batched
   {B1, B3} layer) encoded on the card must equal the spec model's
   bitstream; it decodes on the card and in the spec model, hashes
   verified;
3. low-delay P at full size: 2 frames of 1080p IPPP (1 I + 1 P) at QP32
   with WPP, encoded and decoded on the card, hashes verified, with the
   kernel launch counts of that run, the wall time per pipeline stage
   and the card's busy share sampled by nvidia-smi;
4. the north-star workload: 17 frames of 1080p random access GOP16
   (hierarchical B, intra period 32) at QP32 with WPP, encoded and
   decoded on the card: hashes verified, encoder recon equal to decoder
   output, 331707 bits/frame and frame-0 Y-PSNR 32.21 dB (the reference
   engine's bytes on this generator), 31 me_sad launches; wall time per
   stage and per temporal layer, and the card's busy share;
5. all-intra with the intra toolset (MTS, LFNST, ISP, MIP, MRL, CCLM),
   frame-batched: (5a) a 3-frame 64x96 clip with the six tools encoded
   on the card must equal the copied spec model's bitstream and decode
   on the card and in the spec model, hashes verified, and the tools'
   transforms, LFNST, MIP, CCLM and transform choice on the card must
   equal the CPU path on worst-case inputs; (5b) bench config #1, 4
   frames of 416x240 all-intra QP32, at 47040 bits/frame; (5c) bench
   config #2, 3 frames of 1080p all-intra QP32 with the six tools, at
   1444184 bits/frame (the reference engine's bytes), hashes verified,
   recon == decoded, with stage times, fps, the card's busy share and
   peak memory; me_sad is launched 0 times on these paths;
6. random access with VVC's inter toolset (BCW, CIIP, GPM, affine with
   PROF, DMVR, BDOF, MMVD, AMVR, SMVD, SBT), dependent quantization, ALF
   with CC-ALF and the intra tools in P and B frames: (6a) a 5-frame
   64x256 GOP4 clip whose panels call for GPM, affine, CIIP and ALF,
   with every tool of the slice on, encoded on the card must equal the
   copied spec model's bitstream and decode on the card and in the spec
   model, hashes verified, and each tool must be chosen (SBT index > 0,
   the trellis launched, ALF on in some CTUs); the inter tools, SBT and
   DQ on the card must equal the CPU path on worst-case batches; (6b)
   bench config #4 whole, 5 frames of 1080p RA GOP4 QP32 with WPP and
   every tool of the slice, SBT, DQ and ALF included: hashes verified,
   recon == decoded, 7 me_sad launches and the trellis launched, with
   stage (ALF apart) and per-layer times, fps, the card's busy share,
   peak memory and the trellis's launches, blocks, median and largest
   batch per block shape; then the trellis held against its twin and
   timed at each of those shapes at its median batch and at one block,
   and the path's launches x time per encode.

The last lines are a JSON object per kernel, the card's name and power
limit, and the result object.
"""
from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

# peaks of one H100 SXM outside the tensor cores, from the 67 TFLOP/s
# float32 rate (128 lanes per SM, a fused multiply-add counted as two
# operations) and the results per SM per clock of compute capability 9.0:
# 64 int32 adds, 128 float32 adds, 256 float16 adds (packed half2)
INT32_OPS_PER_S = 67e12 / 4
FP32_ADDS_PER_S = 67e12 / 2
FP16_ADDS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# int32 operations of the dependent-quantization trellis per (transform
# block, position): the forward scale and both floor levels (7), the zero
# level's step cost (3); per quantizer the even and odd levels (4), their
# two step costs (21 each: dequantise 9, distortion 4, rate 5, cost 3)
# and the even choice (3); per target state two sums, a compare and two
# selects (5 each); the renormalisation (11); the trace back (3)
DQ_OPS_PER_POS = 7 + 3 + 2 * (4 + 2 * 21 + 3) + 4 * 5 + 11 + 3

# the trellis recurrence's least dependent depth per position, in integer
# operations of at most three inputs (csrc/dq_trellis.cu advance): (1) the
# higher source's sum per target and the two states' pairwise minima;
# (2) per target the minimum of the two sums (a fused add-min) and the
# negated candidates of the new minimum (one three-input add each);
# (3) the negated minimum (a max); (4) the renormalised, clamped cost (a
# fused add-min).  Every step needs the four costs of the step before.
DQ_CHAIN_DEPTH = 4
# cycles from the issue of a fixed-latency integer operation to the issue
# of one that depends on it (4 on Volta, Turing and Ampere in published
# microbenchmarks; taken as 4 on Hopper)
INT_LATENCY_CYCLES = 4


def synth_frames(n, h, w, seed=0):
    """Synthetic moving test frames (the benchmark's generator)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (90 + 70 * np.sin((xx + 5 * t) / 11.0)
             + 50 * np.cos((yy - 3 * t) / 8.0)
             + 25 * np.sin(xx * yy / 900.0)
             + rng.integers(-10, 10, (h, w))).clip(0, 255).astype(np.int32)
        cb = (128 + 25 * np.sin((xx[::2, ::2] + 2 * t) / 6.0)).clip(
            0, 255).astype(np.int32)
        cr = (128 - 20 * np.cos((yy[::2, ::2] + t) / 7.0)).clip(
            0, 255).astype(np.int32)
        frames.append([y, cb, cr])
    return frames


def motion_frames(n=3, h=64, w=96, seed=30):
    """A small clip of globally shifted frames (the inter parity clip)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (80 + 60 * np.sin(xx / 9.0) + 40 * np.cos(yy / 7.0)
         + rng.integers(-8, 8, (h, w))).clip(0, 255).astype(np.int32)
    cb = (128 + 20 * np.sin(xx[::2, ::2] / 5.0)).astype(np.int32).clip(0, 255)
    cr = (128 - 15 * np.cos(yy[::2, ::2] / 6.0)).astype(np.int32).clip(0, 255)
    return [[np.roll(y, (2 * t, 3 * t), axis=(0, 1)),
             np.roll(cb, (t, t), axis=(0, 1)),
             np.roll(cr, (t, t), axis=(0, 1))] for t in range(n)]


def cuda_ms(fn, reps: int) -> float:
    fn()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int) -> float:
    """Card time in ms of one call of ``fn``: a CUDA graph of ``reps``
    calls replayed after a warm-up, so that the kernels run back to back
    without the host's launch cost between them."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    g.replay()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def me_sad_bound_ms(H: int, W: int, keys, max_sample: int):
    """(least time in ms, what bounds it) for the dense search on this
    card with samples up to ``max_sample``: the larger of the operations'
    time and the bytes (both planes read once, the outputs written once)
    over the memory rate.  Per pixel-offset a difference, an absolute
    value and an accumulate, on the fastest pipe that is exact for these
    samples: three int32 operations; two float32 adds (the absolute value
    is an operand modifier; exact for samples below 2^16); or, while an
    8-column row partial stays within 2048 (8-bit samples), two float16
    adds, with each such partial converted to float32 and summed there
    (two float32 operations per 8 pixel-offsets).  Per key block the
    granule adds, the cost (shift, multiply, add) and the compare-select
    on the int32 pipe, which runs beside the float ones."""
    from vvctpu_torch.kernels import me_sad as kme
    n_off = (2 * 16 + 1) ** 2
    key_ops = 0
    out_words = 0
    for k in keys:
        bh, bw, *_ = kme.KEY_GEOM[k]
        nby, nbx = kme._grid(k, H, W)
        blocks = nby * nbx
        key_ops += blocks * ((bh // 8) * (bw // 8) - 1) + 6 * blocks
        out_words += 3 * blocks
    pix = n_off * H * W
    key_s = n_off * key_ops / INT32_OPS_PER_S
    pipes = [3 * pix / INT32_OPS_PER_S + key_s,
             max(2 * pix / FP32_ADDS_PER_S, key_s)]
    if 8 * max_sample <= 2048:
        pipes.append(max(pix * (2 / FP16_ADDS_PER_S
                                + 2 / 8 / FP32_ADDS_PER_S), key_s))
    ops_ms = min(pipes) * 1e3
    nbytes = 4 * (H * W + (H + 32) * (W + 32) + out_words)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def _dq_cases(rng, h: int, w: int):
    """(n, B) int32 absolute coefficients in walk order for (h, w) blocks:
    noisy blocks with a decaying spectrum, all-zero, saturated (32768)
    and flat ones (every trellis candidate ties)."""
    n = h * w
    noisy = np.abs(rng.normal(0, 900, (n, 24))
                   / (1 + np.arange(n)[:, None] / 6.0)).astype(np.int32)
    flat = np.repeat(np.asarray([[100, 37, 1, 6000]], np.int32), n, 0)
    edge = np.stack([np.zeros(n, np.int32), np.full(n, 32768, np.int32),
                     rng.choice([0, 32768], n).astype(np.int32)], 1)
    return np.ascontiguousarray(np.concatenate([noisy, flat, edge], 1))


def _dq_raster(rng, h: int, w: int):
    """(B, h, w) int32 signed raster coefficients: ``_dq_cases`` with
    seeded signs, scattered from walk order into raster order."""
    from vvctpu_torch.kernels import transform as ktf
    a = _dq_cases(rng, h, w)
    v = np.where(rng.random(a.shape) < 0.5, -a, a)
    out = np.empty((a.shape[1], h * w), np.int32)
    out[:, ktf.walk32(h, w)] = v.T
    return out.reshape(-1, h, w)


def dq_bound_ms(positions: int):
    """(least time in ms, what bounds it) of the trellis over ``positions``
    (block, position) pairs: DQ_OPS_PER_POS int32 operations each against
    the coefficient read once and the level written once."""
    ops_ms = DQ_OPS_PER_POS * positions / INT32_OPS_PER_S * 1e3
    bytes_ms = 8 * positions / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else \
        (bytes_ms, "bytes")


def sm_clock_mhz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm), in MHz."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "-i", "0"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.split()[0])


def dq_chain_floor_ms(n: int, mhz: float) -> float:
    """Least time in ms of one launch over blocks of n positions, whatever
    its batch: one block's chain, n steps of DQ_CHAIN_DEPTH dependent
    integer operations of INT_LATENCY_CYCLES each, at the SM clock."""
    return n * DQ_CHAIN_DEPTH * INT_LATENCY_CYCLES / (mhz * 1e3)


def _dq_noisy(rng, s_h: int, s_w: int, B: int):
    """(B, h, w) int32 signed raster coefficients with a decaying spectrum
    along the walk (a 1080p frame's worth of blocks at most)."""
    from vvctpu_torch.kernels import transform as ktf
    n = s_h * s_w
    a = np.abs(rng.normal(0, 900, (B, n)) / (1 + np.arange(n) / 6.0))
    v = np.where(rng.random((B, n)) < 0.5, -a, a).astype(np.int32)
    out = np.empty_like(v)
    out[:, ktf.walk32(s_h, s_w)] = v
    return out.reshape(B, s_h, s_w)


def _dq_timed(c, mhz: float, tag: str, all_lanes: bool = False):
    """Holds the trellis kernel against its twin (tolerance 0) on the
    signed raster blocks c (B, h, w) at qp 32 and times it: 20 eager
    launches through the wrapper (``cuda_ms``, the yardstick of earlier
    runs) and a replayed CUDA graph of 20 (``graph_ms``, the card's time
    alone), beside the bound and the chain floor; with ``all_lanes``, the
    graph time at every lane count too.  Prints one line; returns (max
    abs err, eager ms, graph ms, bound ms)."""
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.kernels import transform as ktf
    from vvctpu_torch.spec.transform import lambda_rd_int
    B, h, w = c.shape
    n = h * w
    walk = torch.as_tensor(ktf.walk32(h, w), device=c.device)
    p = ktf.dq_params(h, w, 32, lambda_rd_int(32))
    want = kdq.dq_trellis_plain(c, walk, *p)
    e = int((kdq.dq_trellis(c, walk, *p) - want).abs().max())
    if e != 0:
        raise AssertionError(f"dq_trellis differs from its twin on {B} "
                             f"blocks of {h}x{w}: max abs err {e}")
    k_ms = cuda_ms(lambda: kdq.dq_trellis(c, walk, *p), 20)
    g_ms = graph_ms(lambda: kdq.dq_trellis(c, walk, *p), 20)
    b_ms, by = dq_bound_ms(n * B)
    floor = dq_chain_floor_ms(n, mhz)
    per = ""
    if all_lanes:
        t = {la: graph_ms(lambda: kdq.dq_trellis(c, walk, *p, lanes=la), 20)
             for la in kdq.LANES if kdq.lanes_ok(n, la)}
        per = " (graph per lane count: " + ", ".join(
            f"{la}: {v:.4f}" for la, v in t.items()) + ")"
    print(f"{tag}{B} blocks of {h}x{w}: equal to twin (max abs err {e}); "
          f"kernel {k_ms:.4f} ms eager, {g_ms:.4f} ms in a CUDA graph, at "
          f"{kdq.lanes_for(n, B)} lanes per block{per}; bound {b_ms:.4f} ms "
          f"({by}), {100 * b_ms / k_ms:.2f} % of the eager time, "
          f"{100 * b_ms / g_ms:.2f} % of the graph time; chain floor "
          f"{floor:.4f} ms, {100 * floor / g_ms:.1f} % of the graph time; "
          f"{g_ms * mhz * 1e3 / n:.1f} cycles per position")
    return e, k_ms, g_ms, b_ms


def phase_dq_kernel(dev):
    """The fused trellis kernel against its twin on the card (tolerance 0)
    on every transform-block shape of the path (4x4 chroma of 8x8 leaves
    up to 32x32, the SBT halves, the ISP stripes, and 64x64 and its
    halves) at every lane count it takes, on signed raster inputs; then
    against its twin and timed at a 1080p frame's worth of 8x8, 16x16
    and 32x32 blocks (one phase-A batch of config #4 at most), beside
    the bound and the chain floor.  Phase 6b times it at the shapes and
    batches of config #4's path."""
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.kernels import transform as ktf
    from vvctpu_torch.spec.transform import lambda_rd_int
    t0 = time.time()
    log = kdq.build(verbose=True)
    print(f"[1] dq_trellis built in {time.time() - t0:.1f} s")
    for line in log.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill")):
            print(f"[1]   {line.strip()}")
    shapes = [(4, 4), (8, 8), (16, 16), (32, 32), (64, 64), (8, 4), (4, 8),
              (16, 8), (8, 16), (32, 16), (16, 32), (64, 32), (32, 64),
              (4, 16), (16, 4), (8, 32), (32, 8)]
    rng = np.random.default_rng(8)
    err, n_cases = 0, 0
    for h, w in shapes:
        c = torch.as_tensor(_dq_raster(rng, h, w), device=dev)
        walk = torch.as_tensor(ktf.walk32(h, w), device=dev)
        for qp in (22, 37):
            p = ktf.dq_params(h, w, qp, lambda_rd_int(qp))
            want = kdq.dq_trellis_plain(c, walk, *p)
            for lanes in (0,) + kdq.LANES:
                if lanes and not kdq.lanes_ok(h * w, lanes):
                    continue
                got = kdq.dq_trellis(c, walk, *p, lanes=lanes)
                torch.cuda.synchronize()
                e = int((got - want).abs().max())
                if e != 0:
                    raise AssertionError(
                        f"dq_trellis differs from its twin at {h}x{w} qp "
                        f"{qp} lanes {lanes}: max abs err {e}")
                err = max(err, e)
                n_cases += 1
    print(f"[1] dq_trellis: equal to twin (tolerance 0, max abs err {err}) "
          f"on {n_cases} (shape, qp, lanes) batches of {c.shape[0]} signed "
          f"blocks: {', '.join(f'{h}x{w}' for h, w in shapes)}")
    mhz = sm_clock_mhz()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[1] dq_trellis times on {smi}, max SM clock {mhz:.0f} MHz; "
          f"chain floor = n x {DQ_CHAIN_DEPTH} dependent operations x "
          f"{INT_LATENCY_CYCLES} cycles")
    ms = graph = plain = 0.0
    positions = 0
    for s in (8, 16, 32):
        B = (1088 // s) * (1920 // s)
        c = torch.as_tensor(_dq_noisy(rng, s, s, B), device=dev)
        e, k_ms, g_ms, _ = _dq_timed(c, mhz, "[1]   dq_trellis 1080p: ",
                                     all_lanes=True)
        err = max(err, e)
        walk = torch.as_tensor(ktf.walk32(s, s), device=dev)
        p = ktf.dq_params(s, s, 32, lambda_rd_int(32))
        p_ms = cuda_ms(lambda: kdq.dq_trellis_plain(c, walk, *p), 1)
        print(f"[1]     twin {p_ms:.1f} ms")
        ms, graph, plain = ms + k_ms, graph + g_ms, plain + p_ms
        positions += s * s * B
    bound, by = dq_bound_ms(positions)
    print(f"[1] dq_trellis over the three batches: kernel {ms:.4f} ms eager, "
          f"{graph:.4f} ms in CUDA graphs; twin {plain:.1f} ms; bound "
          f"{bound:.4f} ms ({by}), {100 * bound / ms:.2f} % of the eager "
          f"time, {100 * bound / graph:.2f} % of the graph time")
    return dict(ms=ms, plain_ms=plain, max_abs_err=err, bound_ms=bound,
                bound_by=by)


def dq_lanes_sweep(dev):
    """Times the trellis kernel at every lane count it takes, beside
    ``lanes_for``'s choice, for blocks of 4x4 up to 64x64 and batches of
    1 up to 32640 blocks (at most a 1080p frame's worth of positions)."""
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.kernels import transform as ktf
    from vvctpu_torch.spec.transform import lambda_rd_int
    rng = np.random.default_rng(3)
    for s in (4, 8, 16, 32, 64):
        walk = torch.as_tensor(ktf.walk32(s, s), device=dev)
        p = ktf.dq_params(s, s, 32, lambda_rd_int(32))
        for B in (1, 32, 512, 1024, 2048, 4096, 8192, 16384, 32640):
            if s * s * B > 1088 * 1920:
                continue
            c = torch.as_tensor(_dq_noisy(rng, s, s, B), device=dev)
            t = {la: graph_ms(lambda: kdq.dq_trellis(c, walk, *p, lanes=la),
                              10)
                 for la in kdq.LANES if kdq.lanes_ok(s * s, la)}
            print(f"[sweep] {B} blocks of {s}x{s}: " + ", ".join(
                f"{la}: {v:.4f}" for la, v in t.items())
                + f" ms; fastest {min(t, key=t.get)}, chosen "
                f"{kdq.lanes_for(s * s, B)}")


def phase_kernels(dev):
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.spec.decide import lambda_satd_fp
    t0 = time.time()
    log = kme.build(verbose=True)
    print(f"[1] me_sad built in {time.time() - t0:.1f} s")
    for line in log.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill")):
            print(f"[1]   {line.strip()}")
    H, W = 1088, 1920
    rng = np.random.default_rng(1)
    orig = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = (np.roll(orig, (3, -5), (0, 1))
           + rng.integers(-6, 7, (H, W))).clip(0, 255).astype(np.int32)
    lam = lambda_satd_fp(32)
    flat = np.full((H, W), 77, np.int32)
    # noisy motion; a flat frame, where every offset ties and only the
    # row-major order decides; a lam whose lam * bits wraps int32
    cases = {"noisy": (orig, ref, lam), "flat": (flat, flat, lam),
             "wrap": (orig, ref, 2 ** 27)}
    planes = {k: (torch.as_tensor(o, device=dev),
                  torch.as_tensor(np.pad(r, 16, mode="edge"), device=dev),
                  la) for k, (o, r, la) in cases.items()}
    go, gr, _ = planes["noisy"]
    max_sample = int(max(orig.max(), ref.max()))   # of the timed inputs
    print(f"[1] me_sad dy split: {kme.SPLIT} warps per 32x32 region "
          "(csrc/me_sad.cu SPLIT)")
    rows = {}
    for tt in (False, True):
        keys = kme.KEYS[:11 if tt else 7]
        err = 0
        for kind, (o, r, la) in planes.items():
            want = kme.me_sad_reference(o, r, la, tt=tt)
            got = kme.me_sad(o, r, la, tt=tt)
            torch.cuda.synchronize()
            e = max(int((a - b).abs().max()) for g, w_ in zip(got, want)
                    for a, b in zip(g, w_))
            if e != 0:
                raise AssertionError(f"me_sad differs from its twin ({kind}, "
                                     f"tt={tt}): max abs err {e}")
            err = max(err, e)
        ms = cuda_ms(lambda: kme.me_sad(go, gr, lam, tt=tt), 20)
        plain = cuda_ms(lambda: kme.me_sad_reference(go, gr, lam, tt=tt), 3)
        bound, by = me_sad_bound_ms(H, W, keys, max_sample)
        rows[tt] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                        bound_ms=bound, bound_by=by)
        print(f"[1] me_sad {H}x{W} keys={len(keys)}: equal to twin "
              f"(tolerance 0, max abs err {err}) on {', '.join(planes)}")
        print(f"[1]   kernel {ms:.4f} ms; twin {plain:.1f} ms; bound "
              f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f} % of it; "
              f"launches so far {kme.launches}")
    return rows[False]


def _same_planes(*seqs):
    return all(np.array_equal(a[i], b[i]) for x, y in zip(seqs, seqs[1:])
               for a, b in zip(x, y) for i in range(3))


def _spec_clips():
    """The small clips held against the copied spec model: name ->
    (frames, EncoderConfig keywords)."""
    return {
        "ippp": (motion_frames(), dict(qp=32, intra_period=0)),
        "gop4": (motion_frames(5), dict(qp=32, intra_period=0, gop=4)),
        "ai_tools": (synth_frames(3, 64, 96, seed=2), dict(qp=32, **AI_TOOLS)),
        "ra_tools": (tool_frames(), dict(qp=27, intra_period=0, gop=4,
                                         isp=True, mrl=True, sbt=True,
                                         dq=True, alf=True, **RA_TOOLS)),
    }


def _spec_run(name):
    """The spec model's encode of clip ``name`` and its decode with the
    hashes verified: (bytes, decisions, decoded planes, seconds taken).
    Host work only, so main() runs it in worker processes beside the
    card's phases."""
    from vvctpu_torch.spec import sequence as tseq
    t0 = time.time()
    frames, kw = _spec_clips()[name]
    decs = []
    data, _, _ = tseq.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                      decisions_out=decs)
    out, _ = tseq.decode_sequence(data, check_hash=True)
    return data, decs, out, time.time() - t0


# clip name -> future of _spec_run, filled by main(); a phase run on its
# own computes its spec results in place
_SPEC = {}
# seconds the spec model's runs took in the workers, and seconds the
# card's phases waited for them
_SPEC_T = {"work": 0.0, "wait": 0.0}


def _spec(name):
    fut = _SPEC.get(name)
    if fut is None:
        return _spec_run(name)[:3]
    t0 = time.time()
    data, decs, out, took = fut.result()
    _SPEC_T["wait"] += time.time() - t0
    _SPEC_T["work"] += took
    return data, decs, out


def _held_to_spec(tag, dev, name):
    """Encode clip ``name`` on the card, hold its bytes against the spec
    model's and decode it on the card; the card's recon, the card's
    decoded planes and the spec model's decoded planes must agree.
    Returns (bytes, the card's decisions, the spec model's decisions)."""
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    frames, kw = _spec_clips()[name]
    decs = []
    data, recons, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(**kw), device=dev, decisions_out=decs)
    sdata, sdecs, sout = _spec(name)
    if data != sdata:
        raise AssertionError(f"{tag}: card bitstream != spec model's")
    out, _ = tenc.decode_sequence(data, check_hash=True, device=dev)
    if not _same_planes(recons, out, sout):
        raise AssertionError(f"{tag}: recon/decoder mismatch")
    return data, decs, sdecs


def phase_small(dev):
    from vvctpu_torch.core import rom
    from vvctpu_torch.kernels import transform as ktf
    data, _, _ = _held_to_spec("64x96 IPPP", dev, "ippp")
    print(f"[2] 64x96 IPPP: {len(data)} bytes equal to the spec model; "
          "card and spec decoders verified hashes")
    data, _, _ = _held_to_spec("64x96 GOP4", dev, "gop4")
    print(f"[2b] 64x96 GOP4 (I0 P4 B2 B1 B3): {len(data)} bytes equal to "
          "the spec model; card and spec decoders verified hashes")

    rng = np.random.default_rng(2)
    n_cases = 0
    for n in rom.TR_SIZES:
        kinds = [rom.DCT2] + ([rom.DST7, rom.DCT8] if n in rom.MTS_SIZES
                              else [])
        resi = rng.choice([-255, 255], (64, n, n)).astype(np.int32)
        resi[0], resi[1] = 255, -255
        coef = rng.choice([-32768, 32767], (64, n, n)).astype(np.int32)
        coef[0], coef[1] = 32767, -32768
        for kh in kinds:
            for kv in kinds:
                for fn, x in ((ktf.forward_transform, resi),
                              (ktf.inverse_transform, coef)):
                    cpu = fn(torch.as_tensor(x), n, n, kh, kv)
                    gpu = fn(torch.as_tensor(x, device=dev), n, n, kh, kv)
                    if not torch.equal(gpu.cpu(), cpu):
                        raise AssertionError(
                            f"{fn.__name__} n={n} kinds={kh},{kv}: card != "
                            "CPU on worst-case input")
                    n_cases += 1
    print(f"[2] transforms: card == CPU on {n_cases} worst-case cases")


class GpuBusy:
    """Samples nvidia-smi's utilization.gpu (the share of each sample
    period in which a kernel ran) every 100 ms while active."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-i", "0", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        vals = [int(v) for v in out.split() if v.strip().isdigit()]
        self.share = float(np.mean(vals)) if vals else float("nan")
        self.samples = len(vals)
        return False


def _stages_line(tag, times, wall):
    parts = ", ".join(f"{k} {v:.2f} s" for k, v in
                      sorted(times.items(), key=lambda kv: -kv[1]))
    return f"{tag} stages (wall {wall:.2f} s): {parts}"


def _run_full(dev, frames, cfg, decisions_out=None):
    """Encode and decode ``frames`` on the card with the kernels' counts
    set to 0 just before; returns the run's numbers (recon == decoded and the
    decoder's hash check are enforced here).  decisions_out: as in
    encode_sequence."""
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    from vvctpu_torch.pipeline import wave
    r = dict(enc_t={}, dec_t={}, enc_l={}, dec_l={})
    kme.launches = 0
    kdq.launches = 0
    kdq.trace = []
    wave.batches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with GpuBusy() as busy_enc:
        t0 = time.time()
        data, recons, bits = tenc.encode_sequence(
            frames, cfg, device=dev, stage_times=r["enc_t"],
            layer_times=r["enc_l"], decisions_out=decisions_out)
        torch.cuda.synchronize()
        r["t_enc"] = time.time() - t0
    r["dq_path"] = _dq_path(kdq.trace)
    kdq.trace = None
    r["batches"] = wave.batches
    with GpuBusy() as busy_dec:
        t0 = time.time()
        out, _ = tenc.decode_sequence(data, check_hash=True, device=dev,
                                      stage_times=r["dec_t"],
                                      layer_times=r["dec_l"])
        torch.cuda.synchronize()
        r["t_dec"] = time.time() - t0
    r["launches"] = kme.launches
    r["dq_launches"] = kdq.launches
    r["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    if not _same_planes(recons, out):
        raise AssertionError("encoder recon != decoder output")
    r["psnr"] = [float(tseq.psnr(f[0], x[0])) for f, x in zip(frames, recons)]
    for p in r["psnr"]:
        if not np.isfinite(p) or p < 25.0:
            raise AssertionError(f"implausible Y-PSNR {p}")
    r.update(bits=bits, busy_enc=busy_enc, busy_dec=busy_dec,
             alf_ctus=_alf_ctus(data))
    return r


def _dq_path(trace):
    """The encode's trellis launches per block shape: (h, w) -> (launches,
    blocks, median blocks per launch, largest blocks per launch)."""
    by = {}
    for h, w, B in trace:
        by.setdefault((h, w), []).append(B)
    return {k: (len(v), sum(v), int(np.median(v)), max(v))
            for k, v in sorted(by.items())}


def _dq_path_times(dev, path, tag):
    """Times the trellis kernel at each block shape of an encode's path at
    that shape's median batch and at one block (``_dq_timed``), and
    prints the path's launches x time and launches x (time - bound) per
    encode, eager and in CUDA graphs; returns the largest error against
    the twin."""
    mhz = sm_clock_mhz()
    rng = np.random.default_rng(10)
    err = 0
    eager = card = gap = 0.0
    for (h, w), (launches, _, med, _) in path.items():
        for B, what in ((1, "one block"), (med, "median batch")):
            c = torch.as_tensor(_dq_noisy(rng, h, w, B), device=dev)
            e, k_ms, g_ms, b_ms = _dq_timed(
                c, mhz, f"{tag}   dq_trellis {what}: ")
            err = max(err, e)
        eager += launches * k_ms
        card += launches * g_ms
        gap += launches * (g_ms - b_ms)
    print(f"{tag} dq_trellis on this encode's path "
          f"({sum(v[0] for v in path.values())} launches, each at its "
          f"shape's median batch): launches x time {eager:.2f} ms eager, "
          f"{card:.2f} ms in CUDA graphs; launches x (graph time - bound) "
          f"{gap:.2f} ms per encode")
    return err


def _report(tag, r, n):
    print(f"{tag} encode {r['t_enc']:.2f} s ({n / r['t_enc']:.4f} fps), "
          f"decode {r['t_dec']:.2f} s ({n / r['t_dec']:.4f} fps), hashes "
          "verified, recon == decoded")
    print(f"{tag} bits/frame {sum(r['bits']) / n:.1f} (per frame "
          f"{r['bits']}); Y-PSNR mean {np.mean(r['psnr']):.4f} dB (per "
          f"frame {[round(p, 4) for p in r['psnr']]})")
    print(_stages_line(f"{tag} encode", r["enc_t"], r["t_enc"]))
    print(_stages_line(f"{tag} decode", r["dec_t"], r["t_dec"]))
    for k in ("enc", "dec"):
        b = r[f"busy_{k}"]
        print(f"{tag} card busy during {k}ode (nvidia-smi utilization.gpu "
              f"mean): {b.share:.1f} % over {b.samples} samples")
    print(f"{tag} phase-B leaf batches per encode and per decode: "
          f"{r['batches']}")
    print(f"{tag} me_sad launches on this path: {r['launches']}; "
          f"dq_trellis launches: {r['dq_launches']}; peak device memory "
          f"{r['peak_gib']:.2f} GiB (torch.cuda.max_memory_allocated)")
    if r["dq_path"]:
        print(f"{tag} dq_trellis in the encode per block shape (launches, "
              "blocks, median and largest blocks per launch): " + "; ".join(
                  f"{h}x{w} {la}, {b}, {med}, {mx}"
                  for (h, w), (la, b, med, mx) in r["dq_path"].items()))


def phase_full(dev):
    from vvctpu_torch.spec import sequence as tseq
    # 2 frames, for the script's time limit (4 frames took 76-100 s)
    n = 2
    r = _run_full(dev, synth_frames(n, 1080, 1920),
                  tseq.EncoderConfig(qp=32, intra_period=0, wpp=True))
    if r["launches"] != n - 1:
        raise AssertionError(f"me_sad launched {r['launches']} times on "
                             f"the IPPP path, expected {n - 1} (one per P)")
    print(f"[3] 1080p IPPP QP32 WPP, {n} frames (1 I + {n - 1} P)")
    _report("[3]", r, n)
    return r["launches"]


def phase_ra(dev):
    from vvctpu_torch.spec import hls
    from vvctpu_torch.spec import sequence as tseq
    n = 17
    cfg = tseq.EncoderConfig(qp=32, intra_period=32, gop=16, wpp=True)
    r = _run_full(dev, synth_frames(n, 1080, 1920), cfg)
    # me_sad runs once for P16 and once per list for each of the 15 B
    want = 1 + 2 * sum(1 for e in tseq.gop_plan(n, 32, 16)
                       if e[1] == hls.SLICE_B)
    if r["launches"] != want or want != 31:
        raise AssertionError(f"me_sad launched {r['launches']} times on "
                             f"the RA path, expected 31")
    bpf = f"{sum(r['bits']) / n:.0f}"
    if bpf != "331707":
        raise AssertionError(f"RA bits/frame {bpf}, the reference engine "
                             "gives 331707")
    if round(r["psnr"][0], 2) != 32.21:
        raise AssertionError(f"RA frame-0 Y-PSNR {r['psnr'][0]:.4f} dB, "
                             "the reference engine gives 32.21 dB")
    print(f"[4] 1080p RA GOP16 QP32 WPP, {n} frames (I0 P16 + 15 B): "
          f"{bpf} bits/frame and frame-0 Y-PSNR {r['psnr'][0]:.2f} dB as "
          "the reference engine")
    _report("[4]", r, n)
    for k in ("enc", "dec"):
        lt = r[f"{k}_l"]
        print(f"[4] {k}ode wall per temporal layer: " + ", ".join(
            f"{name} {lt[name]:.2f} s" for name in sorted(lt)))
    return r["launches"]


AI_TOOLS = dict(mts=True, lfnst=True, isp=True, mip=True, mrl=True,
                cclm=True)


def _card_eq(tag, dev, fn, *args, **kw):
    """fn on the card equals fn on the CPU (every output, exactly); numpy
    arguments become tensors on each device."""
    def run(d):
        def conv(a):
            return torch.as_tensor(a, device=d) \
                if isinstance(a, np.ndarray) else a
        out = fn(*map(conv, args), **{k: conv(v) for k, v in kw.items()})
        return out if isinstance(out, tuple) else (out,)
    for c, g in zip(run(torch.device("cpu")), run(dev)):
        if not torch.equal(g.cpu(), c):
            raise AssertionError(f"{tag}: card != CPU")
    return 1


def _tool_worst_cases(dev):
    """The intra tools' integer products on the card against the CPU
    path on worst-case inputs; returns the number of cases."""
    from vvctpu_torch.core import rom
    from vvctpu_torch.kernels import intra_pred as kip
    from vvctpu_torch.kernels import transform as ktf
    from vvctpu_torch.spec.codec import isp_kernels, isp_parts
    rng = np.random.default_rng(5)
    n = 0
    ext = np.asarray([-32768, 32767], np.int32)
    # LFNST: every set (modes 0, 2, 13, 24 and their transposes) and
    # kernel on saturated corners; the per-row switch
    modes = np.asarray([0, 1, 2, 13, 24, 34, 45, 56, 66] * 4, np.int32)
    coef = rng.choice(ext, (len(modes), 8, 8)).astype(np.int32)
    coef[0], coef[1] = 32767, -32768
    for k in (0, 1):
        n += _card_eq(f"fwd_lfnst k={k}", dev, ktf.fwd_lfnst, coef, k, modes)
        n += _card_eq(f"inv_lfnst k={k}", dev, ktf.inv_lfnst, coef, k, modes)
    n += _card_eq("inv_lfnst_switch", dev, ktf.inv_lfnst_switch, coef,
                  np.arange(len(modes), dtype=np.int32) % 3, modes)
    # per-row MTS inverse kernels and the ISP stripe pairs
    for s in (4, 8, 16, 32):
        c = rng.choice(ext, (20, s, s)).astype(np.int32)
        n += _card_eq(f"inverse_transform_rows {s}", dev,
                      ktf.inverse_transform_rows, c, s,
                      np.arange(20, dtype=np.int32) % 5)
    for s in (8, 16, 32):
        for d in (1, 2):
            _, _, w, h = isp_parts(s, d)[0]
            kh, kv = isp_kernels(w, h)
            r = rng.choice([-255, 255], (16, h, w)).astype(np.int32)
            c = rng.choice(ext, (16, h, w)).astype(np.int32)
            n += _card_eq(f"isp fwd {w}x{h}", dev, ktf.forward_transform, r, h,
                          w, kh, kv)
            n += _card_eq(f"isp inv {w}x{h}", dev, ktf.inverse_transform, c, h,
                          w, kh, kv)
    # the transform choice: noise, saturation and all-zero ties
    for s in (8, 16, 32):
        r = rng.integers(-60, 61, (24, s, s)).astype(np.int32)
        r[0], r[1], r[2], r[3] = 0, 255, -255, 1
        md = rng.integers(0, 67, 24).astype(np.int32)
        allow = np.arange(24) % 3 > 0
        n += _card_eq(f"choose_tx {s}", dev, ktf.choose_tx, r, s, 32, 347, md,
                      8, mts=True, lfnst=True, rdoq=True, allow=allow)
        n += _card_eq(f"choose_tx dq {s}", dev, ktf.choose_tx, r, s, 32, 347,
                      md, 8, mts=True, lfnst=True, rdoq=True, allow=allow,
                      dq=True)
    # MIP on saturated boundaries, every id
    for s in (8, 16, 32):
        top = rng.choice([0, 255], (16, 2 * s + 1)).astype(np.int32)
        left = rng.choice([0, 255], (16, 2 * s + 1)).astype(np.int32)
        n += _card_eq(f"mip {s}", dev, kip.mip_predict, top, left,
                      np.arange(16, dtype=np.int32), s=s)
    # CCLM over every leaf of a 128x128 frame (edges, flat and steep)
    h = w = 128
    by = np.zeros((1, h + 1 + kip.MARGIN, w + 1 + kip.MARGIN), np.int32)
    by[0, 1:h + 1, 1:w + 1] = rng.integers(0, 256, (h, w))
    by[0, 1:40, 1:40] = 90
    bc = np.zeros((1, h // 2 + 1 + kip.MARGIN, w // 2 + 1 + kip.MARGIN),
                  np.int32)
    bc[0, 1:h // 2 + 1, 1:w // 2 + 1] = rng.integers(0, 256, (h // 2,
                                                              w // 2))
    for s in (8, 16, 32):
        pts = [(x, y) for y in range(0, h, s) for x in range(0, w, s)]
        recy = rng.integers(0, 256, (len(pts), s, s)).astype(np.int32)
        cx = np.asarray([p[0] // 2 for p in pts], np.int32)
        cy = np.asarray([p[1] // 2 for p in pts], np.int32)
        n += _card_eq(f"cclm {s}", dev, kip.cclm_predict_local, by, bc,
                      recy, cx, cy, cs=s // 2, n_ctu_x=2,
                      f=np.zeros(len(pts), np.int32))
    return n


def phase_ai(dev):
    """Phase 5: all-intra with the intra toolset; returns me_sad's
    launches on the two full-size paths (0 expected)."""
    from vvctpu_torch.spec import sequence as tseq
    data, _, decs = _held_to_spec("64x96 AI six tools", dev, "ai_tools")
    used = {"MIP": any((d.modes8 >= 67).any() for d in decs),
            "MRL": any(d.mrl8.any() for d in decs),
            "ISP": any(d.isp8.any() for d in decs),
            "MTS": any(d.mts8.any() for d in decs),
            "LFNST": any(d.lfnst8.any() for d in decs),
            "CCLM": any(d.cmode8.any() for d in decs)}
    print(f"[5a] 64x96 AI, 3 frames, six tools: {len(data)} bytes equal "
          "to the spec model; card and spec decoders verified hashes; "
          f"tools chosen: {', '.join(k for k, v in used.items() if v)}")
    print(f"[5a] intra tools: card == CPU on {_tool_worst_cases(dev)} "
          "worst-case batches (LFNST, MTS rows, ISP stripes, choose_tx, "
          "MIP, CCLM)")

    launches = 0
    for tag, n, h, w, seed, kw, want in (
            ("[5b] config #1, 416x240 AI QP32", 4, 240, 416, 0, {},
             "47040"),
            ("[5c] config #2, 1080p AI QP32, six tools", 3, 1080, 1920, 2,
             AI_TOOLS, "1444184")):
        r = _run_full(dev, synth_frames(n, h, w, seed=seed),
                      tseq.EncoderConfig(qp=32, **kw))
        bpf = f"{sum(r['bits']) / n:.0f}"
        if bpf != want:
            raise AssertionError(f"{tag}: {bpf} bits/frame, the reference "
                                 f"engine gives {want}")
        if r["launches"] != 0:
            raise AssertionError(f"{tag}: me_sad launched {r['launches']} "
                                 "times on an all-intra path")
        print(f"{tag}, {n} frames: {bpf} bits/frame as the reference "
              f"engine; frame-0 Y-PSNR {r['psnr'][0]:.4f} dB")
        _report(tag[:4], r, n)
        launches += r["launches"]
    return launches


# ---------------------------------------------------------------------------
# phase 6: random access with the inter toolset and the intra tools in P/B
# ---------------------------------------------------------------------------

RA_TOOLS = dict(mts=True, lfnst=True, cclm=True, mip=True, mmvd=True,
                bcw=True, amvr=True, smvd=True, ciip=True, gpm=True,
                affine=True, dmvr=True, bdof=True)


def tool_frames(n=5, seed=1):
    """A 64x256 clip whose four 64x64 panels call for the tools: an
    occlusion across a diagonal edge, each reference matching one side
    (GPM); a slow zoom with rotation (affine); flat-DC noise shifting
    under a quadratic brightness drift (CIIP); a fine moving
    sine-product texture with strong chroma texture, whose coding error
    ALF recovers.  The first three panels are the reference's test
    generators for those tools."""
    h = w = 64
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    tex_a = 90 + 60 * np.sin(xx / 7.0) + 30 * np.cos(yy / 5.0)
    tex_b = 160 + 50 * np.cos(xx / 6.0) - 30 * np.sin(yy / 8.0)
    tex_c = 128 + 70 * np.sin((xx + yy) / 4.0)
    tex_d = 100 + 65 * np.cos((xx - yy) / 5.0)
    edge = (2 * xx + yy) > (w + h // 2)
    gpm = []
    for t in range(n):
        if t == 0:
            y = np.where(edge, tex_c, tex_a)      # one side valid
        elif t == n - 1:
            y = np.where(edge, tex_b, tex_d)      # the other side valid
        else:
            y = np.where(edge, tex_b, tex_a)      # both: needs GPM
        gpm.append((y + rng.integers(-4, 4, (h, w))).clip(0, 255))
    rng = np.random.default_rng(seed + 1)
    zoom = []
    for t in range(n):
        sc, th = 1.0 + 0.02 * t, 0.01 * t
        u = (np.cos(th) * (xx - 32) - np.sin(th) * (yy - 32)) * sc + 32
        v = (np.sin(th) * (xx - 32) + np.cos(th) * (yy - 32)) * sc + 32
        zoom.append((120 + 60 * np.sin(u / 6.0) + 45 * np.cos(v / 8.0)
                     + 20 * np.sin((u + v) / 15.0)
                     + rng.integers(-3, 3, (h, w))).clip(0, 255))
    base = np.random.default_rng(seed + 2).integers(50, 98, (h, 2 * w))
    drift = [np.clip(base[:, 3 * t:3 * t + w] + 12 * t * t, 0, 255)
             for t in range(n)]
    cb = (128 + 20 * np.sin(xx[::2, ::2] / 6.0)).astype(np.int32)
    cr = (128 - 18 * np.cos(yy[::2, ::2] / 5.0)).astype(np.int32)
    rng = np.random.default_rng(seed + 2)
    fine = [[(128 + 90 * np.sin((xx + 2 * t) / 3.0) * np.cos((yy - t) / 4.0)
              + rng.integers(-3, 4, (h, w))).clip(0, 255),
             (128 + 60 * np.sin((xx[::2, ::2] + t) / 2.5)).astype(np.int32),
             (128 - 60 * np.cos((yy[::2, ::2] + t) / 2.0)).astype(np.int32)]
            for t in range(n)]
    return [[np.concatenate([gpm[t], zoom[t], drift[t], fine[t][0]],
                            1).astype(np.int32),
             np.concatenate([cb, cb, np.full_like(cb, 118 + 4 * t),
                             fine[t][1]], 1),
             np.concatenate([cr, cr, np.full_like(cr, 134 - 3 * t),
                             fine[t][2]], 1)]
            for t in range(n)]
def _phase_a_out(refs, rows, s, flags):
    """Phase A of one leaf size on a zero carry (frame axis of 1, on the
    refs' device); returns the luma recon and level planes."""
    from vvctpu_torch.pipeline import recon
    dev = refs[0].device
    h, w = refs[0].shape[-2] - 160, refs[0].shape[-1] - 160
    m = recon.MARGIN

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    src = torch.arange(h * w, device=dev, dtype=torch.int32).reshape(
        1, h, w) * 37 % 256
    carry = dict(by=z(1, h + 1 + m, w + 1 + m), bcb=z(1, h // 2 + 1 + m,
                                                      w // 2 + 1 + m),
                 bcr=z(1, h // 2 + 1 + m, w // 2 + 1 + m), ly=z(1, h, w),
                 lcb=z(1, h // 2, w // 2), lcr=z(1, h // 2, w // 2),
                 sy=src, scb=src[:, ::2, ::2].contiguous(),
                 scr=src[:, 1::2, 1::2].contiguous(),
                 sbtp=z(1, h // 8, w // 8))
    recon._inter_batch_pass(carry, rows, [r[None] for r in refs], s, 32, 8,
                            True, rdoq=True, lam_rd=347, **flags)
    return (carry["by"], carry["ly"], carry["bcb"], carry["lcr"],
            carry["sbtp"])


def _inter_tool_worst_cases(dev):
    """The inter tools on the card against the CPU path on worst-case
    batches: saturated 0/255 references, flat references where every
    candidate ties, negative MVs and MVs past the padded plane, phase A
    with SBT and DQ included; returns the number of cases."""
    from vvctpu_torch.coding import decide as tdec
    from vvctpu_torch.kernels import mc
    rng = np.random.default_rng(6)
    n = 0
    h, w = 64, 128
    sat = rng.choice([0, 255], (h, w)).astype(np.int32)
    noisy = rng.integers(0, 256, (h, w)).astype(np.int32)
    flat = np.full((h, w), 77, np.int32)
    pads = {k: (np.pad(p, 80, mode="edge"), np.pad(p[::2, ::2], 40,
                                                   mode="edge"))
            for k, p in (("sat", sat), ("noisy", noisy), ("flat", flat))}
    k = 64
    x = (rng.integers(0, w // 16, k) * 16).astype(np.int32)
    y = (rng.integers(0, h // 16, k) * 16).astype(np.int32)
    mv = (rng.integers(-270, 271, (k, 4)) * 4).astype(np.int32)
    mv[:4, :2] = [[-16 * 95, 0], [0, 16 * 90], [16 * 200, -16 * 200],
                  [-3, -5]]
    dm = rng.choice([-8, -4, 0, 4, 8, -29, 36], (k, 2)).astype(np.int32)
    f = (np.arange(k) % 2).astype(np.int32)
    for name, (ly, lc) in pads.items():
        other = pads["noisy"][0]
        n += _card_eq(f"dmvr_offset {name}", dev, mc.dmvr_offset, ly, other,
                      x, y, 16, mv[:, 0], mv[:, 1], mv[:, 2], mv[:, 3])
        stk, cstk = np.stack([ly, other]), np.stack([lc, pads["noisy"][1]])
        for s in (16, 32):
            for prof in (False, True):
                n += _card_eq(f"affine luma {name} s={s} prof={prof}", dev,
                              mc.affine_pred_luma, stk, x // s * s,
                              y // s * s, s, mv[:, 0], mv[:, 1], dm[:, 0],
                              dm[:, 1], 8, prof=prof, f=f)
            n += _card_eq(f"affine chroma {name} s={s}", dev,
                          mc.affine_pred_chroma, cstk, x // s * s // 2,
                          y // s * s // 2, s // 2, mv[:, 0], mv[:, 1],
                          dm[:, 0], dm[:, 1], s, 8, f=f)
        for s in (8, 16, 32):
            g = (h // s, w // s, 2)
            m0, m1 = (rng.integers(-270, 271, g) * 4).astype(np.int32), \
                (rng.integers(-270, 271, g) * 4).astype(np.int32)
            m0[0, 0] = [-16 * 95, 16 * 90]
            n += _card_eq(f"gpm_pass {name} s={s}", dev, tdec.gpm_pass,
                          ly[80:-80, 80:-80].copy(), ly, other, m0, m1,
                          s=s, frame_w=w, frame_h=h)
            if s >= 16:
                n += _card_eq(f"affine_pass {name} s={s}", dev,
                              tdec.affine_pass, ly[80:-80, 80:-80].copy(),
                              ly, m0, 211, 512, s=s, frame_w=w, frame_h=h)
    for s in (8, 16, 32):
        p0 = rng.choice([0, 255], (32, s + 2, s + 2)).astype(np.int32)
        p1 = rng.choice([0, 255], (32, s + 2, s + 2)).astype(np.int32)
        p1[0] = 255 - p0[0]
        p0[1] = p1[1] = 128
        n += _card_eq(f"bdof_blend s={s}", dev, mc.bdof_blend, p0, p1, 8)
    # phase A's blends: BCW weights, GPM masks, DMVR + BDOF and affine
    # with PROF on saturated references
    refs = [pads["sat"][0], pads["sat"][1], pads["noisy"][1],
            pads["noisy"][0], pads["noisy"][1], pads["sat"][1]]
    for s in (8, 16, 32):
        nb = (h // s) * (w // s)
        rows = np.zeros((nb, 14), np.int32)
        rows[:, 0] = np.arange(nb) % (w // s) * s
        rows[:, 1] = np.arange(nb) // (w // s) * s
        rows[:, 2:6] = (rng.integers(-64, 65, (nb, 4)) * 4).astype(np.int32)
        rows[:, 6] = rng.choice([0, 1, 2, 2], nb)
        rows[:, 7] = rng.integers(0, 3, nb)
        rows[:, 9] = np.where(rows[:, 6] == 2, rng.integers(0, 65, nb), 0)
        rows[:, 10] = (rows[:, 6] < 2) & (s >= 16)
        rows[:, 11:13] = rng.choice([-8, 4, 8, -36], (nb, 2))
        for flags in (dict(dmvr=True, bdof=True, gpm=True, affine=True),
                      dict(dmvr=True), dict(bdof=True),
                      dict(gpm=True, affine=True, sbt=True, dq=True)):
            n += _card_eq(f"phase A s={s} {sorted(flags)}", dev,
                          lambda *r, rows=rows, flags=flags: _phase_a_out(
                              r, rows, s, flags), *refs)
    return n


def _tool_counts(decs):
    """Leaves (8x8 granules) of the inter frames that use each tool."""
    inter = [d for d in decs if d.inter8.any()]
    cnt = dict(
        GPM=sum(int((d.gpm8 > 0).sum()) for d in inter),
        CIIP=sum(int(d.ciip8.sum()) for d in inter),
        affine=sum(int(d.aff8.sum()) for d in inter),
        BCW=sum(int(((d.inter8 > 0) & (d.bcw8 != 1)).sum()) for d in inter),
        BI=sum(int(((d.inter8 > 0) & (d.dir8 == 2)).sum()) for d in inter),
        intra=sum(int((d.inter8 == 0).sum()) for d in inter),
        MIP=sum(int(((d.inter8 == 0) & (d.modes8 >= 67)).sum())
                for d in inter),
        MRL=sum(int(d.mrl8.astype(bool).sum()) for d in inter),
        ISP=sum(int(d.isp8.astype(bool).sum()) for d in inter),
        MTS=sum(int(d.mts8.astype(bool).sum()) for d in inter),
        LFNST=sum(int(d.lfnst8.astype(bool).sum()) for d in inter),
        CCLM=sum(int(d.cmode8.astype(bool).sum()) for d in inter),
        SBT=sum(int((d.sbt8 > 0).sum()) for d in inter))
    return cnt


def _alf_ctus(data):
    """(luma, chroma) CTU counts with ALF on, summed over a stream's
    pictures (host parse of the port's decoder)."""
    from vvctpu_torch.pipeline import encoder as tenc
    _, _, entries = tenc._parse(data, False)
    luma = sum(int(e["alf"].ctu_on.sum()) for e in entries
               if e["alf"] is not None and e["alf"].enabled)
    chroma = sum(int(e["alf"].ctu_on_c[c].sum()) for e in entries
                 if e["alf"] is not None for c in (0, 1)
                 if e["alf"].c_enabled[c])
    return luma, chroma


def _phase_tools_small(dev):
    """Phase 6a: the 64x256 clip with every tool of the slice against the
    spec model, and the inter tools' worst-case batches."""
    from vvctpu_torch.kernels import dq as kdq
    before = kdq.launches
    data, decs, _ = _held_to_spec("64x256 GOP4 with every tool of the slice",
                                  dev, "ra_tools")
    dq_launches = kdq.launches - before
    cnt = _tool_counts(decs)
    alf_y, alf_c = _alf_ctus(data)
    missing = [t for t in ("GPM", "CIIP", "affine", "BCW", "BI", "SBT")
               if not cnt[t]]
    if not dq_launches:
        missing.append("DQ")
    if not alf_y + alf_c:
        missing.append("ALF")
    if missing:
        raise AssertionError(f"64x256 GOP4 tools: never chose {missing}")
    print(f"[6a] 64x256 GOP4 QP27, 5 frames, every tool of the slice: "
          f"{len(data)} bytes equal to the spec model; card and spec "
          "decoders verified hashes; 8x8 granules of P/B frames per tool: "
          + ", ".join(f"{k} {v}" for k, v in cnt.items())
          + f"; dq_trellis launches in the encode {dq_launches}; CTUs with "
          f"ALF on: luma {alf_y}, chroma {alf_c}")
    print(f"[6a] inter tools: card == CPU on {_inter_tool_worst_cases(dev)} "
          "worst-case batches (dmvr_offset, bdof_blend, affine luma with "
          "and without PROF and chroma, gpm_pass, affine_pass, phase A "
          "with BCW/GPM/DMVR/BDOF/affine and with SBT/DQ)")


def phase_ra_tools(dev):
    """Phase 6: random access with the inter toolset, SBT, DQ, ALF and
    the intra tools in P and B frames; returns the kernels' launches on
    the 1080p path (me_sad, dq_trellis) and the trellis's largest error
    against its twin at the path's shapes."""
    from vvctpu_torch.spec import sequence as tseq
    _phase_tools_small(dev)
    n = 5
    decs = []
    cfg = tseq.EncoderConfig(qp=32, intra_period=32, gop=4, wpp=True,
                             sbt=True, dq=True, alf=True, **RA_TOOLS)
    frames = synth_frames(n, 1080, 1920, seed=4)
    r = _run_full(dev, frames, cfg, decisions_out=decs)
    # me_sad runs once for P4 and once per list for each of B2, B1, B3
    if r["launches"] != 7:
        raise AssertionError(f"me_sad launched {r['launches']} times on "
                             "the config #4 path, expected 7")
    cnt = _tool_counts(decs)
    if not r["dq_launches"]:
        raise AssertionError("config #4: dq_trellis was never launched")
    tag = "[6b]"
    print(f"{tag} bench config #4 whole: 1080p RA GOP4 QP32 WPP with SBT, "
          f"DQ and ALF, {n} frames (I0 P4 B2 B1 B3), "
          f"{sum(r['bits']) / n:.1f} bits/frame (new data: the reference "
          "engine has no config #4 number); 8x8 granules of P/B frames per "
          "tool: " + ", ".join(f"{k} {v}" for k, v in cnt.items()))
    alf_y, alf_c = r["alf_ctus"]
    print(f"{tag} CTUs with ALF on over the {n} frames: luma {alf_y}, "
          f"chroma {alf_c}; alf stage: encode "
          f"{r['enc_t'].get('alf', 0.0):.2f} s, decode "
          f"{r['dec_t'].get('alf', 0.0):.2f} s")
    _report(tag, r, n)
    for k in ("enc", "dec"):
        lt = r[f"{k}_l"]
        print(f"{tag} {k}ode wall per temporal layer: " + ", ".join(
            f"{name} {lt[name]:.2f} s" for name in sorted(lt)))
    dq_err = _dq_path_times(dev, r["dq_path"], tag)
    return r["launches"], r["dq_launches"], dq_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")

    def timed(tag, fn):
        t0 = time.time()
        out = fn(dev)
        print(f"[time] {tag}: {time.time() - t0:.1f} s")
        return out

    # the spec model's side of phases 2, 5a and 6a is host work: two
    # worker processes run it while the card runs the phases before them
    pool = ProcessPoolExecutor(max_workers=2,
                               mp_context=multiprocessing.get_context("spawn"))
    try:
        for name in _spec_clips():
            _SPEC[name] = pool.submit(_spec_run, name)
        krow = timed("phase 1 me_sad", phase_kernels)
        drow = timed("phase 1 dq_trellis", phase_dq_kernel)
        timed("phase 2", phase_small)
        launches = (timed("phase 3", phase_full) + timed("phase 4", phase_ra)
                    + timed("phase 5", phase_ai))
        me4, dq_launches, dq_err = timed("phase 6", phase_ra_tools)
    finally:
        pool.shutdown(wait=True, cancel_futures=True)
    print(f"[time] spec model side in the workers: {_SPEC_T['work']:.1f} s; "
          f"the card's phases waited {_SPEC_T['wait']:.1f} s for it, so "
          f"the workers saved {_SPEC_T['work'] - _SPEC_T['wait']:.1f} s")
    kernels = [dict(name="me_sad", route="cuda",
                    source="vvctpu_torch/csrc/me_sad.cu",
                    replaces="vvctpu/kernels/me_pallas.py:248",
                    launches=launches + me4, equal=krow["max_abs_err"] == 0,
                    max_abs_err=krow["max_abs_err"], ms=krow["ms"],
                    plain_ms=krow["plain_ms"], bound_ms=krow["bound_ms"],
                    bound_by=krow["bound_by"], library_ms=None),
               dict(name="dq_trellis", route="cuda",
                    source="vvctpu_torch/csrc/dq_trellis.cu",
                    replaces="vvctpu/kernels/transform.py:232 quantize_dq_j",
                    launches=dq_launches,
                    equal=max(drow["max_abs_err"], dq_err) == 0,
                    max_abs_err=max(drow["max_abs_err"], dq_err),
                    ms=drow["ms"],
                    plain_ms=drow["plain_ms"], bound_ms=drow["bound_ms"],
                    bound_by=drow["bound_by"], library_ms=None)]
    print(json.dumps({"kernels": kernels}))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi.splitlines()[0])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
