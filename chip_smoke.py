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
   and the path's launches x time per encode;
7. the multi-type tree (BT and TT splits), as every VVC common test
   condition partitions: (7a) a 4-frame 64x96 all-intra clip with MTT,
   TT, MIP, MRL and ISP, and the 64x256 GOP4 clip of 6a with config #4's
   toolset, MTT and TT, encoded on the card must equal the spec model's
   bitstream and decisions and decode on the card and in the spec model,
   hashes verified, with me_sad at 11 keys once per P frame and once per
   list for each B frame; the rect decision passes, the rect intra leaf
   class and phase A of rect inter leaves (with and without DQ) on the
   card must equal the CPU path on worst-case batches; (7b) 3 frames of
   1080p (I0 P2 B1) with config #4's toolset, MTT and TT: hashes
   verified, recon == decoded, 3 me_sad launches at 11 keys, with the
   rect leaves per shape, stage and per-layer times, the phase-B batches
   per leaf class, the trellis per block shape (the 12 rect shapes among
   them) timed against its twin, and the decide stage of one I, P and B
   frame with and without MTT and its rect passes timed.  Every rect
   shape and both TT directions must occur in 7a and 7b together;
8. LMCS (luma mapping with chroma residual scaling), one model per frame
   through the frame-batched wave: (8a) test_lmcs.py's all-intra and GOP2
   clips (64x96) and test_tt.py's LMCS config (64x96 GOP4 with MTT, TT
   and the inter toolset) encoded on the card must equal the spec
   model's bitstream and decisions and decode on the card and in the
   spec model, hashes verified; every leaf class (intra with MTS, LFNST,
   MIP and CCLM, ISP, rect, CIIP) and phase A (square with every inter
   tool, SBT and DQ; rect) with a CRS LUT at both clamps (512, 8192) and
   residuals of both signs, the scaled component and chroma choice, and
   the inverse mapping before the loop filters, on the card must equal
   the CPU path; (8b) phase 7b's 3 frames of 1080p with LMCS on
   (7b's toolset with LMCS): hashes verified, recon == decoded,
   3 me_sad launches at 11 keys, the trellis launched, with stage and
   per-layer times, the phase-B batches per leaf class and the encode
   and decode walls against 7b's in the same process;
9. 10-bit input, tiles and subpictures: (9a) test_codec_roundtrip.py's
   10-bit all-intra clip, test_tiles.py's two configs, a 192x192 10-bit
   GOP2 clip whose 2x2 grid has four tile sizes, and test_subpic.py's
   2x1 and 100x150 2x2 configs, encoded on the card, must equal the
   spec model's bitstream and decisions (each subpicture's) and decode
   on the card and in the spec model, hashes verified; phase 6a's clip
   in 10 bits with every tool of the slice, LMCS, MTT and TT must give
   the reference engine's stream (its SHA-256: the spec model's differs
   at 10 bits) and decode on the card and in the spec model; the
   transforms, transform choice, motion search, every leaf class and
   phase A (at a tile's reference offset) and the loop filters on the
   card must equal the CPU path on 10-bit worst-case inputs; me_sad at
   2176x3840 on 10-bit samples equals its twin (noisy, flat, wrapping
   lam) and is timed against its float32 bound; (9b) bench config #5 on
   one card: 3 frames of 4K 10-bit random access GOP2 (I0 P2 B1, the
   depth cut from a GOP for the script's limit) with a 2x2 tile grid
   and the default toolset: hashes verified, recon == decoded, 3 me_sad
   launches at 2176x3840, with stage and per-layer times, the phase-B
   batches, fps, the card's busy share and peak memory.

10. transform skip, joint Cb-Cr residuals, MCTF and rate control: (10a)
   test_tskip.py's two configurations, test_jccr.py's with CCLM off
   and on, test_apps.py's rate-control and MCTF configurations, the
   four tools with 6a's toolset, MTT, TT and LMCS on a 64x64 clip and on
   6a's 64x256 clip, encoded on the card, must equal the spec model's
   bitstream and decisions and decode on the card and in the spec
   model, hashes verified, with TS and JCCR chosen where they are on;
   the MCTF prefilter on 5 frames of 416x240 on the card must equal the
   spec model's; (10b) 8b's configuration with TS, JCCR, MCTF and rate
   control at 600000 bits/frame on 3 frames of 1080p: MCTF leaves the
   1080-row frames unchanged, the controller moves the QP, hashes
   verified, recon == decoded, 3 me_sad launches at 11 keys, with the
   per-frame QPs, bits and PSNR, stage and per-layer times; (10c) the
   MCTF prefilter on 3 frames of config #5's 4K 10-bit source, timed on
   the card (4 me_sad launches at lam 0), me_sad held against its twin
   at lam 0 on one of its searches and its blend against the spec
   model's arithmetic given the card's motion.
11. intra block copy and palette (the screen-content leaf classes of I
   slices), then CTU 128: (11a) test_ibc.py's two and test_palette.py's
   three engine configurations, test_ctu128.py's configurations (the
   same frame at CTU 64 and at 128 giving two streams) and 10a's 64x64
   CTC clip at CTU 128 without rate control, encoded on the card, must
   equal the spec model's bitstream and decisions and decode on the card
   and in the spec model, hashes verified, with IBC and palette chosen
   where they are on; (11b) 3 frames of 1080p synthetic screen content
   all-intra QP32 with WPP, IBC, palette and config #2's intra toolset:
   IBC and palette chosen in every frame, the IBC and palette leaf
   classes in the wave, hashes verified, recon == decoded, with the
   block-vector search's time on the card and the palette costs' on the
   host, stage times, batches per leaf class and peak memory; (11c) VTM's
   common-test-condition random-access toolset whole: 10b's
   configuration at CTU 128 without rate control, 3 frames of 1080p
   (padded to 1152 rows): hashes verified, recon == decoded, 3 me_sad
   launches at 11 keys on 1152x1920, the trellis launched, its POC 0
   printed beside 10b's.

12. multi-device (vvctpu_torch/dist), four ranks, child processes on the
   one card joined under gloo: (12a) test_shard.py's three configs (the
   third takes the unsharded wave: 2 tiles on a 4-rank tile axis), a 2x2
   LMCS clip and test_rdoq.py's and test_isp.py's RDOQ-off configs
   encoded and decoded over a (1, 4) mesh must equal the spec model's
   bitstream and decisions, hashes verified, with a syntax trace equal
   to the spec model's; __graft_entry__'s dry-run shape over a (2, 2)
   mesh (a closed-GOP segment per gop row, the tiles over its row) must
   equal the unsharded encode_gop_parallel; the CLI's --distributed over
   two processes must give encode_gop_parallel's stream after parcat;
   (12b) bench config #5 (9b's clip) over a (1, 4) mesh, tile t of every
   frame on rank t: its bytes equal to 9b's one-rank stream of the same
   run, hashes verified, recon == decoded, 3 me_sad launches, with the
   walls, the controller's stages, each rank's wave seconds and batches,
   the exchange's seconds and bytes per group and each rank's peak
   memory.

After phase 4 the script runs in five processes, each on a CUDA context
of its own: phase 5 in the first, phases 7 and 8 in a second, phases 9
and 12 in a third (12 with four rank processes of its own, in the room
9b has returned), phases 10 and 6 in a fourth, phase 11 (11b, 11a, then
11c) and phase 3 in a fifth.  So the walls and card busy shares of
phases 3 and 5 to 12 are measured with the others running (the card's
busy share is the device's); the lines of phases 7 and 8, then 9 and 12,
then 10 and 6, then 11 and 3 print after phase 5's.

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


def synth_frames10(n, h, w, seed=0):
    """Synthetic moving 10-bit test frames: the benchmark's pattern at
    four times its amplitude around a brighter base, with noise over the
    two low bits, so the samples reach both 0 and 1023."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (420 + 280 * np.sin((xx + 5 * t) / 11.0)
             + 200 * np.cos((yy - 3 * t) / 8.0)
             + 100 * np.sin(xx * yy / 900.0)
             + rng.integers(-40, 41, (h, w))).clip(0, 1023).astype(np.int32)
        cb = (512 + 100 * np.sin((xx[::2, ::2] + 2 * t) / 6.0)
              + rng.integers(-4, 5, (h // 2, w // 2))).clip(
            0, 1023).astype(np.int32)
        cr = (512 - 80 * np.cos((yy[::2, ::2] + t) / 7.0)
              + rng.integers(-4, 5, (h // 2, w // 2))).clip(
            0, 1023).astype(np.int32)
        frames.append([y, cb, cr])
    return frames


def shard_frames(n, h, w, seed=3):
    """test_shard.py's frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (80 + 60 * np.sin((xx + 4 * t) / 9.0)
             + 40 * np.cos((yy - 2 * t) / 7.0)
             + rng.integers(-8, 8, (h, w))).clip(0, 255).astype(np.int32)
        cb = (128 + 20 * np.sin((xx[::2, ::2] + t) / 5.0)).clip(
            0, 255).astype(np.int32)
        cr = (128 - 15 * np.cos((yy[::2, ::2] + t) / 6.0)).clip(
            0, 255).astype(np.int32)
        frames.append([y, cb, cr])
    return frames


def isp_frames(n, h, w, seed=0):
    """test_isp.py's frames."""
    rng = np.random.default_rng(seed)
    frames = []
    for t in range(n):
        yy, xx = np.mgrid[0:h, 0:w]
        y = (100 + 70 * np.sin((xx + 4 * t) / 9.0)
             + 50 * np.cos(yy / 7.0) + (xx // 16) * 3
             + rng.integers(-8, 8, (h, w))).clip(0, 255).astype(np.int32)
        cb = (128 + 20 * np.sin(xx[::2, ::2] / 6.0)).astype(np.int32)
        cr = (128 - 18 * np.cos(yy[::2, ::2] / 5.0)).astype(np.int32)
        frames.append([y, cb, cr])
    return frames


def dryrun_frames(n, h, w):
    """__graft_entry__.py's frames for its multi-device dry run."""
    rng = np.random.default_rng(7)
    yy, xx = np.mgrid[0:h, 0:w]
    frames = []
    for t in range(n):
        y = (90 + 60 * np.sin((xx + 6 * t) / 9.0)
             + 45 * np.cos((yy - 4 * t) / 7.0)
             + rng.integers(-8, 8, (h, w))).clip(0, 255).astype(np.int32)
        cb = (128 + 20 * np.sin((xx[::2, ::2] + 2 * t) / 5.0)).clip(
            0, 255).astype(np.int32)
        cr = (128 - 16 * np.cos((yy[::2, ::2] + t) / 6.0)).clip(
            0, 255).astype(np.int32)
        frames.append([y, cb, cr])
    return frames


def c5_config():
    """Bench config #5 as phases 9b and 12b run it: 4K 10-bit random
    access GOP2 QP32 with a 2x2 tile grid."""
    from vvctpu_torch.spec import sequence as tseq
    return tseq.EncoderConfig(qp=32, bit_depth=10, intra_period=32, gop=2,
                              tile_cols=2, tile_rows=2)


def to10(frames, seed=0):
    """10-bit frames from 8-bit ones: each sample times four plus noise
    over the two low bits."""
    rng = np.random.default_rng(seed)
    return [[(np.asarray(p, np.int32) << 2)
             | rng.integers(0, 4, p.shape).astype(np.int32) for p in f]
            for f in frames]


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
    err = max(err, _dq_rect_cases(dev, rng))
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


def _dq_rect_cases(dev, rng):
    """The trellis against its twin (tolerance 0) at the transform-block
    shapes of the multi-type tree's rect leaves (phase 7), at one block
    and at 300, each at the lane count ``lanes_for`` picks, which must be
    one the kernel takes; returns the largest error."""
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.kernels import transform as ktf
    from vvctpu_torch.pipeline import plan as tplan
    from vvctpu_torch.spec.transform import lambda_rd_int
    shapes = sorted({(h // c, w // c) for w, h in tplan.RECT_SHAPES
                     for c in (1, 2)})
    err, lanes = 0, {}
    for h, w in shapes:
        walk = torch.as_tensor(ktf.walk32(h, w), device=dev)
        p = ktf.dq_params(h, w, 32, lambda_rd_int(32))
        for B in (1, 300):
            la = kdq.lanes_for(h * w, B)
            if la not in kdq.LANES or not kdq.lanes_ok(h * w, la):
                raise AssertionError(f"dq_trellis: lanes_for gives {la} "
                                     f"lanes for {B} blocks of {h}x{w}")
            lanes[(h, w, B)] = la
            c = torch.as_tensor(_dq_noisy(rng, h, w, B), device=dev)
            e = int((kdq.dq_trellis(c, walk, *p)
                     - kdq.dq_trellis_plain(c, walk, *p)).abs().max())
            if e != 0:
                raise AssertionError(f"dq_trellis differs from its twin on "
                                     f"{B} blocks of {h}x{w}: max abs err "
                                     f"{e}")
            err = max(err, e)
    print(f"[1] dq_trellis at the {len(shapes)} rect block shapes of the "
          f"multi-type tree (h x w), 1 and 300 blocks: equal to twin "
          f"(tolerance 0); lanes per block (1, 300 blocks): " + ", ".join(
              f"{h}x{w} {lanes[(h, w, 1)]}/{lanes[(h, w, 300)]}"
              for h, w in shapes))
    return err


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


def _me_sad_planes(dev, H, W, mx, seed, noise, flat):
    """me_sad's check inputs at H x W with samples 0..mx: noisy motion; a
    flat frame of value ``flat``, where every offset ties and only the
    row-major order decides; a lam whose lam * bits wraps int32.  Returns
    name -> (orig, padded ref, lam) on ``dev``."""
    from vvctpu_torch.spec.decide import lambda_satd_fp
    rng = np.random.default_rng(seed)
    orig = rng.integers(0, mx + 1, (H, W)).astype(np.int32)
    ref = (np.roll(orig, (3, -5), (0, 1))
           + rng.integers(-noise, noise + 1, (H, W))).clip(0, mx).astype(
               np.int32)
    flat = np.full((H, W), flat, np.int32)
    lam = lambda_satd_fp(32)
    cases = {"noisy": (orig, ref, lam), "flat": (flat, flat, lam),
             "wrap": (orig, ref, 2 ** 27)}
    return {k: (torch.as_tensor(o, device=dev),
                torch.as_tensor(np.pad(r, 16, mode="edge"), device=dev), la)
            for k, (o, r, la) in cases.items()}


def phase_kernels(dev):
    """Phase 1, me_sad: built, held against its twin and timed at 1080p
    with 8-bit samples (7 and 11 keys) and at config #5's 2176x3840 with
    10-bit samples (7 keys), on the card alone.  Returns the rows of the
    1080p 7-key and the 4K 10-bit runs."""
    from vvctpu_torch.kernels import me_sad as kme
    t0 = time.time()
    log = kme.build(verbose=True)
    print(f"[1] me_sad built in {time.time() - t0:.1f} s")
    for line in log.splitlines():
        if any(w in line for w in ("Compiling", "registers", "spill")):
            print(f"[1]   {line.strip()}")
    print(f"[1] me_sad dy split: {kme.SPLIT} warps per 32x32 region "
          "(csrc/me_sad.cu SPLIT)")
    rows = {}
    for tag, H, W, mx, seed, noise, flat, tts, plain_reps in (
            ("8-bit", 1088, 1920, 255, 1, 6, 77, (False, True), 3),
            ("10-bit", 2176, 3840, 1023, 13, 24, 1023, (False,), 2)):
        planes = _me_sad_planes(dev, H, W, mx, seed, noise, flat)
        go, gr, lam = planes["noisy"]
        for tt in tts:
            keys = kme.KEYS[:11 if tt else 7]
            err = 0
            for kind, (o, r, la) in planes.items():
                want = kme.me_sad_reference(o, r, la, tt=tt)
                got = kme.me_sad(o, r, la, tt=tt)
                torch.cuda.synchronize()
                e = max(int((a - b).abs().max()) for g, w_ in zip(got, want)
                        for a, b in zip(g, w_))
                if e != 0:
                    raise AssertionError(
                        f"me_sad {H}x{W} {tag} differs from its twin "
                        f"({kind}, tt={tt}): max abs err {e}")
                err = max(err, e)
            ms = cuda_ms(lambda: kme.me_sad(go, gr, lam, tt=tt), 20)
            plain = cuda_ms(lambda: kme.me_sad_reference(go, gr, lam, tt=tt),
                            plain_reps)
            bound, by = me_sad_bound_ms(H, W, keys, mx)
            rows[tag, tt] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                                 bound_ms=bound, bound_by=by)
            print(f"[1] me_sad {H}x{W} keys={len(keys)}, {tag} samples "
                  f"(0..{mx}): equal to twin (tolerance 0, max abs err "
                  f"{err}) on {', '.join(planes)}")
            print(f"[1]   kernel {ms:.4f} ms; twin {plain:.1f} ms; bound "
                  f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f} % of it; "
                  f"launches so far {kme.launches}")
        del planes, go, gr
    return rows["8-bit", False], rows["10-bit", False]


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
        "mtt_intra": (motion_frames(4, 64, 96, seed=81),
                      dict(qp=32, mip=True, mrl=True, isp=True, **MTT)),
        "mtt_ra_tools": (tool_frames(), dict(qp=27, intra_period=0, gop=4,
                                             isp=True, mrl=True, sbt=True,
                                             dq=True, alf=True, **MTT,
                                             **RA_TOOLS)),
        # test_lmcs.py:52 and :61, test_tt.py:112
        "lmcs_ai": (motion_frames(2, 64, 96, seed=70),
                    dict(qp=32, intra_period=1, lmcs=True)),
        "lmcs_gop2": (motion_frames(4, 64, 96, seed=71),
                      dict(qp=32, intra_period=0, gop=2, lmcs=True)),
        "lmcs_tt": (motion_frames(4, 64, 96, seed=81),
                    dict(qp=32, intra_period=0, gop=4, mmvd=True, sbt=True,
                         ciip=True, bcw=True, gpm=True, affine=True,
                         lmcs=True, dq=True, **MTT)),
        # phase 9: test_codec_roundtrip.py:146, test_tiles.py:55 (both
        # configs), unequal tiles, test_subpic.py:12 and :49
        "ai10": (ai10_frames(), dict(qp=32, bit_depth=10)),
        "tiles21": (motion_frames(3, 64, 128, seed=83),
                    dict(qp=32, tile_cols=2, tile_rows=1)),
        "tiles22": (motion_frames(3, 64, 128, seed=83),
                    dict(qp=32, tile_cols=2, tile_rows=2, intra_period=0,
                         gop=2, mmvd=True, ciip=True, sbt=True, lmcs=True)),
        "tiles_unequal": (motion_frames(3, 192, 192, seed=84),
                          dict(qp=32, bit_depth=10, tile_cols=2,
                               tile_rows=2, intra_period=0, gop=2)),
        "subpic21": (motion_frames(3, 64, 128, seed=21),
                     dict(qp=32, subpic_cols=2, subpic_rows=1,
                          intra_period=0)),
        "subpic22": (motion_frames(2, 100, 150, seed=24),
                     dict(qp=34, subpic_cols=2, subpic_rows=2)),
        # phase 10: test_tskip.py:76 and :96, test_jccr.py:59 with CCLM
        # off and on, test_apps.py:102 (rate control) and :135 (MCTF), the
        # four tools with MTT, TT and LMCS on a 64x64 clip and on 6a's,
        # and the MCTF prefilter alone at config #1's size
        "ts_tools": ([screen_planes(64, 128, seed=6)],
                     dict(qp=32, sao=False, deblock=False, tskip=True,
                          mts=True, lfnst=True, mip=True)),
        "ts_alone": ([screen_planes(64, 128, seed=8)],
                     dict(qp=24, sao=False, deblock=False, tskip=True)),
        "jccr": ([corr_chroma_planes(64, 128, seed=7)],
                 dict(qp=32, sao=False, deblock=False, jccr=True,
                      cclm=False, mts=True, mip=True)),
        "jccr_cclm": ([corr_chroma_planes(64, 128, seed=7)],
                      dict(qp=32, sao=False, deblock=False, jccr=True,
                           cclm=True, mts=True, mip=True)),
        "rc": (motion_frames(4, 64, 64, seed=96),
               dict(qp=26, intra_period=0, rc_bits_per_frame=1200)),
        "mctf": (motion_frames(4, 64, 64, seed=98),
                 dict(qp=32, intra_period=0, gop=2, mctf=True)),
        "ctc": (ctc_frames(), dict(qp=27, intra_period=0, gop=2,
                                   rc_bits_per_frame=4000, **CTC_SMALL)),
        "ctc_6a": (tool_frames(), dict(qp=27, intra_period=0, gop=4,
                                       rc_bits_per_frame=12000,
                                       **CTC_SMALL)),
        "mctf416": (synth_frames(5, 240, 416, seed=6), dict(filter_gop=4)),
        # phase 11: test_ibc.py:67's two configs, test_palette.py:86's
        # three, test_ctu128.py's (the same frame at CTU 64 and 128
        # apart) and 10a's CTC clip at CTU 128 without rate control
        "ibc": ([glyph_planes(128, 128, seed=5)], dict(qp=32, ibc=True)),
        "ibc_mtt": ([glyph_planes(128, 128, seed=5)],
                    dict(qp=32, ibc=True, mtt=True, dq=True, mts=True)),
        "plt": (_plt_pair(), dict(qp=32, plt=True)),
        "plt_ibc_lmcs": (_plt_pair(), dict(qp=32, plt=True, ibc=True,
                                           lmcs=True)),
        "plt_tiles": (_plt_pair(), dict(qp=32, plt=True, tile_cols=2,
                                        tile_rows=1)),
        "c128_ai": (ctu128_frames(1, 140, 190),
                    dict(qp=32, ctu=128, mts=True)),
        "c128_at64": (ctu128_frames(1, 128, 192), dict(qp=30, ctu=64)),
        "c128_at128": (ctu128_frames(1, 128, 192), dict(qp=30, ctu=128)),
        "c128_gop2": (ctu128_frames(3, 128, 192, seed=11),
                      dict(qp=32, ctu=128, intra_period=0, gop=2)),
        "c128_wpp": (ctu128_frames(1, 256, 192, seed=12),
                     dict(qp=32, ctu=128, wpp=True)),
        "c128_mtt": (ctu128_frames(1, 128, 192, seed=13),
                     dict(qp=32, ctu=128, mtt=True, tt=True, isp=True)),
        "c128_ctc": (ctc_frames(), dict(qp=27, intra_period=0, gop=2,
                                        ctu=128, **CTC_SMALL)),
        # phase 12: test_shard.py's three configs, test_tiles.py:55's 2x2
        # LMCS config at 128 rows (at 64 its grid is one row of 2 tiles),
        # test_rdoq.py:70's and test_isp.py:33's RDOQ-off configs
        "shard_inter": (shard_frames(3, 128, 256),
                        dict(qp=32, intra_period=4, gop=2, tile_cols=4,
                             tile_rows=1)),
        "shard_22": (shard_frames(2, 128, 128, seed=9),
                     dict(qp=37, intra_period=1, tile_cols=2, tile_rows=2)),
        "shard_fallback": (shard_frames(1, 64, 128, seed=5),
                           dict(qp=32, intra_period=1, tile_cols=2)),
        "shard_lmcs": (motion_frames(3, 128, 128, seed=83),
                       dict(qp=32, tile_cols=2, tile_rows=2, intra_period=0,
                            gop=2, mmvd=True, ciip=True, sbt=True,
                            lmcs=True)),
        "shard_lmcs_dq": (motion_frames(3, 128, 128, seed=83),
                          dict(qp=32, tile_cols=2, tile_rows=2,
                               intra_period=0, gop=2, mmvd=True, ciip=True,
                               sbt=True, lmcs=True, dq=True)),
        "rdoq_off": (motion_frames(2, 64, 96, seed=61),
                     dict(qp=32, intra_period=1, rdoq=False)),
        "isp_rdoq_off": (isp_frames(1, 64, 128, seed=3),
                         dict(qp=30, isp=True, deblock=False, sao=False,
                              rdoq=False)),
    }


def _spec_run(name):
    """The spec model's encode of clip ``name`` and its decode with the
    hashes verified: (bytes, decisions, decoded planes, seconds taken).
    Host work only, so main() runs it in worker processes beside the
    card's phases."""
    from vvctpu_torch.spec import mctf as smctf
    from vvctpu_torch.spec import sequence as tseq
    t0 = time.time()
    frames, kw = _spec_clips()[name]
    if "filter_gop" in kw:
        # the prefilter alone: the filtered frames
        return (smctf.temporal_filter(frames, kw["filter_gop"]), None, None,
                time.time() - t0)
    decs = []
    if kw.get("subpic_cols", 1) * kw.get("subpic_rows", 1) > 1:
        data, _, _ = _subpic_spec(frames, kw, decs)
    else:
        data, _, _ = tseq.encode_sequence(frames, tseq.EncoderConfig(**kw),
                                          decisions_out=decs)
    out, _ = tseq.decode_sequence(data, check_hash=True)
    return data, decs, out, time.time() - t0


# clip name -> future of _spec_run, filled by main(); a phase run on its
# own computes its spec results in place
_SPEC = {}
# in a process of _phase_proc: main()'s shared dict of the finished spec
# results (name -> _spec's result), which _spec waits on
_SPEC_SHARED = None
# seconds this process's phases waited for the spec model's results
_SPEC_T = {"wait": 0.0}
# runs a later phase of the same process compares with (phase 7's 7b,
# phase 9's 9b)
_RUNS = {}


def _spec(name):
    fut = _SPEC.get(name)
    if fut is None and _SPEC_SHARED is not None:
        t0 = time.time()
        while name not in _SPEC_SHARED:
            if time.time() - t0 > 1500:
                raise TimeoutError(f"spec model result {name!r} never came")
            time.sleep(0.2)
        res = _SPEC_SHARED[name]
        _SPEC_T["wait"] += time.time() - t0
        if isinstance(res, str):
            raise RuntimeError(f"spec model run {name!r} failed: {res}")
        return res
    if fut is None:
        return _spec_run(name)[:3]
    t0 = time.time()
    data, decs, out, _ = fut.result()
    _SPEC_T["wait"] += time.time() - t0
    return data, decs, out


def _held_to_spec(tag, dev, name):
    """Encode clip ``name`` on the card, hold its bytes and whole-plane
    decisions against the spec model's and decode it on the card; the
    card's recon, the card's decoded planes and the spec model's decoded
    planes must agree.  Returns (bytes, the card's decisions, the spec
    model's decisions)."""
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    frames, kw = _spec_clips()[name]
    decs = []
    data, recons, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(**kw), device=dev, decisions_out=decs)
    sdata, sdecs, sout = _spec(name)
    if data != sdata:
        raise AssertionError(f"{tag}: card bitstream != spec model's")
    _decisions_equal(tag, decs, sdecs)
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
    kme.trace = []
    kdq.launches = 0
    kdq.trace = []
    wave.batches = 0
    wave.batch_kinds = {}
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
    r["me_keys"] = [k for k, _, _ in kme.trace]
    r["me_shapes"] = [(h, w) for _, h, w in kme.trace]
    kdq.trace = kme.trace = None
    r["batches"] = wave.batches
    r["batch_kinds"] = dict(wave.batch_kinds)
    wave.batch_kinds = None
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
    # the processes share the card's memory: give this run's cached
    # blocks back before the next run in this process
    torch.cuda.empty_cache()
    if not _same_planes(recons, out):
        raise AssertionError("encoder recon != decoder output")
    r["psnr"] = [float(tseq.psnr(f[0], x[0], cfg.bit_depth))
                 for f, x in zip(frames, recons)]
    for p in r["psnr"]:
        if not np.isfinite(p) or p < 25.0:
            raise AssertionError(f"implausible Y-PSNR {p}")
    r.update(bits=bits, busy_enc=busy_enc, busy_dec=busy_dec,
             alf_ctus=_alf_ctus(data), qps=tenc.slice_qps(data), data=data)
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
        if c is None and g is None:
            continue
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
def ctc_frames(n=3, seed=3):
    """A 64x64 clip for transform skip and joint Cb-Cr coding under
    motion: sharp rectangles on a flat ground (screen content) panning 2
    px right and 1 px down per frame, over anti-correlated Cb and Cr."""
    h = w = 64
    rng = np.random.default_rng(seed)
    big = np.zeros((h + 2 * n, w + 2 * n))
    for _ in range(40):
        x0, y0 = rng.integers(0, w), rng.integers(0, h)
        big[y0:y0 + rng.integers(2, 9), x0:x0 + rng.integers(2, 9)] = \
            rng.integers(0, 256)
    base = rng.integers(-40, 41, (h // 2 + n, w // 2 + n))
    out = []
    for t in range(n):
        b = base[t // 2:t // 2 + h // 2, t:t + w // 2]
        out.append([big[t:t + h, 2 * t:2 * t + w].astype(np.int32),
                    np.clip(128 + b, 0, 255).astype(np.int32),
                    np.clip(128 - b, 0, 255).astype(np.int32)])
    return out


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


# ---------------------------------------------------------------------------
# phase 7: the multi-type tree (BT and TT splits) in I, P and B frames
# ---------------------------------------------------------------------------

MTT = dict(mtt=True, tt=True)


def _decisions_equal(tag, decs, sdecs):
    """Every field of each frame's decisions equals the spec model's, on
    whole planes (FrameDecisions.equal)."""
    import dataclasses
    if len(decs) != len(sdecs):
        raise AssertionError(f"{tag}: {len(decs)} decisions, the spec model "
                             f"has {len(sdecs)}")
    for i, (a, b) in enumerate(zip(decs, sdecs)):
        if not a.equal(b):
            bad = [f.name for f in dataclasses.fields(a)
                   if isinstance(getattr(a, f.name), np.ndarray)
                   and not np.array_equal(getattr(a, f.name),
                                          getattr(b, f.name))]
            raise AssertionError(f"{tag}: frame {i} {bad} differ from the "
                                 "spec model's")


def _rect_counts(decs, h, w):
    """Rect leaves per shape over the frames' decisions, as {(w, h):
    [intra, inter]}, and the TT nodes per direction."""
    from vvctpu_torch.pipeline import plan as tplan
    cnt = {sh: [0, 0] for sh in tplan.RECT_SHAPES}
    for d in decs:
        op = tplan.leaf_plan(d, h, w)[0]
        for i, sh in enumerate(tplan.RECT_SHAPES):
            cnt[sh][0] += int((op == tplan.OP_RECT_INTRA0 + i).sum())
            cnt[sh][1] += int((op == tplan.OP_RECT_INTER0 + i).sum())
    tt = {"TT-H": sum(int((d.bt32 == 3).sum()) for d in decs),
          "TT-V": sum(int((d.bt32 == 4).sum()) for d in decs)}
    return cnt, tt


def _counts_line(cnt, tt):
    return ("rect leaves (intra, inter) " + ", ".join(
        f"{w}x{h} {a}, {b}" for (w, h), (a, b) in cnt.items())
        + "; TT nodes " + ", ".join(f"{k} {v}" for k, v in tt.items()))


def _rect_leaf_out(kind, src, buf_y, buf_c, *refs, rows, w, h, dq):
    """The rect intra leaf class (``kind`` "rect", rows (k, 17)) or phase A
    of rect inter leaves ("inter", rows (k, 8)) of w x h leaves on a carry
    of one frame whose recon buffers hold buf_y and the (Cb, Cr) stack
    buf_c and whose source planes come from src; returns the recon and
    level planes."""
    from vvctpu_torch.pipeline import recon, wave
    dev = src.device
    hh, ww = src.shape
    carry = dict(by=buf_y[None].clone(), bc=buf_c.clone(),
                 ly=torch.zeros((1, hh, ww), dtype=torch.int32, device=dev),
                 lc=torch.zeros((2, hh // 2, ww // 2), dtype=torch.int32,
                                device=dev),
                 sy=src[None], sc=torch.stack([src[::2, ::2],
                                               src[1::2, 1::2]]))
    for k in ("b", "l", "s"):
        carry[k + "cb"], carry[k + "cr"] = carry[k + "c"].split(1)
    if kind == "rect":
        wave._rect_batch(carry, torch.as_tensor(rows, device=dev), 32, 347,
                         w=w, h=h, frame_w=ww, frame_h=hh, log2_ctu=6, bd=8,
                         encode=True, rdoq=True, dq=dq)
    else:
        recon._inter_batch_pass_rect(carry, rows, [r[None] for r in refs],
                                     w, h, 32, 8, True, rdoq=True,
                                     lam_rd=347, dq=dq)
    return carry["by"], carry["ly"], carry["bc"], carry["lc"]


def _mtt_worst_cases(dev):
    """The multi-type tree's passes on the card against the CPU path on
    worst-case batches: saturated 0/255 and flat planes and references
    (every candidate ties on a flat one), all 67 modes, negative MVs and
    MVs past the padded plane; returns the number of cases."""
    from vvctpu_torch.coding import decide as tdec
    from vvctpu_torch.coding import me as tme
    from vvctpu_torch.kernels import intra_pred as kip
    from vvctpu_torch.pipeline import plan as tplan
    rng = np.random.default_rng(7)
    h, w = 64, 128
    m = kip.MARGIN
    planes = {"sat": rng.choice([0, 255], (h, w)).astype(np.int32),
              "noisy": rng.integers(0, 256, (h, w)).astype(np.int32),
              "flat": np.full((h, w), 77, np.int32)}
    geoms = tdec._rect_keys(True)
    n = 0

    def refine_bi(orig, r0, r1, imv0, imv1, **geo):
        p0 = tme.quarter_phase_planes(r0)
        p1 = tme.quarter_phase_planes(r1)
        c0, m0 = tme.refine_pass(orig, r0, imv0, 211, planes=p0, **geo)
        c1, m1 = tme.refine_pass(orig, r1, imv1, 211, planes=p1, **geo)
        return (c0, m0, c1, m1) + tme.bi_cost_pass(
            orig, m0, m1, 211, planes0=p0, planes1=p1, **geo)

    for name, p in planes.items():
        buf = np.zeros((h + 1 + m, w + 1 + m), np.int32)
        buf[1:h + 1, 1:w + 1] = p
        ref = np.pad(p, 80, mode="edge")
        other = np.pad(planes["noisy"], 80, mode="edge")
        for g, (bw, bh, sy, sx, oy, ox) in geoms.items():
            geo = dict(frame_w=w, frame_h=h, sy=sy, sx=sx, oy=oy, ox=ox)
            n += _card_eq(f"rect_size_pass {name} {g}", dev,
                          tdec.rect_size_pass, buf, 211, bw=bw, bh=bh, **geo)
            nby, nbx, *_ = tme.tiling(w, h, bw, bh, sy, sx, oy, ox)
            imv = rng.integers(-16, 17, (2, nby, nbx, 2)).astype(np.int32)
            n += _card_eq(f"rect refine + bi {name} {g}", dev, refine_bi,
                          planes["noisy"], ref, other, imv[0], imv[1], s=bw,
                          bh=bh, **geo)
    # the rect leaf classes on saturated recon buffers and references
    src = planes["noisy"]
    buf_y = rng.choice([0, 255], (h + 1 + m, w + 1 + m)).astype(np.int32)
    buf_c = rng.choice([0, 255], (2, h // 2 + 1 + m,
                                  w // 2 + 1 + m)).astype(np.int32)
    sat, noisy = planes["sat"], planes["noisy"]
    refs = [np.pad(sat, 80, mode="edge"), np.pad(sat[::2, ::2], 40,
                                                 mode="edge"),
            np.pad(noisy[::2, ::2], 40, mode="edge"),
            np.pad(noisy, 80, mode="edge"),
            np.pad(noisy[1::2, 1::2], 40, mode="edge"),
            np.pad(sat[1::2, 1::2], 40, mode="edge")]
    for g, (bw, bh, sy, sx, oy, ox) in geoms.items():
        _, _, _, ys, xs = tme.tiling(w, h, bw, bh, sy, sx, oy, ox)
        k = ys.shape[0]
        rows = np.zeros((k, 17), np.int32)
        rows[:, 1], rows[:, 2] = xs.numpy(), ys.numpy()
        rows[:, 3] = np.arange(k) % 67
        mv = (rng.integers(-270, 271, (k, 4)) * 4).astype(np.int32)
        mv[:3, :2] = [[-16 * 95, 0], [0, 16 * 90], [16 * 200, -16 * 200]]
        irows = np.concatenate([rows[:, 1:3], mv, rng.choice(
            [0, 1, 2], (k, 1)), np.zeros((k, 1))], 1).astype(np.int32)
        for dq in (False, True):
            n += _card_eq(f"rect leaves {g} dq={dq}", dev,
                          lambda *a, rows=rows, bw=bw, bh=bh, dq=dq:
                          _rect_leaf_out("rect", *a, rows=rows, w=bw, h=bh,
                                         dq=dq), src, buf_y, buf_c)
            if (bw, bh) in tplan.RECT_SHAPES and not isinstance(g, str):
                n += _card_eq(f"phase A rect {g} dq={dq}", dev,
                              lambda *a, rows=irows, bw=bw, bh=bh, dq=dq:
                              _rect_leaf_out("inter", *a, rows=rows, w=bw,
                                             h=bh, dq=dq),
                              src, buf_y, buf_c, *refs)
    return n


def _mtt_decide_times(dev, frames, cfg):
    """Wall of the decisions of one I, P and B frame of ``frames`` (P2
    from I0, B1 from I0 and P2, the source planes standing in for the
    references) with and without MTT and TT, and the card time of the rect
    passes of the B frame at each geometry; prints them."""
    import dataclasses

    from vvctpu_torch.coding import decide as tdec
    from vvctpu_torch.coding import me as tme
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.pipeline import recon
    from vvctpu_torch.spec import codec as scodec
    from vvctpu_torch.spec import hls
    from vvctpu_torch.spec.decide import lambda_satd_fp
    tag = "[7b]"
    out = {}
    for mtt in (False, True):
        c = dataclasses.replace(cfg, mtt=mtt, tt=mtt)
        sps = c.make_sps(frames[0][0].shape[1], frames[0][0].shape[0])
        pad = [scodec.pad_planes(f, sps) for f in frames[:3]]
        dpb = {i: recon.pad_refs_dev([torch.as_tensor(p, device=dev)
                                      for p in pad[i]]) for i in (0, 2)}
        t = {}
        for name, fn in (
                ("I", lambda: tdec.decide_frame(
                    pad[0][0], 32, device=dev,
                    **tenc._decide_tools(sps, hls.SLICE_I))),
                ("P", lambda: tdec.decide_frame_p(
                    pad[2][0], dpb[0][0], 32, device=dev, me_ext=True,
                    **tenc._decide_tools(sps, hls.SLICE_P))),
                ("B", lambda: tdec.decide_frame_b(
                    pad[1][0], dpb[0][0], dpb[2][0], 32, device=dev,
                    **tenc._decide_tools(sps, hls.SLICE_B)))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            t[name] = time.perf_counter() - t0
        out[mtt] = t
    print(f"{tag} decide wall of one 1080p frame (one run each, after the "
          "encode), without / with MTT and TT: " + ", ".join(
              f"{k} {out[False][k]:.3f} / {out[True][k]:.3f} s"
              for k in ("I", "P", "B")))
    h, w = pad[1][0].shape
    buf = tdec._pad_buf(pad[1][0], dev)
    orig = torch.as_tensor(np.ascontiguousarray(pad[1][0], np.int32),
                           device=dev)
    pl = [tme.quarter_phase_planes(dpb[i][0]) for i in (0, 2)]
    lam = lambda_satd_fp(32)
    parts = []
    for g, (bw, bh, sy, sx, oy, ox) in tdec._rect_keys(True).items():
        geo = dict(frame_w=w, frame_h=h, sy=sy, sx=sx, oy=oy, ox=ox)
        nby, nbx, *_ = tme.tiling(w, h, bw, bh, sy, sx, oy, ox)
        imv = torch.zeros((nby, nbx, 2), dtype=torch.int32, device=dev)
        ts = cuda_ms(lambda: tdec.rect_size_pass(buf, lam, bw=bw, bh=bh,
                                                 **geo), 3)
        tr = cuda_ms(lambda: tme.refine_pass(orig, dpb[0][0], imv, lam,
                                             s=bw, bh=bh, planes=pl[0],
                                             **geo), 3)
        mv = tme.refine_pass(orig, dpb[0][0], imv, lam, s=bw, bh=bh,
                             planes=pl[0], **geo)[1]
        tb = cuda_ms(lambda: tme.bi_cost_pass(orig, mv, mv, lam, s=bw, bh=bh,
                                              planes0=pl[0], planes1=pl[1],
                                              **geo), 3)
        name = g if isinstance(g, str) else f"{g[0]}x{g[1]}"
        parts.append(f"{name} {nby * nbx} blocks {ts:.1f} / {tr:.1f} / "
                     f"{tb:.1f}")
    print(f"{tag} rect passes of the B frame per geometry (CUDA events, 3 "
          "runs each), rect_size_pass / refine_pass per list / bi_cost_pass "
          "in ms: " + "; ".join(parts))


def phase_mtt(dev):
    """Phase 7: the multi-type tree (BT and TT splits) in I, P and B
    frames; returns the 1080p path's kernel launches (me_sad, dq_trellis),
    and the trellis's largest error against its twin at its shapes; keeps
    7b's run (_run_full's numbers) in _RUNS for phase 8."""
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.spec import hls
    from vvctpu_torch.spec import sequence as tseq
    counts = []
    data, decs, _ = _held_to_spec("64x96 AI with MTT and TT", dev,
                                  "mtt_intra")
    counts.append(_rect_counts(decs, 64, 96))
    print(f"[7a] 64x96 AI, 4 frames, MTT, TT, MIP, MRL, ISP: {len(data)} "
          "bytes and decisions equal to the spec model; card and spec "
          f"decoders verified hashes; {_counts_line(*counts[-1])}")
    kme.trace = []
    data, decs, _ = _held_to_spec("64x256 GOP4 with MTT and TT", dev,
                                  "mtt_ra_tools")
    keys, kme.trace = [k for k, _, _ in kme.trace], None
    # one me_sad per P frame and one per list for each B frame, 11 keys
    plan = tseq.gop_plan(5, 0, 4)
    want = [11] * sum(1 if e[1] == hls.SLICE_P else 2 for e in plan
                      if e[1] != hls.SLICE_I)
    if keys != want:
        raise AssertionError(f"[7a] me_sad launches (keys) {keys}, expected "
                             f"{want}")
    counts.append(_rect_counts(decs, 64, 256))
    print(f"[7a] 64x256 GOP4 QP27, 5 frames, config #4's toolset with MTT "
          f"and TT: {len(data)} bytes and decisions equal to the spec "
          "model; card and spec decoders verified hashes; me_sad launches "
          f"{len(keys)}, all at 11 keys; {_counts_line(*counts[-1])}")
    print(f"[7a] multi-type tree: card == CPU on {_mtt_worst_cases(dev)} "
          "worst-case batches (rect_size_pass, rect refine and BI cost at "
          "the 8 geometries; rect intra leaves and phase A of rect inter "
          "leaves with and without DQ)")

    n = 3
    decs = []
    cfg = tseq.EncoderConfig(qp=32, intra_period=32, gop=2, wpp=True,
                             sbt=True, dq=True, alf=True, **MTT, **RA_TOOLS)
    frames = synth_frames(n, 1080, 1920, seed=4)
    r = _run_full(dev, frames, cfg, decisions_out=decs)
    tag = "[7b]"
    # me_sad runs once for P2 and once per list for B1, at 11 keys
    if r["me_keys"] != [11] * 3:
        raise AssertionError(f"{tag} me_sad launches (keys) {r['me_keys']}, "
                             "expected three at 11 keys")
    if not r["dq_launches"]:
        raise AssertionError(f"{tag} dq_trellis was never launched")
    counts.append(_rect_counts(decs, 1088, 1920))
    print(f"{tag} 1080p RA GOP2 QP32 WPP, config #4's toolset with MTT and "
          f"TT, {n} frames (I0 P2 B1): {sum(r['bits']) / n:.1f} bits/frame "
          "(new data: the reference engine never ran it); me_sad launches "
          f"{r['launches']}, all at 11 keys; {_counts_line(*counts[-1])}; "
          "8x8 granules of P/B frames per tool: " + ", ".join(
              f"{k} {v}" for k, v in _tool_counts(decs).items()))
    _report(tag, r, n)
    print(f"{tag} phase-B batches of the encode per leaf class: " + ", ".join(
        f"{k} {v}" for k, v in sorted(r["batch_kinds"].items())))
    for k in ("enc", "dec"):
        lt = r[f"{k}_l"]
        print(f"{tag} {k}ode wall per temporal layer: " + ", ".join(
            f"{name} {lt[name]:.2f} s" for name in sorted(lt)))
    missing = [f"{w}x{h}" for (w, h) in counts[0][0]
               if not any(sum(c[(w, h)]) for c, _ in counts)]
    missing += [k for k in ("TT-H", "TT-V")
                if not any(tt[k] for _, tt in counts)]
    if missing:
        raise AssertionError(f"phase 7: never chose {missing}")
    dq_err = _dq_path_times(dev, r["dq_path"], tag)
    _mtt_decide_times(dev, frames, cfg)
    _RUNS["7b"] = r
    return r["launches"], r["dq_launches"], dq_err


# ---------------------------------------------------------------------------
# phase 8: LMCS, one model per frame, in I, P and B frames
# ---------------------------------------------------------------------------

# a codeword model whose CRS LUT takes both clamps: mapped luma below 128
# (source below 32) scales by 4x (8192), 128-175 by 1/4x (512)
LMCS_CW = (64, 64) + (4,) * 12 + (40, 40)


def _lmcs_leaf_out(kind, sy, sc, by, bc, fwd, crs, *refs, rows, s=0, w=0,
                   h=0, d=0, flags=None, bd=8, roff=None):
    """One leaf batch (kind "intra", "isp", "rect", "ciip", "phase_a" or
    "phase_a_rect") of one frame, encoding, on a carry whose source
    planes are sy and the (Cb, Cr) stack sc, recon buffers by and bc and
    LMCS LUTs fwd and crs (None: no LMCS), at bit depth ``bd``; ``roff``
    None or (rox, roy), the offset of a tile whose MC reads the full
    reference; returns the carry's planes."""
    from vvctpu_torch.pipeline import recon, wave
    dev = sy.device
    hh, ww = sy.shape

    def z(*shape):
        return torch.zeros(shape, dtype=torch.int32, device=dev)

    carry = dict(by=by[None].clone(), bc=bc.clone(), ly=z(1, hh, ww),
                 lc=z(2, hh // 2, ww // 2), sy=sy[None], sc=sc,
                 mtsp=z(1, hh // 8, ww // 8),
                 lfnstp=z(1, hh // 8, ww // 8), cmodep=z(1, hh // 8, ww // 8),
                 sbtp=z(1, hh // 8, ww // 8))
    if fwd is not None:
        carry.update(fwd=fwd[None], crs=crs[None])
    if roff is not None:
        carry["roff"] = torch.tensor([[0, *roff]], dtype=torch.int32,
                                     device=dev)
    for k in ("b", "l", "s"):
        carry[k + "cb"], carry[k + "cr"] = carry[k + "c"].split(1)
    geo = dict(frame_w=ww, frame_h=hh, log2_ctu=6, bd=bd, encode=True,
               rdoq=True)
    rt = torch.as_tensor(rows, device=dev)
    refs = [r[None] for r in refs]
    if kind == "intra":
        wave._intra_batch(carry, rt, rows, 32, 347, s=s, mts=True,
                          lfnst=True, cclm=True, mip=True, **flags, **geo)
    elif kind == "isp":
        wave._isp_batch(carry, rt, rows, 32, 347, s=s, d=d, cclm=True,
                        **flags, **geo)
    elif kind == "rect":
        wave._rect_batch(carry, rt, 32, 347, w=w, h=h, **flags, **geo)
    elif kind == "ciip":
        wave._ciip_batch(carry, rt, refs, 32, 347, s=s, **flags, **geo)
    elif kind == "phase_a":
        recon._inter_batch_pass(carry, rows, refs, s, 32, bd, True,
                                rdoq=True, lam_rd=347, **flags)
    else:
        recon._inter_batch_pass_rect(carry, rows, refs, w, h, 32, bd, True,
                                     rdoq=True, lam_rd=347, **flags)
    return tuple(carry[k] for k in ("by", "ly", "bc", "lc", "mtsp", "lfnstp",
                                    "cmodep", "sbtp"))


def _lmcs_worst_cases(dev):
    """LMCS on the card against the CPU path on worst-case inputs: a CRS
    LUT at both clamps (512, 8192) over a source with dark and mid-grey
    halves (so leaves take either clamp) and noise (residuals of both
    signs), in every leaf class, in phase A (square with every inter
    tool, SBT and DQ; rect), the scaled component and chroma choice at
    saturated residuals, and the inverse mapping before the loop filters;
    returns the number of cases."""
    from vvctpu_torch.kernels import intra_pred as kip
    from vvctpu_torch.kernels import loopfilter as klf
    from vvctpu_torch.pipeline import plan as tplan
    from vvctpu_torch.pipeline import recon
    from vvctpu_torch.spec import codec as scodec
    from vvctpu_torch.spec import lmcs as slmcs
    rng = np.random.default_rng(8)
    h, w = 64, 128
    m = kip.MARGIN
    fwd, inv = slmcs.build_luts(LMCS_CW)
    crs = slmcs.build_crs_lut(LMCS_CW)
    if set(crs) != {512, 5120, 8192}:
        raise AssertionError(f"CRS LUT scales {set(crs)}")
    src = np.where(np.arange(w)[None] < w // 2,
                   rng.integers(0, 31, (h, w)),
                   rng.integers(40, 221, (h, w))).astype(np.int32)
    msrc = fwd[src]
    sc = np.stack([src[::2, ::2], src[1::2, 1::2]])
    by = np.zeros((h + 1 + m, w + 1 + m), np.int32)
    by[1:h + 1, 1:w + 1] = msrc
    by[1:h + 1, 1:w + 1] ^= rng.integers(0, 4, (h, w)).astype(np.int32)
    bc = np.zeros((2, h // 2 + 1 + m, w // 2 + 1 + m), np.int32)
    bc[:, 1:h // 2 + 1, 1:w // 2 + 1] = sc
    sat = rng.choice([0, 255], (h, w)).astype(np.int32)
    refs = [np.pad(src, 80, mode="edge"), np.pad(sc[0], 40, mode="edge"),
            np.pad(sat[::2, ::2], 40, mode="edge"),
            np.pad(sat, 80, mode="edge"), np.pad(sc[1], 40, mode="edge"),
            np.pad(src[1::2, 1::2], 40, mode="edge")]
    planes = (msrc, sc, by, bc, fwd, crs)
    n = 0

    def grid(sw, sh, op):
        ys, xs = np.mgrid[0:h:sh, 0:w:sw]
        rows = np.zeros((xs.size, 17), np.int32)
        rows[:, 0], rows[:, 1], rows[:, 2] = op, xs.ravel(), ys.ravel()
        return rows

    for s in (8, 16, 32):
        rows = grid(s, s, s.bit_length() - 3)
        rows[:, 3] = np.arange(rows.shape[0]) * 7 % (67 + 16)
        for dq in (False, True):
            n += _card_eq(f"lmcs intra {s} dq={dq}", dev,
                          lambda *a, rows=rows, s=s, dq=dq: _lmcs_leaf_out(
                              "intra", *a, rows=rows, s=s,
                              flags=dict(dq=dq)), *planes)
        for d in (1, 2):
            r = rows.copy()
            r[:, 3] %= 67
            r[:, 15] = d
            n += _card_eq(f"lmcs isp {s} d={d}", dev,
                          lambda *a, rows=r, s=s, d=d: _lmcs_leaf_out(
                              "isp", *a, rows=rows, s=s, d=d,
                              flags=dict(dq=True)), *planes)
        r = grid(s, s, 7 + s.bit_length() - 4)
        k = r.shape[0]
        r[:, 4:6] = (rng.integers(-270, 271, (k, 2)) * 4).astype(np.int32)
        r[:, 11:13] = (rng.integers(-270, 271, (k, 2)) * 4).astype(np.int32)
        r[:, 13] = np.arange(k) % 3
        r[:, 14] = np.arange(k) % 3
        n += _card_eq(f"lmcs ciip {s}", dev,
                      lambda *a, rows=r, s=s: _lmcs_leaf_out(
                          "ciip", *a, rows=rows, s=s, flags=dict(dq=True)),
                      *planes, *refs)
        nb = (h // s) * (w // s)
        pa = np.zeros((nb, 14), np.int32)
        pa[:, 0] = np.arange(nb) % (w // s) * s
        pa[:, 1] = np.arange(nb) // (w // s) * s
        pa[:, 2:6] = (rng.integers(-64, 65, (nb, 4)) * 4).astype(np.int32)
        pa[:, 6] = np.arange(nb) % 3
        pa[:, 7] = rng.integers(0, 3, nb)
        pa[:, 9] = np.where(pa[:, 6] == 2, rng.integers(0, 65, nb), 0)
        pa[:, 10] = (pa[:, 6] < 2) & (s >= 16)
        pa[:, 11:13] = rng.choice([-8, 4, 8, -36], (nb, 2))
        n += _card_eq(f"lmcs phase A {s}", dev,
                      lambda *a, rows=pa, s=s: _lmcs_leaf_out(
                          "phase_a", *a, rows=rows, s=s, flags=dict(
                              dmvr=True, bdof=True, gpm=True, affine=True,
                              sbt=True, dq=True)), *planes, *refs)
    for i, (rw, rh) in enumerate(tplan.RECT_SHAPES):
        r = grid(rw, rh, tplan.OP_RECT_INTRA0 + i)
        r[:, 3] = np.arange(r.shape[0]) % 67
        n += _card_eq(f"lmcs rect {rw}x{rh}", dev,
                      lambda *a, rows=r, rw=rw, rh=rh: _lmcs_leaf_out(
                          "rect", *a, rows=rows, w=rw, h=rh,
                          flags=dict(dq=True)), *planes)
        k = r.shape[0]
        ir = np.zeros((k, 8), np.int32)
        ir[:, :2] = r[:, 1:3]
        ir[:, 2:6] = (rng.integers(-270, 271, (k, 4)) * 4).astype(np.int32)
        ir[:, 6] = np.arange(k) % 3
        n += _card_eq(f"lmcs phase A rect {rw}x{rh}", dev,
                      lambda *a, rows=ir, rw=rw, rh=rh: _lmcs_leaf_out(
                          "phase_a_rect", *a, rows=rows, w=rw, h=rh,
                          flags=dict(dq=True)), *planes, *refs)
    # the scaled component and chroma choice at saturated residuals
    for cs in (4, 8, 16):
        k = 16
        scale = np.array([512, 8192] * (k // 2), np.int32)
        blk = rng.choice([0, 255], (2, k, cs, cs)).astype(np.int32)
        pred = (255 - blk).astype(np.int32)
        f = np.arange(k, dtype=np.int32)
        zero = np.zeros(k, np.int32)
        n += _card_eq(f"lmcs component {cs}", dev,
                      lambda *a, cs=cs: recon._component(
                          a[0], a[1], a[2], a[3], a[3], cs, cs, 32, 8, True,
                          True, 347, True, crs_sc=a[4]),
                      blk[0], pred[0], f, zero, scale)
        n += _card_eq(f"lmcs chroma_rd {cs}", dev,
                      lambda *a, cs=cs: recon.chroma_rd(
                          a[0], a[1], [(a[2], a[3]), (a[3], a[2])], cs, 32,
                          8, True, 347, True, crs_sc=a[4]),
                      blk[0], blk[1], pred[0], pred[1], scale)
    # the inverse mapping before deblocking and SAO
    dec = scodec.FrameDecisions.empty(h, w)
    n += _card_eq("lmcs finish_frame_j", dev,
                  lambda *a: klf.finish_frame_j(list(a[:3]), dec, 32, 347,
                                                list(a[3:]), inv_lut=inv),
                  msrc, sc[0], sc[1], src, sc[0], sc[1])
    return n


def phase_lmcs(dev):
    """Phase 8: LMCS in I, P and B frames, one model per frame; where
    phase 7 ran before it in this process, 8b's walls are printed against
    7b's.  Returns the 1080p path's kernel launches (me_sad,
    dq_trellis)."""
    from vvctpu_torch.spec import sequence as tseq
    for name, what in (("lmcs_ai", "64x96 AI, 2 frames"),
                       ("lmcs_gop2", "64x96 GOP2, 4 frames"),
                       ("lmcs_tt", "64x96 GOP4, 4 frames, MTT, TT and the "
                                   "inter toolset")):
        data, _, _ = _held_to_spec(f"[8a] {what}", dev, name)
        print(f"[8a] {what} with LMCS: {len(data)} bytes and decisions "
              "equal to the spec model; card and spec decoders verified "
              "hashes")
    print(f"[8a] LMCS: card == CPU on {_lmcs_worst_cases(dev)} worst-case "
          "batches (CRS scales 512 and 8192: intra with MTS/LFNST/MIP/CCLM, "
          "ISP, CIIP, rect leaves, phase A square with every inter tool, "
          "SBT and DQ and rect, the scaled component and chroma choice, "
          "the inverse mapping before the loop filters)")
    n = 3
    cfg = tseq.EncoderConfig(qp=32, intra_period=32, gop=2, wpp=True,
                             sbt=True, dq=True, alf=True, lmcs=True, **MTT,
                             **RA_TOOLS)
    r = _run_full(dev, synth_frames(n, 1080, 1920, seed=4), cfg)
    tag = "[8b]"
    # me_sad runs once for P2 and once per list for B1, at 11 keys
    if r["me_keys"] != [11] * 3:
        raise AssertionError(f"{tag} me_sad launches (keys) {r['me_keys']}, "
                             "expected three at 11 keys")
    if not r["dq_launches"]:
        raise AssertionError(f"{tag} dq_trellis was never launched")
    print(f"{tag} 1080p RA GOP2 QP32 WPP, 7b's toolset with LMCS, "
          f"{n} frames (I0 P2 B1): "
          f"{sum(r['bits']) / n:.1f} bits/frame (new data: the reference "
          f"engine never ran it); me_sad launches {r['launches']}, all at "
          "11 keys")
    _report(tag, r, n)
    print(f"{tag} phase-B batches of the encode per leaf class: " + ", ".join(
        f"{k} {v}" for k, v in sorted(r["batch_kinds"].items())))
    for k in ("enc", "dec"):
        lt = r[f"{k}_l"]
        print(f"{tag} {k}ode wall per temporal layer: " + ", ".join(
            f"{name} {lt[name]:.2f} s" for name in sorted(lt)))
    ref = _RUNS.get("7b")
    if ref is not None:
        parts = []
        for k, what in (("enc", "encode"), ("dec", "decode")):
            a, b = r[f"t_{k}"], ref[f"t_{k}"]
            wa = r[f"{k}_t"]["wave"] / r["batches"] * 1e3
            wb = ref[f"{k}_t"]["wave"] / ref["batches"] * 1e3
            parts.append(f"{what} {a:.2f} s against {b:.2f} s "
                         f"({100 * (a / b - 1):+.1f} %), wave per batch "
                         f"{wa:.1f} against {wb:.1f} ms, card busy "
                         f"{r['busy_' + k].share:.1f} against "
                         f"{ref['busy_' + k].share:.1f} %")
        print(f"{tag} LMCS against 7b (same frames, toolset and process, "
              f"one after the other): {'; '.join(parts)}; bits/frame "
              f"{sum(r['bits']) / n:.1f} against {sum(ref['bits']) / n:.1f}, "
              f"phase-B batches {r['batches']} against {ref['batches']}")
    return r["launches"], r["dq_launches"]


# ---------------------------------------------------------------------------
# phase 9: 10-bit input, tiles and subpictures
# ---------------------------------------------------------------------------


def ai10_frames():
    """test_codec_roundtrip.py:146's 10-bit 64x96 frame."""
    rng = np.random.default_rng(60)
    h, w = 64, 96
    yy, xx = np.mgrid[0:h, 0:w]
    y10 = (400 + 240 * np.sin(xx / 9.0) + 160 * np.cos(yy / 7.0)
           + rng.integers(-30, 30, (h, w))).clip(0, 1023).astype(np.int32)
    cb = (512 + 80 * np.sin(xx[::2, ::2] / 5.0)).clip(0, 1023).astype(
        np.int32)
    cr = (512 - 60 * np.cos(yy[::2, ::2] / 6.0)).clip(0, 1023).astype(
        np.int32)
    return [[y10, cb, cr]]


def ra10_clip():
    """Phase 6a's 64x256 GOP4 clip in 10 bits (``to10``) with every tool
    of the slice: (frames, EncoderConfig keywords)."""
    return to10(tool_frames(), seed=9), dict(
        qp=27, intra_period=0, gop=4, bit_depth=10, isp=True, mrl=True,
        sbt=True, dq=True, alf=True, lmcs=True, **MTT, **RA_TOOLS)


# SHA-256 and length of the reference engine's stream of ra10_clip, which
# the spec model's does not equal (at 10 bits the spec model's sub-pel
# refinement clamps at 8 bits), computed on the CPU (23 min there) from
# the repo root with
#   JAX_PLATFORMS=cpu python -c "import hashlib, chip_smoke as c;
#   from vvctpu.pipeline import encoder as e; from vvctpu.spec import
#   sequence as s; f, kw = c.ra10_clip(); d = e.encode_sequence(f,
#   s.EncoderConfig(**kw))[0]; print(len(d), hashlib.sha256(d).hexdigest())"
RA10_BYTES = 29099
RA10_SHA256 = ("2000d401a7c5f80a0d7e24f70a8a0883"
               "cb4bdd712ed14b0ddabf842a9c46fce4")

LMCS_CW10 = tuple(4 * c for c in LMCS_CW)


def _bitdepth_worst_cases(dev):
    """10-bit inputs on the card against the CPU path: the transforms at
    +-1023 residuals, the transform choice with RDOQ and DQ, the motion
    search's quarter-pel planes, refinement and BI costs at samples 0 and
    1023, every leaf class and phase A (every inter tool, SBT and DQ, with
    and without LMCS, at a tile's reference offset), deblocking, SAO and
    ALF; returns the number of cases."""
    from vvctpu_torch.coding import me as tme
    from vvctpu_torch.core import rom
    from vvctpu_torch.kernels import intra_pred as kip
    from vvctpu_torch.kernels import loopfilter as klf
    from vvctpu_torch.kernels import transform as ktf
    from vvctpu_torch.pipeline import plan as tplan
    from vvctpu_torch.spec import alf as salf
    from vvctpu_torch.spec import codec as scodec
    from vvctpu_torch.spec import lmcs as slmcs
    bd, mx = 10, 1023
    rng = np.random.default_rng(12)
    n = 0
    for sz in rom.TR_SIZES:
        kinds = [rom.DCT2] + ([rom.DST7, rom.DCT8] if sz in rom.MTS_SIZES
                              else [])
        resi = rng.choice([-mx, mx], (64, sz, sz)).astype(np.int32)
        resi[0], resi[1] = mx, -mx
        coef = rng.choice([-32768, 32767], (64, sz, sz)).astype(np.int32)
        for kh in kinds:
            for kv in kinds:
                n += _card_eq(f"fwd {sz} {kh},{kv}", dev,
                              ktf.forward_transform, resi, sz, sz, kh, kv,
                              bd)
                n += _card_eq(f"inv {sz} {kh},{kv}", dev,
                              ktf.inverse_transform, coef, sz, sz, kh, kv,
                              bd)
    for s in (8, 16, 32):
        r = rng.integers(-mx, mx + 1, (24, s, s)).astype(np.int32)
        r[0], r[1], r[2], r[3] = 0, mx, -mx, 1
        md = rng.integers(0, 67, 24).astype(np.int32)
        for dq in (False, True):
            n += _card_eq(f"choose_tx {s} dq={dq}", dev, ktf.choose_tx, r,
                          s, 32, 347, md, bd, mts=True, lfnst=True,
                          rdoq=True, dq=dq)
    # motion search at the sample clamps
    h, w = 64, 128
    sat = rng.choice([0, mx], (h, w)).astype(np.int32)
    noisy = rng.integers(0, mx + 1, (h, w)).astype(np.int32)
    r0, r1 = np.pad(sat, 80, mode="edge"), np.pad(noisy, 80, mode="edge")
    n += _card_eq("quarter_phase_planes", dev, tme.quarter_phase_planes, r0,
                  bd)
    for s in (8, 16, 32):
        g = (h // s, w // s, 2)
        imv = rng.integers(-20, 21, g).astype(np.int32)
        m0 = (rng.integers(-80, 81, g) * 4).astype(np.int32)
        m1 = (rng.integers(-80, 81, g) * 4).astype(np.int32)
        n += _card_eq(f"refine_pass {s}", dev,
                      lambda o, rp, mv, s=s: tme.refine_pass(
                          o, rp, mv, 211, s=s, frame_w=w, frame_h=h, bd=bd),
                      noisy, r0, imv)
        n += _card_eq(f"bi_cost_pass {s}", dev,
                      lambda o, a, b, p0, p1, s=s: tme.bi_cost_pass(
                          o, a, b, 211, s=s, frame_w=w, frame_h=h, bd=bd,
                          planes0=tme.quarter_phase_planes(p0, bd),
                          planes1=tme.quarter_phase_planes(p1, bd),
                          bcw=True, bcw_fp=(300, 100, 300)),
                      sat, m0, m1, r0, r1)
    # every leaf class and phase A on saturated 10-bit planes
    m = kip.MARGIN
    src = rng.choice([0, mx], (h, w)).astype(np.int32)
    src[:, : w // 2] = rng.integers(0, mx + 1, (h, w // 2))
    sc = np.stack([src[::2, ::2], src[1::2, 1::2]]).copy()
    by = np.zeros((h + 1 + m, w + 1 + m), np.int32)
    by[1:h + 1, 1:w + 1] = mx - src
    bc = np.zeros((2, h // 2 + 1 + m, w // 2 + 1 + m), np.int32)
    bc[:, 1:h // 2 + 1, 1:w // 2 + 1] = mx - sc
    # a 2x-wide reference picture: the tile at (64, 0) reads its right half
    big = np.concatenate([noisy, sat], 1)
    refs = [np.pad(big, 80, mode="edge"),
            np.pad(big[::2, ::2], 40, mode="edge"),
            np.pad(big[1::2, 1::2], 40, mode="edge"),
            np.pad(big[:, ::-1].copy(), 80, mode="edge"),
            np.pad(big[::2, ::-2].copy(), 40, mode="edge"),
            np.pad(big[1::2, ::-2].copy(), 40, mode="edge")]
    fwd, _ = slmcs.build_luts(LMCS_CW10, bd)
    crs = slmcs.build_crs_lut(LMCS_CW10, bd)
    kw = dict(bd=bd)

    def grid(sw, sh, op):
        ys, xs = np.mgrid[0:h:sh, 0:w:sw]
        rows = np.zeros((xs.size, 17), np.int32)
        rows[:, 0], rows[:, 1], rows[:, 2] = op, xs.ravel(), ys.ravel()
        return rows

    for lm in (None, (fwd, crs)):
        tag = "lmcs " if lm else ""
        planes = ((fwd[src] if lm else src), sc, by, bc) \
            + (lm if lm else (None, None))
        for s in (8, 16, 32):
            rows = grid(s, s, s.bit_length() - 3)
            rows[:, 3] = np.arange(rows.shape[0]) * 7 % (67 + 16)
            rows[:, 9] = np.arange(rows.shape[0]) % 3 * (s == 8)
            n += _card_eq(f"{tag}intra {s}", dev,
                          lambda *a, rows=rows, s=s: _lmcs_leaf_out(
                              "intra", *a, rows=rows, s=s,
                              flags=dict(dq=True), **kw), *planes)
            r = rows.copy()
            r[:, 3] %= 67
            r[:, 9] = 0
            r[:, 15] = 1 + (s == 16)
            n += _card_eq(f"{tag}isp {s}", dev,
                          lambda *a, rows=r, s=s: _lmcs_leaf_out(
                              "isp", *a, rows=rows, s=s, d=int(rows[0, 15]),
                              flags=dict(dq=False), **kw), *planes)
            r = grid(s, s, 7 + s.bit_length() - 4)
            k = r.shape[0]
            r[:, 4:6] = (rng.integers(-270, 271, (k, 2)) * 4).astype(np.int32)
            r[:, 11:13] = (rng.integers(-270, 271, (k, 2)) * 4).astype(
                np.int32)
            r[:, 13] = np.arange(k) % 3
            r[:, 14] = np.arange(k) % 3
            n += _card_eq(f"{tag}ciip {s} tile offset", dev,
                          lambda *a, rows=r, s=s: _lmcs_leaf_out(
                              "ciip", *a, rows=rows, s=s, roff=(64, 0),
                              flags=dict(dq=True), **kw), *planes, *refs)
            nb = (h // s) * (w // s)
            pa = np.zeros((nb, 14), np.int32)
            pa[:, 0] = np.arange(nb) % (w // s) * s
            pa[:, 1] = np.arange(nb) // (w // s) * s
            pa[:, 2:6] = (rng.integers(-64, 65, (nb, 4)) * 4).astype(np.int32)
            pa[:, 6] = np.arange(nb) % 3
            pa[:, 7] = rng.integers(0, 3, nb)
            pa[:, 9] = np.where(pa[:, 6] == 2, rng.integers(0, 65, nb), 0)
            pa[:, 10] = (pa[:, 6] < 2) & (s >= 16)
            pa[:, 11:13] = rng.choice([-8, 4, 8, -36], (nb, 2))
            for flags in (dict(dmvr=True, bdof=True, gpm=True, affine=True,
                               sbt=True, dq=True), dict(sbt=True)):
                n += _card_eq(f"{tag}phase A {s} tile offset {sorted(flags)}",
                              dev, lambda *a, rows=pa, s=s, fl=flags:
                              _lmcs_leaf_out("phase_a", *a, rows=rows, s=s,
                                             roff=(64, 0), flags=fl, **kw),
                              *planes, *refs)
        for i, (rw, rh) in enumerate(tplan.RECT_SHAPES):
            r = grid(rw, rh, tplan.OP_RECT_INTRA0 + i)
            r[:, 3] = np.arange(r.shape[0]) % 67
            n += _card_eq(f"{tag}rect {rw}x{rh}", dev,
                          lambda *a, rows=r, rw=rw, rh=rh: _lmcs_leaf_out(
                              "rect", *a, rows=rows, w=rw, h=rh,
                              flags=dict(dq=True), **kw), *planes)
            k = r.shape[0]
            ir = np.zeros((k, 8), np.int32)
            ir[:, :2] = r[:, 1:3]
            ir[:, 2:6] = (rng.integers(-270, 271, (k, 4)) * 4).astype(
                np.int32)
            ir[:, 6] = np.arange(k) % 3
            n += _card_eq(f"{tag}phase A rect {rw}x{rh} tile offset", dev,
                          lambda *a, rows=ir, rw=rw, rh=rh: _lmcs_leaf_out(
                              "phase_a_rect", *a, rows=rows, w=rw, h=rh,
                              roff=(64, 0), flags=dict(dq=True), **kw),
                          *planes, *refs)
    # deblocking (8x8 intra leaves: every edge filtered), SAO, ALF
    dec = scodec.FrameDecisions.empty(h, w)
    dec.split32[:] = 1
    dec.split16[:] = 1
    dec.modes8[:] = rng.integers(0, 67, dec.modes8.shape)
    orig = [noisy, noisy[::2, ::2].copy(), noisy[1::2, 1::2].copy()]
    rec = [np.clip(p + rng.integers(-90, 91, p.shape), 0, mx).astype(
        np.int32) for p in orig]
    for qp in (22, 37, 51):
        n += _card_eq(f"finish_frame_j qp={qp}", dev,
                      lambda *a, qp=qp: klf.finish_frame_j(
                          list(a[:3]), dec, qp, 347, list(a[3:]), bd=bd),
                      *rec, *orig)
    alf = salf.derive_alf_frame(orig, rec, 27, 64, bd)
    n += _card_eq("apply_alf_frame", dev,
                  lambda *a: tuple(klf.apply_alf_frame(list(a), alf, 64, bd)),
                  *rec)
    return n


def _subpic_spec(frames, kw, decs):
    """The spec model's encode of a subpicture configuration with each
    subpicture's decisions (subpicture after subpicture) in ``decs``."""
    from vvctpu_torch.dist.subpic import encode_subpics
    from vvctpu_torch.spec import sequence as tseq
    return encode_subpics(frames, tseq.EncoderConfig(**kw),
                          lambda fr, c: tseq.encode_sequence(
                              fr, c, decisions_out=decs), threads=False)


def phase_bitdepth_tiles(dev):
    """Phase 9: 10-bit input, tiles and subpictures; returns the kernels'
    launches on the 4K path (me_sad, dq_trellis)."""
    import hashlib

    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    for name, what in (
            ("ai10", "64x96 AI, 10-bit, 1 frame (test_codec_roundtrip.py)"),
            ("tiles21", "64x128 AI, 2x1 tiles, 3 frames (test_tiles.py)"),
            ("tiles22", "64x128 GOP2, 2x2 tiles, MMVD, CIIP, SBT, LMCS, "
                        "3 frames (test_tiles.py)"),
            ("tiles_unequal", "192x192 GOP2, 10-bit, 2x2 tiles of 1 and 2 "
                              "CTUs (four tile sizes), 3 frames"),
            ("subpic21", "64x128 IPPP, 2x1 subpictures, 3 frames "
                         "(test_subpic.py)"),
            ("subpic22", "100x150 AI, 2x2 subpictures, 2 frames "
                         "(test_subpic.py)")):
        data, _, _ = _held_to_spec(f"[9a] {what}", dev, name)
        print(f"[9a] {what}: {len(data)} bytes and decisions equal to the "
              "spec model; card and spec decoders verified hashes")
    frames, kw = ra10_clip()
    decs = []
    before = kdq.launches
    data, recons, _ = tenc.encode_sequence(
        frames, tseq.EncoderConfig(**kw), device=dev, decisions_out=decs)
    dq_small = kdq.launches - before
    digest = hashlib.sha256(data).hexdigest()
    if (len(data), digest) != (RA10_BYTES, RA10_SHA256):
        raise AssertionError(f"[9a] 10-bit 64x256 GOP4: {len(data)} bytes, "
                             f"SHA-256 {digest}; the reference engine's "
                             f"are {RA10_BYTES}, {RA10_SHA256}")
    out, _ = tenc.decode_sequence(data, check_hash=True, device=dev)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    if not _same_planes(recons, out, sout):
        raise AssertionError("[9a] 10-bit 64x256 GOP4: recon/decoder "
                             "mismatch")
    cnt = _tool_counts(decs)
    if not dq_small or not all(cnt[t] for t in ("GPM", "affine", "BI")):
        raise AssertionError(f"[9a] 10-bit 64x256 GOP4 tools: {cnt}, dq "
                             f"{dq_small}")
    print(f"[9a] 64x256 GOP4 QP27, 10-bit, 5 frames, every tool of the "
          f"slice with LMCS, MTT and TT: {len(data)} bytes, SHA-256 equal "
          "to the reference engine's stream; card and spec decoders "
          "verified hashes; 8x8 granules of P/B frames per tool: "
          + ", ".join(f"{k} {v}" for k, v in cnt.items())
          + f"; dq_trellis launches {dq_small}")
    print(f"[9a] 10 bits: card == CPU on {_bitdepth_worst_cases(dev)} "
          "worst-case batches (transforms at +-1023, choose_tx with RDOQ "
          "and DQ, quarter-pel planes, refine and BI costs at samples 0 "
          "and 1023, every leaf class and phase A with and without LMCS at "
          "a tile's offset, deblocking, SAO, ALF)")
    # 9b: bench config #5 on one card
    n = 3
    r = _run_full(dev, synth_frames10(n, 2160, 3840, seed=5), c5_config())
    # phase 12b, next in this process, holds its four-rank stream to this
    _RUNS["9b"] = _c5_summary(r)
    tag = "[9b]"
    if r["me_shapes"] != [(2176, 3840)] * 3:
        raise AssertionError(f"{tag} me_sad launches at {r['me_shapes']}, "
                             "expected three at 2176x3840")
    print(f"{tag} bench config #5 on one card: 4K (3840x2160) 10-bit RA "
          f"GOP2 QP32, 2x2 tiles of 1920x1088, {n} frames (I0 P2 B1; depth "
          f"cut from a GOP for the script's limit): "
          f"{sum(r['bits']) / n:.1f} bits/frame (new data: the reference "
          f"engine never ran it); me_sad launches {r['launches']}, all at "
          "2176x3840")
    _report(tag, r, n)
    print(f"{tag} phase-B batches of the encode per leaf class: " + ", ".join(
        f"{k} {v}" for k, v in sorted(r["batch_kinds"].items())))
    for k in ("enc", "dec"):
        lt = r[f"{k}_l"]
        print(f"{tag} {k}ode wall per temporal layer: " + ", ".join(
            f"{name} {lt[name]:.2f} s" for name in sorted(lt)))
    return r["launches"], r["dq_launches"]


# ---------------------------------------------------------------------------
# phase 10: transform skip, joint Cb-Cr residuals, MCTF and rate control
# ---------------------------------------------------------------------------

CTC_TOOLS = dict(tskip=True, jccr=True, mctf=True)
# 10c's frame size: config #5's source
MCTF_4K = (2160, 3840)
# 6a's toolset with the multi-type tree, LMCS and the three tools above
CTC_SMALL = dict(isp=True, mrl=True, sbt=True, dq=True, alf=True,
                 lmcs=True, **CTC_TOOLS, **MTT, **RA_TOOLS)


def screen_planes(h, w, seed=0):
    """test_tskip.py's sharp synthetic screen content: text-like
    rectangles on a black ground, flat chroma."""
    rng = np.random.default_rng(seed)
    y = np.zeros((h, w), np.int32)
    for _ in range(30):
        x0, y0 = rng.integers(0, w - 8), rng.integers(0, h - 8)
        y[y0:y0 + rng.integers(2, 8), x0:x0 + rng.integers(2, 8)] = \
            rng.integers(0, 256)
    cb = np.full((h // 2, w // 2), 110, np.int32)
    cr = np.full((h // 2, w // 2), 140, np.int32)
    return [y, cb, cr]


def corr_chroma_planes(h, w, seed=0):
    """test_jccr.py's content with anti-correlated chroma residuals."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = (xx * 2 + yy + rng.integers(0, 10, (h, w))).astype(np.int32) % 256
    base = rng.integers(-40, 41, (h // 2, w // 2)).astype(np.int32)
    cb = np.clip(128 + base, 0, 255)
    cr = np.clip(128 - base, 0, 255)
    return [y, cb, cr]


def _ctc_small(dev):
    """10a: the tools' small clips against the spec model, and the MCTF
    prefilter at config #1's size against the copied spec function."""
    from vvctpu_torch.coding import mctf as tmctf
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.pipeline import encoder as tenc
    for name, what in (
            ("ts_tools", "64x128 AI, TS with MTS, LFNST, MIP "
                         "(test_tskip.py)"),
            ("ts_alone", "64x128 AI, TS alone, QP24 (test_tskip.py)"),
            ("jccr", "64x128 AI, JCCR with MTS, MIP (test_jccr.py)"),
            ("jccr_cclm", "64x128 AI, JCCR with CCLM, MTS, MIP "
                          "(test_jccr.py)"),
            ("rc", "64x64 IPPP, rate control at 1200 bits/frame, 4 frames "
                   "(test_apps.py)"),
            ("mctf", "64x64 GOP2, MCTF, 4 frames (test_apps.py)"),
            ("ctc", "64x64 GOP2, 3 frames, TS, JCCR, MCTF and rate control "
                    "with 6a's toolset, MTT, TT and LMCS"),
            ("ctc_6a", "6a's 64x256 GOP4 clip, 5 frames, TS, JCCR, MCTF "
                       "and rate control with its toolset, MTT, TT and "
                       "LMCS")):
        data, decs, _ = _held_to_spec(f"[10a] {what}", dev, name)
        ts = sum(int((d.mts8 == 5).sum()) for d in decs)
        jc = sum(int(d.jccr8.sum()) for d in decs)
        kw = _spec_clips()[name][1]
        if (kw.get("tskip") and not ts) or (kw.get("jccr") and not jc):
            raise AssertionError(f"[10a] {what}: TS granules {ts}, JCCR "
                                 f"granules {jc}")
        qps = tenc.slice_qps(data)
        print(f"[10a] {what}: {len(data)} bytes and decisions equal to the "
              f"spec model; card and spec decoders verified hashes; 8x8 "
              f"granules with TS {ts}, JCCR {jc}; QP per POC "
              f"{[qps[p] for p in sorted(qps)]}")
    frames, kw = _spec_clips()["mctf416"]
    before = kme.launches
    got = tmctf.temporal_filter(frames, kw["filter_gop"], device=dev)
    n_me = kme.launches - before
    want = _spec("mctf416")[0]
    if not _same_planes(got, want):
        raise AssertionError("[10a] MCTF 416x240: card != spec model")
    if _same_planes(got, frames) or n_me != 4:
        raise AssertionError(f"[10a] MCTF 416x240 filtered nothing or ran "
                             f"me_sad {n_me} times (4 expected)")
    print(f"[10a] MCTF prefilter, 5 frames of 416x240 (config #1's size), "
          f"GOP4: every plane equal to the spec model's temporal_filter; "
          f"{n_me} me_sad launches (lam 0, 7 keys at 256x448)")


def _ctc_full(dev):
    """10b: 8b's configuration with TS, JCCR, MCTF and rate control at
    1080p; returns its kernel launches (me_sad, dq_trellis) and POC 0's
    (bits, Y-PSNR)."""
    from vvctpu_torch.coding import mctf as tmctf
    from vvctpu_torch.spec import sequence as tseq
    n = 3
    cfg = tseq.EncoderConfig(qp=32, intra_period=32, gop=2, wpp=True,
                             sbt=True, dq=True, alf=True, lmcs=True,
                             rc_bits_per_frame=600000, **CTC_TOOLS, **MTT,
                             **RA_TOOLS)
    frames = synth_frames(n, 1080, 1920, seed=4)
    tag = "[10b]"
    # 1080 rows are not a multiple of 16: the prefilter passes them
    if not _same_planes(tmctf.temporal_filter(frames, 2, device=dev),
                        frames):
        raise AssertionError(f"{tag} MCTF changed 1080-row frames")
    decs = []
    r = _run_full(dev, frames, cfg, decisions_out=decs)
    if r["me_keys"] != [11] * 3:
        raise AssertionError(f"{tag} me_sad launches (keys) {r['me_keys']}, "
                             "expected three at 11 keys")
    if not r["dq_launches"]:
        raise AssertionError(f"{tag} dq_trellis was never launched")
    qps = [r["qps"][p] for p in range(n)]
    if qps[0] != 32 or len(set(qps)) < 2:
        raise AssertionError(f"{tag} rate control left the QPs at {qps}")
    ts = [int((d.mts8 == 5).sum()) for d in decs]
    jc = [int(d.jccr8.sum()) for d in decs]
    print(f"{tag} 1080p RA GOP2 QP32 WPP, 8b's toolset with TS, JCCR, MCTF "
          f"and rate control at 600000 bits/frame, {n} frames (I0 P2 B1): "
          f"MCTF left the 1080-row frames unchanged, as the reference does "
          f"(1080 % 16 = 8); {sum(r['bits']) / n:.1f} bits/frame (new data: "
          f"the reference engine never ran it); QP per POC {qps}; 8x8 "
          f"granules with TS {ts}, JCCR {jc} (coding order I0 P2 B1); "
          f"me_sad launches {r['launches']}, all at 11 keys")
    _report(tag, r, n)
    print(f"{tag} phase-B batches of the encode per leaf class: " + ", ".join(
        f"{k} {v}" for k, v in sorted(r["batch_kinds"].items())))
    for k in ("enc", "dec"):
        lt = r[f"{k}_l"]
        print(f"{tag} {k}ode wall per temporal layer: " + ", ".join(
            f"{name} {lt[name]:.2f} s" for name in sorted(lt)))
    return r["launches"], r["dq_launches"], (r["bits"][0], r["psnr"][0])


def _mctf_4k(dev):
    """10c: the MCTF prefilter on 3 frames of config #5's 4K 10-bit source
    (GOP2), timed on the card; its motion search's me_sad held against the
    twin at lam 0, and its blend against the spec model's arithmetic
    given the card's motion field.  Returns (me_sad launches of the timed
    run, the search's largest error against the twin)."""
    import types

    from vvctpu_torch.coding import mctf as tmctf
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.spec import mctf as smctf
    from vvctpu_torch.spec.inter import ME_RANGE
    tag = "[10c]"
    frames = synth_frames10(3, *MCTF_4K, seed=5)
    # the search of anchor 0 in neighbour 1, as block_motion frames it
    o, nb = (torch.as_tensor(frames[i][0], device=dev) for i in (0, 1))
    H, W = (-(-n // 64) * 64 for n in o.shape)
    o64 = tmctf._clamped(o, 0, H, 0, W).contiguous()
    refp = tmctf._clamped(nb, -ME_RANGE, H + 2 * ME_RANGE, -ME_RANGE,
                          W + 2 * ME_RANGE).contiguous()
    err = max(int((a - b).abs().max())
              for g, w in zip(kme.me_sad(o64, refp, 0),
                              kme.me_sad_reference(o64, refp, 0))
              for a, b in zip(g, w))
    if err:
        raise AssertionError(f"{tag} me_sad at lam 0 differs from its twin "
                             f"by {err}")
    del o, nb, o64, refp
    mvs = []
    first = tmctf.temporal_filter(frames, 2, device=dev, motion_out=mvs)
    kme.launches = 0
    torch.cuda.synchronize()
    t0 = time.time()
    out = tmctf.temporal_filter(frames, 2, device=dev)
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = kme.launches
    if launches != 4 or not _same_planes(out, first):
        raise AssertionError(f"{tag} {launches} me_sad launches (4 "
                             "expected), or the two runs differ")
    # the spec model's blend with the card's motion: its me_size_pass
    # gives the card's fields in its own call order
    it = iter(mv.cpu().numpy() for mv in mvs)
    spec_dec = smctf.sdecide
    smctf.sdecide = types.SimpleNamespace(
        me_size_pass=lambda *a, **k: (None, next(it)))
    try:
        t1 = time.time()
        want = smctf.temporal_filter(frames, 2)
        t_np = time.time() - t1
    finally:
        smctf.sdecide = spec_dec
    if not _same_planes(out, want):
        raise AssertionError(f"{tag} blend != the spec model's arithmetic")
    moved = [int(np.abs(mv.cpu().numpy()).max()) for mv in mvs]
    print(f"{tag} MCTF prefilter, 3 frames of 4K (3840x2160) 10-bit (config "
          f"#5's source), GOP2 (anchors 0 and 2, 4 neighbour searches): "
          f"{dt:.3f} s on the card (host clock, ends in a sync), "
          f"{launches} me_sad launches at {H}x{W}, lam 0 (the twin equal "
          f"at lam 0, max abs err {err}); the blend equals the spec model's "
          f"_mc_plane and _neighbour_weight given the card's motion "
          f"(largest |mv| per search {moved}; the NumPy blend took "
          f"{t_np:.1f} s)")
    return launches, err


def mctf_host_search(dev):
    """One of 10c's neighbour searches (anchor 0 in frame 1 of config #5's
    4K 10-bit source) timed in the copied spec model's NumPy
    (me_size_pass, what the reference engine's MCTF runs on the host) and
    on the card (coding/mctf.py block_motion, host clock around work that
    ends in a sync); both motion fields must be equal.  Not run by main:

        python3 -c "import torch, chip_smoke;
            chip_smoke.mctf_host_search(torch.device('cuda'))"
    """
    from vvctpu_torch.coding import mctf as tmctf
    from vvctpu_torch.spec import decide as sdecide
    frames = synth_frames10(2, *MCTF_4K, seed=5)
    o, nb = (torch.as_tensor(f[0], device=dev) for f in frames)
    tmctf.block_motion(o, nb)                   # build and warm up
    torch.cuda.synchronize()
    t0 = time.time()
    mv = tmctf.block_motion(o, nb)
    torch.cuda.synchronize()
    t_card = time.time() - t0
    t0 = time.time()
    _, smv = sdecide.me_size_pass(frames[0][0], frames[1][0], 16, lam=0)
    t_host = time.time() - t0
    if not np.array_equal(mv.cpu().numpy(), smv):
        raise AssertionError("[10c] card and host motion fields differ")
    print(f"[10c] one 4K 10-bit neighbour search: spec model's NumPy "
          f"me_size_pass {t_host:.1f} s on the host, block_motion "
          f"{t_card:.4f} s on the card; motion fields equal")


def phase_ctc_tools(dev):
    """Phase 10: transform skip, joint Cb-Cr residuals, MCTF and rate
    control; returns the kernels' launches on the 1080p and 4K paths
    (me_sad, dq_trellis), me_sad's largest error against its twin and
    10b's POC 0 (bits, Y-PSNR), its frame at QP 32."""
    _ctc_small(dev)
    me_b, dq_b, i0 = _ctc_full(dev)
    me_c, err = _mctf_4k(dev)
    return me_b + me_c, dq_b, err, i0


# ---------------------------------------------------------------------------
# phase 11: IBC and palette in I slices, then CTU 128
# ---------------------------------------------------------------------------


def glyph_planes(h, w, seed=4):
    """test_ibc.py's screen frame: one random 16x16 glyph tiled over the
    luma (every tile an exact copy of its neighbours), flat chroma."""
    rng = np.random.default_rng(seed)
    glyph = rng.integers(0, 255, (16, 16))
    y = np.tile(glyph, (h // 16 + 1, w // 16 + 1))[:h, :w].astype(np.int32)
    return [y, np.full((h // 2, w // 2), 128, np.int32),
            np.full((h // 2, w // 2), 128, np.int32)]


def flat_rect_planes(h, w, seed=3, n_colors=5):
    """test_palette.py's screen frame: 12 random rectangles of a few flat
    colours, chroma derived from the luma."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(16, 240, (n_colors,))
    y = np.full((h, w), int(cols[0]), np.int32)
    for _ in range(12):
        x0 = int(rng.integers(0, w - 8))
        y0 = int(rng.integers(0, h - 8))
        ww = int(rng.integers(8, w - x0 + 1))
        hh = int(rng.integers(8, h - y0 + 1))
        y[y0:y0 + hh, x0:x0 + ww] = int(cols[rng.integers(0, n_colors)])
    cb = 96 + (y[0::2, 0::2] % 64)
    cr = 160 - (y[0::2, 0::2] % 32)
    return [y, cb.astype(np.int32), cr.astype(np.int32)]


def _plt_pair():
    return [flat_rect_planes(64, 96, seed=7), flat_rect_planes(64, 96,
                                                              seed=8)]


def ctu128_frames(n, h, w, seed=9):
    """test_ctu128.py's frames: the benchmark's pattern with noise, flat
    Cb, a slow Cr wave."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for t in range(n):
        y = (90 + 70 * np.sin((xx + 5 * t) / 11.0)
             + 50 * np.cos((yy - 3 * t) / 8.0)
             + rng.integers(-8, 8, (h, w))).clip(0, 255).astype(np.int32)
        cb = np.full((h // 2, w // 2), 120, np.int32)
        cr = (128 + 20 * np.sin(yy[::2, ::2] / 9.0)).astype(np.int32)
        out.append([y, cb, cr])
    return out


def scc_frames(n, h, w, seed=0):
    """Synthetic screen content of w x h, as a desktop shows it: a panel of
    test_ibc.py's tiled glyphs (a third of the width), a panel of
    test_palette.py's flat-colour rectangles scaled to the panel (a
    third), and a text panel: lines of characters from a 16-glyph 8x12
    bitmap font in two colours on a flat ground, every frame scrolled up
    by one 16-row line.  Chroma is flat per panel, derived from the luma
    in the rectangles' panel."""
    rng = np.random.default_rng(seed)
    w1, w2 = w // 3 // 8 * 8, 2 * (w // 3) // 8 * 8
    glyph = glyph_planes(h, w1, seed=seed + 5)
    rects = flat_rect_planes(h, w2 - w1, seed=seed + 7)
    font = rng.integers(0, 2, (16, 12, 8)).astype(bool)
    tw = w - w2
    lines = h // 16 + n + 1
    text = np.full((lines * 16, tw), 236, np.int32)
    for li in range(lines):
        chars = rng.integers(0, 16, tw // 8)
        for ci, c in enumerate(chars[:int(rng.integers(tw // 16, tw // 8))]):
            text[li * 16 + 2:li * 16 + 14, ci * 8:ci * 8 + 8] = np.where(
                font[c], 20, 236)
    out = []
    for t in range(n):
        y = np.concatenate([glyph[0], rects[0], text[16 * t:16 * t + h]],
                           1).astype(np.int32)
        cb = np.concatenate([glyph[1], rects[1],
                             np.full((h // 2, tw // 2), 124, np.int32)], 1)
        cr = np.concatenate([glyph[2], rects[2],
                             np.full((h // 2, tw // 2), 131, np.int32)], 1)
        out.append([y, cb, cr])
    return out


def _granules(decs, key):
    return [int(getattr(d, key).sum()) for d in decs]


def _scc_small(dev):
    """11a: test_ibc.py's and test_palette.py's engine configs and
    test_ctu128.py's configs (with 10a's CTC clip at CTU 128) against the
    spec model."""
    for name, what in (
            ("ibc", "128x128 AI, IBC (test_ibc.py)"),
            ("ibc_mtt", "128x128 AI, IBC with MTT, DQ, MTS (test_ibc.py)"),
            ("plt", "64x96 AI, 2 frames, palette (test_palette.py)"),
            ("plt_ibc_lmcs", "64x96 AI, 2 frames, palette with IBC and "
                             "LMCS (test_palette.py)"),
            ("plt_tiles", "64x96 AI, 2 frames, palette with a 2x1 tile "
                          "grid (test_palette.py)")):
        data, decs, _ = _held_to_spec(f"[11a] {what}", dev, name)
        kw = _spec_clips()[name][1]
        ibc, plt = _granules(decs, "ibc8"), _granules(decs, "plt8")
        if (kw.get("ibc") and not sum(ibc)) or (kw.get("plt")
                                                and not sum(plt)):
            raise AssertionError(f"[11a] {what}: IBC granules {ibc}, "
                                 f"palette granules {plt}")
        print(f"[11a] {what}: {len(data)} bytes and decisions equal to the "
              f"spec model; card and spec decoders verified hashes; 8x8 "
              f"granules with IBC {ibc}, palette {plt} per frame")
    got = {}
    for name, what in (
            ("c128_ai", "140x190 (256x256 padded) AI with MTS"),
            ("c128_at64", "128x192 AI at CTU 64"),
            ("c128_at128", "the same frame at CTU 128"),
            ("c128_gop2", "128x192 GOP2, 3 frames"),
            ("c128_wpp", "256x192 AI with WPP"),
            ("c128_mtt", "128x192 AI with MTT, TT, ISP"),
            ("c128_ctc", "10a's 64x64 GOP2 clip, 3 frames, with 6a's "
                         "toolset, MTT, TT, LMCS, TS, JCCR, MCTF")):
        data, _, _ = _held_to_spec(f"[11a] {what}", dev, name)
        got[name] = data
        print(f"[11a] {what} (test_ctu128.py): {len(data)} bytes and "
              "decisions equal to the spec model; card and spec decoders "
              "verified hashes")
    if got["c128_at64"] == got["c128_at128"]:
        raise AssertionError("[11a] CTU 64 and 128 streams are equal")


def _scc_full(dev):
    """11b: 3 frames of 1080p screen content, all-intra, with IBC, palette
    and config #2's intra toolset; returns its kernel launches (me_sad,
    dq_trellis)."""
    from vvctpu_torch.coding import me as tme
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import codec as scodec
    from vvctpu_torch.spec import palette as splt
    from vvctpu_torch.spec import sequence as tseq
    from vvctpu_torch.spec.decide import lambda_satd_fp
    from vvctpu_torch.cabac import estimate as est
    n, tag = 3, "[11b]"
    cfg = tseq.EncoderConfig(qp=32, wpp=True, ibc=True, plt=True,
                             **AI_TOOLS)
    frames = scc_frames(n, 1080, 1920, seed=6)
    # the two screen-content decision passes alone on frame 0: the block
    # vector search on the card, the palette costs on the host
    sps = cfg.make_sps(1920, 1080)
    orig = scodec.pad_planes(frames[0], sps)[0]
    lam, fp = lambda_satd_fp(32), int(est.decision_bits(2, 32).ibc_fp)
    o = torch.as_tensor(orig, device=dev)
    tme.ibc_pass(o, lam, frame_w=sps.width, frame_h=sps.height, ibc_fp=fp)
    torch.cuda.synchronize()
    t0 = time.time()
    tme.ibc_pass(o, lam, frame_w=sps.width, frame_h=sps.height, ibc_fp=fp)
    torch.cuda.synchronize()
    t_ibc = time.time() - t0
    t0 = time.time()
    for s in (8, 16, 32):
        splt.palette_size_pass(orig, s, lam, 8)
    t_plt = time.time() - t0
    del o
    decs = []
    r = _run_full(dev, frames, cfg, decisions_out=decs)
    ibc, plt = _granules(decs, "ibc8"), _granules(decs, "plt8")
    kinds = r["batch_kinds"]
    if not (all(ibc) and all(plt) and kinds.get("ibc") and kinds.get("plt")):
        raise AssertionError(f"{tag} IBC granules {ibc}, palette {plt}, "
                             f"batches {kinds}")
    if r["launches"] or r["dq_launches"]:
        raise AssertionError(f"{tag} me_sad {r['launches']}, dq_trellis "
                             f"{r['dq_launches']} launches (0 expected)")
    print(f"{tag} 1080p screen content (glyphs, flat rectangles, scrolling "
          f"text), AI QP32 WPP, IBC and palette with config #2's intra "
          f"toolset, {n} frames: {sum(r['bits']) / n:.1f} bits/frame (new "
          f"data: the reference never ran it), per frame {r['bits']}; "
          f"8x8 granules with IBC {ibc}, palette {plt} (of "
          f"{sps.width * sps.height // 64} per frame)")
    print(f"{tag} ibc_pass on the card (host clock around work that ends in "
          f"a sync, warm): {t_ibc:.4f} s per 1088x1920 frame; "
          f"palette_size_pass (8, 16, 32) on the host {t_plt:.3f} s per "
          f"frame; the encoder's palette stage (derive_plt_data and "
          f"build_planes) {r['enc_t'].get('palette', 0.0) / n:.3f} s per "
          f"frame")
    _report(tag, r, n)
    print(f"{tag} phase-B batches of the encode per leaf class: " + ", ".join(
        f"{k} {v}" for k, v in sorted(kinds.items())))
    return r["launches"], r["dq_launches"]


def _ctc128_full(dev):
    """11c: VTM's CTC random-access toolset whole: 10b's configuration at
    CTU 128 without rate control, on 10b's 3 frames of 1080p (I0 P2 B1);
    returns (me_sad launches, dq_trellis launches, (POC 0's bits, its
    Y-PSNR))."""
    from vvctpu_torch.spec import sequence as tseq
    n, tag = 3, "[11c]"
    cfg = tseq.EncoderConfig(qp=32, intra_period=32, gop=2, wpp=True,
                             ctu=128, sbt=True, dq=True, alf=True,
                             lmcs=True, **CTC_TOOLS, **MTT, **RA_TOOLS)
    r = _run_full(dev, synth_frames(n, 1080, 1920, seed=4), cfg)
    if r["me_keys"] != [11] * 3 or r["me_shapes"] != [(1152, 1920)] * 3:
        raise AssertionError(f"{tag} me_sad launches (keys) {r['me_keys']} "
                             f"at {r['me_shapes']}, expected three at 11 "
                             "keys on 1152x1920")
    if not r["dq_launches"]:
        raise AssertionError(f"{tag} dq_trellis was never launched")
    print(f"{tag} 1080p RA GOP2 QP32 WPP at CTU 128 (1152 rows padded), "
          f"VTM's CTC random-access toolset (config #4's, MTT, TT, LMCS, "
          f"TS, JCCR, MCTF), {n} frames (I0 P2 B1): "
          f"{sum(r['bits']) / n:.1f} bits/frame (new data), per frame "
          f"{r['bits']}, Y-PSNR per frame "
          f"{[round(p, 4) for p in r['psnr']]}; me_sad launches "
          f"{r['launches']}, all at 11 keys on 1152x1920; dq_trellis "
          f"launches {r['dq_launches']}")
    _report(tag, r, n)
    print(f"{tag} phase-B batches of the encode per leaf class: " + ", ".join(
        f"{k} {v}" for k, v in sorted(r["batch_kinds"].items())))
    return r["launches"], r["dq_launches"], (r["bits"][0], r["psnr"][0])


def phase_scc_ctu128(dev):
    """Phase 11: IBC and palette in I slices (11b at 1080p), 11a's small
    clips of IBC, palette and CTU 128 (11b runs first, while the spec
    model's side of 11a, computed last, is still running), then CTU 128
    at 1080p (11c, VTM's CTC random-access toolset).  Returns (me_sad
    launches, dq_trellis launches, 11c's POC 0 (bits, Y-PSNR))."""
    me_b, dq_b = _scc_full(dev)
    _scc_small(dev)
    me_c, dq_c, i0 = _ctc128_full(dev)
    return me_b + me_c, dq_b + dq_c, i0


# ---------------------------------------------------------------------------
# phase 12: multi-device (vvctpu_torch/dist) over four ranks on the card
# ---------------------------------------------------------------------------

# 12a's clips over a (1, 4) mesh: test_shard.py's three configs (the third
# has 2 tiles on the 4-rank tile axis and takes the unsharded wave), the
# 2x2 LMCS clip without and with DQ (the trellis on every rank), the
# RDOQ-off configs (one tile: unsharded as well)
DIST_CLIPS = ("shard_inter", "shard_22", "shard_fallback", "shard_lmcs",
              "shard_lmcs_dq", "rdoq_off", "isp_rdoq_off")
DIST_SHARDED = ("shard_inter", "shard_22", "shard_lmcs", "shard_lmcs_dq")
# the clip 12a encodes with the syntax trace on
DIST_TRACED = "shard_22"
# free device bytes 12b's controller waits for, and its longest wait
DIST_ROOM = 32 * 2 ** 30
DIST_WAIT_S = 420


def _dist_rank(small, dry, big: bool):
    """One of phase 12's four ranks, a process on the card joined to the
    others under gloo: (12a) each clip of ``small`` ((name, frames,
    EncoderConfig keywords)) encoded and decoded (hashes verified) over a
    (1, 4) mesh; ``dry`` ((frames, keywords)) encoded with
    encode_gop_parallel over a (2, 2) mesh and decoded over row 0's tile
    axis (``dry`` None: not run); then, when ``big``, (12b) bench config
    #5 over the (1, 4) mesh, encoded and decoded with the hashes verified.
    Rank 0 returns {name: results}; rank 2, the other (2, 2) row's
    controller, its gathered stream and the me_sad and dq_trellis
    launches of its row (its own and its server's); the others None.
    Each result counts the launches of the controller and, per rank, of
    the ranks that served it."""
    from vvctpu_torch.dist import gop as tgop
    from vvctpu_torch.dist import mesh as dmesh
    from vvctpu_torch.dist import shard
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    dev = torch.device("cuda")
    m14 = dmesh.make_mesh(4, gop=1, device_type="cuda")
    m22 = dmesh.make_mesh(4, gop=2, device_type="cuda")
    ctl = shard.is_controller(m14)
    out = {}
    for name, frames, kw in small:
        with shard.use_mesh(m14):
            if not ctl:
                shard.serve(m14)
                continue
            calls = len(shard.stats["calls"])
            me0, dq0 = kme.launches, kdq.launches
            ranks0 = _rank_launches(0)
            decs = []

            def enc():
                return tenc.encode_sequence(
                    frames, tseq.EncoderConfig(**kw), device=dev,
                    decisions_out=decs)
            text, (data, recons, _) = (
                _traced(enc) if name == DIST_TRACED else (None, enc()))
            dec, _ = tenc.decode_sequence(data, check_hash=True, device=dev)
            out[name] = dict(data=data, decs=decs, recons=recons, dec=dec,
                             trace=text,
                             waves=len(shard.stats["calls"]) - calls,
                             me=kme.launches - me0, dq=kdq.launches - dq0,
                             ranks=_rank_launches(0, ranks0))
    gathered = None
    if dry is not None:
        frames, kw = dry
        rank = dmesh.dist.get_rank()
        me0, dq0, ranks0 = kme.launches, kdq.launches, _rank_launches(rank)
        res = tgop.encode_gop_parallel(frames, tseq.EncoderConfig(**kw),
                                       mesh=m22, device=dev)
        if m22.get_coordinate()[0] == 0:
            dec = shard.run(m22["tile"], lambda d: tenc.decode_sequence(
                d, check_hash=True, device=dev)[0], res and res[0])
        if res is not None:
            mine = _rank_launches(rank, ranks0)
            launches = (kme.launches - me0
                        + sum(m for m, _ in mine.values()),
                        kdq.launches - dq0
                        + sum(q for _, q in mine.values()))
            if ctl:
                out["dry"] = dict(data=res[0], recons=res[1], dec=dec,
                                  launches=launches)
            else:
                gathered = (res[0], launches)
    if big:
        _dist_big(m14, ctl, out)
    return out if ctl else gathered


def _rank_launches(ctl, since=None):
    """{rank: (me_sad, dq_trellis launches)} of the ranks that served this
    controller's sharded waves (their reports in shard.stats), less
    ``since``, an earlier result."""
    from vvctpu_torch.dist import shard
    since = since or {}
    return {r: (s["me_sad"] - since.get(r, (0, 0))[0],
                s["dq_trellis"] - since.get(r, (0, 0))[1])
            for r, s in shard.stats["ranks"].items() if r != ctl}


def _traced(fn):
    """(the syntax trace that fn() writes, fn's result)."""
    import os
    import tempfile

    from vvctpu_torch.core import trace
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "syntax.trc")
        trace.open_trace(path)
        try:
            res = fn()
        finally:
            trace.close_trace()
        with open(path) as f:
            return f.read(), res


def _dist_big(m14, ctl, out):
    """12b on one of _dist_rank's ranks: the controller encodes and
    decodes bench config #5 over ``m14`` into out["12b"], the others
    serve its waves."""
    from vvctpu_torch.dist import shard
    from vvctpu_torch.kernels import dq as kdq
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.pipeline import encoder as tenc
    dev = torch.device("cuda")
    shard.reset_stats()
    with shard.use_mesh(m14):
        if not ctl:
            shard.serve(m14)
            return
        frames = synth_frames10(3, 2160, 3840, seed=5)
        r = dict(enc_t={}, dec_t={}, enc_l={}, dec_l={})
        # the controller's decisions on the whole 4K frame take 9b's 28
        # GiB: wait (at most DIST_WAIT_S) until the card has that room
        # beside the other phases' processes
        t0 = time.time()
        while (torch.cuda.mem_get_info()[0] < DIST_ROOM
               and time.time() - t0 < DIST_WAIT_S):
            time.sleep(1.0)
        r["wait"] = time.time() - t0
        r["free"] = torch.cuda.mem_get_info()[0]
        kme.launches = kdq.launches = 0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        data, recons, bits = tenc.encode_sequence(
            frames, c5_config(), device=dev, stage_times=r["enc_t"],
            layer_times=r["enc_l"])
        torch.cuda.synchronize()
        r["t_enc"] = time.time() - t0
        r["enc_calls"] = len(shard.stats["calls"])
        r["me"], r["dq"] = kme.launches, kdq.launches
        t0 = time.time()
        dec, _ = tenc.decode_sequence(data, check_hash=True, device=dev,
                                      stage_times=r["dec_t"],
                                      layer_times=r["dec_l"])
        torch.cuda.synchronize()
        r["t_dec"] = time.time() - t0
        r["same"] = _same_planes(recons, dec)
        r["peak"] = torch.cuda.max_memory_allocated()
        r.update(data=data, bits=bits)
    # the workers' peaks come with their stop, at the block's end
    r["stats"] = dict(shard.stats)
    r["ranks"] = _rank_launches(0)
    out["12b"] = r


def _dist_cli(dev, frames, kw):
    """The CLI's --distributed over two processes on the card (a file://
    rendezvous): each encodes its closed-GOP segment to a .seg file; their
    parcat must equal encode_gop_parallel(segments=2).  Returns the
    stream's bytes."""
    import os
    import shutil
    import tempfile

    from vvctpu_torch.dist import gop as tgop
    from vvctpu_torch.io import yuv
    from vvctpu_torch.io.parcat import parcat
    from vvctpu_torch.spec import sequence as tseq
    tmp = tempfile.mkdtemp(prefix="vvctpu_cli_")
    try:
        src, bit = os.path.join(tmp, "in.yuv"), os.path.join(tmp, "o.bin")
        yuv.write_yuv(src, frames)
        h, w = frames[0][0].shape
        args = [sys.executable, "-m", "vvctpu_torch", "encode", "-i", src,
                "--wdt", str(w), "--hgt", str(h), "-q", str(kw["qp"]),
                "--ip", str(kw["intra_period"]), "--gop", str(kw["gop"]),
                "-b", bit, "--distributed", "--coordinator",
                "file://" + os.path.join(tmp, "rendezvous"),
                "--num-processes", "2"]
        root = os.path.dirname(os.path.abspath(__file__))
        procs = [subprocess.Popen(args + ["--process-id", str(r)], cwd=root,
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for r in range(2)]
        try:
            logs = [p.communicate(timeout=300)[0] for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if any(p.returncode for p in procs):
            raise AssertionError("[12a] --distributed CLI failed:\n"
                                 + "\n".join(logs))
        segs = []
        for r in range(2):
            with open(f"{bit}.seg{r}", "rb") as f:
                segs.append(f.read())
        got = parcat(segs)
    finally:
        shutil.rmtree(tmp)
    want, _, _ = tgop.encode_gop_parallel(frames, tseq.EncoderConfig(**kw),
                                          segments=2, device=dev)
    if got != want:
        raise AssertionError("[12a] --distributed over 2 processes: parcat "
                             "of the segments != encode_gop_parallel's")
    return got


def _rank_waves(calls):
    """Each rank's own wave seconds and phase-B batches summed over
    shard.stats calls: ({rank: seconds}, {rank: batches})."""
    waves, nb = {}, {}
    for c in calls:
        for rank, sec in [(0, c["own_wave_s"]), *c["rank_wave_s"].items()]:
            waves[rank] = waves.get(rank, 0.0) + sec
            nb[rank] = nb.get(rank, 0) + c["rank_batches"][rank]
    return waves, nb


def _report_12b(r, one, smi):
    """12b's lines: walls, the controller's stages, each rank's wave and
    batches, the exchange per group, peak memory, against 9b's one-rank
    run of the same stream (``one``)."""
    n = len(r["bits"])
    st = r["stats"]
    print(f"[12b] {smi}: bench config #5 over a (1, 4) mesh, four ranks "
          "on the card (gloo), tile t of every frame on rank t: "
          f"{sum(r['bits']) / n:.1f} bits/frame, bytes equal to 9b's "
          "one-rank stream of this run; hashes verified, recon == decoded; "
          f"me_sad launches {r['me']} (the controller's decisions), "
          f"dq_trellis {r['dq']}; ranks 1-3 (me_sad, dq_trellis): "
          + ", ".join(f"rank {k} {v}" for k, v in sorted(r["ranks"].items())))
    print(f"[12b] waited {r['wait']:.1f} s for {DIST_ROOM / 2 ** 30:.0f} "
          f"GiB of the card free ({r['free'] / 2 ** 30:.1f} GiB free at the "
          "start)")
    print(f"[12b] {smi}: encode {r['t_enc']:.2f} s ({n / r['t_enc']:.4f} "
          f"fps), decode {r['t_dec']:.2f} s ({n / r['t_dec']:.4f} fps); "
          f"9b one rank in its own process: encode {one['t_enc']:.2f} s, "
          f"decode {one['t_dec']:.2f} s")
    print(_stages_line("[12b] controller encode", r["enc_t"], r["t_enc"]))
    print(_stages_line("[12b] controller decode", r["dec_t"], r["t_dec"]))
    calls = st["calls"]
    enc, dec = calls[:r["enc_calls"]], calls[r["enc_calls"]:]
    for what, cs in (("encode", enc), ("decode", dec)):
        waves, nb = _rank_waves(cs)
        print(f"[12b] {smi}: {what} wave per rank (its own frame_wave_batch "
              "calls, synchronised; phase-B batches): " + ", ".join(
                  f"rank {k} {v:.2f} s, {nb[k]}"
                  for k, v in sorted(waves.items()))
              + f"; 9b's one-rank {what} wave "
              f"{one['wave' if what == 'encode' else 'dec_wave']:.2f} s"
              + (f", {one['batches']} batches" if what == "encode" else ""))
        for i, c in enumerate(cs):
            slow = max([c["own_wave_s"], *c["rank_wave_s"].values()])
            ex = c["wall_s"] - slow
            print(f"[12b]   {what} group {i} ({c['frames']} frames): wall "
                  f"{c['wall_s']:.3f} s, slowest rank's wave {slow:.3f} s, "
                  f"exchange {ex:.3f} s ({100 * ex / c['wall_s']:.1f} %), "
                  f"{c['bytes_out'] / 2 ** 20:.1f} MiB out, "
                  f"{c['bytes_in'] / 2 ** 20:.1f} MiB in")
    print("[12b] peak device memory per rank (encode and decode; "
          "torch.cuda.max_memory_allocated of each process): " + ", ".join(
              f"rank {k} "
              f"{(r['peak'] if k == 0 else v['peak_bytes']) / 2 ** 30:.2f} GiB"
              for k, v in sorted(st["ranks"].items())))


def phase_dist(dev, big: bool = True):
    """Phase 12: multi-device over four ranks, child processes on the one
    card joined under gloo: 12a small clips against the spec model, the
    (2, 2) mesh against the unsharded encode_gop_parallel, the CLI's
    --distributed over two processes, an encode trace against the spec
    model's; then (``big``) 12b, bench config #5 over a (1, 4) mesh,
    against 9b's one-rank stream of the same run (phase 9 before it in
    this process; run alone, phase 12 encodes 9b's clip on one rank after
    the ranks).  Returns the kernels' launches on the path (me_sad,
    dq_trellis)."""
    import os

    from vvctpu_torch.dist import gop as tgop
    from vvctpu_torch.dist import mesh as dmesh
    from vvctpu_torch.spec import sequence as tseq
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    clips = _spec_clips()
    small = [(name, *clips[name]) for name in DIST_CLIPS]
    dry = (dryrun_frames(4, 64, 128),
           dict(qp=34, intra_period=4, gop=2, tile_cols=2))
    # expandable segments: less of the card held in the ranks' cached,
    # unused blocks, beside the other phases' processes
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    t0 = time.time()
    res = dmesh.run_ranks(_dist_rank, 4, args=(small, dry, big),
                          timeout_s=1000)
    t_ranks = time.time() - t0
    out, other = res[0], res[2]
    me = dq = 0
    for name, frames, kw in small:
        r = out[name]
        sdata, sdecs, sout = _spec(name)
        tag = f"[12a] {name}"
        if r["data"] != sdata:
            raise AssertionError(f"{tag}: four-rank bitstream != spec "
                                 "model's")
        _decisions_equal(tag, r["decs"], sdecs)
        if not _same_planes(r["recons"], r["dec"], sout):
            raise AssertionError(f"{tag}: recon/decoder mismatch")
        sharded = name in DIST_SHARDED
        if bool(r["waves"]) != sharded:
            raise AssertionError(f"{tag}: {r['waves']} sharded waves")
        if kw.get("dq") and not (
                sorted(r["ranks"]) == [1, 2, 3]
                and all(q > 0 for _, q in r["ranks"].values())):
            raise AssertionError(f"{tag}: dq_trellis launches per serving "
                                 f"rank (me_sad, dq_trellis) {r['ranks']}")
        me = me + r["me"] + sum(m for m, _ in r["ranks"].values())
        dq = dq + r["dq"] + sum(q for _, q in r["ranks"].values())
        print(f"[12a] {name} {kw}: {len(r['data'])} bytes and decisions "
              "equal to the spec model over four ranks "
              + (f"({r['waves']} sharded waves, encode and decode)"
                 if sharded else "(one tile per frame on a 4-rank tile axis:"
                 " the unsharded wave, as in the reference)")
              + "; hashes verified; launches (me_sad, dq_trellis): "
              f"controller ({r['me']}, {r['dq']}), " + ", ".join(
                  f"rank {k} {v}" for k, v in sorted(r["ranks"].items())))
    frames, kw = clips[DIST_TRACED]
    stext, _ = _traced(lambda: tseq.encode_sequence(
        frames, tseq.EncoderConfig(**kw)))
    if not stext or out[DIST_TRACED]["trace"] != stext:
        raise AssertionError("[12a] the sharded encode's syntax trace != "
                             "the spec model's")
    print(f"[12a] syntax trace of {DIST_TRACED}'s sharded encode equal to "
          f"the spec model's ({len(stext.splitlines())} lines)")
    d = out["dry"]
    me += d["launches"][0] + other[1][0]
    dq += d["launches"][1] + other[1][1]
    base, base_rec, _ = tgop.encode_gop_parallel(
        dry[0], tseq.EncoderConfig(**dry[1]), segments=2, device=dev)
    if not (d["data"] == other[0] == base and _same_planes(
            d["recons"], base_rec) and _same_planes(d["dec"], base_rec)):
        raise AssertionError("[12a] (2, 2) mesh: the gathered stream != "
                             "the unsharded encode_gop_parallel's")
    print(f"[12a] (2, 2) mesh, __graft_entry__'s dry-run shape (4 frames "
          f"64x128 GOP2, 2 tiles): {len(base)} bytes gathered over the gop "
          "axis on both rows' controllers, equal to the unsharded "
          "encode_gop_parallel; row 0's sharded decode verified hashes")
    cli = _dist_cli(dev, motion_frames(4, 64, 64, seed=90),
                    dict(qp=32, intra_period=0, gop=2))
    print(f"[12a] --distributed CLI over 2 processes: parcat of the .seg "
          f"files ({len(cli)} bytes) equals encode_gop_parallel(segments=2)")
    print(f"[12a] {smi}: the four ranks' run (12a and 12b, their start "
          f"included) {t_ranks:.1f} s")
    if not big:
        return me, dq
    r = out["12b"]
    one = _RUNS.get("9b") or _c5_summary(_run_full(
        dev, synth_frames10(3, 2160, 3840, seed=5), c5_config()))
    if r["data"] != one["data"]:
        raise AssertionError("[12b] four-rank stream != 9b's one-rank "
                             "stream")
    if not r["same"] or r["me"] != 3:
        raise AssertionError(f"[12b] recon == decoded {r['same']}, me_sad "
                             f"launches {r['me']} (3 expected)")
    _report_12b(r, one, smi)
    return (me + r["me"] + sum(m for m, _ in r["ranks"].values()),
            dq + r["dq"] + sum(q for _, q in r["ranks"].values()))


def _c5_summary(r):
    """What 12b compares with of 9b's one-rank run (_run_full's)."""
    return dict(data=r["data"], wave=r["enc_t"]["wave"],
                dec_wave=r["dec_t"]["wave"], batches=r["batches"],
                t_enc=r["t_enc"], t_dec=r["t_dec"])


def walls(dev):
    """Encode and decode walls of phase 4's and phase 6b's configurations
    (1080p RA GOP16, 17 frames; bench config #4 whole, 5 frames) with the
    vvctpu_torch that comes first on sys.path; prints one line each.  Not
    run by main: to compare two trees on one card, run this file once per
    tree, in turns, with that tree's root first on sys.path:

        python3 -c "import sys, runpy, torch; sys.path.insert(0, ROOT);
            runpy.run_path('chip_smoke.py')['walls'](torch.device('cuda'))"
    """
    import vvctpu_torch
    from vvctpu_torch.spec import sequence as tseq
    for tag, n, seed, cfg in (
            ("RA GOP16", 17, 0, tseq.EncoderConfig(
                qp=32, intra_period=32, gop=16, wpp=True)),
            ("config #4", 5, 4, tseq.EncoderConfig(
                qp=32, intra_period=32, gop=4, wpp=True, sbt=True, dq=True,
                alf=True, **RA_TOOLS))):
        r = _run_full(dev, synth_frames(n, 1080, 1920, seed=seed), cfg)
        print(f"[walls] {vvctpu_torch.__file__}: {tag} encode "
              f"{r['t_enc']:.2f} s, decode {r['t_dec']:.2f} s, "
              f"{sum(r['bits']) / n:.1f} bits/frame; "
              + _stages_line("encode", r["enc_t"], r["t_enc"]))


def dist_walls(dev):
    """12b's walls against 9b's one-rank run of the same stream, with the
    card to each in turn: one rank (in this process), four ranks (phase
    12's ranks, spawned), four ranks, one rank; each process warmed first
    on 12a's shard_inter clip, and every run's bytes held equal.  Prints
    one line per run.  Not run by main (about 11 min):

        python3 -c "import torch, chip_smoke;
            chip_smoke.dist_walls(torch.device('cuda'))"
    """
    import os

    from vvctpu_torch.dist import mesh as dmesh
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    wframes, wkw = _spec_clips()["shard_inter"]
    data, _, _ = tenc.encode_sequence(wframes, tseq.EncoderConfig(**wkw),
                                      device=dev)
    tenc.decode_sequence(data, check_hash=True, device=dev)
    # the ranks' allocator as in phase 12 (this process's is set up now)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    frames = synth_frames10(3, 2160, 3840, seed=5)
    first = None
    for i, n in enumerate((1, 4, 4, 1), start=1):
        if n == 1:
            r = _c5_summary(_run_full(dev, frames, c5_config()))
            line = (f"one rank: encode {r['t_enc']:.2f} s, decode "
                    f"{r['t_dec']:.2f} s, wave stage {r['wave']:.2f} / "
                    f"{r['dec_wave']:.2f} s, {r['batches']} batches")
        else:
            r = dmesh.run_ranks(_dist_rank, 4, args=(
                [("shard_inter", wframes, wkw)], None, True),
                timeout_s=1000)[0]["12b"]
            calls = r["stats"]["calls"]
            waves, nb = _rank_waves(calls[:r["enc_calls"]])
            dwaves, _ = _rank_waves(calls[r["enc_calls"]:])
            line = (f"four ranks: encode {r['t_enc']:.2f} s, decode "
                    f"{r['t_dec']:.2f} s, wave stage (the sharded calls' "
                    f"walls) {r['enc_t']['wave']:.2f} / "
                    f"{r['dec_t']['wave']:.2f} s; each rank's own wave "
                    "(encode / decode, batches): " + ", ".join(
                        f"rank {k} {waves[k]:.2f} / {dwaves[k]:.2f} s, "
                        f"{nb[k]}" for k in sorted(waves))
                    + f"; waited {r['wait']:.1f} s for room")
        if first is None:
            first = r["data"]
        elif r["data"] != first:
            raise AssertionError(f"[dist_walls] run {i}'s stream != run 1's")
        print(f"[dist_walls] {smi}: run {i}, {line}", flush=True)


def _phase_proc(spec, phases):
    """The phase functions ``phases``, one after the other, in a process of
    their own on a CUDA context of its own, with the spec model's results
    they hold clips against read from ``spec``, main()'s shared dict
    (name -> _spec's result, filled as each run finishes); returns (what
    they printed, [(each phase's result, its seconds)], seconds waited for
    spec results).  On a failure it writes what it printed to stderr."""
    import contextlib
    import io
    global _SPEC_SHARED
    _SPEC_SHARED = spec
    buf = io.StringIO()
    outs = []
    try:
        with contextlib.redirect_stdout(buf):
            for fn in phases:
                t0 = time.time()
                outs.append((fn(torch.device("cuda")), time.time() - t0))
    except BaseException:
        sys.stderr.write(buf.getvalue())
        raise
    return buf.getvalue(), outs, _SPEC_T["wait"]


# the side processes: phases 7 and 8; phases 9 and 12 (12's four ranks in
# the room 9b has returned: beside the four other processes, a fifth
# phase's process ran out of the card's memory); phases 10 and 6; phases
# 11 and 3
_SIDE = ((phase_mtt, phase_lmcs), (phase_bitdepth_tiles, phase_dist),
         (phase_ctc_tools, phase_ra_tools), (phase_scc_ctu128, phase_full))


def _share(shared, name, fut):
    """Done-callback of a spec model run: its result (or its error, as a
    string) into the dict the side processes read."""
    try:
        shared[name] = fut.result()[:3]
    except BaseException as e:      # the side process raises it
        shared[name] = f"{type(e).__name__}: {e}"


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

    # the spec model's side of phases 2, 5a, 6a, 7a, 8a, 9a, 10a and 11a is
    # host work: two worker processes run it while the card runs the
    # phases before them, and each result goes to the side processes
    # through a shared dict as soon as it is done
    ctx = multiprocessing.get_context("spawn")
    pool = ProcessPoolExecutor(max_workers=2, mp_context=ctx)
    mgr = ctx.Manager()
    shared = mgr.dict()
    # after phase 4 the script runs in five processes: phase 5 here,
    # phases 7 and 8 in a second, phases 9 and 12 in a third (12's four
    # ranks after 9b), phases 10 and 6 in a fourth, phases 11 and 3 in a
    # fifth; each phase's host is one core and its card mostly idle, and
    # one after the other they would leave the script no margin within its
    # limit.  Their walls and busy shares are those of a card the five
    # share (a sixth process saturated the card and left phase 9b's 28 GiB
    # too little of its memory).
    side = [ProcessPoolExecutor(max_workers=1, mp_context=ctx)
            for _ in _SIDE]
    try:
        for name in _spec_clips():
            _SPEC[name] = pool.submit(_spec_run, name)
            _SPEC[name].add_done_callback(
                lambda f, n=name: _share(shared, n, f))
        krow, krow10 = timed("phase 1 me_sad", phase_kernels)
        drow = timed("phase 1 dq_trellis", phase_dq_kernel)
        timed("phase 2", phase_small)
        launches = timed("phase 4", phase_ra)
        futs = [ex.submit(_phase_proc, shared, fns)
                for ex, fns in zip(side, _SIDE)]
        launches += timed("phase 5", phase_ai)
        outs = {}
        for fut, fns in zip(futs, _SIDE):
            t0 = time.time()
            text, res, waited = fut.result()
            print(text, end="")
            outs.update((fn.__name__, out) for fn, (out, _) in zip(fns, res))
            print("[time] " + " and ".join(
                f"{fn.__name__} {t:.1f} s" for fn, (_, t) in zip(fns, res))
                + " in a process of their own, beside the others (waited "
                f"{waited:.1f} s for spec model results; then main waited "
                f"for it {time.time() - t0:.1f} s)")
    finally:
        for ex in (*side, pool):
            ex.shutdown(wait=True, cancel_futures=True)
        mgr.shutdown()
    print(f"[time] spec model side in the workers: "
          f"{sum(f.result()[3] for f in _SPEC.values()):.1f} s; the main "
          f"process's phases waited {_SPEC_T['wait']:.1f} s for it")
    me7, dq7, dq_err7 = outs["phase_mtt"]
    me8, dq8 = outs["phase_lmcs"]
    me9, dq9 = outs["phase_bitdepth_tiles"]
    me4, dq_launches, dq_err = outs["phase_ra_tools"]
    me10, dq10, me_err10, i0_10 = outs["phase_ctc_tools"]
    me11, dq11, i0_11 = outs["phase_scc_ctu128"]
    me12, dq12 = outs["phase_dist"]
    print(f"[11c] POC 0 (I, QP 32) at CTU 128: {i0_11[0]} bits, Y-PSNR "
          f"{i0_11[1]:.4f} dB; 10b's at CTU 64 (rate control leaves POC 0 "
          f"at QP 32): {i0_10[0]} bits, {i0_10[1]:.4f} dB")
    launches += outs["phase_full"]
    me_err = max(krow["max_abs_err"], krow10["max_abs_err"], me_err10)
    kernels = [dict(name="me_sad", route="cuda",
                    source="vvctpu_torch/csrc/me_sad.cu",
                    replaces="vvctpu/kernels/me_pallas.py:248",
                    launches=(launches + me4 + me7 + me8 + me9 + me10
                              + me11 + me12),
                    equal=me_err == 0, max_abs_err=me_err, ms=krow["ms"],
                    plain_ms=krow["plain_ms"], bound_ms=krow["bound_ms"],
                    bound_by=krow["bound_by"], library_ms=None),
               dict(name="dq_trellis", route="cuda",
                    source="vvctpu_torch/csrc/dq_trellis.cu",
                    replaces="vvctpu/kernels/transform.py:232 quantize_dq_j",
                    launches=(dq_launches + dq7 + dq8 + dq9 + dq10 + dq11
                              + dq12),
                    equal=max(drow["max_abs_err"], dq_err, dq_err7) == 0,
                    max_abs_err=max(drow["max_abs_err"], dq_err, dq_err7),
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
