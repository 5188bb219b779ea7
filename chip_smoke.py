"""Chip smoke test of the PyTorch/CUDA port (vvctpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. build the hand-written kernels and hold each against its plain PyTorch
   twin on the card at the main path's shapes (1088x1920 dense motion
   search, 7 and 11 keys), with timings;
2. exactness at a small size: a 3-frame 64x96 IPPP clip encoded on the
   card must equal the copied spec model's bitstream, decode on the card
   with hashes verified, and decode in the spec model; the transforms on
   the card must equal the CPU path on worst-case inputs;
3. the slice at full size: 4 frames of 1080p low-delay P (1 I + 3 P) at
   QP32 with WPP, encoded and decoded on the card, hashes verified, with
   the kernel launch counts of that run, the wall time per pipeline stage
   and the card's busy share sampled by nvidia-smi.

The last lines are a JSON object per kernel, the card's name and power
limit, and the result object.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# int32 ALU peak of one H100 SXM: 64 INT32 lanes per SM (a quarter of the
# 67 TFLOP/s float32 rate, which counts 128 lanes and a fused
# multiply-add as two operations)
INT32_OPS_PER_S = 67e12 / 4
HBM_BYTES_PER_S = 3.35e12


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


def me_sad_bound_ms(H: int, W: int, keys):
    """(least time in ms, what bounds it) for the dense search on this
    card: the larger of the int32 operations over the int32 peak (per
    offset: subtract, absolute value and accumulate per pixel; per key
    block the granule adds, the cost (shift, multiply, add) and the
    compare-select) and the bytes (both planes read once, the outputs
    written once) over the memory rate."""
    from vvctpu_torch.kernels import me_sad as kme
    n_off = (2 * 16 + 1) ** 2
    ops_off = 3 * H * W
    out_words = 0
    for k in keys:
        bh, bw, *_ = kme.KEY_GEOM[k]
        nby, nbx = kme._grid(k, H, W)
        blocks = nby * nbx
        ops_off += blocks * ((bh // 8) * (bw // 8) - 1) + 6 * blocks
        out_words += 3 * blocks
    ops_ms = n_off * ops_off / INT32_OPS_PER_S * 1e3
    nbytes = 4 * (H * W + (H + 32) * (W + 32) + out_words)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def phase_kernels(dev):
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.spec.decide import lambda_satd_fp
    t0 = time.time()
    log = kme.build(verbose=True)
    print(f"[1] me_sad built in {time.time() - t0:.1f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1]   {line.strip()}")
    H, W = 1088, 1920
    rng = np.random.default_rng(1)
    orig = rng.integers(0, 256, (H, W)).astype(np.int32)
    ref = (np.roll(orig, (3, -5), (0, 1))
           + rng.integers(-6, 7, (H, W))).clip(0, 255).astype(np.int32)
    go = torch.as_tensor(orig, device=dev)
    gr = torch.as_tensor(np.pad(ref, 16, mode="edge"), device=dev)
    lam = lambda_satd_fp(32)
    rows = {}
    for tt in (False, True):
        got = kme.me_sad(go, gr, lam, tt=tt)
        want = kme.me_sad_reference(go, gr, lam, tt=tt)
        torch.cuda.synchronize()
        err = max(int((a - b).abs().max()) for g, w_ in zip(got, want)
                  for a, b in zip(g, w_))
        if err != 0:
            raise AssertionError(f"me_sad differs from its twin (tt={tt}): "
                                 f"max abs err {err}")
        ms = cuda_ms(lambda: kme.me_sad(go, gr, lam, tt=tt), 20)
        plain = cuda_ms(lambda: kme.me_sad_reference(go, gr, lam, tt=tt), 3)
        keys = kme.KEYS[:11 if tt else 7]
        bound, by = me_sad_bound_ms(H, W, keys)
        rows[tt] = dict(ms=ms, plain_ms=plain, max_abs_err=err,
                        bound_ms=bound, bound_by=by)
        print(f"[1] me_sad {H}x{W} keys={len(keys)}: equal to twin "
              f"(tolerance 0, max abs err {err}); "
              f"kernel {ms:.3f} ms, twin {plain:.1f} ms, "
              f"bound {rows[tt]['bound_ms']:.3f} ms, "
              f"launches so far {kme.launches}")
    return rows[False]


def phase_small(dev):
    from vvctpu_torch.core import rom
    from vvctpu_torch.kernels import transform as ktf
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    frames = motion_frames()
    cfg = tseq.EncoderConfig(qp=32, intra_period=0)
    data, recons, _ = tenc.encode_sequence(frames, cfg, device=dev)
    sdata, _, _ = tseq.encode_sequence(frames, cfg)
    if data != sdata:
        raise AssertionError("64x96 IPPP: card bitstream != spec model's")
    out, _ = tenc.decode_sequence(data, check_hash=True, device=dev)
    sout, _ = tseq.decode_sequence(data, check_hash=True)
    for a, b, c in zip(recons, out, sout):
        for i in range(3):
            if not (np.array_equal(a[i], b[i]) and np.array_equal(b[i], c[i])):
                raise AssertionError("64x96 IPPP: recon/decoder mismatch")
    print(f"[2] 64x96 IPPP: {len(data)} bytes equal to the spec model; "
          "card and spec decoders verified hashes")

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
    return f"[3] {tag} stages (wall {wall:.2f} s): {parts}"


def phase_full(dev):
    from vvctpu_torch.kernels import me_sad as kme
    from vvctpu_torch.pipeline import encoder as tenc
    from vvctpu_torch.spec import sequence as tseq
    n = 4
    frames = synth_frames(n, 1080, 1920)
    cfg = tseq.EncoderConfig(qp=32, intra_period=0, wpp=True)
    enc_t, dec_t = {}, {}
    kme.launches = 0
    torch.cuda.synchronize()
    with GpuBusy() as busy_enc:
        t0 = time.time()
        data, recons, bits = tenc.encode_sequence(frames, cfg, device=dev,
                                                  stage_times=enc_t)
        torch.cuda.synchronize()
        t_enc = time.time() - t0
    with GpuBusy() as busy_dec:
        t0 = time.time()
        out, _ = tenc.decode_sequence(data, check_hash=True, device=dev,
                                      stage_times=dec_t)
        torch.cuda.synchronize()
        t_dec = time.time() - t0
    launches = kme.launches
    n_p = n - 1
    if launches != n_p:
        raise AssertionError(f"me_sad launched {launches} times on the "
                             f"main path, expected {n_p} (one per P frame)")
    for a, b in zip(recons, out):
        for i in range(3):
            if not np.array_equal(a[i], b[i]):
                raise AssertionError("1080p: encoder recon != decoder output")
    psnr = [float(tseq.psnr(f[0], r[0])) for f, r in zip(frames, recons)]
    for p in psnr:
        if not np.isfinite(p) or p < 25.0:
            raise AssertionError(f"1080p: implausible Y-PSNR {p}")
    print(f"[3] 1080p IPPP QP32 WPP, {n} frames (1 I + {n_p} P): encode "
          f"{t_enc:.2f} s ({n / t_enc:.4f} fps), decode {t_dec:.2f} s "
          f"({n / t_dec:.4f} fps), hashes verified, recon == decoded")
    print(f"[3] bits/frame {sum(bits) / n:.1f} (per frame {bits}); "
          f"Y-PSNR mean {np.mean(psnr):.4f} dB (per frame "
          f"{[round(p, 4) for p in psnr]})")
    print(_stages_line("encode", enc_t, t_enc))
    print(_stages_line("decode", dec_t, t_dec))
    print(f"[3] card busy (nvidia-smi utilization.gpu mean): encode "
          f"{busy_enc.share:.1f} % over {busy_enc.samples} samples, decode "
          f"{busy_dec.share:.1f} % over {busy_dec.samples} samples")
    print(f"[3] me_sad launches on the main path: {launches}")
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    krow = phase_kernels(dev)
    phase_small(dev)
    launches = phase_full(dev)
    kernels = [dict(name="me_sad", route="cuda",
                    source="vvctpu_torch/csrc/me_sad.cu",
                    replaces="vvctpu/kernels/me_pallas.py:248",
                    launches=launches, equal=krow["max_abs_err"] == 0,
                    max_abs_err=krow["max_abs_err"], ms=krow["ms"],
                    plain_ms=krow["plain_ms"], bound_ms=krow["bound_ms"],
                    bound_by=krow["bound_by"], library_ms=None)]
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
