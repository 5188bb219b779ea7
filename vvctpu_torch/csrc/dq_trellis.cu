// Trellis dependent quantization (4-state Viterbi) for Hopper (sm_90a).
//
// A stage that earned a hand kernel, not a TPU kernel: the reference runs
// it as a lax.scan in vvctpu/kernels/transform.py:232 quantize_dq_j.  Per
// transform block (TB) the walk visits every coefficient position in
// coding order (reverse diagonal scan).  At each position each of the 4
// quantizer states offers three levels (0, lf, lf + 1), lf the active
// quantizer's floor level; each candidate costs
// (min(|a - deq|, 30000)^2 + lam * rate) >> 4 on top of its state's
// running cost and moves to DQ_TRANS[state][level & 1].  Each target
// state keeps the first minimum in (state-major, candidate-minor) order,
// the running costs are renormalised by their minimum and clamped at
// 2^28, and after the last position the first cheapest state is traced
// back.  Every intermediate fits int32: d^2 < 2^30, lam * rate < 2^27.
//
// Design: one thread per TB, serial over the positions.  The 12
// candidates reduce exactly to two per target state: the step cost
// depends only on the quantizer (Q0 for states 0/1, Q1 for 2/3), and a
// target is reached from two fixed (state, parity) pairs, so per
// quantizer only the best even level (0 before the even one of
// lf, lf + 1, strict less) and the odd one matter.  Back-pointers and
// levels go to a global scratch, one int32 per (position, state, TB)
// packed as (previous state << 16) | level.  Inputs, outputs and scratch
// are position-major ([position][TB]), so a warp's 32 threads touch 32
// consecutive words.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kCoeffMin = -32768;
constexpr int kCoeffMax = 32767;
constexpr int kBig = 1 << 28;

struct Params {
  int qscale, q_bits, iq, net, lam;
};

__device__ __forceinline__ int deq(int l, bool q1, const Params& p) {
  int t = (2 * l - ((q1 && l > 0) ? 1 : 0)) * p.iq;
  int c;
  if (p.net >= 0) {
    int lim = 1 << (30 - p.net);
    c = min(max(t, -lim), lim) << p.net;
  } else {
    int m = -p.net;
    c = (t + (1 << (m - 1))) >> m;
  }
  return min(max(c, kCoeffMin), kCoeffMax);
}

__device__ __forceinline__ int step_cost(int a, int l, bool q1,
                                         const Params& p) {
  int d = min(abs(a - deq(l, q1, p)), 30000);
  int rate = l > 0 ? 2 + 2 * (32 - __clz(l)) : 0;
  return (d * d + p.lam * rate) >> 4;
}

// best even (level, step) and the odd (level, step) of one quantizer
__device__ __forceinline__ void quantizer(int a, int lf, bool q1,
                                          int step0, const Params& p,
                                          int& lev_e, int& st_e, int& lev_o,
                                          int& st_o) {
  int e = lf + (lf & 1);
  int o = lf + 1 - (lf & 1);
  int se = step_cost(a, e, q1, p);
  if (se < step0) {
    lev_e = e;
    st_e = se;
  } else {
    lev_e = 0;
    st_e = step0;
  }
  lev_o = o;
  st_o = step_cost(a, o, q1, p);
}

__global__ void dq_trellis_kernel(const int* __restrict__ a_in,
                                  int* __restrict__ out,
                                  int* __restrict__ scratch, int n, int B,
                                  Params p) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int c0 = 0, c1 = kBig, c2 = kBig, c3 = kBig;
  for (int j = 0; j < n; ++j) {
    int a = a_in[(size_t)j * B + b];
    int u = (a * p.qscale) >> (p.q_bits - 1);
    int lf0 = min(u >> 1, kCoeffMax - 1);
    int lf1 = min((u + 1) >> 1, kCoeffMax - 1);
    int step0 = step_cost(a, 0, false, p);  // deq(0) = 0 in both
    int le0, se0, lo0, so0, le1, se1, lo1, so1;
    quantizer(a, lf0, false, step0, p, le0, se0, lo0, so0);
    quantizer(a, lf1, true, step0, p, le1, se1, lo1, so1);
    // DQ_TRANS = ((0, 2), (2, 0), (1, 3), (3, 1)): target t from
    // (state, parity): 0 <- (0, even), (1, odd); 1 <- (2, even),
    // (3, odd); 2 <- (0, odd), (1, even); 3 <- (2, odd), (3, even).
    // The lower state comes first, so the higher one needs strict less.
    int n0, n1, n2, n3, r0, r1, r2, r3;
    {
      int x = c0 + se0, y = c1 + so0;
      n0 = y < x ? y : x;
      r0 = y < x ? ((1 << 16) | lo0) : le0;
    }
    {
      int x = c2 + se1, y = c3 + so1;
      n1 = y < x ? y : x;
      r1 = y < x ? ((3 << 16) | lo1) : ((2 << 16) | le1);
    }
    {
      int x = c0 + so0, y = c1 + se0;
      n2 = y < x ? y : x;
      r2 = y < x ? ((1 << 16) | le0) : lo0;
    }
    {
      int x = c2 + so1, y = c3 + se1;
      n3 = y < x ? y : x;
      r3 = y < x ? ((3 << 16) | le1) : ((2 << 16) | lo1);
    }
    int m = min(min(n0, n1), min(n2, n3));
    c0 = min(n0 - m, kBig);
    c1 = min(n1 - m, kBig);
    c2 = min(n2 - m, kBig);
    c3 = min(n3 - m, kBig);
    int* sp = scratch + (size_t)j * 4 * B + b;
    sp[0] = r0;
    sp[B] = r1;
    sp[2 * B] = r2;
    sp[3 * B] = r3;
  }
  // first cheapest final state, then the trace back
  int s = 0, best = c0;
  if (c1 < best) { s = 1; best = c1; }
  if (c2 < best) { s = 2; best = c2; }
  if (c3 < best) { s = 3; }
  for (int j = n - 1; j >= 0; --j) {
    int v = scratch[((size_t)j * 4 + s) * B + b];
    out[(size_t)j * B + b] = v & 0xFFFF;
    s = v >> 16;
  }
}

}  // namespace

// a: (n, B) int32 absolute coefficients, position-major in walk order;
// out: (n, B) int32 levels; scratch: n * 4 * B int32.  Returns the CUDA
// error code of the launch (0 on success).
extern "C" int dq_trellis_launch(const int* a, int* out, int* scratch,
                                 int n, int B, int qscale, int q_bits,
                                 int iq, int net, int lam, void* stream) {
  if (B <= 0 || n <= 0) return 0;
  Params p{qscale, q_bits, iq, net, lam};
  int threads = 128;
  int blocks = (B + threads - 1) / threads;
  dq_trellis_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      a, out, scratch, n, B, p);
  return (int)cudaGetLastError();
}
