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
// The 12 candidates reduce exactly to two per target state: the step
// cost depends only on the quantizer (Q0 for states 0/1, Q1 for 2/3), and
// a target is reached from two fixed (state, parity) pairs, so per
// quantizer only the best even level (0 before the even one of lf,
// lf + 1, strict less) and the odd one matter.  DQ_TRANS = ((0, 2),
// (2, 0), (1, 3), (3, 1)): target t is reached from state 2 (t & 1) (x)
// and from state 2 (t & 1) + 1 (y), with even parity from x for t < 2
// and odd parity from x for t >= 2.  The lower state comes first, so y
// needs strict less; one bit per target (y won) is the back-pointer.
//
// What bounds it: a serial chain of n positions per TB whose step is a
// few dependent integer operations.  A thread per TB, with all of a
// position's arithmetic in front of its step and the back-pointers in a
// global scratch, ran at about 1600 cycles per position on an H100.
// Design here: L lanes per TB (L = 32, a warp per TB, at the main path's
// small batches; 16 or 8 as the batch grows, 32 / L TBs to a warp,
// chosen by kernels/dq.py lanes_for), in tiles of L positions:
//   - the warp's TBs, consecutive in memory, are copied into shared
//     memory in one asynchronous copy and gathered there in walk order;
//     the levels go back out coalesced;
//   - off the chain, each lane takes one position of the tile (a tile
//     ahead, during the chain before): the walk index, the coefficient,
//     both floor levels and the four step costs, staged in shared
//     memory, and the two even-level choices, kept beside the
//     coefficient;
//   - the chain: every lane of the TB runs the same four running costs
//     over the tile's L positions, one broadcast shared-memory read and
//     four dependent integer operations per position (the recurrence's
//     depth; Hopper's fused add-min, __viaddmin_s32, takes a sum and a
//     minimum in one), storing the costs entering each position;
//   - the tile's 4-bit back-pointers, one position per lane, from those
//     costs and the steps, packed 8 to a word in shared memory (n / 2
//     bytes per TB, no global scratch);
//   - the trace back, two dependent operations per position, turns the
//     bits into each position's target state and bit: L / 4 chunks of
//     the walk at once, each from the 4 states it may end in, then the
//     true ends chained over the chunks;
//   - every lane recovers its positions' levels in parallel from
//     (coefficient, choices, target state, bit) and writes sign * level.
// The gather into walk order, the signs and the scatter back are inside:
// a quantize call is this one launch.

#include <algorithm>
#include <cstdint>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kCoeffMin = -32768;
constexpr int kCoeffMax = 32767;
constexpr int kBig = 1 << 28;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxWarps = 4;         // warps per CTA
constexpr int kSmemLimit = 96 * 1024;  // dynamic shared memory per CTA

// The quantizers' scalars, and the dequantizer's net shift as a clamp, a
// left shift, a rounding offset and a right shift (one of the two shifts
// is 0), so that no position branches on its sign.
struct Params {
  int qscale, q_bits, iq, lam;
  int lim, up, rnd, dn;
};

__device__ __forceinline__ int deq(int l, bool q1, const Params& p) {
  int t = (2 * l - ((q1 && l > 0) ? 1 : 0)) * p.iq;
  int c = ((min(max(t, -p.lim), p.lim) << p.up) + p.rnd) >> p.dn;
  return min(max(c, kCoeffMin), kCoeffMax);
}

__device__ __forceinline__ int step_cost(int a, int l, bool q1,
                                         const Params& p) {
  int d = min(abs(a - deq(l, q1, p)), 30000);
  int rate = l > 0 ? 2 + 2 * (32 - __clz(l)) : 0;
  return (d * d + p.lam * rate) >> 4;
}

// the zero level's step cost: deq(0) = 0 and rate(0) = 0 in both
// quantizers
__device__ __forceinline__ int zero_cost(int a) {
  int d = min(a, 30000);
  return (d * d) >> 4;
}

__device__ __forceinline__ int floor_level(int a, bool q1, const Params& p) {
  int u = (a * p.qscale) >> (p.q_bits - 1);
  return min((q1 ? u + 1 : u) >> 1, kCoeffMax - 1);
}

// The four step costs of |coefficient| a: the best even level's and the
// odd level's, for Q0 (.x, .y) and Q1 (.z, .w).  The best even level is
// 0 unless the even one of lf, lf + 1 is strictly cheaper, so its cost is
// the minimum of the two; ``evens`` gets bit q set where it is that one.
__device__ __forceinline__ int4 step_costs(int a, const Params& p,
                                           unsigned& evens) {
  int step0 = zero_cost(a);
  int lf0 = floor_level(a, false, p), lf1 = floor_level(a, true, p);
  int e0 = step_cost(a, lf0 + (lf0 & 1), false, p);
  int e1 = step_cost(a, lf1 + (lf1 & 1), true, p);
  evens = (unsigned)(e0 < step0) | (unsigned)(e1 < step0) << 1;
  return make_int4(min(e0, step0), step_cost(a, lf0 + 1 - (lf0 & 1), false, p),
                   min(e1, step0), step_cost(a, lf1 + 1 - (lf1 & 1), true, p));
}

// The level chosen at a position whose target state is t and whose
// back-pointer bit is y: the quantizer is Q1 for odd targets, the
// parity is y ^ (t >> 1); odd takes the odd level, even the best even
// (bit q of ``evens``, from step_costs).
__device__ __forceinline__ int level_of(int a, int t, int y, unsigned evens,
                                        const Params& p) {
  int lf = floor_level(a, t & 1, p);
  int even = (evens >> (t & 1)) & 1 ? lf + (lf & 1) : 0;
  return ((y ^ (t >> 1)) & 1) ? lf + 1 - (lf & 1) : even;
}

// A coefficient in shared memory keeps its value in bits 0-19 and, once
// its steps are computed, their ``evens`` in bits 20-21.
__device__ __forceinline__ int coef_of(int w) {
  return (int)((unsigned)w << 12) >> 12;
}

// One position of the chain: the four running costs after it.  Target 0
// from (0, even), (1, odd); 1 from (2, even), (3, odd); 2 from (0, odd),
// (1, even); 3 from (2, odd), (3, even).  The minimum over the four new
// costs is each quantizer's cheaper step on its two states' cheaper
// cost, so it comes off the costs beside the four minima:
//   depth 1: c_y + step_y, min(c0, c1), min(c2, c3);
//   depth 2: n_t = min(c_x + step_x, c_y + step_y) (one fused add-min),
//            -min(c0, c1) - min(se0, so0), -min(c2, c3) - min(se1, so1);
//   depth 3: -m, the larger of those two;
//   depth 4: min(n_t - m, 2^28) (one fused add-min).
__device__ __forceinline__ void advance(int& c0, int& c1, int& c2, int& c3,
                                        int4 s) {
  int n0 = __viaddmin_s32(c0, s.x, c1 + s.y);
  int n1 = __viaddmin_s32(c2, s.z, c3 + s.w);
  int n2 = __viaddmin_s32(c0, s.y, c1 + s.x);
  int n3 = __viaddmin_s32(c2, s.w, c3 + s.z);
  int negm = max(-min(c0, c1) - min(s.x, s.y), -min(c2, c3) - min(s.z, s.w));
  c0 = __viaddmin_s32(n0, negm, kBig);
  c1 = __viaddmin_s32(n1, negm, kBig);
  c2 = __viaddmin_s32(n2, negm, kBig);
  c3 = __viaddmin_s32(n3, negm, kBig);
}

// The back-pointer bits of a position (bit t: target t came from its
// higher source state), from the costs entering it and its steps.
__device__ __forceinline__ unsigned choice_bits(int4 c, int4 s) {
  return (unsigned)(c.y + s.y < c.x + s.x)
         | (unsigned)(c.w + s.w < c.z + s.z) << 1
         | (unsigned)(c.y + s.x < c.x + s.y) << 2
         | (unsigned)(c.w + s.z < c.z + s.w) << 3;
}

// coef, out: (B, n) int32 signed raster coefficients and levels; walk:
// (n,) raster index of each walk step.  Warp w of the grid takes TBs
// w * K .. w * K + K - 1 (K = 32 / L), lanes g * L .. g * L + L - 1 the
// g-th of them.  Shared memory per warp (warp_smem): the tile's steps and
// entering costs ([position][TB] int4, 1 KiB), the TBs' bit words (n / 8
// each), the TBs' coefficients, then levels (n + 1 words each, the
// padding word spreading the TBs over the banks) and the trace back's 4
// copies of each TB's words.
template <int L>
__global__ void __launch_bounds__(kMaxWarps * 32)
dq_trellis_kernel(const int* __restrict__ coef, const int* __restrict__ walk,
                  int* __restrict__ out, int n, int B, Params p) {
  constexpr int K = 32 / L;
  extern __shared__ int4 smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane / L, i = lane % L;
  const int b0 = (blockIdx.x * warps + warp) * K;
  if (b0 >= B) return;  // the whole warp lies past the batch
  const int live = min(K, B - b0);  // TBs of this warp in the batch
  const int nw = n >> 3;
  int4* sbuf = smem + warp * 64;
  int4* cbuf = sbuf + 32;
  unsigned* base = reinterpret_cast<unsigned*>(smem + warps * 64);
  unsigned* bits = base + (size_t)(warp * K + g) * nw;
  int* sc = reinterpret_cast<int*>(base + (size_t)warps * K * nw)
            + (size_t)warp * K * (n + 1);
  int* scg = sc + g * (n + 1);
  unsigned* hyp = base + (size_t)warps * K * (nw + n + 1)
                  + (size_t)(warp * K + g) * 4 * (nw + 1);
  const int tiles = n / L;

  // the warp's TBs are consecutive in memory: copy them in, all loads in
  // flight at once; TBs past the batch are zeros and are not written
  const int* src = coef + (size_t)b0 * n;
  for (int q = 0; q < K; ++q)
    for (int r = lane; r < n; r += 32) {
      if (q < live)
        __pipeline_memcpy_async(sc + q * (n + 1) + r, src + q * n + r, 4);
      else
        sc[q * (n + 1) + r] = 0;
    }
  __pipeline_commit();
  int r_next = walk[i];
  __pipeline_wait_prior(0);
  __syncwarp();

  // each tile's steps are computed during the chain of the tile before
  // (the last tile's twice, to the same result), their choices stored
  // after that chain so that its shared-memory traffic does not wait
  int v = coef_of(scg[r_next]);
  unsigned evens;
  int4 s_cur = step_costs(abs(v), p, evens);
  scg[r_next] = (v & 0xFFFFF) | (int)(evens << 20);
  r_next = walk[min(1, tiles - 1) * L + i];
  int c0 = 0, c1 = kBig, c2 = kBig, c3 = kBig;
  for (int t = 0; t < tiles; ++t) {
    __syncwarp();
    sbuf[i * K + g] = s_cur;
    __syncwarp();
    const int r_steps = r_next;
    v = coef_of(scg[r_steps]);
    int4 s_next = step_costs(abs(v), p, evens);
    r_next = walk[min(t + 2, tiles - 1) * L + i];
#pragma unroll
    for (int k = 0; k < L; ++k) {
      int4 st = sbuf[k * K + g];
      cbuf[k * K + g] = make_int4(c0, c1, c2, c3);
      advance(c0, c1, c2, c3, st);
    }
    __syncwarp();
    // the tile's bits, 8 positions' nibbles to a word (position j at bits
    // 4 (j & 7) of word j >> 3)
    unsigned nib = choice_bits(cbuf[i * K + g], s_cur);
#pragma unroll
    for (int d = 1; d < 8; d *= 2)
      nib |= __shfl_down_sync(kFull, nib, d) << (4 * d);
    if ((i & 7) == 0) bits[(t * L + i) >> 3] = nib;
    scg[r_steps] = (v & 0xFFFFF) | (int)(evens << 20);
    s_cur = s_next;
  }
  __syncwarp();
  // the first cheapest final state, then the trace back: the state before
  // position j is 2 (s_j & 1) + bit s_j of position j, two dependent
  // operations per position.  A walked word holds the target state (bits
  // 0-1) and the bit (bit 2) of its positions.  L / 4 chunks of whole
  // words (fewer for short walks) are each walked at once from each of
  // the 4 states it may end in, by its own lane, into its own copy; then
  // the true ends, from the last chunk down, one shuffle per chunk.
  unsigned s = 0;
  int best = c0;
  if (c1 < best) { s = 1; best = c1; }
  if (c2 < best) { s = 2; best = c2; }
  if (c3 < best) s = 3;
  const int nc = min(L / 4, nw);
  const int cshift = __ffs(nw / nc) - 1;  // log2 of the words per chunk
  const int c = i >> 2;
  unsigned st = i & 3;
  if (c < nc) {
    unsigned* copy = hyp + (i & 3) * (nw + 1);
    for (int w = ((c + 1) << cshift) - 1; w >= (c << cshift); --w) {
      unsigned word = bits[w], res = 0;
#pragma unroll
      for (int k = 7; k >= 0; --k) {
        unsigned y = (word >> (4 * k)) >> st & 1u;
        res |= (st | y << 2) << (4 * k);
        st = ((st << 1) & 2u) | y;
      }
      copy[w] = res;
    }
  }
  unsigned starts = 0;  // 2 bits per chunk: the state it truly ends in
  for (int cc = nc - 1; cc >= 0; --cc) {
    starts |= s << (2 * cc);
    s = __shfl_sync(kFull, st, g * L + cc * 4 + s);
  }
  __syncwarp();
  // each lane's positions: the level from (coefficient, target, bit), in
  // place of the coefficient; then the live TBs out, coalesced
#pragma unroll 4
  for (int t = 0; t < tiles; ++t) {
    int j = t * L + i;
    int r = walk[j];
    int cw = scg[r], v = coef_of(cw);
    const unsigned* words =
        hyp + ((starts >> (2 * (j >> 3 >> cshift))) & 3) * (nw + 1);
    unsigned ts = words[j >> 3] >> (4 * (j & 7));
    int lev =
        level_of(abs(v), ts & 3, (ts >> 2) & 1, (unsigned)cw >> 20, p);
    scg[r] = v < 0 ? -lev : lev;
  }
  __syncwarp();
  int* dst = out + (size_t)b0 * n;
  for (int q = 0; q < live; ++q)
    for (int r = lane; r < n; r += 32) dst[q * n + r] = sc[q * (n + 1) + r];
}

// bytes of shared memory one warp of dq_trellis_kernel<L> takes
constexpr size_t warp_smem(int n, int L) {
  return 64 * sizeof(int4)
         + (size_t)(32 / L) * (n / 8 + n + 1 + 4 * (n / 8 + 1)) * sizeof(int);
}

template <int L>
int launch(const int* coef, const int* walk, int* out, int n, int B,
           const Params& p, cudaStream_t stream) {
  constexpr int K = 32 / L;
  static bool opted_in = false;  // shared memory above 48 KiB
  if (!opted_in) {
    cudaError_t e = cudaFuncSetAttribute(
        dq_trellis_kernel<L>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemLimit);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  if (n < L) return (int)cudaErrorInvalidValue;
  size_t per_warp = warp_smem(n, L);
  int tbs_warps = (B + K - 1) / K;
  int warps = (int)(kSmemLimit / per_warp);
  if (warps < 1) return (int)cudaErrorInvalidValue;
  warps = std::min(std::min(warps, kMaxWarps), tbs_warps);
  int blocks = (tbs_warps + warps - 1) / warps;
  dq_trellis_kernel<L><<<blocks, warps * 32, warps * per_warp, stream>>>(
      coef, walk, out, n, B, p);
  return (int)cudaGetLastError();
}

}  // namespace

// coef: (B, n) int32 signed raster coefficients; walk: (n,) int32 raster
// index of each walk step; out: (B, n) int32 signed levels; lanes: lanes
// per TB, 32, 16 or 8, at most n; n a power of two, at least 8.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int dq_trellis_launch(const int* coef, const int* walk, int* out,
                                 int n, int B, int qscale, int q_bits,
                                 int iq, int net, int lam, int lanes,
                                 void* stream) {
  if (B <= 0 || n <= 0) return 0;
  if (n < 8 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  Params p{qscale, q_bits, iq, lam, 1 << 30, 0, 0, 0};
  if (net >= 0) {
    p.lim = 1 << (30 - net);
    p.up = net;
  } else {
    p.dn = -net;
    p.rnd = 1 << (-net - 1);
  }
  cudaStream_t st = (cudaStream_t)stream;
  switch (lanes) {
    case 32: return launch<32>(coef, walk, out, n, B, p, st);
    case 16: return launch<16>(coef, walk, out, n, B, p, st);
    case 8: return launch<8>(coef, walk, out, n, B, p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
