// Dense +-16 integer motion search for Hopper (sm_90a).
//
// Replaces the TPU kernel vvctpu/kernels/me_pallas.py me_sad_pallas: for
// every offset (dy, dx) in [-16, 16]^2, taken in row-major order, the SAD
// of the original frame against the shifted reference is summed per 8x8
// granule, then per key geometry (squares 8/16/32, the four BT rectangles
// and, with TT, the 32x8 / 8x32 keys and the two TT middle stripes).  The
// cost per key block is (SAD << 8) + lam * (2 + 2*bitlen(dx) + 2*bitlen(dy))
// in wrapping int32 arithmetic, and a running strict-less minimum keeps the
// first offset that reaches the smallest cost.
//
// Design: one thread block per 64x64 tile of the frame.  Every key block
// (the TT stripes included) lies inside one 64x64 tile, so a block needs
// only its tile and the (64 + 32)^2 reference window around it, which it
// keeps in shared memory.  Each of the 256 threads holds 16 original
// pixels (two rows of one 8x8 granule) in registers; per offset it sums
// their absolute differences, four neighbouring lanes reduce to the
// granule SAD, and the 64 granule SADs go to shared memory.  After one
// barrier each thread that owns a key block (at most 204 per tile) sums
// its granules and updates its running (cost, dx, dy).  Offsets are walked
// in the reference order inside the block, so ties break exactly as in
// the reference.  The 64 granule SADs are double-buffered, so one barrier
// per offset is enough.
//
// Bound: int32 ALU work (about 2.3 G absolute differences per 1080p
// reference, each a load, a subtract, an absolute value and an add);
// memory traffic is about 20 MB per call.
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr int R = 16;                 // ME_RANGE
constexpr int TILE = 64;
constexpr int WIN = TILE + 2 * R;     // 96: reference window side
constexpr int WSTRIDE = WIN + 1;      // padded row stride (bank spread)
constexpr int NTHREADS = 256;
constexpr int MAX_KEYS = 11;

// key geometry in pixels: block h, block w, stride y, stride x, offset y,
// offset x -- the order of vvctpu_torch.kernels.me_sad.KEYS
__constant__ int c_geom[MAX_KEYS][6] = {
    {8, 8, 8, 8, 0, 0},        // 8
    {16, 16, 16, 16, 0, 0},    // 16
    {32, 32, 32, 32, 0, 0},    // 32
    {8, 16, 8, 16, 0, 0},      // (16, 8)
    {16, 8, 16, 8, 0, 0},      // (8, 16)
    {16, 32, 16, 32, 0, 0},    // (32, 16)
    {32, 16, 32, 16, 0, 0},    // (16, 32)
    {8, 32, 8, 32, 0, 0},      // (32, 8)
    {32, 8, 32, 8, 0, 0},      // (8, 32)
    {16, 32, 32, 32, 8, 0},    // tth_mid
    {32, 16, 32, 32, 0, 8},    // ttv_mid
};

__device__ __forceinline__ int bitlen(int v) {
  const unsigned a = static_cast<unsigned>(v < 0 ? -v : v);
  return a ? 32 - __clz(a) : 0;
}

__global__ void __launch_bounds__(NTHREADS)
me_sad_kernel(const int* __restrict__ orig, const int* __restrict__ refp,
              int H, int W, int lam, int nkeys, int* __restrict__ cost_out,
              int* __restrict__ dx_out, int* __restrict__ dy_out) {
  __shared__ int s_ref[WIN * WSTRIDE];
  __shared__ int s_sad[2][64];
  const int tid = threadIdx.x;
  const int ty0 = blockIdx.y * TILE;
  const int tx0 = blockIdx.x * TILE;
  const int rw = W + 2 * R;

  for (int i = tid; i < WIN * WIN; i += NTHREADS) {
    const int r = i / WIN, c = i - (i / WIN) * WIN;
    s_ref[r * WSTRIDE + c] = refp[(size_t)(ty0 + r) * rw + tx0 + c];
  }

  // this thread's 16 original pixels: rows 2q, 2q+1 of granule g
  const int g = tid >> 2, q = tid & 3;
  const int py = (g >> 3) * 8 + 2 * q;
  const int px = (g & 7) * 8;
  int o[16];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      o[r * 8 + c] = orig[(size_t)(ty0 + py + r) * W + tx0 + px + c];

  // the key block this thread owns, if any
  int key = -1, kb = 0, first = 0;
  for (int k = 0, acc = 0; k < nkeys; ++k) {
    const int nb = (TILE / c_geom[k][2]) * (TILE / c_geom[k][3]);
    if (key < 0 && tid < acc + nb) {
      key = k;
      kb = tid - acc;
    }
    acc += nb;
  }
  int gy0 = 0, gx0 = 0, gh = 0, gw = 0;
  size_t out_idx = 0;
  if (key >= 0) {
    for (int k = 0; k < key; ++k)
      first += (H / c_geom[k][2]) * (W / c_geom[k][3]);
    const int bh = c_geom[key][0], bw = c_geom[key][1];
    const int sy = c_geom[key][2], sx = c_geom[key][3];
    const int cols = TILE / sx;
    const int br = kb / cols, bc = kb - (kb / cols) * cols;
    gy0 = (br * sy + c_geom[key][4]) >> 3;
    gx0 = (bc * sx + c_geom[key][5]) >> 3;
    gh = bh >> 3;
    gw = bw >> 3;
    const int nbx = W / sx;
    out_idx = (size_t)first +
              (size_t)(blockIdx.y * (TILE / sy) + br) * nbx +
              blockIdx.x * cols + bc;
  }
  __syncthreads();

  int best = INT_MAX, bdx = 0, bdy = 0;
  int it = 0;
  for (int dy = -R; dy <= R; ++dy) {
    const int ybits = 2 * bitlen(dy);
    for (int dx = -R; dx <= R; ++dx, ++it) {
      const int* rp = s_ref + (py + dy + R) * WSTRIDE + px + dx + R;
      int s = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c)
          s += abs(o[r * 8 + c] - rp[r * WSTRIDE + c]);
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      const int buf = it & 1;
      if (q == 0) s_sad[buf][g] = s;
      __syncthreads();
      if (key >= 0) {
        int sad = 0;
        for (int a = 0; a < gh; ++a)
          for (int b = 0; b < gw; ++b)
            sad += s_sad[buf][(gy0 + a) * 8 + gx0 + b];
        const unsigned bits = 2u + 2u * bitlen(dx) + ybits;
        const int cst = static_cast<int>((static_cast<unsigned>(sad) << 8) +
                                         static_cast<unsigned>(lam) * bits);
        if (cst < best) {
          best = cst;
          bdx = dx;
          bdy = dy;
        }
      }
    }
  }
  if (key >= 0) {
    cost_out[out_idx] = best;
    dx_out[out_idx] = bdx;
    dy_out[out_idx] = bdy;
  }
}

}  // namespace

// orig: (H, W) int32; refp: (H + 32, W + 32) int32, both contiguous on the
// device; H and W multiples of 64; nkeys 7 or 11.  Outputs: per-key block
// grids laid end to end in KEYS order.  Returns cudaGetLastError().
extern "C" int me_sad_launch(const int* orig, const int* refp, int H, int W,
                             int lam, int nkeys, int* cost, int* dx, int* dy,
                             void* stream) {
  const dim3 grid(W / TILE, H / TILE);
  me_sad_kernel<<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      orig, refp, H, W, lam, nkeys, cost, dx, dy);
  return static_cast<int>(cudaGetLastError());
}
