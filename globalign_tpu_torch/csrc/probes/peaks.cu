// peaks.cu — probes of the least time this card can take for the work of
// the port's kernels, for the bounds that chip_smoke.py reports beside
// each kernel's time.  Not on any path of the package: built and run only
// by the measurement (globalign_tpu_torch/utils/peaks.py).
//
// cells_kernel<MOVES>: the Gotoh cell's arithmetic with nothing else —
// no memory traffic, no barrier, no table lookup.  Thread t fills the
// pair (a_t repeated m times, b_t1..b_t8) in registers: sub8[t] holds
// cost(a_t, b_tc), d8[t] dcost(b_tc), icost[t] icost(a_t).  That is a
// real fill (the default boundary of fill_scan.py, BIG = 1 << 30 clamps,
// tie order M > Ix > Iy), so its final3 and codes are checked against
// the plain row scan; each cell is written in the fewest int32
// operations sm_90 needs, with the DPX fused add-min (__viaddmin_s32)
// and 3-way min (__vimin3_s32):
//   cost only, 9 a cell: M  vimin3, viaddmin (+sub, clamp);
//                        Iy min, viaddmin (+go), viaddmin (+ic, clamp);
//                        Ix min, viaddmin (+go vs the carry), add d, min;
//   with codes, 23: M  two vibmin (min + which), viaddmin, two selects;
//                   Iy vibmin, add go, vibmin, viaddmin, two selects;
//                   Ix the 4 above, two adds, two compares, two selects;
//                   packing, two shift-adds.
// MOVES folds each code into a running hash (one multiply-add: it stands
// in for the store of the code byte, which the byte bound counts).  The
// cells per second of a launch that fills the card are the peak rate of
// the fill's arithmetic.
//
// addmin_kernel: 8 independent chains a thread of x = __viaddmin_s32(x,
// y, z) — the issue rate of the DPX fused add-min, per clock per SM.
//
// chase_kernel: one thread's chain of dependent loads, k = next[k], timed
// by clock64 after a warm pass — the latency of one dependent load from
// L1 (a cycle within a few KB) or from L2 (a cycle over a few MB, one
// 128-byte line a step).  chase_smem_kernel: the same chain over a copy of
// next in shared memory — the latency of one dependent shared-memory load.
// walk_block's steps are such a chain: each reads a code byte from the
// tile it staged in shared memory, its first tile from L2 or beyond.
//
// Launch conventions: every launcher runs on the caller's stream,
// allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int COLS = 8;

template <bool MOVES>
__global__ void __launch_bounds__(256)
cells_kernel(const int* __restrict__ sub8, const int* __restrict__ d8,
             const int* __restrict__ icost, int go, int m, int T,
             int* __restrict__ out) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= T) return;
  int sub[COLS], d[COLS], uM[COLS], uX[COLS], uY[COLS];
  int acc = go;  // row 0: (BIG, go + D[j], BIG)
#pragma unroll
  for (int c = 0; c < COLS; ++c) {
    sub[c] = sub8[t * COLS + c];
    d[c] = d8[t * COLS + c];
    acc += d[c];
    uM[c] = BIG, uX[c] = acc, uY[c] = BIG;
  }
  const int ic = icost[t];
  int col0y = go;                 // Iy(i, 0)
  int eM = 0, eX = 0, eY = 0;     // cell (i-1, 0): the corner at i = 1
  unsigned hash = 0;
  for (int i = 1; i <= m; ++i) {
    int dM = eM, dX = eX, dY = eY;
    col0y += ic;
    int lM = BIG, lX = BIG, lY = col0y, lXu = BIG;
#pragma unroll
    for (int c = 0; c < COLS; ++c) {
      const int mp = uM[c], xp = uX[c], yp = uY[c];
      int mc, xc, yc, xu;
      if (MOVES) {
        bool p, q, r, s;
        const int m1 = __vibmin_s32(dX, dY, &p);     // p: dX <= dY
        const int best = __vibmin_s32(dM, m1, &q);   // q: dM <= min(dX, dY)
        mc = __viaddmin_s32(best, sub[c], BIG);
        const int cm = q ? 0 : (p ? 1 : 2);
        const int t2 = __vibmin_s32(mp, xp, &r);     // r: mp <= xp
        const int vy = __vibmin_s32(t2 + go, yp, &s);  // s: Iy opens
        yc = __viaddmin_s32(vy, ic, BIG);
        const int cy = s ? (r ? 0 : 1) : 2;
        xu = __viaddmin_s32(min(lM, lY), go, lXu) + d[c];
        xc = min(xu, BIG);
        const int cx = xc == lM + go + d[c] ? 0 : (xc == lX + d[c] ? 1 : 2);
        hash = hash * 31u + (unsigned)(cm + (cx << 2) + (cy << 4));
      } else {
        mc = __viaddmin_s32(__vimin3_s32(dM, dX, dY), sub[c], BIG);
        yc = __viaddmin_s32(__viaddmin_s32(min(mp, xp), go, yp), ic, BIG);
        xu = __viaddmin_s32(min(lM, lY), go, lXu) + d[c];
        xc = min(xu, BIG);
      }
      dM = mp, dX = xp, dY = yp;
      uM[c] = mc, uX[c] = xc, uY[c] = yc;
      lM = mc, lX = xc, lY = yc, lXu = xu;
    }
    eM = BIG, eX = BIG, eY = col0y;
  }
  out[4 * t] = uM[COLS - 1];
  out[4 * t + 1] = uX[COLS - 1];
  out[4 * t + 2] = uY[COLS - 1];
  out[4 * t + 3] = (int)hash;
}

__global__ void addmin_kernel(int y, int z, int iters, int* __restrict__ out) {
  int x[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) x[k] = threadIdx.x + k;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) x[k] = __viaddmin_s32(x[k], y, z);
  }
  int s = 0;
#pragma unroll
  for (int k = 0; k < 8; ++k) s ^= x[k];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

__global__ void chase_kernel(const int* __restrict__ next, int start, int warm,
                             int steps, long long* __restrict__ out) {
  int k = start;
  for (int s = 0; s < warm; ++s) k = next[k];
  const long long t0 = clock64();
  for (int s = 0; s < steps; ++s) k = next[k];
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = k;
}

__global__ void chase_smem_kernel(const int* __restrict__ next, int count,
                                  int start, int warm, int steps,
                                  long long* __restrict__ out) {
  extern __shared__ int ring[];
  for (int k = threadIdx.x; k < count; k += blockDim.x) ring[k] = next[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  volatile int* s = ring;
  int k = start;
  for (int n = 0; n < warm; ++n) k = s[k];
  const long long t0 = clock64();
  for (int n = 0; n < steps; ++n) k = s[k];
  const long long t1 = clock64();
  out[0] = t1 - t0;
  out[1] = k;
}

}  // namespace

extern "C" {

// T threads, each filling m rows x 8 columns; out is (T, 4) int32:
// final3 of its pair and the hash of its codes (0 without codes).
int peak_cells_launch(const void* sub8, const void* d8, const void* icost,
                      int go, int m, int T, int moves, void* out,
                      void* stream) {
  if (T < 1 || m < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const int blocks = (T + threads - 1) / threads;
  auto kernel = moves ? cells_kernel<true> : cells_kernel<false>;
  kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)sub8, (const int*)d8, (const int*)icost, go, m, T,
      (int*)out);
  return (int)cudaGetLastError();
}

// blocks x threads threads, 8 chains of `iters` fused add-mins each.
int peak_addmin_launch(int blocks, int threads, int y, int z, int iters,
                       void* out, void* stream) {
  if (blocks < 1 || threads < 1 || threads > 1024 || iters < 1)
    return (int)cudaErrorInvalidValue;
  addmin_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(y, z, iters,
                                                               (int*)out);
  return (int)cudaGetLastError();
}

// One thread: `warm` untimed steps, then `steps` timed ones; out is (2,)
// int64: the clocks of the timed steps and the index reached.
int peak_chase_launch(const void* next, int start, int warm, int steps,
                      void* out, void* stream) {
  if (warm < 0 || steps < 1) return (int)cudaErrorInvalidValue;
  chase_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const int*)next, start, warm, steps, (long long*)out);
  return (int)cudaGetLastError();
}

// The chase of peak_chase_launch over next[0..count) copied into shared
// memory (count <= 12 288 ints) by a block of 32 threads.
int peak_chase_smem_launch(const void* next, int count, int start, int warm,
                           int steps, void* out, void* stream) {
  if (count < 1 || count > 12288 || warm < 0 || steps < 1)
    return (int)cudaErrorInvalidValue;
  chase_smem_kernel<<<1, 32, count * (int)sizeof(int), (cudaStream_t)stream>>>(
      (const int*)next, count, start, warm, steps, (long long*)out);
  return (int)cudaGetLastError();
}

const char* peak_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
