// wave_split.cu — the anti-diagonal wavefront of the meet-in-the-middle
// cost for uniform schemes, on Hopper (sm_90a): two problems, a block each.
//
// What it replaces.  globalign_tpu/ops/fill_pallas.py:_make_wave_kernel
// (:1510), called with B = 2 by wave_split_fill_cost (:1690).  The TPU
// kernel stacked the two problems in one VPU instruction stream and kept
// each wave as (R, 128) lane tiles, shifting the previous waves one
// position by lane rolls and carrying seq_2's tokens in a shifted buffer
// because Mosaic has no per-lane gather.  Here each problem is a block,
// a thread owns a segment of DP rows, and the seq_2 token of cell (i, t-i)
// is read by index.  The join over the crossing anti-diagonal stays
// outside the kernel (ops/fill_wave.py), as in the JAX package.
//
// What it computes.  Problem p = blockIdx.x: 0 the pair forward, 1 both
// sequences reversed (row i holds tok_a[m+1-i], column j tok_b[n+1-j]).
// Row i of wave t is the cell (i, t-i).  For t = 1 .. cap1[p], every row
// the wave reaches (max(0, t-n) <= i <= min(t, m)) is
//   row 0:     (BIG, go + t*d, BIG)
//   column 0:  (BIG, BIG, go + t*ic)
//   otherwise  M  = min(min3(wave t-2, row i-1) + sub, BIG)
//              Ix = min(min(min(M, Iy)(wave t-1, row i) + go, Ix) + d, BIG)
//              Iy = min(min(min(M, Ix)(wave t-1, row i-1) + go, Iy) + ic, BIG)
// with sub = cmatch if the tokens agree, else cmismatch; wave 0 is the
// (0, 0, 0) corner.  out[p][k] (3, R) is wave cap_k[p] (M, Ix, Iy by row):
// the reached rows, BIG at every other row; a capture wave before 0 is all
// BIG.  Integers as the TPU kernel's, so the captures are bit-identical to
// the plain version (ops/fill_wave.py:_plain).
//
// Design.  Thread th owns rows th*S .. th*S+S-1 and keeps each row's state
// — (M, Ix, Iy) of the last wave and the min3 of the wave before, one int4
// — at state[r * T + th] (r the row in the segment), so a warp's accesses
// coalesce: in shared memory when it fits the card's opt-in limit (up to
// ~12 400 rows), else in a global scratch the wrapper allocates (L2 holds
// 0.8 MB at 50 000 rows).  In a wave a thread walks its reached rows from
// high to low: row i reads row i-1's state before row i-1 is updated, and
// carries it in registers as row i-1's own state.  Rows go K at a time,
// their K loads issued before any is used, so K latencies overlap.  The row
// below a segment comes from the neighbour thread's top row, published in
// a shared-memory double buffer by wave parity: one __syncthreads a wave.
//
// What bounds it on this card.  tmax ~ (m+n)/2 + 1 dependent waves, each a
// block barrier, and a cell's ~10 int32 operations issued by the one SM of
// its problem: the two problems use 2 of the 132 SMs by design (one pair,
// two problems).  With the state in shared memory the SM's issue rate bounds
// a wave; past it every wave reads and writes 32 bytes a cell of its window
// through that one SM's path to L2, which bounds it instead (PERF.md has the
// times).  K = 4 keeps the loop within the 64 registers a thread has at
// 1024 threads.
// More SMs a problem, and the state in registers, are later work.
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing (the caller passes the output and the scratch), and the launcher
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int BIG = 1 << 30;
constexpr int MAX_THREADS = 1024;
constexpr int K = 4;  // rows whose loads a thread issues together

__device__ __forceinline__ int4 big4() { return make_int4(BIG, BIG, BIG, BIG); }

template <bool SMEM>
__device__ __forceinline__ int4 load_state(const int4* p) {
  if (SMEM) return *p;
  return __ldcg(p);
}

template <bool SMEM>
__device__ __forceinline__ void store_state(int4* p, int4 v) {
  if (SMEM) *p = v;
  else __stcg(p, v);
}

template <bool SMEM>
__global__ void __launch_bounds__(MAX_THREADS)
wave_split_kernel(const int* __restrict__ tok_a, const int* __restrict__ tok_b,
                  int* __restrict__ out, int4* __restrict__ scratch, int R,
                  int m, int n, int cmatch, int cmismatch, int d, int ic,
                  int go, int cap00, int cap01, int cap10, int cap11, int S) {
  extern __shared__ int4 smem[];
  const int T = blockDim.x;
  const int th = threadIdx.x;
  const int p = blockIdx.x;
  int4* edge = smem;  // [2][T]: each thread's top row, by wave parity
  int4* st = SMEM ? smem + 2 * T : scratch + (long long)p * S * T;
  const int base = th * S;
  const int top = base + S - 1;
  const int cap0 = p ? cap10 : cap00;
  const int cap1 = p ? cap11 : cap01;
  int* o = out + (long long)p * 6 * R;

  // Wave 0: the corner at row 0, BIG elsewhere (min3 of wave -1: BIG).
  for (int r = 0; r < S; ++r)
    store_state<SMEM>(st + r * T + th,
                      base + r == 0 ? make_int4(0, 0, 0, BIG) : big4());
  edge[th] = edge[T + th] = top == 0 ? make_int4(0, 0, 0, BIG) : big4();
  // Output rows no capture wave writes: past m, and every row of a capture
  // wave <= 0 (wave 0: the corner; before it: BIG).
  for (int k = 0; k < 2; ++k) {
    const int cap = k ? cap1 : cap0;
    int* ok = o + k * 3 * R;
    for (int i = (cap > 0 ? m + 1 : 0) + th; i < R; i += T) {
      const int v = cap == 0 && i == 0 ? 0 : BIG;
      ok[i] = v, ok[R + i] = v, ok[2 * R + i] = v;
    }
  }
  __syncthreads();

  for (int t = 1; t <= cap1; ++t) {
    const int wlo = max(0, t - n), whi = min(t, m);  // the wave's rows
    const int lo = max(wlo, base), hi = min(whi, top);  // this thread's
    if (lo <= hi) {
      const int4 below = th ? edge[((t - 1) & 1) * T + th - 1] : big4();
      int4 own = load_state<SMEM>(st + (hi - base) * T + th);
      int4 published = own;
      for (int i = hi; i >= lo; i -= K) {
        int4 pv[K];
        int av[K], bv[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int r = i - k;  // the row computed; q = r - 1 its neighbour
          const int q = r - 1;
          const int j = t - r;
          if (r >= lo) {
            pv[k] = q >= base ? load_state<SMEM>(st + (q - base) * T + th)
                              : below;
            if (r > 0 && j > 0) {
              av[k] = __ldg(tok_a + (p ? m + 1 - r : r));
              bv[k] = __ldg(tok_b + (p ? n + 1 - j : j));
            }
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int r = i - k;
          if (r >= lo) {
            const int4 pr = pv[k];
            int4 nw;
            nw.w = min(min(own.x, own.y), own.z);
            if (r == 0) {
              nw.x = BIG, nw.y = go + t * d, nw.z = BIG;
            } else if (r == t) {
              nw.x = BIG, nw.y = BIG, nw.z = go + t * ic;
            } else {
              const int sub = av[k] == bv[k] ? cmatch : cmismatch;
              nw.x = min(pr.w + sub, BIG);
              nw.y = min(min(min(own.x, own.z) + go, own.y) + d, BIG);
              nw.z = min(min(min(pr.x, pr.y) + go, pr.z) + ic, BIG);
            }
            store_state<SMEM>(st + (r - base) * T + th, nw);
            if (r == top) published = nw;
            own = pr;
          }
        }
      }
      if (hi == top) edge[(t & 1) * T + th] = published;
    }
    if (t == cap0 || t == cap1) {  // every row 0..m of the segment
      int* ok = o + (t == cap1 ? 3 * R : 0);
      for (int r = 0; r < S && base + r <= m; ++r) {
        const int i = base + r;
        const int4 v = i >= wlo && i <= whi
                           ? load_state<SMEM>(st + r * T + th)
                           : big4();
        ok[i] = v.x, ok[R + i] = v.y, ok[2 * R + i] = v.z;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" {

// Launches both problems on `stream`.  tok_a is (R,) and tok_b (n+1 or
// more,) int32 1-origin tokens with 0 <= m < R; out is (2, 2, 3, R) int32;
// scratch holds 2 * S * threads int4 (used when the state does not fit in
// shared memory).  cap0x / cap1x are the forward / reversed capture waves,
// each pair (c, c + 1); S * threads must cover rows 0..m.
int wave_split_launch(const void* tok_a, const void* tok_b, void* out,
                      void* scratch, int R, int m, int n, int cmatch,
                      int cmismatch, int dcost, int icost, int gap_open,
                      int cap00, int cap01, int cap10, int cap11, int threads,
                      int S, void* stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 != 0 || S < 1 ||
      m < 0 || n < 0 || m >= R || R > INT_MAX / 6 ||
      (long long)S * threads < m + 1 ||
      cap01 != cap00 + 1 || cap11 != cap10 + 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;

  const size_t edge_bytes = 2 * (size_t)threads * sizeof(int4);
  const size_t state_bytes = (size_t)S * threads * sizeof(int4);
  const bool in_smem = edge_bytes + state_bytes <= (size_t)optin;
  const size_t smem = edge_bytes + (in_smem ? state_bytes : 0);
  auto kernel = in_smem ? wave_split_kernel<true> : wave_split_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<2, threads, smem, (cudaStream_t)stream>>>(
      (const int*)tok_a, (const int*)tok_b, (int*)out, (int4*)scratch, R, m,
      n, cmatch, cmismatch, dcost, icost, gap_open, cap00, cap01, cap10, cap11,
      S);
  return (int)cudaGetLastError();
}

const char* wave_split_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
