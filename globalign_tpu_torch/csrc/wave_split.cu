// wave_split.cu — the crossing-anti-diagonal meet-in-the-middle cost for
// uniform schemes, on Hopper (sm_90a): both problems' DP triangles as a
// tiled wavefront over every SM of the card, in one launch.
//
// What it replaces.  globalign_tpu/ops/fill_pallas.py:_make_wave_kernel
// (:1510), called with B = 2 by wave_split_fill_cost (:1690).  The TPU
// kernel stacked the two problems in one VPU instruction stream and swept
// them a wave at a time, each wave as (R, 128) lane tiles, shifting the
// previous waves by lane rolls.  The captures are only the DP planes at
// anti-diagonal cells, so here the kernel fills each problem's triangle
// i + j <= cap in tiles, in any order the dependencies allow, and writes
// the cells that lie on the capture waves.  The join over the crossing
// anti-diagonal stays outside the kernel (ops/fill_wave.py).
//
// What it computes.  Problem p: 0 the pair forward, 1 both sequences
// reversed (row i holds tok_a[m+1-i], column j tok_b[n+1-j]).  Cell (i, j)
// of a problem, 1 <= i <= m, 1 <= j <= n, is
//   M  = min(min3(i-1, j-1) + sub, BIG)
//   Ix = min(min(min(M, Iy)(i, j-1) + go, Ix(i, j-1)) + d, BIG)
//   Iy = min(min(min(M, Ix)(i-1, j) + go, Iy(i-1, j)) + ic, BIG)
// with sub = cmatch if the tokens agree, else cmismatch; row 0 is
// (BIG, go + j*d, BIG), column 0 (BIG, BIG, go + i*ic), the corner (0, 0,
// 0).  out[p][k] (3, R) is wave cap_k[p] (M, Ix, Iy by row i, the cell
// (i, cap - i)): the rows the wave reaches, BIG at every other row; a
// capture wave before 0 is all BIG.  These are the integers of the wave
// recurrence of the plain version (ops/fill_wave.py:_plain), bit for bit:
// a cell's value does not depend on the order cells are filled in, and
// no sum here comes near the int32 range (every value is <= BIG + go + d).
//
// Design.
//   * Tiles over the whole card.  A tile is one warp's work: 32 lanes x W
//     consecutive columns by H = 32 W rows (square tiles, W = 4: 128 x
//     128, faster than W = 8 at every shape timed, PERF.md §6).  Lane l
//     holds its W columns of the previous row
//     (M, Ix, Iy) and their seq_2 tokens in registers; lanes are skewed a
//     row apart, the left cell moving by __shfl_up_sync, so a tile takes
//     H + 31 steps and nothing of a cell goes to memory but a tile's
//     edges and its captures.  The cells use DPX add-min and 3-way min;
//     Ix's serial chain is one add-min a cell (min(Ix + d, min(h + go + d,
//     BIG)), the same integers as the recurrence's two steps).
//   * A warp's shared memory stages the tile's left edge (H + 1 slots: the
//     corner, then a row each, with the row's seq_1 token), loaded before
//     any slot is stored.  Lane 0 reads a slot a step; lane 31 writes its
//     last cell of each row back into the slot lane 0 read 31 steps
//     before, so the right edge leaves the tile after the steps, in
//     coalesced stores, with the bottom row: the step loop stores nothing
//     but captures.
//   * Hand-offs through L2, no grid barrier.  Per problem, one row buffer
//     holds the bottom rows of the tiles last finished in each tile column
//     (read by the tile below), and a column buffer of H + 1 slots a tile
//     row holds the right column of the tile last finished in that row
//     (read by the tile to its right) and, in slot 0, the diagonal corner
//     that tile needs: the last top-edge cell of its left neighbour.  The
//     corner cannot come from the row buffer: by then the left neighbour
//     has overwritten it with its own bottom row.  A tile column's flag
//     counts its finished tiles; a warp publishes with __threadfence and
//     a release store, and waits on acquire loads with __nanosleep.  Two
//     tiles that run at once never touch the same buffer entries: the
//     tiles that share a tile column or a tile row are ordered by their
//     dependencies.
//   * Tiles by ticket.  A warp takes the next ticket (atomicAdd) and reads
//     its tile from a table the wrapper builds (ops/fill_wave.tile_order):
//     tile anti-diagonal order b + c, the two problems interleaved.  Every
//     producer of a tile holds a smaller ticket, already taken by a warp
//     that is running, so a waiting warp only ever waits on a resident
//     one, whatever the block scheduler does.  Tiles past the last capture
//     wave or past (m, n) are not in the table; a tile that straddles a
//     capture wave computes its rectangle, cut to the rows and columns the
//     triangle reaches, and writes only the captured cells.
//   * Output rows no tile writes (row 0, column 0, rows a wave does not
//     reach, rows past m, waves before 1) are written by every thread of
//     the launch before it takes a ticket.
//
// What bounds it on this card.  A cell is ~10 int32 operations; the card
// issues 64 a clock an SM, so m*n cells (both triangles together) are
// bounded by issue over 132 SMs.  The wavefront adds a critical path of
// b + c + 1 tiles (cap / H), each H + 31 steps plus a hand-off through
// L2.  A step is a lone warp's ~80 int32 instructions (4 cells and the
// skew's shuffles), and an SM sub-partition issues a warp's int32
// instruction every other clock: so the launch keeps one block of 4 warps
// an SM, a warp to each sub-partition, and the critical path, not the
// cell count, sets the time (PERF.md §6).

// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing (the caller passes the output, the tile table, the edge buffers
// and the zeroed flags), and the launcher returns cudaGetLastError().  A
// wait that can never end traps after ~2^25 polls (several seconds), so a
// fault fails the launch instead of hanging it.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int BIG = 1 << 30;
constexpr int WARP = 32;
constexpr int W = 4;              // columns a lane: tiles of 32 W x H
constexpr int BW = WARP * W;      // columns a tile
constexpr int H = BW;             // rows a tile: square tiles
constexpr int WARPS = 4;          // warps a block, one block an SM
constexpr int FLAG_STRIDE = 32;   // ints between flags: one 128-byte line each
constexpr unsigned FULL = 0xffffffffu;

struct Params {
  const int* tok_a;
  const int* tok_b;
  int* out;
  const int2* order;  // (tiles,) of (2 b + p, c)
  int4* rowbuf;       // (2, C * 32 W + 1) of (M, Ix, Iy, -)
  int4* colbuf;       // (2, B, H + 1) of (M, Ix, Iy, -)
  int* flags;         // [0] the ticket counter; [FLAG_STRIDE (1 + p C + c)]
  int R, m, n, cmatch, cmismatch, d, ic, go;
  int cap00, cap01, cap10, cap11;  // [problem][k]
  int tiles, B, C;
};

__device__ __forceinline__ int addmin(int a, int b, int c) {
  return __viaddmin_s32(a, b, c);  // min(a + b, c)
}

__device__ __forceinline__ int min3(int a, int b, int c) {
  return __vimin3_s32(a, b, c);
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Waits, the whole warp, until *flag >= need.
__device__ __forceinline__ void wait_for(const int* flag, int need) {
  unsigned ns = 32;
  int polls = 0;
  while (!__all_sync(FULL, load_acquire(flag) >= need)) {
    __nanosleep(ns);
    ns = min(2 * ns, 512u);
    if (++polls > (1 << 25)) __trap();
  }
}

// Output rows that no tile writes: for each (p, k) and row i, every cell
// but the inner ones (1 <= i <= m, 1 <= cap - i <= n).
__device__ __forceinline__ void write_boundary_rows(const Params& P) {
  const long long total = 4LL * P.R;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < total; q += stride) {
    const int pk = (int)(q / P.R), i = (int)(q % P.R);
    const int cap = pk == 0 ? P.cap00 : pk == 1 ? P.cap01 : pk == 2 ? P.cap10 : P.cap11;
    const int j = cap - i;
    if (i >= 1 && i <= P.m && j >= 1 && j <= P.n) continue;  // a tile's
    int vm = BIG, vx = BIG, vy = BIG;
    if (i <= P.m && j >= 0 && j <= P.n) {  // the wave reaches row i
      if (i == 0 && j == 0) vm = 0, vx = 0, vy = 0;
      else if (i == 0) vx = P.go + j * P.d;
      else vy = P.go + i * P.ic;  // j == 0
    }
    int* o = P.out + (long long)pk * 3 * P.R + i;
    o[0] = vm, o[P.R] = vx, o[2LL * P.R] = vy;
  }
}

__device__ __forceinline__ void run_tile(const Params& P, int p, int b, int c,
                                         int lane, int4* edge) {
  constexpr int SLOTS = (H + 1 + WARP - 1) / WARP;  // edge slots a lane stages
  const int m = P.m, n = P.n, go = P.go, d = P.d, ic = P.ic;
  const int cmatch = P.cmatch, cmismatch = P.cmismatch, gd = go + d;
  const int r0 = b * H, c0 = c * BW;  // the row above, the column to the left
  const int cap0 = p ? P.cap10 : P.cap00, cap1 = p ? P.cap11 : P.cap01;
  // The rows and lanes the triangle reaches (>= 1: the tile is ticketed).
  const int hh = min(min(H, m - r0), cap1 - c0 - 1 - r0);
  const int lanes = min(WARP, (min(n, cap1 - r0 - 1) - c0 + W - 1) / W);
  const bool cut = (cap0 >= r0 + c0 + 2 && cap0 <= r0 + hh + c0 + lanes * W) ||
                   (cap1 >= r0 + c0 + 2 && cap1 <= r0 + hh + c0 + lanes * W);
  int4* rowbuf = P.rowbuf + p * ((long long)P.C * BW + 1);
  int4* col = P.colbuf + ((long long)p * P.B + b) * (H + 1);
  int* done = P.flags + FLAG_STRIDE * (1 + p * P.C);
  const int j0 = c0 + lane * W + 1;  // the lane's first column

  // The tokens, which wait for no producer: the lane's seq_2 tokens, and
  // the seq_1 token of each edge slot k (row r0 + k) it stages.
  int tok[W], rowtok[SLOTS];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int j = j0 + q;
    tok[q] = j <= n ? __ldg(P.tok_b + (p ? n + 1 - j : j)) : -1;
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = lane + s * WARP, i = r0 + k;
    rowtok[s] = k >= 1 && k <= hh ? __ldg(P.tok_a + (p ? m + 1 - i : i)) : 0;
  }

  if (c > 0) wait_for(done + FLAG_STRIDE * (c - 1), b + 1);  // left
  if (b > 0) wait_for(done + FLAG_STRIDE * c, b);            // above

  // The left edge, slot k = row r0 + k at column c0 (slot 0 the corner),
  // with the row's seq_1 token in .w, staged in this warp's shared
  // memory: every load issued before any is stored.
  int4 slot[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = lane + s * WARP, i = r0 + k;
    if (c == 0) slot[s] = i == 0 ? make_int4(0, 0, 0, 0)
                                 : make_int4(BIG, BIG, go + i * ic, 0);
    else if (b == 0 && k == 0) slot[s] = make_int4(BIG, go + c0 * d, BIG, 0);
    else if (k <= hh) slot[s] = __ldcg(col + k);
  }
  // The top edge (row r0) at the lane's columns j0 .. j0 + W - 1.
  int pM[W], pX[W], pY[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    if (b == 0) {
      pM[q] = BIG, pX[q] = go + (j0 + q) * d, pY[q] = BIG;
    } else {
      const int4 v = __ldcg(rowbuf + j0 + q);
      pM[q] = v.x, pX[q] = v.y, pY[q] = v.z;
    }
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = lane + s * WARP;
    if (k <= hh) edge[k] = make_int4(slot[s].x, slot[s].y, slot[s].z, rowtok[s]);
  }
  __syncwarp();
  // The diagonal of the lane's first cell: (r0, j0 - 1).
  int dM = __shfl_up_sync(FULL, pM[W - 1], 1);
  int dX = __shfl_up_sync(FULL, pX[W - 1], 1);
  int dY = __shfl_up_sync(FULL, pY[W - 1], 1);
  if (lane == 0) {
    const int4 e = edge[0];
    dM = e.x, dX = e.y, dY = e.z;
  }
  // The right neighbour's corner: (r0, c0 + BW), lane 31's last top cell.
  const int cM = pM[W - 1], cX = pX[W - 1], cY = pY[W - 1];

  // Step k: lane l fills row r0 + 1 + k - l.  Lane 31 puts its last cell
  // of each row, the right edge, back into the staging slot of that row,
  // which lane 0 read 31 steps before; the edges go out after the loop.
  int oM = BIG, oX = BIG, oY = BIG, oA = 0;  // the lane's last cell, its token
  const int steps = hh + lanes - 1;
#pragma unroll 2
  for (int k = 0; k < steps; ++k) {
    // The left cell of the lane's row: the left lane's last cell of the
    // step before, or for lane 0 the staged left edge.
    int lM = __shfl_up_sync(FULL, oM, 1);
    int lX = __shfl_up_sync(FULL, oX, 1);
    int lY = __shfl_up_sync(FULL, oY, 1);
    int a = __shfl_up_sync(FULL, oA, 1);
    const int4 e = edge[min(k + 1, hh)];
    if (lane == 0) lM = e.x, lX = e.y, lY = e.z, a = e.w;
    const int r = k - lane;
    if (r >= 0 && r < hh && lane < lanes) {
      int xl = lX, hl = min(lM, lY);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int mp = pM[q], xp = pX[q], yp = pY[q];
        const int sub = a == tok[q] ? cmatch : cmismatch;
        const int mc = addmin(min3(dM, dX, dY), sub, BIG);
        const int yc = addmin(addmin(min(mp, xp), go, yp), ic, BIG);
        const int xc = addmin(xl, d, addmin(hl, gd, BIG));
        dM = mp, dX = xp, dY = yp;
        pM[q] = mc, pX[q] = xc, pY[q] = yc;
        xl = xc, hl = min(mc, yc);
      }
      dM = lM, dX = lX, dY = lY;
      oM = pM[W - 1], oX = pX[W - 1], oY = pY[W - 1], oA = a;
      if (lane == WARP - 1) {
        int4* e1 = edge + 1 + r;
        e1->x = oM, e1->y = oX, e1->z = oY;
      }
      if (cut) {
        const int i = r0 + 1 + r;
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int q = (kk ? cap1 : cap0) - i - j0;
          if (q >= 0 && q < W && j0 + q <= n) {
            int vm = pM[0], vx = pX[0], vy = pY[0];
#pragma unroll
            for (int s = 1; s < W; ++s)
              if (s == q) vm = pM[s], vx = pX[s], vy = pY[s];
            int* o = P.out + (long long)(p * 2 + kk) * 3 * P.R + i;
            o[0] = vm, o[P.R] = vx, o[2LL * P.R] = vy;
          }
        }
      }
    }
  }
  // The bottom row (row r0 + hh), for the tile below.
  if (lane < lanes) {
#pragma unroll
    for (int q = 0; q < W; ++q)
      __stcg(rowbuf + j0 + q, make_int4(pM[q], pX[q], pY[q], 0));
  }
  // The right column and the corner, for the tile to the right.
  if (lanes == WARP) {
    if (lane == WARP - 1) edge[0] = make_int4(cM, cX, cY, 0);
    __syncwarp();
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int k = lane + s * WARP;
      if (k <= hh) __stcg(col + k, edge[k]);
    }
  }
  __threadfence();
  __syncwarp();
  if (lane == 0) store_release(done + FLAG_STRIDE * c, b + 1);
  __syncwarp();  // the edge staging is reused by the warp's next tile
}

__global__ void __launch_bounds__(WARPS * WARP)
wave_tile_kernel(const __grid_constant__ Params P) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x % WARP;
  int4* edge = smem + (threadIdx.x / WARP) * (H + 1);
  write_boundary_rows(P);
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(P.flags, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= P.tiles) return;  // warp-uniform
    const int2 code = __ldg(P.order + t);
    run_tile(P, code.x & 1, code.x >> 1, code.y, lane, edge);
  }
}

}  // namespace

extern "C" {

// Launches both problems on `stream`.  tok_a is (R,) and tok_b (n+1 or
// more,) int32 1-origin tokens with 0 <= m < R; out is (2, 2, 3, R) int32;
// tiles are H = 128 rows by 32 W = 128 columns; order is the (tiles, 2)
// int32 table of ops/fill_wave.tile_order(m, n, 4, 128); rowbuf holds
// 2 (C 32 W + 1) and colbuf 2 B (H + 1) int4, with B = ceil(m / H) and
// C = ceil(n / 32 W); flags holds 32 (1 + 2 C) zeroed int32.  cap0x /
// cap1x are the forward / reversed capture waves, each pair (c, c + 1).
// One block of 4 warps an SM: a warp to each SM sub-partition.
int wave_split_launch(const void* tok_a, const void* tok_b, void* out,
                      const void* order, void* rowbuf, void* colbuf,
                      void* flags, int R, int m, int n, int cmatch,
                      int cmismatch, int dcost, int icost, int gap_open,
                      int cap00, int cap01, int cap10, int cap11, int tiles,
                      void* stream) {
  if (m < 0 || n < 0 || m >= R || R > INT_MAX / 6 || tiles < 0 ||
      cap01 != cap00 + 1 || cap11 != cap10 + 1)
    return (int)cudaErrorInvalidValue;
  Params P;
  P.tok_a = (const int*)tok_a, P.tok_b = (const int*)tok_b;
  P.out = (int*)out, P.order = (const int2*)order;
  P.rowbuf = (int4*)rowbuf, P.colbuf = (int4*)colbuf, P.flags = (int*)flags;
  P.R = R, P.m = m, P.n = n, P.cmatch = cmatch, P.cmismatch = cmismatch;
  P.d = dcost, P.ic = icost, P.go = gap_open;
  P.cap00 = cap00, P.cap01 = cap01, P.cap10 = cap10, P.cap11 = cap11;
  P.tiles = tiles;
  P.B = (m + H - 1) / H;
  P.C = (n + BW - 1) / BW;
  if ((long long)tiles > 2LL * P.B * P.C) return (int)cudaErrorInvalidValue;

  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)WARPS * (H + 1) * sizeof(int4);
  const long long want = ((long long)tiles + WARPS - 1) / WARPS;
  const int blocks = (int)(want < 1 ? 1 : want < sms ? want : sms);
  wave_tile_kernel<<<blocks, WARPS * WARP, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

const char* wave_split_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
