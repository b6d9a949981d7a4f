// gotoh_tile.cu — one pair's Gotoh fill (or a few pairs') as a tiled
// wavefront over every SM of the card (sm_90a): final3 and, optionally,
// the move codes, the last row and any number of checkpoint rows, with
// row 0 and the column-0 seed injected or not.
//
// What it replaces.  The single-pair launches of these TPU kernels (files
// under globalign_tpu/ops/), which csrc/gotoh_fill.cu serves for batches:
//   * fill_lanes.py:_make_lane_kernel (:201), moves mode (lanes_batch_moves,
//     lanes_general_moves) with B = 1: the single-pair align's fill, and
//     with its row0 / col0y_top injection the blocked traceback's replays;
//   * fill_pallas.py:_make_stacked_kernel(want_moves=True) (:496), the
//     injected moves fill (stacked_fill_with_moves);
//   * _make_lane_kernel's cost modes with B = 2: the cost split's two
//     halves (lanes_split_fill_cost);
//   * fill_pallas.py:stacked_fill_last_rows (:735) and
//     _make_row_kernel / row_fill_last_rows (:153, :256): the blocked
//     traceback's checkpoint rows — here every checkpoint row of the pass
//     from one launch, where the JAX package fills a block a call;
//   * with codes in a ragged moves fill's buffer, the pairs of a
//     gotoh_fill ragged launch class that its clusters leave to a lone
//     last wave (ops/fill_tile.route_tail): the JAX package's moves fills
//     of an align_pairs call (globalign_tpu/batch.py:_lanes_walk_fills).
//
// What it computes.  Pair p, with 1-origin tokens a_0..a_m and b_0..b_n
// read at its own offsets from tok_a and tok_b (pairs[p]: the pairs of a
// launch may lie anywhere in one buffer, at any padded widths) and true
// lengths m, n (meta), exactly what gotoh_fill's moves and last-row modes
// compute (csrc/gotoh_fill.cu:33-70):
//   final3[f] = (M, Ix, Iy) at (m, n), f the pair's final3 row (pairs[p]);
//   codes (optional) at a byte offset, row stride ld >= n + 1 and count of
//   rows >= m + 1 of the pair's own (pairs[p]): code (i, j) at byte
//   i ld + j of that region for 1 <= i <= m, 1 <= j <= n, bits 0-1 the M
//   predecessor, 2-3 Ix, 4-5 Iy (0 = M, 1 = Ix, 2 = Iy, ties M > Ix > Iy);
//   every other byte of the region is written 0 and no byte outside it.
//   A dense (B, M+1, N+1) buffer is the regions p (M+1)(N+1), N + 1 and
//   M + 1; a ragged moves fill's (ops/fill_cuda.batch_moves_ragged) the
//   pairs' own offsets, strides ragged_stride(n) and m + 1 rows, so a
//   launch can fill some of its pairs into the buffer gotoh_fill fills;
//   rows_out[p, k] (optional) = row r_k of the pair's list (meta), under
//   the contract of fill_cuda.batch_last_rows: (M, Ix, Iy) at columns
//   1..n, column 0 (BIG, BIG, Iy(r, 0)) — row 0 itself when r = 0 —, BIG
//   past n.  The last row is the list [m]; the blocked traceback's
//   checkpoint pass is the list of its block ends.
// Row 0 is (BIG, go + D[j], BIG) with the (0, 0, 0) corner, or row0[p]
// (corner included); Iy(i, 0) = c0 + icost(a_1) + ... + icost(a_i) with
// c0 = col0y_top[p], or go.  The arithmetic is the row scan's
// (globalign_tpu/ops/fill_rows.py) in int32 with BIG = 1 << 30, in the
// DPX forms of gotoh_fill: M and Iy clamped at BIG, Ix as the serial
// X[j] = min(X[j-1] + d_j, min(M, Iy)(i, j-1) + go + d_j) on unclamped
// sums with X = BIG at column 0, clamped when stored, its code tested
// against the left cell's M + go + d and clamped Ix + d.  The same
// integers as the row scan's prefix minimum, so every code matches.
//
// Design, for this card.  A pair's DP is a wavefront: cell (i, j) waits
// for (i-1, j) and (i, j-1).  gotoh_fill runs a pair on one cluster of at
// most 8 SMs; here the pair is cut into tiles that any SM takes.
//   * A tile is one warp's work: 32 lanes x W consecutive columns by H rows
//     (template parameters; the launch's (H, W) is ops/fill_tile.plan's).
//     Lane l keeps its W columns of the previous row (M, Ix, Iy), their
//     seq_2 tokens and gap costs in registers; lanes are skewed a row apart
//     and the left cell moves by __shfl_up_sync, so a tile takes H + 31
//     steps and nothing of a cell goes to memory but the tile's edges, its
//     codes and the requested rows.  The (A, A) cost table is in shared
//     memory, and each warp builds its tile column's profile there, the
//     costs cost(a, b_j) of every token a at the lane's W columns, so a
//     step's substitution costs are one 4W-byte load, made a step ahead
//     (with an alphabet too large for that, lookups in the table in
//     global memory).
//   * The left edge is staged in the warp's shared memory (H + 1 slots:
//     the corner, then a row each, with the row's seq_1 token and its
//     checkpoint mark), loaded before any slot is stored.  Lane 31 writes
//     its last cell of each row back into the slot lane 0 read 31 steps
//     before, so the right edge leaves the tile after its steps in
//     coalesced stores.  An edge cell carries Ix unclamped: the next
//     tile's serial Ix starts from it.
//   * Codes are staged for the whole tile in the warp's shared memory (H
//     rows of 32 W bytes, 17 KB at 128 x 128) and written out after its
//     steps, a row a run: head bytes singly, then aligned words, then the
//     tail (a row stride may be odd), as gotoh_fill writes them.  The
//     step loop stores one word a lane and never waits on the warp.
//   * Hand-offs through L2, no grid barrier (wave_split.cu's scheme).  Per
//     pair, a row buffer holds the bottom row of the tile last finished in
//     each tile column (entry 0: the column-0 Iy at that row), and a column
//     buffer of H + 1 slots a tile row the right column of the tile last
//     finished in that row and, in slot 0, the diagonal corner the next
//     tile needs: its left neighbour's last top-row cell, which the row
//     buffer no longer holds by then.  The default row 0 and the column-0
//     Iy are prefix sums that travel the same way: tile (0, c) takes
//     go + D at its corner from its left neighbour, tile (b, 0) the
//     column-0 Iy from the tile above.  A tile column's flag counts its
//     finished tiles; a warp publishes with __threadfence and a release
//     store and waits on acquire loads with __nanosleep.
//   * Tiles by ticket.  A warp takes the next ticket (atomicAdd) and reads
//     its tile from a table the wrapper builds (ops/fill_tile.tile_order):
//     anti-diagonal b + c, then the pair, then b.  A tile's producers
//     hold smaller tickets, taken by running warps, so a warp only waits on
//     resident ones.  A wait that can never end traps after ~2^25 polls.
//   * Bytes and rows that no tile writes (row 0 and column 0 of a pair's
//     codes, the padding of its region, columns past n of the requested
//     rows, and the pairs and rows that hold no inner cell) are written by
//     the launch's threads before they take a ticket.
//
// What bounds it on this card.  A cell is ~10 int32 operations cost only,
// ~24 with codes; the card issues 64 a clock an SM.  A tile's steps are a
// lone warp's dependent chain, so the critical path of tiles, (ceil(m/H) +
// ceil(n/32W) - 1) tiles of H + 31 steps each plus a hand-off, sets the
// time of one pair, and not the card's issue rate: one block of 4 warps an
// SM, a warp to each SM sub-partition, as wave_split.  The path's tiles
// times a tile's measured time model every timed launch within ~5%
// (PERF.md section 6); with codes a step costs about twice a cost-only one.
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing (the caller passes the outputs, the ticket table, the metadata,
// the edge buffers and the zeroed flags) and the launcher returns
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BIG = 1 << 30;
constexpr int WARP = 32;
constexpr int WARPS = 4;          // warps a block, one block an SM
constexpr int FLAG_STRIDE = 32;   // ints between flags: one 128-byte line each
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ALPHABET = 1 << 16;  // tokens share a word with a mark
constexpr int PAIR_VECS = 3;      // longlong2 a pair (ops/fill_tile.PAIR_WORDS)

struct Params {
  const int* tok_a;      // pair p's seq_1 at pairs[p].x, m + 1 tokens
  const int* tok_b;      // pair p's seq_2 at pairs[p].y, n + 1 tokens
  const int* cost;       // (A, A)
  const int* row0;       // (B, 3, N+1) or null
  const int* col0y_top;  // (B,) or null
  // (m, n) a pair (B, 2); each pair's first row-list entry at or past each
  // tile row, (B, TB+1); each pair's row list, (B, K) ascending in [0, m]
  const int* meta;
  const int4* order;     // (tiles,) of (p, b, c, -)
  // (B,) of PAIR_VECS: (seq_1 offset, seq_2 offset) in int32 words from
  // tok_a / tok_b; (final3 row, the codes' byte offset); (the codes' row
  // stride, their rows)
  const longlong2* pairs;
  int* final3;           // (rows, 3): pair p's at its final3 row
  uint8_t* moves;        // the codes buffer (pairs[p]'s regions) or null
  int* rows_out;         // (B, K, 3, N+1) or null
  int4* rowbuf;          // (B, C 32 W + 1) of (M, Ix, Iy, -)
  int4* colbuf;          // (B, TB, H + 1) of (M, Ix unclamped, Iy, -)
  int* flags;            // [0] the ticket counter; [FLAG_STRIDE (1 + p C + c)]
  int B, N, A, gap_id, go, K, TB, C, tiles;
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
    ns = min(2 * ns, 256u);
    if (++polls > (1 << 25)) __trap();
  }
}

// Inclusive prefix sum over the warp's lanes (int32, wrapping as a cumsum).
__device__ __forceinline__ int warp_scan(int x, int lane) {
#pragma unroll
  for (int off = 1; off < WARP; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Bytes a staged code row takes: 32 W plus a pad that spreads the lanes'
// skewed stores over the banks (gotoh_fill.cu's slot_bytes).
template <int W>
__host__ __device__ constexpr int slot_bytes() {
  return WARP * W + ((W / 4) % 2 ? 8 : 4);
}

// Writes a tile's `rows` staged code rows (SLOT bytes apart, `cols` <= 128
// bytes each) to out + r ld (any alignment), as gotoh_fill's flush_row
// does a row: head bytes singly (lanes 0-2), then aligned words (lane t
// the word t), then the tail (lanes 4-6).  Eight rows at a time, every
// load of the eight issued before any store.
template <int SLOT>
__device__ __forceinline__ void flush_rows(uint8_t* __restrict__ out,
                                           long long ld,
                                           const uint8_t* __restrict__ stage,
                                           int rows, int cols, int lane) {
  constexpr int G = 8;
  for (int r0 = 0; r0 < rows; r0 += G) {
    uint32_t word[G];
    uint8_t byte[G];
    int at[G], bat[G];  // the lane's word and byte offsets in the row, or -1
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = r0 + g;
      at[g] = bat[g] = -1;
      if (r < rows) {
        const uint8_t* src = stage + r * SLOT;
        const int head = min((int)((4 - ((uintptr_t)(out + r * ld) & 3)) & 3), cols);
        const int words = (cols - head) >> 2;
        const int done = head + 4 * words;
        if (lane < words) {
          const uint32_t* sw = reinterpret_cast<const uint32_t*>(src);
          const unsigned sel = head | ((head + 1) << 4) | ((head + 2) << 8) |
                               ((head + 3) << 12);
          word[g] = __byte_perm(sw[lane], sw[lane + 1], sel);
          at[g] = head + 4 * lane;
        }
        const int bi = lane < 4 ? lane : done + lane - 4;
        if (lane < head || (lane >= 4 && lane - 4 < cols - done)) {
          byte[g] = src[bi];
          bat[g] = bi;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      uint8_t* dst = out + (r0 + g) * ld;
      if (at[g] >= 0) *reinterpret_cast<uint32_t*>(dst + at[g]) = word[g];
      if (bat[g] >= 0) dst[bat[g]] = byte[g];
    }
  }
}

__device__ __forceinline__ const int* pair_dims(const Params& P) { return P.meta; }
__device__ __forceinline__ const int* ck_first(const Params& P, int p) {
  return P.meta + 2 * P.B + p * (P.TB + 1);
}
__device__ __forceinline__ const int* row_list(const Params& P, int p) {
  return P.meta + 2 * P.B + P.B * (P.TB + 1) + p * P.K;
}
__device__ __forceinline__ int* row_out(const Params& P, int p, int k) {
  return P.rows_out + ((long long)p * P.K + k) * 3 * (P.N + 1);
}
__device__ __forceinline__ const int* seq_a(const Params& P, int p) {
  return P.tok_a + __ldg(P.pairs + PAIR_VECS * p).x;
}
__device__ __forceinline__ const int* seq_b(const Params& P, int p) {
  return P.tok_b + __ldg(P.pairs + PAIR_VECS * p).y;
}
__device__ __forceinline__ int* final3_of(const Params& P, int p) {
  return P.final3 + 3 * __ldg(P.pairs + PAIR_VECS * p + 1).x;
}
__device__ __forceinline__ uint8_t* codes_of(const Params& P, int p) {
  return P.moves + __ldg(P.pairs + PAIR_VECS * p + 1).y;
}
// (row stride, rows) of the pair's codes
__device__ __forceinline__ longlong2 codes_shape(const Params& P, int p) {
  return __ldg(P.pairs + PAIR_VECS * p + 2);
}

// What no tile writes.  Every thread of the launch: the code bytes of row
// 0, column 0, the padding and the rows past m of each pair's own region;
// the columns past n of the requested rows.  Warp p of the launch (a warp a pair): a pair with no
// inner cell (m = 0 or n = 0) — its final3 and rows — and row 0 when the
// pair's list asks for it.
__device__ void write_boundary(const Params& P, const int* tab) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthr = (long long)gridDim.x * blockDim.x;
  const int N = P.N, A = P.A, gap = P.gap_id, go = P.go;
  const long long ld = N + 1;
  for (int p = 0; p < P.B; ++p) {
    const int m = pair_dims(P)[2 * p], n = pair_dims(P)[2 * p + 1];
    if (P.moves) {
      uint8_t* mv = codes_of(P, p);
      const longlong2 shape = codes_shape(P, p);
      const long long cld = shape.x;
      for (long long j = tid; j < cld; j += nthr) mv[j] = 0;
      for (long long i = 1 + tid; i <= m; i += nthr) mv[i * cld] = 0;
      const long long pad = cld - 1 - n;
      if (pad > 0)
        for (long long k = tid; k < (long long)m * pad; k += nthr)
          mv[(1 + k / pad) * cld + n + 1 + k % pad] = 0;
      for (long long k = (m + 1) * cld + tid; k < shape.y * cld; k += nthr) mv[k] = 0;
    }
    if (P.rows_out) {
      const long long pad = N - n;
      for (long long k = tid; k < (long long)P.K * 3 * pad; k += nthr) {
        const long long row = k / pad;  // (k, lane) of the pair
        row_out(P, p, 0)[row * ld + n + 1 + k % pad] = BIG;
      }
    }
  }

  const int lane = threadIdx.x % WARP;
  const long long gw = tid / WARP, nw = nthr / WARP;
  for (long long p = gw; p < P.B; p += nw) {
    const int m = pair_dims(P)[2 * p], n = pair_dims(P)[2 * p + 1];
    const int* rows = row_list(P, p);
    const bool row0_out = P.rows_out && P.K > 0 && rows[0] == 0;
    const int* r0 = P.row0 ? P.row0 + p * 3 * ld : nullptr;
    int* f3 = final3_of(P, p);
    if (m == 0 || row0_out) {  // row 0 at columns 0..n
      const int* tb = seq_b(P, p);
      int carry = go;  // default: Ix(0, j) = go + D[j]
      for (int base = 0; base <= n; base += WARP) {
        const int j = base + lane;
        const int dj = j >= 1 && j <= n ? tab[gap * A + tb[j]] : 0;
        const int incl = warp_scan(dj, lane);
        const int x = carry + incl;
        carry += __shfl_sync(FULL, incl, WARP - 1);
        if (j > n) continue;
        int vm, vx, vy;
        if (r0) vm = r0[j], vx = r0[ld + j], vy = r0[2 * ld + j];
        else if (j == 0) vm = 0, vx = 0, vy = 0;
        else vm = BIG, vx = x, vy = BIG;
        if (row0_out) {
          int* o = row_out(P, p, 0);
          o[j] = vm, o[ld + j] = vx, o[2 * ld + j] = vy;
        }
        if (m == 0 && j == n) f3[0] = vm, f3[1] = vx, f3[2] = vy;
      }
    }
    if (n == 0 && m > 0) {  // column 0 only: Iy(i, 0) = c0 + icost(a_1..a_i)
      const int* ta = seq_a(P, p);
      int carry = P.col0y_top ? P.col0y_top[p] : go;
      int k = row0_out ? 1 : 0;
      for (int base = 1; base <= m; base += WARP) {
        const int i = base + lane;
        const int ic = i <= m ? tab[ta[i] * A + gap] : 0;
        const int incl = warp_scan(ic, lane);
        const int y = carry + incl;
        carry += __shfl_sync(FULL, incl, WARP - 1);
        if (i == m) f3[0] = BIG, f3[1] = BIG, f3[2] = y;
        for (; P.rows_out && k < P.K && rows[k] < base + WARP; ++k)
          if (rows[k] == i) {
            int* o = row_out(P, p, k);
            o[0] = BIG, o[ld] = BIG, o[2 * ld] = y;
          }
      }
    }
  }
}

// Substitution costs of row token a at the lane's W columns: from the
// warp's profile (prof[a][lane W + q], one 4W-byte load), or from the table.
template <int W, bool PROF>
__device__ __forceinline__ void lookup(const int* tab, const int* prof, int A,
                                       int a, int lane, const int (&tk)[W],
                                       int (&sb)[W]) {
  if (PROF) {
    if (W == 4) {
      const int4 v = *reinterpret_cast<const int4*>(prof + a * WARP * W + lane * W);
      sb[0] = v.x, sb[1 % W] = v.y, sb[2 % W] = v.z, sb[3 % W] = v.w;
    } else {
      const int2 v = *reinterpret_cast<const int2*>(prof + a * WARP * W + lane * W);
      sb[0] = v.x, sb[1 % W] = v.y;
    }
  } else {
#pragma unroll
    for (int q = 0; q < W; ++q) sb[q] = __ldg(tab + a * A + tk[q]);
  }
}

template <int H, int W, bool MOVES, bool PROF>
__device__ __forceinline__ void run_tile(const Params& P, const int* tab,
                                         int p, int b, int c, int lane,
                                         int4* edge, int* prof,
                                         uint8_t* stage) {
  constexpr int BW = WARP * W;                      // columns a tile
  constexpr int SLOTS = (H + 1 + WARP - 1) / WARP;  // edge slots a lane stages
  constexpr int SLOT = slot_bytes<W>();
  const int A = P.A, go = P.go, gap = P.gap_id;
  const long long ld = P.N + 1;
  const int m = pair_dims(P)[2 * p], n = pair_dims(P)[2 * p + 1];
  const int r0 = b * H, c0 = c * BW;  // the row above, the column to the left
  const int hh = min(H, m - r0);      // rows of the tile (>= 1)
  const int lanes = min(WARP, (n - c0 + W - 1) / W);  // lanes with columns
  const int* ta = seq_a(P, p);
  const int* tb = seq_b(P, p);
  int4* rowbuf = P.rowbuf + p * ((long long)P.C * BW + 1);
  int4* col = P.colbuf + ((long long)p * P.TB + b) * (H + 1);
  int* done = P.flags + FLAG_STRIDE * (1 + p * P.C);
  const int j0 = c0 + lane * W + 1;  // the lane's first column
  const int* gap_row = tab + gap * A;

  // What waits for no producer: the lane's seq_2 tokens and gap costs, and
  // each edge slot's word (slot k = row r0 + k): the row's seq_1 token,
  // and in the high half 1 + the row's index among this tile row's
  // requested rows (0: not requested).
  int tk[W], dc[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int j = j0 + q;
    tk[q] = j <= n ? __ldg(tb + j) : 0;
    dc[q] = gap_row[tk[q]];
  }
  if (PROF) {  // the tile column's profile: cost(a, b_j) at the lane's columns
    for (int a = 0; a < A; ++a) {
      int* dst = prof + a * BW + lane * W;
      const int* row = tab + a * A;
      if (W == 4)
        *reinterpret_cast<int4*>(dst) =
            make_int4(row[tk[0]], row[tk[1 % W]], row[tk[2 % W]], row[tk[3 % W]]);
      else
        *reinterpret_cast<int2*>(dst) = make_int2(row[tk[0]], row[tk[1 % W]]);
    }
  }
  int word[SLOTS];
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = lane + s * WARP;
    word[s] = k >= 1 && k <= hh ? __ldg(ta + r0 + k) : 0;
  }
  int ck_lo = 0, ck_hi = 0;
  if (P.rows_out) ck_lo = ck_first(P, p)[b], ck_hi = ck_first(P, p)[b + 1];
  for (int kk = ck_lo; kk < ck_hi; ++kk) {
    const int k = row_list(P, p)[kk] - r0;  // in 1..hh
#pragma unroll
    for (int s = 0; s < SLOTS; ++s)
      if (k == lane + s * WARP) word[s] |= (kk - ck_lo + 1) << 16;
  }

  if (c > 0) wait_for(done + FLAG_STRIDE * (c - 1), b + 1);  // left
  if (b > 0) wait_for(done + FLAG_STRIDE * c, b);            // above

  // The left edge, slot k = row r0 + k at column c0 (slot 0 the corner):
  // (M, Ix unclamped, Iy) from the left tile, or column 0 with its Iy
  // prefix from the tile above (or the seed).
  int4 slot[SLOTS];
  int ybot = 0;  // tile column 0: column 0's Iy at the bottom row (slot hh)
  if (c == 0) {
    const int y0 = b > 0 ? __ldcg(rowbuf).z
                         : (P.col0y_top ? P.col0y_top[p] : go);  // Iy(r0, 0)
    int carry = y0;
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int k = lane + s * WARP;
      const int ic = k >= 1 && k <= hh ? tab[(word[s] & 0xffff) * A + gap] : 0;
      const int incl = warp_scan(ic, lane);
      slot[s] = make_int4(BIG, BIG, carry + incl, 0);
      if (k == hh) ybot = carry + incl;
      carry += __shfl_sync(FULL, incl, WARP - 1);
    }
    ybot = __shfl_sync(FULL, ybot, hh % WARP);
    if (lane == 0) {  // the corner (r0, 0)
      if (b > 0) slot[0] = make_int4(BIG, BIG, y0, 0);
      else if (P.row0) {
        const int* r0p = P.row0 + p * 3 * ld;
        slot[0] = make_int4(r0p[0], r0p[ld], r0p[2 * ld], 0);
      } else {
        slot[0] = make_int4(0, 0, 0, 0);
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < SLOTS; ++s) {
      const int k = lane + s * WARP;
      if (k <= hh) slot[s] = __ldcg(col + k);
    }
  }
  // The top edge (row r0) at the lane's columns.
  int pM[W], pX[W], pY[W];
  if (b > 0) {
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const int4 v = __ldcg(rowbuf + j0 + q);
      pM[q] = v.x, pX[q] = v.y, pY[q] = v.z;
    }
  } else if (P.row0) {
    const int* r0p = P.row0 + p * 3 * ld;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const int j = j0 + q;
      const bool in = j <= n;
      pM[q] = in ? r0p[j] : BIG;
      pX[q] = in ? r0p[ld + j] : BIG;
      pY[q] = in ? r0p[2 * ld + j] : BIG;
    }
  } else {  // Ix(0, j) = go + D[j]: go + D[c0] from the corner, then a scan
    const int base = c == 0 ? go : __shfl_sync(FULL, slot[0].y, 0);
    int part = 0;
#pragma unroll
    for (int q = 0; q < W; ++q) part += j0 + q <= n ? dc[q] : 0;
    int run = base + warp_scan(part, lane) - part;
#pragma unroll
    for (int q = 0; q < W; ++q) {
      run += j0 + q <= n ? dc[q] : 0;
      pM[q] = BIG, pX[q] = run, pY[q] = BIG;
    }
  }
#pragma unroll
  for (int s = 0; s < SLOTS; ++s) {
    const int k = lane + s * WARP;
    if (k <= hh) edge[k] = make_int4(slot[s].x, slot[s].y, slot[s].z, word[s]);
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

  // The lookups of the lane's row, made a step ahead: sub(a_i, b_j) for
  // the lane's columns and icost(a_i).
  // Lane 0's staged slot of the next step, read a step ahead: the left
  // cell (M, Ix, Iy) of its row and the word of the row after.
  int4 en = edge[min(1, hh)];
  int w = lane == 0 ? en.w : 0;
  int sb[W], ic = tab[(w & 0xffff) * A + gap];
  lookup<W, PROF>(tab, prof, A, w & 0xffff, lane, tk, sb);

  // Step k: lane l fills row r0 + 1 + k - l.
  int oM = BIG, oXu = BIG, oY = BIG;  // the lane's last cell
  const int steps = hh + lanes - 1;
  const int cols = min(BW, n - c0);
  uint8_t* mv = MOVES ? codes_of(P, p) + c0 + 1 : nullptr;
  const long long cld = MOVES ? codes_shape(P, p).x : 0;  // the codes' stride
#pragma unroll 2
  for (int k = 0; k < steps; ++k) {
    // The next step's word and lookups: lane 0 takes row k + 2 from the
    // edge, the others their left neighbour's word of this step.
    const int4 e = en;  // lane 0: slot k + 1, the left cell of row k + 1
    int wn = __shfl_up_sync(FULL, w, 1);
    if (lane == 0) {
      en = edge[min(k + 2, hh)];
      wn = en.w;
    }
    int sbn[W];
    const int icn = tab[(wn & 0xffff) * A + gap];
    lookup<W, PROF>(tab, prof, A, wn & 0xffff, lane, tk, sbn);
    // The left cell of the lane's row: the left lane's last cell of the
    // step before, or for lane 0 the staged left edge.
    int lM = __shfl_up_sync(FULL, oM, 1);
    int lXu = __shfl_up_sync(FULL, oXu, 1);
    int lY = __shfl_up_sync(FULL, oY, 1);
    if (lane == 0) lM = e.x, lXu = e.y, lY = e.z;
    const int r = k - lane;
    if (r >= 0 && r < hh && lane < lanes) {
      const int lX = min(lXu, BIG);
      int xu = lXu, hM = lM, hX = lX, hY = lY;
      uint32_t code[(W + 3) / 4] = {};
#pragma unroll
      for (int q = 0; q < W; ++q) {
        const int mp = pM[q], xp = pX[q], yp = pY[q];
        const int d = dc[q];
        int mc, yc;
        if (MOVES) {
          bool p1, p2, p3, p4;
          const int m1 = __vibmin_s32(dX, dY, &p1);    // dX <= dY
          const int best = __vibmin_s32(dM, m1, &p2);  // dM first
          mc = addmin(best, sb[q], BIG);
          const int t2 = __vibmin_s32(mp, xp, &p3);       // mp <= xp
          const int vy = __vibmin_s32(t2 + go, yp, &p4);  // Iy opens
          yc = addmin(vy, ic, BIG);
          code[q / 4] |= (uint32_t)((p2 ? 0 : (p1 ? 1 : 2)) |
                                    ((p4 ? (p3 ? 0 : 1) : 2) << 4))
                         << (8 * (q % 4));
        } else {
          mc = addmin(min3(dM, dX, dY), sb[q], BIG);
          yc = addmin(addmin(min(mp, xp), go, yp), ic, BIG);
        }
        xu = addmin(xu, d, min(hM, hY) + go + d);  // unclamped
        const int xc = min(xu, BIG);
        if (MOVES)
          code[q / 4] |= (uint32_t)(xc == hM + go + d ? 0 : (xc == hX + d ? 1 : 2))
                         << (8 * (q % 4) + 2);
        dM = mp, dX = xp, dY = yp;
        pM[q] = mc, pX[q] = xc, pY[q] = yc;
        hM = mc, hX = xc, hY = yc;
      }
      dM = lM, dX = lX, dY = lY;  // the next row's diagonal
      oM = pM[W - 1], oXu = xu, oY = pY[W - 1];
      if (lane == WARP - 1) edge[1 + r] = make_int4(oM, oXu, oY, 0);
      if (MOVES) {
        uint8_t* sp = stage + r * SLOT + lane * W;
        if (W % 4 == 0) {
#pragma unroll
          for (int u = 0; u < (W + 3) / 4; ++u)
            reinterpret_cast<uint32_t*>(sp)[u] = code[u];
        } else {
          *reinterpret_cast<uint16_t*>(sp) = (uint16_t)code[0];
        }
      }
      if (w >> 16) {  // a requested row
        int* ck_row = row_out(P, p, ck_lo + (w >> 16) - 1);
#pragma unroll
        for (int q = 0; q < W; ++q)
          if (j0 + q <= n)
            ck_row[j0 + q] = pM[q], ck_row[ld + j0 + q] = pX[q],
            ck_row[2 * ld + j0 + q] = pY[q];
        if (c == 0 && lane == 0)
          ck_row[0] = BIG, ck_row[ld] = BIG, ck_row[2 * ld] = lY;
      }
    }
    w = wn, ic = icn;
#pragma unroll
    for (int q = 0; q < W; ++q) sb[q] = sbn[q];
  }
  if (MOVES) {  // the tile's staged codes, a row a run
    __syncwarp();
    flush_rows<SLOT>(mv + (long long)(r0 + 1) * cld, cld, stage, hh, cols, lane);
  }
  // final3: the cell (m, n), in the lane's last row if the tile holds it.
  const int cn = n - j0;
  if (m - r0 <= H && cn >= 0 && cn < W) {
    int fM = BIG, fX = BIG, fY = BIG;
#pragma unroll
    for (int q = 0; q < W; ++q)
      if (q == cn) fM = pM[q], fX = pX[q], fY = pY[q];
    int* f3 = final3_of(P, p);
    f3[0] = fM, f3[1] = fX, f3[2] = fY;
  }
  // The bottom row (row r0 + hh), for the tile below; column 0's Iy there.
  if (lane < lanes) {
#pragma unroll
    for (int q = 0; q < W; ++q)
      __stcg(rowbuf + j0 + q, make_int4(pM[q], pX[q], pY[q], 0));
  }
  if (c == 0 && lane == 0) __stcg(rowbuf, make_int4(BIG, BIG, ybot, 0));
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

// Shared memory, in int32: the warps' edges, then (PROF) the table padded
// to 16 bytes and each warp's profile (A rows of 32 W), then (MOVES) the
// warps' code rings.
__host__ __device__ constexpr long long table_ints(int A) { return (A * A + 3) / 4 * 4; }

template <int H, int W, bool MOVES, bool PROF>
__global__ void __launch_bounds__(WARPS * WARP, 1)
gotoh_tile_kernel(const __grid_constant__ Params P) {
  extern __shared__ int4 smem[];
  const int lane = threadIdx.x % WARP;
  const int v = threadIdx.x / WARP;
  int4* edge = smem + v * (H + 1);
  int* s_tab = reinterpret_cast<int*>(smem + WARPS * (H + 1));
  int* profs = s_tab + (PROF ? table_ints(P.A) : 0);
  int* prof = PROF ? profs + (long long)v * P.A * WARP * W : nullptr;
  uint8_t* stage = MOVES ? reinterpret_cast<uint8_t*>(
                               profs + (PROF ? (long long)WARPS * P.A * WARP * W : 0)) +
                               v * H * slot_bytes<W>()
                         : nullptr;
  if (PROF) {
    for (int k = threadIdx.x; k < P.A * P.A; k += blockDim.x) s_tab[k] = P.cost[k];
    __syncthreads();
  }
  const int* tab = PROF ? s_tab : P.cost;
  write_boundary(P, tab);
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(P.flags, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= P.tiles) return;  // warp-uniform
    const int4 tile = __ldg(P.order + t);
    run_tile<H, W, MOVES, PROF>(P, tab, tile.x, tile.y, tile.z, lane, edge,
                                prof, stage);
  }
}

using Kernel = void (*)(const Params);

template <int H, int W>
Kernel pick_mode(bool moves, bool prof) {
  return moves ? (prof ? gotoh_tile_kernel<H, W, true, true>
                       : gotoh_tile_kernel<H, W, true, false>)
               : (prof ? gotoh_tile_kernel<H, W, false, true>
                       : gotoh_tile_kernel<H, W, false, false>);
}

// The kernel's (H, W) instances: ops/fill_tile.SHAPES.
Kernel pick(int H, int W, bool moves, bool prof) {
  if (H == 128 && W == 4) return pick_mode<128, 4>(moves, prof);
  if (H == 64 && W == 4) return pick_mode<64, 4>(moves, prof);
  if (H == 64 && W == 2) return pick_mode<64, 2>(moves, prof);
  if (H == 32 && W == 4) return pick_mode<32, 4>(moves, prof);
  return nullptr;
}

int stage_bytes(int W) {
  return W == 2 ? slot_bytes<2>() : slot_bytes<4>();
}

int optin_of[64];  // per device, 0 until read (an int write is benign)

}  // namespace

extern "C" {

// Launches the fill of B pairs on `stream`: tiles of H rows by 32 W
// columns, in the order of `order` ((tiles, 4) int32 of ops/fill_tile.
// tile_order); `meta` holds (m, n) a pair, the first list entry of each
// tile row (B, TB+1) and the row lists (B, K) (ops/fill_tile.metadata);
// `pairs` (B, 6) int64 each pair's seq_1 and seq_2 offsets (int32 words
// from tok_a and tok_b), its final3 row, and its codes' byte offset in
// `moves`, row stride and rows (ops/fill_tile.host_layout); rowbuf holds
// B (C 32 W + 1) and colbuf B TB (H + 1) int4, TB = ceil(M/H) and
// C = ceil(N/32W); flags holds 32 (1 + B C) zeroed int32.  `moves` (the
// codes buffer, uint8), `rows_out` ((B, K, 3, N+1) int32), `row0`
// ((B, 3, N+1)) and `col0y_top` ((B,)) may be null.  The caller checks the
// lengths, lists and codes regions (disjoint, each in the buffer).  One
// block of 4 warps an SM.
int gotoh_tile_launch(const void* tok_a, const void* tok_b,
                      const void* cost_mat, const void* row0,
                      const void* col0y_top, const void* meta,
                      const void* order, const void* pairs, void* final3,
                      void* moves, void* rows_out, void* rowbuf, void* colbuf,
                      void* flags,
                      int B, int M, int N, int A, int gap_id, int gap_open,
                      int K, int tiles, int H, int W, void* stream) {
  if (B < 1 || M < 0 || N < 0 || A < 1 || A > MAX_ALPHABET || gap_id < 0 ||
      gap_id >= A || K < 0 || (K > 0) != (rows_out != nullptr) || tiles < 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!optin_of[dev]) {
    err = cudaDeviceGetAttribute(&optin_of[dev],
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t edges = (size_t)WARPS * (H + 1) * sizeof(int4);
  const size_t stage = moves ? (size_t)WARPS * H * stage_bytes(W) : 0;
  const size_t lookups =  // the table and the warps' profiles
      (table_ints(A) + (size_t)WARPS * A * WARP * W) * sizeof(int);
  if (edges + stage > (size_t)optin_of[dev]) return (int)cudaErrorInvalidConfiguration;
  const bool prof = edges + stage + lookups <= (size_t)optin_of[dev];
  const size_t smem = edges + stage + (prof ? lookups : 0);
  const Kernel kernel = pick(H, W, moves != nullptr, prof);
  if (!kernel) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // past the default: opt in
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  Params P;
  P.tok_a = (const int*)tok_a, P.tok_b = (const int*)tok_b;
  P.cost = (const int*)cost_mat, P.row0 = (const int*)row0;
  P.col0y_top = (const int*)col0y_top, P.meta = (const int*)meta;
  P.order = (const int4*)order, P.pairs = (const longlong2*)pairs;
  P.final3 = (int*)final3;
  P.moves = (uint8_t*)moves, P.rows_out = (int*)rows_out;
  P.rowbuf = (int4*)rowbuf, P.colbuf = (int4*)colbuf, P.flags = (int*)flags;
  P.B = B, P.N = N, P.A = A, P.gap_id = gap_id, P.go = gap_open;
  P.K = K, P.TB = (M + H - 1) / H, P.C = (N + WARP * W - 1) / (WARP * W);
  P.tiles = tiles;
  if ((long long)tiles > (long long)B * P.TB * P.C) return (int)cudaErrorInvalidValue;

  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long want = ((long long)tiles + WARPS - 1) / WARPS;
  const int blocks = (int)(want < 1 ? 1 : want < sms ? want : sms);
  kernel<<<blocks, WARPS * WARP, smem, (cudaStream_t)stream>>>(P);
  return (int)cudaGetLastError();
}

const char* gotoh_tile_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
