// gotoh_fill.cu — Gotoh affine-gap DP fill for Hopper (sm_90a): final3
// and, optionally, the packed move codes, the last DP row, a block boundary
// injected from a checkpoint row, and — in strip mode — a column strip's
// left boundary taken from its neighbour and its own right edge.  One pair
// runs on a cluster of up to 8 blocks.
//
// What it replaces.  One kernel takes the place of these TPU kernels and
// modes (files under globalign_tpu/ops/):
//   * fill_lanes.py:_make_lane_kernel (via _lanes_run), moves mode, uniform
//     and general schemes — entries lanes_batch_moves / lanes_general_moves,
//     with their row0 / col0y_top injection (the blocked replay);
//   * fill_pallas.py:_make_stacked_kernel(want_moves=True) — entry
//     stacked_fill_with_moves, with its row0 / c0y_start injection;
//   * _make_lane_kernel's cost modes: final3 (lanes_batch_final3,
//     lanes_general_final3), last rows with injection
//     (lanes_batch_last_rows, lanes_general_last_rows) and the split's
//     2-pair last rows (lanes_split_fill_cost);
//   * fill_pallas.py:_make_stacked_kernel cost mode — stacked_fill_last_rows;
//   * fill_pallas.py:_make_row_kernel — row_fill_last_rows (row0 / col0y
//     overrides), the blocked traceback's checkpoint fill;
//   * fill_pallas.py:_make_strip_kernel (:1811) — strip_fill_block (:1956),
//     one column strip's block of rows in the sequence-parallel fill
//     (parallel/seqpar.py), as the strip mode below;
//   * the moves fills of an align_pairs call's traceback pairs past 1024
//     columns (csrc/gotoh_batch_moves.cu fills the others), which the JAX
//     package queues for one device walk over the call
//     (globalign_tpu/batch.py:_lanes_walk_fills, _mega_walk_flush), as the
//     ragged moves mode below.
// The TPU needed several kernels because Mosaic has no per-lane gather and
// VMEM sizing picks the variant; here a thread reads the (A, A) cost table
// at any index, so one kernel serves every scheme, alphabet and mode.
//
// What it computes.  For pair b, with 1-origin tokens tok_a[b, 0..M] and
// tok_b[b, 0..N] and true lengths m = m_true[b], n = n_true[b]:
//   final3[b] = (M, Ix, Iy) at cell (m, n);
//   moves[b, i, j] for 1 <= i <= m, 1 <= j <= n: bits 0-1 the M
//   predecessor, 2-3 Ix, 4-5 Iy (0 = M, 1 = Ix, 2 = Iy).  Every other
//   byte of moves[b] (row 0, column 0, the padding) is written 0;
//   last[b, :, j] = (M, Ix, Iy) of row m at column j <= n; column 0 is
//   (BIG, BIG, Iy(m, 0)), or row 0's column 0 when m = 0; columns past n
//   are written BIG.
// Boundary: row 0 is (BIG, go + D[j], BIG) with the (0, 0, 0) corner, and
// Iy(i, 0) = go + icost(a_1) + ... + icost(a_i) — unless row0[b] (3, N+1)
// replaces row 0 (corner included) and col0y_top[b] replaces the go that
// starts the column-0 sum.  A block of rows i0+1..i1 of a larger matrix is
// filled exactly by injecting its checkpoint row i0 and Iy(i0, 0).
// Strip mode (col0 (B, 3, M+1) given, with row0): column 0 is a neighbour
// strip's right edge, cell (i, 0) = col0[b, :, i] in all three lanes, and
// that Ix continues into row i without a fresh gap-open (the row scan's
// col0_full mode, fill_rows.py:119-124, :183-194).  The strip's own right
// edge comes back in edge (B, 3, M+1): entry 0 is row0 at column n, entry i
// the lanes of cell (i, n) for 1 <= i <= m, entries past m are BIG.  last
// is then the row m, column 0 included — the TPU kernel's `fin`.  Its
// `last` (the state after every row of a padded block) differs only on a
// partial final block, which no block follows, so it is not emitted.
// Ragged moves mode (gotoh_fill_ragged_launch): pair b is described by
// desc[b] (DESC_WORDS int64: its seq_1 and seq_2 token addresses, m, n, the
// byte offset of its codes in `moves`, their row stride ld >= n + 1, and
// its row of final3), so one launch takes pairs of any shapes, each with
// its codes packed where the caller placed them: (m + 1) rows of ld bytes,
// real cells as above, every other byte of the rows 0.  Offsets are 64-bit.
// The arithmetic is the row scan's (globalign_tpu/ops/fill_rows.py:133-289)
// in int32 with BIG = 1 << 30: the clamps min(., BIG) at :175, :177, :193,
// the code tests of :212-231 on unclamped sums with tie order M > Ix > Iy,
// and the boundary of fill_scan.py:90-104, written with sm_90's DPX forms.
// The row scan's Ix prefix minimum is carried as its serial form X[j] =
// min(X[j-1] + d_j, H[j-1] + d_j) with X[0] = BIG — the same integers, so
// codes match bit for bit; X crosses every strip edge unclamped.
//
// What bounds it on this card.  Each row of a strip is a serial chain (the
// Ix carry), so a pair is a skewed wavefront whose speed is the SM issue
// rate of the cells in flight, and a pair that runs on one SM uses 1 of 132.
// The design:
//   * Strip state in registers.  Lane l of a warp owns W consecutive
//     columns (W a template parameter, 4 to 32) and keeps its previous row
//     (M, Ix, Iy), its seq_2 tokens and their gap costs in registers; the
//     cost table is in shared memory (one lookup a cell).  Nothing of the
//     state goes to shared or global memory between rows.
//   * Skew inside a warp by shuffles.  In wave k lane l fills row k - l + 1;
//     its left edge (M, Ix, Iy, X unclamped) and its row's seq_1 token come
//     from lane l - 1 by __shfl_up_sync.  No block barrier in the wave loop.
//   * A chain of warps over a cluster.  A pair's columns are cut into warp
//     segments of 32 W columns; `warps` consecutive segments make a band,
//     one block a band, and the P bands of a pair are one thread block
//     cluster (co-scheduled, so no band waits on a band that never runs).
//     A warp's right edge goes to the next warp's ring of RING rows in that
//     warp's shared memory (the next block's through distributed shared
//     memory) by st.async, each hand-off of CH rows counted on an mbarrier
//     of the consumer's (its transaction bytes); the consumer waits on its
//     own barrier, takes the CH rows into registers, and arrives on the
//     producer's barrier of that ring slot when it has used them, so only
//     the two warps concerned synchronise, with no fence.  Wider pairs
//     than a cluster holds run in passes over the columns; a pass leaves
//     its right edge in a global buffer for the next (one cluster barrier
//     between passes).
//   * Coalesced code stores.  A warp stages its skewed codes in a shared
//     ring of 32 rows; the row that lane 31 completes in wave k is written
//     out by the whole warp as one contiguous run of 32 W bytes, in aligned
//     4-byte words (the row stride N + 1 is odd, so each row's head and
//     tail bytes go singly).
// The host (ops/fill_cuda.py:plan) picks W, warps and P from B, N and the
// SM count so that B * P blocks fill the card where the width allows; the
// launcher refuses a cluster the card cannot schedule.
// What bounds it now (H100 80GB HBM3 at 700 W, measured by the timing
// script that lived at chip_smoke.py until commit b226048): an 8000^2
// cost-only fill runs at ~0.9 cells a clock on each of its 8 SMs, an
// eighth of that script's probe cell rate.  A pair is held to the 8 SMs of
// one portable cluster, 2 warps a scheduler, and each wave pays its
// shuffles, lookups and hand-off tests for only W cells a lane.
//
// Launch conventions: the kernel runs on the caller's stream, allocates
// nothing (the caller passes every output and the pass buffer), and the
// launcher returns the launch's error code.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <vector>

namespace cg = cooperative_groups;

namespace {

constexpr int BIG = 1 << 30;
constexpr int WARP = 32;
constexpr int MAX_WARPS = 8;
constexpr int MAX_BANDS = 8;  // the portable cluster size
constexpr int CH = 16;        // rows a hand-off between warps
constexpr int RING = 64;      // rows an edge ring holds
constexpr int NSLOT = RING / CH;  // hand-offs a ring holds
constexpr unsigned FULL = 0xffffffffu;
constexpr int DESC_WORDS = 8;  // int64 words of a ragged pair descriptor

// Bytes a staged code row takes: 32 W plus a pad that makes the lanes'
// skewed word stores fall in distinct banks.
template <int W>
__host__ __device__ constexpr int slot_bytes() {
  return WARP * W + ((W / 4) % 2 ? 8 : 4);
}

struct Args {
  const int* tok_a;
  const int* tok_b;
  const int* cost;
  const int* m_true;  // ragged moves mode: the descriptors (below)
  const int* n_true;
  const int* row0;
  const int* col0y_top;
  const int* col0;
  int* final3;
  uint8_t* moves;
  int* last;
  int* edge;
  int4* pass_edge;  // (B, 2, M+1): a pass's right edge for the next pass
  int M, N, A, gap_id, go, P;
};

// Ragged moves mode: (B, DESC_WORDS) int64 pair descriptors in m_true's
// place, which that mode does not read.  Not a field of its own: one more
// field alone changes how ptxas allocates the other modes' registers (the
// W = 16 moves instances then spill).
__device__ __forceinline__ const long long* descriptors(const Args& a) {
  return reinterpret_cast<const long long*>(a.m_true);
}

// 32-bit shared-memory addresses: a block's own (shared::cta) and, through
// mapa, a block's of the cluster (shared::cluster).  The rings and their
// barriers are reached only so, never through generic pointers.
__device__ __forceinline__ uint32_t cta_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(cta_addr(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ void bar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(cta_addr(bar)) : "memory");
}

__device__ __forceinline__ void bar_inval(uint64_t* bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];" ::"r"(cta_addr(bar)) : "memory");
}

// One row of the ring into a neighbour's shared memory, counted on its
// barrier (the transaction bytes the barrier waits for).
__device__ __forceinline__ void st_async(uint32_t a, int4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.s32 [%0], "
      "{%1, %2, %3, %4}, [%5];"
      ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

// The producer's arrival on a neighbour's barrier, with the bytes of the
// hand-off it will store there.
__device__ __forceinline__ void bar_expect(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, [%0], %1;"
      ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void bar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];"
               ::"r"(bar) : "memory");
}

// Waits for phase `parity` of a barrier of this block; traps after ~2^30
// polls, so a wait that cannot end fails the launch instead of hanging.
__device__ __forceinline__ void bar_wait(uint32_t bar, int parity) {
  long long polls = 0;
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (++polls > (1LL << 30)) __trap();
  }
}

__device__ __forceinline__ int4 shfl4(int4 x, int src) {
  return make_int4(__shfl_sync(FULL, x.x, src), __shfl_sync(FULL, x.y, src),
                   __shfl_sync(FULL, x.z, src), __shfl_sync(FULL, x.w, src));
}

__device__ __forceinline__ int warp_sum(int x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// Copies `cols` staged code bytes to dst (any alignment): head bytes
// singly, then aligned words, then the tail.
__device__ __forceinline__ void flush_row(uint8_t* dst, const uint8_t* src,
                                          int cols, int lane) {
  const int head = min((int)((4 - ((uintptr_t)dst & 3)) & 3), cols);
  if (lane < head) dst[lane] = src[lane];
  const int words = (cols - head) >> 2;
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(src);
  uint32_t* dw = reinterpret_cast<uint32_t*>(dst + head);
  const unsigned sel = head | ((head + 1) << 4) | ((head + 2) << 8) |
                       ((head + 3) << 12);
  for (int t = lane; t < words; t += WARP)  // src bytes head + 4t ..
    dw[t] = __byte_perm(sw[t], sw[t + 1], sel);
  const int done = head + 4 * words;
  if (lane < cols - done) dst[done + lane] = src[done + lane];
}

// min(a + b, c) and min(a, b, c): sm_90's DPX forms.
__device__ __forceinline__ int addmin(int a, int b, int c) {
  return __viaddmin_s32(a, b, c);
}

__device__ __forceinline__ int min3(int a, int b, int c) {
  return __vimin3_s32(a, b, c);
}

// Pair b's row of final3: its descriptor's in ragged mode.  Found where it
// is written, so no pointer to it stays live through the waves.
template <bool RAGGED>
__device__ __forceinline__ int* final3_row(const Args& a, int b) {
  return a.final3 + 3 * (RAGGED ? descriptors(a)[(long long)b * DESC_WORDS + 6]
                                : (long long)b);
}

// RAGGED (with MOVES) reads each pair's shape from its descriptor; an
// instance of its own, so the other modes compile as if it did not exist.
template <int W, bool MOVES, bool TSMEM, bool RAGGED>
__global__ void __launch_bounds__(MAX_WARPS * WARP, 1)
gotoh_fill_kernel(const Args a) {
  extern __shared__ int4 smem[];
  __shared__ uint64_t s_full[MAX_WARPS][NSLOT];   // hand-offs into v's ring
  __shared__ uint64_t s_empty[MAX_WARPS][NSLOT];  // v's consumer took them
  __shared__ int s_red[MAX_WARPS];
  __shared__ int s_tot[MAX_WARPS];
  constexpr int SW = WARP * W;  // columns a warp
  constexpr int SLOT = slot_bytes<W>();

  cg::cluster_group cluster = cg::this_cluster();
  const int warps = blockDim.x / WARP;
  const int lane = threadIdx.x % WARP;
  const int v = threadIdx.x / WARP;
  const int P = a.P;
  const int b = blockIdx.x / P;
  const int p = blockIdx.x % P;  // the block's rank in its cluster
  const int A = a.A, go = a.go, gap_id = a.gap_id;
  const bool strip = a.col0 != nullptr;
  const bool want_last = a.last != nullptr;

  int4* ring = smem;  // [warps][RING] edges into warp v
  int* tab_s = reinterpret_cast<int*>(smem + warps * RING);
  // The cost table: in shared memory when it fits (TSMEM), else read
  // from global memory, so no alphabet is refused.
  const int* tab = TSMEM ? tab_s : a.cost;
  if (TSMEM)
    for (int k = threadIdx.x; k < A * A; k += blockDim.x) tab_s[k] = a.cost[k];
  uint8_t* stage =
      MOVES ? reinterpret_cast<uint8_t*>(tab_s + (TSMEM ? A * A : 0)) +
                  v * WARP * SLOT
            : nullptr;
  if (threadIdx.x < warps * NSLOT) {
    bar_init(&s_full[threadIdx.x / NSLOT][threadIdx.x % NSLOT]);
    bar_init(&s_empty[threadIdx.x / NSLOT][threadIdx.x % NSLOT]);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }

  // The pair's shape: its lengths, its rows M and row stride ld (its codes
  // and rows hold columns 0..N), its tokens and codes.
  const long long* d = RAGGED ? descriptors(a) + (long long)b * DESC_WORDS : nullptr;
  const int m = RAGGED ? (int)d[2] : a.m_true[b];
  const int n = RAGGED ? (int)d[3] : a.n_true[b];
  const int M = RAGGED ? m : a.M;
  const long long ld = RAGGED ? d[5] : a.N + 1;
  const int N = RAGGED ? (int)(ld - 1) : a.N;
  const int* ta = RAGGED ? (const int*)d[0] : a.tok_a + (long long)b * (M + 1);
  const int* tb = RAGGED ? (const int*)d[1] : a.tok_b + (long long)b * (N + 1);
  const long long lc = a.M + 1;  // row stride of col0, edge and pass_edge
  const int* r0 = a.row0 ? a.row0 + (long long)b * 3 * ld : nullptr;
  int* lst = want_last ? a.last + (long long)b * 3 * ld : nullptr;
  const int* c0s = strip ? a.col0 + (long long)b * 3 * lc : nullptr;
  int* eg = strip ? a.edge + (long long)b * 3 * lc : nullptr;
  uint8_t* mv = !MOVES ? nullptr
                : RAGGED ? a.moves + d[4]
                         : a.moves + (long long)b * (M + 1) * ld;
  const int c0 = a.col0y_top ? a.col0y_top[b] : go;  // Iy(0, 0) seed

  // Every byte the waves do not write, shared among the pair's P blocks.
  const int tid = p * blockDim.x + threadIdx.x;
  const int nthr = P * blockDim.x;
  if (MOVES) {
    for (long long j = tid; j <= N; j += nthr) mv[j] = 0;
    for (long long i = 1 + tid; i <= M; i += nthr) mv[i * ld] = 0;
    const int pad = N - n;
    if (pad > 0)
      for (long long k = tid; k < (long long)m * pad; k += nthr)
        mv[(1 + k / pad) * ld + n + 1 + k % pad] = 0;
    for (long long k = (m + 1) * ld + tid; k < (M + 1) * ld; k += nthr) mv[k] = 0;
  }
  if (want_last)
    for (int j = n + 1 + tid; j <= N; j += nthr)
      lst[j] = lst[ld + j] = lst[2 * ld + j] = BIG;
  if (strip) {
    for (int i = m + 1 + tid; i <= M; i += nthr)
      eg[i] = eg[lc + i] = eg[2 * lc + i] = BIG;
    if (tid == 0) eg[0] = r0[n], eg[lc] = r0[ld + n], eg[2 * lc] = r0[2 * ld + n];
  }
  __syncthreads();  // the cost table is staged
  const int* gap_row = tab + gap_id * A;  // dcost(c) = cost('-', c)

  if (m == 0 || n == 0) {  // only boundary cells: fill_scan.py:90-104
    if (tid == 0) {        // (m and n are the cluster's: all its blocks leave)
      int f0, f1, f2;
      if (m == 0 && r0) {  // the injected row is the last row
        f0 = r0[n], f1 = r0[ld + n], f2 = r0[2 * ld + n];
        if (want_last)
          for (int j = 0; j <= n; ++j)
            lst[j] = r0[j], lst[ld + j] = r0[ld + j], lst[2 * ld + j] = r0[2 * ld + j];
      } else if (m == 0) {  // row 0: (0, 0, 0), then (BIG, go + D[j], BIG)
        int acc = go;
        f0 = 0, f1 = 0, f2 = 0;
        if (want_last) lst[0] = lst[ld] = lst[2 * ld] = 0;
        for (int j = 1; j <= n; ++j) {
          acc += gap_row[tb[j]];
          f0 = BIG, f1 = acc, f2 = BIG;
          if (want_last) lst[j] = BIG, lst[ld + j] = acc, lst[2 * ld + j] = BIG;
        }
      } else if (strip) {  // n == 0: the strip is its left edge
        f0 = c0s[m], f1 = c0s[lc + m], f2 = c0s[2 * lc + m];
        for (int i = 1; i <= m; ++i)
          eg[i] = c0s[i], eg[lc + i] = c0s[lc + i], eg[2 * lc + i] = c0s[2 * lc + i];
        if (want_last) lst[0] = f0, lst[ld] = f1, lst[2 * ld] = f2;
      } else {  // n == 0: column 0 only
        int acc = c0;
        for (int i = 1; i <= m; ++i) acc += tab[ta[i] * A + gap_id];
        f0 = BIG, f1 = BIG, f2 = acc;
        if (want_last) lst[0] = BIG, lst[ld] = BIG, lst[2 * ld] = acc;
      }
      int* f3 = final3_row<RAGGED>(a, b);
      f3[0] = f0, f3[1] = f1, f3[2] = f2;
    }
    return;
  }
  cluster.sync();  // every block's flags are zero before any remote write

  const int BW = warps * SW;  // columns a band
  const int C = P * BW;       // columns a pass
  const int chain = P * warps;
  const int passes = (n + C - 1) / C;
  const int4 big4 = make_int4(BIG, BIG, BIG, BIG);
  for (int q = 0; q < passes; ++q) {
    if (q > 0) {  // the last pass is done and its edge written
      cluster.sync();
      if (threadIdx.x < warps * NSLOT) {  // every barrier back to phase 0
        uint64_t* f = &s_full[threadIdx.x / NSLOT][threadIdx.x % NSLOT];
        uint64_t* e = &s_empty[threadIdx.x / NSLOT][threadIdx.x % NSLOT];
        bar_inval(f), bar_inval(e), bar_init(f), bar_init(e);
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      }
      cluster.sync();
    }
    const int g = p * warps + v;  // the warp's place in the pass's chain
    const int J0 = q * C + g * SW + 1;
    const int j0 = J0 + lane * W;  // the lane's first column

    // Tokens and gap costs of the lane's columns; D[j0 - 1], the prefix of
    // the gap costs (int32 wraps as the row scan's cumsum): the block's
    // sum over the columns before its band, then a scan over its lanes.
    // tk2 packs the tokens two to a register; D[c] = d_0 + ... + d_c is
    // the strip's own prefix of the gap costs d_c = dcost(b_{j0+c}).
    int tk2[W / 2], D[W];
    int part = 0;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      const int t = j0 + c <= n ? tb[j0 + c] : 0;
      if (c % 2 == 0) tk2[c / 2] = t;
      else tk2[c / 2] |= t << 16;
      part += j0 + c <= n ? gap_row[t] : 0;
      D[c] = (c > 0 ? D[c - 1] : 0) + gap_row[t];
    }
    int d_before = 0;
    if (!r0) {
      const int band0 = q * C + p * BW + 1;
      int s = 0;
      for (int j = 1 + threadIdx.x; j < band0 && j <= n; j += blockDim.x)
        s += gap_row[tb[j]];
      s = warp_sum(s);
      int incl = part;
      for (int off = 1; off < WARP; off <<= 1) {
        const int x = __shfl_up_sync(FULL, incl, off);
        if (lane >= off) incl += x;
      }
      if (lane == 0) s_red[v] = s;
      if (lane == WARP - 1) s_tot[v] = incl;
      __syncthreads();
      d_before = incl - part;
      for (int u = 0; u < warps; ++u) d_before += s_red[u] + (u < v ? s_tot[u] : 0);
      __syncthreads();
    }

    if (J0 <= n) {  // a warp with columns of this pair (warp-uniform)
      // Row 0 and the diagonal predecessor of the strip's first cell.
      int pM[W], pX[W], pY[W];
      int dM, dX, dY;
      if (r0) {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          const int j = j0 + c;
          pM[c] = j <= n ? r0[j] : BIG;
          pX[c] = j <= n ? r0[ld + j] : BIG;
          pY[c] = j <= n ? r0[2 * ld + j] : BIG;
        }
        const bool in = j0 - 1 <= n;
        dM = in ? r0[j0 - 1] : BIG;
        dX = in ? r0[ld + j0 - 1] : BIG;
        dY = in ? r0[2 * ld + j0 - 1] : BIG;
      } else {
#pragma unroll
        for (int c = 0; c < W; ++c)
          pM[c] = BIG, pX[c] = go + d_before + D[c], pY[c] = BIG;
        if (j0 == 1) dM = 0, dX = 0, dY = 0;
        else dM = BIG, dX = go + d_before, dY = BIG;
      }

      // Where lane 0's left edge comes from: 0 the ring (a warp before it),
      // 1 the last pass's edge, 2 the strip's col0, 3 the matrix edge.
      const int kind = g > 0 ? 0 : (q > 0 ? 1 : (strip ? 2 : 3));
      const int4* pass_in =
          kind == 1 ? a.pass_edge + ((long long)b * 2 + ((q - 1) & 1)) * lc : nullptr;
      const bool has_next = g + 1 < chain && J0 + SW <= n;
      const bool to_pass = g + 1 == chain && q + 1 < passes;
      int4* pass_out =
          to_pass ? a.pass_edge + ((long long)b * 2 + (q & 1)) * lc : nullptr;
      uint32_t ring_out = 0, full_out = 0;  // the next warp's ring, barriers
      if (has_next) {
        const int pn = (g + 1) / warps, vn = (g + 1) % warps;
        ring_out = cluster_addr(ring + vn * RING, pn);
        full_out = cluster_addr(&s_full[vn][0], pn);
      }
      const uint32_t empty_out =  // the last warp's barriers: what this took
          g > 0 ? cluster_addr(&s_empty[(g - 1) % warps][0], (g - 1) / warps) : 0;
      const uint32_t full_in = cta_addr(&s_full[v][0]);
      const uint32_t empty_in = cta_addr(&s_empty[v][0]);
      const int4* ring_in = ring + v * RING;
      auto edge_at = [&](int row) -> int4 {  // a global left edge
        if (row > m || kind == 0 || kind == 3) return big4;
        if (kind == 1) return pass_in[row];
        const int x = c0s[lc + row];
        return make_int4(c0s[row], x, c0s[2 * lc + row], x);
      };

      const int cn = n - j0;  // the lane's slot of column n, if it holds it
      const bool holds_n = cn >= 0 && cn < W;
      // Lanes < CH hold rows base + lane of the current hand-off: its left
      // edges and, a wave ahead, its seq_1 tokens; for a global source the
      // next hand-off's edges too.
      int4 ce = big4;
      int4 ne = lane < CH ? edge_at(1 + lane) : big4;
      int ctok = lane < CH && 1 + lane <= m ? ta[1 + lane] : 0;
      int ntok = lane < CH && 1 + CH + lane <= m ? ta[1 + CH + lane] : 0;
      int col0y = c0;  // matrix edge: Iy(i, 0) = c0 + icost(a_1..a_i)
      int oM = BIG, oX = BIG, oY = BIG, oXu = BIG;  // right edge of last row
      int arow = __shfl_sync(FULL, ctok, 0);  // seq_1 token of the lane's row
      // The row's cost-table lookups, made a wave ahead: sub(a_i, b_j) for
      // the lane's columns and icost(a_i).
      int sb[W], icn;
      auto lookups = [&](int ai) {
        const int* row = tab + ai * A;
        icn = row[gap_id];
#pragma unroll
        for (int c = 0; c < W; ++c) sb[c] = row[(tk2[c / 2] >> (16 * (c % 2))) & 0xffff];
      };
      lookups(arow);

      const int waves = m + WARP - 1;
      for (int k = 0; k < waves; ++k) {
        const int i = k - lane + 1;  // this lane's row
        if (k < m && k % CH == 0) {  // lane 0 starts hand-off rows k+1..
          const int row = k + 1 + lane;
          if (kind == 0) {
            const int c = k / CH;  // this hand-off; the last one is used up
            if (lane == 0 && c > 0) bar_arrive(empty_out + 8 * ((c - 1) % NSLOT));
            bar_wait(full_in + 8 * (c % NSLOT), (c / NSLOT) & 1);
            ce = lane < CH && row <= m ? ring_in[row % RING] : big4;
          } else {
            ce = ne;
            ne = lane < CH ? edge_at(row + CH) : big4;
          }
        }
        // Lane 31 fills row k - 30 and writes it to the next ring: its slot
        // must be free.
        const int i31 = k - (WARP - 2);
        if (has_next && i31 >= 1 && i31 <= m && (i31 - 1) % CH == 0) {
          const int c = (i31 - 1) / CH;  // its slot held hand-off c - NSLOT
          if (c >= NSLOT)
            bar_wait(empty_in + 8 * (c % NSLOT), ((c / NSLOT) - 1) & 1);
          if (lane == WARP - 1)
            bar_expect(full_out + 8 * (c % NSLOT), 16 * min(CH, m - i31 + 1));
        }
        // The left edge of this lane's row (the neighbour's right edge of
        // the same row, filled in the last wave); only Ix's tail needs it.
        const int rM = __shfl_up_sync(FULL, oM, 1);
        const int rX = __shfl_up_sync(FULL, oX, 1);
        const int rY = __shfl_up_sync(FULL, oY, 1);
        const int rXu = __shfl_up_sync(FULL, oXu, 1);
        const int4 e0 = shfl4(ce, k % CH);
        if (i >= 1 && i <= m) {
          const int ic = icn;  // icost(a_i)
          // M and Iy of the row need only the row above and the diagonal;
          // so does G[c] = min over 1 <= k <= c of h_k + d_{k+1} + ... + d_c,
          // h_k = min(M, Iy)(i, j0+k-1) + go + d_k, the part of Ix that
          // does not start at the left edge.  pX[c] holds G[c] until the
          // left edge comes.
          uint32_t code[MOVES ? W / 4 : 1] = {};
          int gx = 0;
#pragma unroll
          for (int c = 0; c < W; ++c) {
            const int mp = pM[c], xp = pX[c], yp = pY[c];
            const int sub = sb[c];
            int mc, yc;
            if (MOVES) {
              bool p1, p2, p3, p4;
              const int m1 = __vibmin_s32(dX, dY, &p1);    // dX <= dY
              const int best = __vibmin_s32(dM, m1, &p2);  // dM first
              mc = addmin(best, sub, BIG);
              const int t2 = __vibmin_s32(mp, xp, &p3);    // mp <= xp
              const int vy = __vibmin_s32(t2 + go, yp, &p4);  // Iy opens
              yc = addmin(vy, ic, BIG);
              code[c / 4] |= (uint32_t)((p2 ? 0 : (p1 ? 1 : 2)) |
                                        ((p4 ? (p3 ? 0 : 1) : 2) << 4))
                             << (8 * (c % 4));
            } else {
              mc = addmin(min3(dM, dX, dY), sub, BIG);
              yc = addmin(addmin(min(mp, xp), go, yp), ic, BIG);
            }
            if (c > 0) {
              const int d = D[c] - D[c - 1];
              const int h = min(pM[c - 1], pY[c - 1]) + go + d;
              gx = c == 1 ? h : addmin(gx, d, h);
              pX[c] = gx;
            }
            dM = mp, dX = xp, dY = yp;
            pM[c] = mc, pY[c] = yc;
          }
          int lM, lX, lY, lXu;  // row i, column j0 - 1
          if (lane > 0) {
            lM = rM, lX = rX, lY = rY, lXu = rXu;
          } else if (kind == 3) {
            col0y += ic;
            lM = BIG, lX = BIG, lY = col0y, lXu = BIG;
          } else {
            lM = e0.x, lX = e0.y, lY = e0.z, lXu = e0.w;
          }
          // Ix: X[c] = min(L + D[c], G[c]) with L = min(X, min(M, Iy) + go)
          // of the left edge — the serial X[c] = min(X[c-1] + d_c, h_c)
          // unrolled, the same integers.
          const int L = min(lXu, min(lM, lY) + go);
          int xu = L + D[0];
#pragma unroll
          for (int c = 0; c < W; ++c) {
            if (c > 0) xu = addmin(L, D[c], pX[c]);
            const int xc = min(xu, BIG);
            if (MOVES) {
              const int d = c > 0 ? D[c] - D[c - 1] : D[0];
              const int hM = c > 0 ? pM[c - 1] : lM;  // M and Ix to the left
              const int hX = c > 0 ? pX[c - 1] : lX;
              code[c / 4] |= (uint32_t)(xc == hM + go + d ? 0 : (xc == hX + d ? 1 : 2))
                             << (8 * (c % 4) + 2);
            }
            pX[c] = xc;
          }
          const int eM = lM, eX = lX, eY = lY;
          if (MOVES) {
            uint32_t* sp = reinterpret_cast<uint32_t*>(
                stage + (i % WARP) * SLOT + lane * W);
#pragma unroll
            for (int u = 0; u < W / 4; ++u) sp[u] = code[u];
          }
          oM = pM[W - 1], oX = pX[W - 1], oY = pY[W - 1], oXu = xu;
          if (lane == WARP - 1) {  // the warp's right edge
            if (has_next) {
              st_async(ring_out + 16 * (i % RING), make_int4(oM, oX, oY, oXu),
                       full_out + 8 * (((i - 1) / CH) % NSLOT));
            } else if (to_pass) {
              pass_out[i] = make_int4(oM, oX, oY, oXu);
            }
          }
          if (holds_n) {  // column n: final3 and the strip's right edge
            int fM = BIG, fX = BIG, fY = BIG;
#pragma unroll
            for (int c = 0; c < W; ++c)
              if (c == cn) fM = pM[c], fX = pX[c], fY = pY[c];
            if (strip) eg[i] = fM, eg[lc + i] = fX, eg[2 * lc + i] = fY;
            if (i == m) {
              int* f3 = final3_row<RAGGED>(a, b);
              f3[0] = fM, f3[1] = fX, f3[2] = fY;
            }
          }
          if (want_last && i == m) {  // the strip's share of the last row
            if (j0 == 1) {
              lst[0] = strip ? eM : BIG, lst[ld] = strip ? eX : BIG;
              lst[2 * ld] = strip ? eY : col0y;
            }
#pragma unroll
            for (int c = 0; c < W; ++c)
              if (j0 + c <= n)
                lst[j0 + c] = pM[c], lst[ld + j0 + c] = pX[c],
                lst[2 * ld + j0 + c] = pY[c];
          }
          dM = eM, dX = eX, dY = eY;
        }
        // The next wave's row token: lane 0 takes row k + 2 from the
        // hand-off, the others their left neighbour's.
        if ((k + 1) % CH == 0) {
          ctok = ntok;
          const int row = k + 2 + CH + lane;
          ntok = lane < CH && row <= m ? ta[row] : 0;
        }
        const int a_up = __shfl_up_sync(FULL, arow, 1);
        const int a0 = __shfl_sync(FULL, ctok, (k + 1) % CH);
        arow = lane == 0 ? a0 : a_up;
        lookups(arow);
        if (MOVES) {  // lane 31 completed row k - 30: one contiguous run
          __syncwarp();
          if (i31 >= 1 && i31 <= m)
            flush_row(mv + i31 * ld + J0, stage + (i31 % WARP) * SLOT,
                      min(SW, n - J0 + 1), lane);
          __syncwarp();
        }
      }
    }
  }
  cluster.sync();  // no block leaves while a neighbour may still write to it
}

using Kernel = void (*)(const Args);

template <bool MOVES, bool TSMEM, bool RAGGED>
Kernel pick_width(int W) {
  switch (W) {
    case 4: return gotoh_fill_kernel<4, MOVES, TSMEM, RAGGED>;
    case 8: return gotoh_fill_kernel<8, MOVES, TSMEM, RAGGED>;
    case 16: return gotoh_fill_kernel<16, MOVES, TSMEM, RAGGED>;
    case 32:  // 32 staged rows of 1 KB a warp: no codes
      return MOVES ? nullptr : gotoh_fill_kernel<32, false, TSMEM, false>;
    default: return nullptr;
  }
}

// The ragged mode is a moves mode.
Kernel pick_kernel(int W, bool moves, bool tsmem, bool ragged) {
  if (ragged)
    return tsmem ? pick_width<true, true, true>(W) : pick_width<true, false, true>(W);
  return moves ? (tsmem ? pick_width<true, true, false>(W)
                        : pick_width<true, false, false>(W))
               : (tsmem ? pick_width<false, true, false>(W)
                        : pick_width<false, false, false>(W));
}

int stage_bytes(int W) {
  switch (W) {
    case 4: return slot_bytes<4>();
    case 8: return slot_bytes<8>();
    case 16: return slot_bytes<16>();
    default: return slot_bytes<32>();
  }
}

// The card queries of a launch, made once: a traceback chunk launches the
// fill ~50 times on a few shapes.  Guarded, since ctypes releases the GIL.
struct Placed {  // a shape the occupancy query placed
  Kernel kernel;
  int dev;
  size_t smem;
  int warps;
  int P;
  int clusters;  // of the shape the card holds at once
};
struct Allowed {  // the dynamic shared memory a kernel may take on a card
  Kernel kernel;
  int dev;
  size_t smem;
};
std::mutex cache_mu;
std::vector<int> optin_of;  // per device, 0 until read
std::vector<Placed> placed;
std::vector<Allowed> allowed;

cudaError_t optin_bytes(int dev, int* optin) {
  std::lock_guard<std::mutex> hold(cache_mu);
  if ((int)optin_of.size() <= dev) optin_of.resize(dev + 1, 0);
  if (!optin_of[dev]) {
    const cudaError_t err = cudaDeviceGetAttribute(
        &optin_of[dev], cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err != cudaSuccess) return err;
  }
  *optin = optin_of[dev];
  return cudaSuccess;
}

// Lets `kernel` take `smem` bytes and reads how many clusters of `cfg` the
// card holds at once into `clusters`; cudaErrorInvalidConfiguration if none
// fits.
cudaError_t place(Kernel kernel, int dev, size_t smem, int warps, int P,
                  const cudaLaunchConfig_t& cfg, int* clusters) {
  std::lock_guard<std::mutex> hold(cache_mu);
  for (const Placed& p : placed)
    if (p.kernel == kernel && p.dev == dev && p.smem == smem &&
        p.warps == warps && p.P == P) {
      *clusters = p.clusters;
      return cudaSuccess;
    }
  Allowed* allow = nullptr;
  for (Allowed& a : allowed)
    if (a.kernel == kernel && a.dev == dev) allow = &a;
  if (!allow || allow->smem < smem) {
    const cudaError_t err = cudaFuncSetAttribute(
        (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    if (allow)
      allow->smem = smem;
    else
      allowed.push_back({kernel, dev, smem});
  }
  int count = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&count, (const void*)kernel, &cfg);
  if (err != cudaSuccess) return err;
  if (count < 1) return cudaErrorInvalidConfiguration;
  placed.push_back({kernel, dev, smem, warps, P, count});
  *clusters = count;
  return cudaSuccess;
}

// The kernel and dynamic shared memory of a launch shape on card `dev`: the
// (A, A) cost table in shared memory where it fits beside the rings and
// the staged codes.
cudaError_t shape_of(int dev, int A, bool moves, bool ragged, int W, int warps,
                     Kernel* kernel, size_t* smem) {
  int optin = 0;
  const cudaError_t err = optin_bytes(dev, &optin);
  if (err != cudaSuccess) return err;
  // s_full, s_empty, s_red and s_tot
  const size_t static_bytes = 2 * MAX_WARPS * (NSLOT * sizeof(uint64_t) + sizeof(int));
  const size_t ring_bytes = (size_t)warps * RING * sizeof(int4);
  const size_t stage = moves ? (size_t)warps * WARP * stage_bytes(W) : 0;
  const size_t table_bytes = (size_t)A * A * sizeof(int);
  if (static_bytes + ring_bytes + stage > (size_t)optin)
    return cudaErrorInvalidConfiguration;
  const bool table_in_smem =
      static_bytes + ring_bytes + stage + table_bytes <= (size_t)optin;
  *smem = ring_bytes + stage + (table_in_smem ? table_bytes : 0);
  *kernel = pick_kernel(W, moves, table_in_smem, ragged);
  return *kernel ? cudaSuccess : cudaErrorInvalidValue;
}

// The configuration of a launch of B clusters of P blocks of `warps` warps;
// `attr` holds its cluster attribute.
cudaLaunchConfig_t config_of(int B, int P, int warps, size_t smem,
                             void* stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * P);
  cfg.blockDim = dim3(warps * WARP);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launches one fill: B pairs of up to M rows (pass_edge's row stride) and
// N columns, W columns a lane, `warps` warps a block, P blocks a pair.
cudaError_t launch(Args args, int B, int N, bool moves, bool ragged, int W,
                   int warps, int P, void* stream) {
  if (B < 1 || args.M < 0 || N < 0 || args.A < 1 || warps < 1 ||
      warps > MAX_WARPS || P < 1 || P > MAX_BANDS ||
      (long long)B * P > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  if ((long long)N > (long long)P * warps * WARP * W && !args.pass_edge)
    return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  Kernel kernel = nullptr;
  size_t smem = 0;
  err = shape_of(dev, args.A, moves, ragged, W, warps, &kernel, &smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config_of(B, P, warps, smem, stream, attr);
  int clusters = 0;
  err = place(kernel, dev, smem, warps, P, cfg, &clusters);
  if (err != cudaSuccess) return err;
  args.P = P;
  err = cudaLaunchKernelEx(&cfg, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the fill of B pairs on `stream`: W columns a lane, `warps` warps
// a block, P blocks (a cluster) a pair; pairs wider than P * warps * 32 * W
// columns run in passes and need `pass_edge` ((B, 2, M+1) int4).  `moves`
// (W <= 16) and `last` may be null (not wanted); `row0` ((B, 3, N+1)) and
// `col0y_top` ((B,)) may be null (the default boundary).  `col0`
// ((B, 3, M+1)) selects strip mode, which needs `row0`, `last` and `edge`
// ((B, 3, M+1)) and no `moves`; otherwise `col0` and `edge` are null.
// Lengths in m_true / n_true must lie in [0, M] / [0, N] (the caller
// checks).  A shape the card cannot schedule is refused, never queued.
int gotoh_fill_launch(const void* tok_a, const void* tok_b,
                      const void* cost_mat, const void* m_true,
                      const void* n_true, const void* row0,
                      const void* col0y_top, const void* col0, void* final3,
                      void* moves, void* last, void* edge, void* pass_edge,
                      int B, int M, int N, int A, int gap_id, int gap_open,
                      int W, int warps, int P, void* stream) {
  const bool strip = col0 != nullptr;
  if (strip ? (!row0 || !last || !edge || moves) : edge != nullptr)
    return (int)cudaErrorInvalidValue;
  Args args{(const int*)tok_a, (const int*)tok_b, (const int*)cost_mat,
            (const int*)m_true, (const int*)n_true, (const int*)row0,
            (const int*)col0y_top, (const int*)col0, (int*)final3,
            (uint8_t*)moves, (int*)last, (int*)edge, (int4*)pass_edge,
            M, N, A, gap_id, gap_open, P};
  return (int)launch(args, B, N, moves != nullptr, false, W, warps, P, stream);
}

// Launches the ragged moves fill of B pairs on `stream`: pair b's tokens,
// lengths, codes (at a byte offset of `moves`, with its own row stride) and
// final3 row come from desc[b] ((B, DESC_WORDS) int64, device memory).
// M and N are the launch's greatest m and n (M sizes `pass_edge`,
// (B, 2, M+1) int4, needed when N passes P * warps * 32 * W columns); the
// caller checks every descriptor.  W, warps and P as in gotoh_fill_launch.
int gotoh_fill_ragged_launch(const void* desc, const void* cost_mat,
                             void* final3, void* moves, void* pass_edge,
                             int B, int M, int N, int A, int gap_id,
                             int gap_open, int W, int warps, int P,
                             void* stream) {
  if (!desc || !moves) return (int)cudaErrorInvalidValue;
  Args args{nullptr, nullptr, (const int*)cost_mat, (const int*)desc,
            nullptr, nullptr, nullptr, nullptr, (int*)final3,
            (uint8_t*)moves, nullptr, nullptr, (int4*)pass_edge,
            M, N, A, gap_id, gap_open, P};
  return (int)launch(args, B, N, true, true, W, warps, P, stream);
}

// How many clusters of a launch shape the current card holds at once
// (cudaOccupancyMaxActiveClusters), into `clusters`: W columns a lane,
// `warps` warps a block, P blocks a cluster, with codes or not, the ragged
// mode or not, an (A, A) cost table (in shared memory where it fits, as a
// launch places it).  Read once a shape, as the launches read it.
int gotoh_fill_clusters(int W, int warps, int P, int moves, int ragged, int A,
                        int* clusters) {
  if (!clusters || warps < 1 || warps > MAX_WARPS || P < 1 || P > MAX_BANDS ||
      A < 1 || (ragged && !moves))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  Kernel kernel = nullptr;
  size_t smem = 0;
  err = shape_of(dev, A, moves != 0, ragged != 0, W, warps, &kernel, &smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = config_of(1, P, warps, smem, nullptr, attr);
  return (int)place(kernel, dev, smem, warps, P, cfg, clusters);
}

const char* gotoh_fill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
