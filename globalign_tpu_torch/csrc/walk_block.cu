// walk_block.cu — the traceback walk over move codes, on the card: a warp
// a walk, the codes staged in shared memory a tile at a time.
//
// What it replaces.  globalign_tpu/ops/linear_tb.py:_walk_block_impl, row
// layout (:74-164): an XLA while_loop, not a Pallas kernel, that walks one
// replay block's codes where they were written so that only the O(K + n)
// op tape crosses to the host.  Here it is written by hand for the same
// reason, and because a serial walk in PyTorch would cost one launch per
// step.  The skewed "lanes" layout of that function is a TPU artefact and
// is not ported: gotoh_fill writes codes row-major.  The ragged entry
// replaces linear_tb.py:lanes_mega_walk (:268), the JAX package's one walk
// over every traceback bucket of an align_pairs call: it walks the codes
// that gotoh_fill's ragged moves mode packed, each pair through its own
// descriptor, with 64-bit offsets (the JAX blob's int32 offsets wrap past
// 2^31 bytes, globalign_tpu/batch.py:944-948).  The same kernel is the
// single-pair align's walk (models/gotoh.py), the counterpart of the JAX
// package's host walker (globalign_tpu/ops/traceback.py:63-77).
//
// What it computes.  For pair b, from row i_entry[b] of moves[b]
// ((K+1, N+1) uint8, row-major, bits 0-1 the M predecessor, 2-3 Ix, 4-5
// Iy), column j_entry[b] and level level_entry[b] (0 = M, 1 = Ix, 2 = Iy),
// step until the row is 0, writing one op a step to ops[b]: OP_DIAG (0) in
// level M, OP_LEFT (1) in Ix, OP_UP (2) in Iy and at column 0, where the
// level holds and no code is read (reference globaligner.py:562-581).
// Then count[b] = the number of ops, j_exit[b] / level_exit[b] = where the
// walk left the block — the entry of the next block up.  The entry values
// are device memory, so a chain of block walks runs without a host sync.
//
// Ragged: pair b's codes are desc[b]'s ((B, DESC_WORDS) int64, the layout
// of gotoh_fill's ragged moves mode): (m + 1) rows of ld bytes at a byte
// offset of `moves`.  Its walk starts at (m, n) in the level of the least of
// final3[r] (ties M > Ix > Iy), r = desc[b]'s final3 row, and writes its op
// tape, count and exit column to row r of ops ((R, L) uint8), count and
// j_exit: the outputs of lanes_mega_walk beside the fill's final3.
//
// What bounds it on this card.  Every step reads one code byte whose
// address depends on the step before: a chain of dependent loads, latency
// and not bandwidth.  A load from device memory or L2 costs hundreds of
// clocks, one from shared memory a few tens, so the design keeps every
// load of the chain in shared memory:
//
//   * A thread block of two warps walks one pair (one block of the blocked
//     route): warp 0 walks, its lanes in lockstep (each reads the same
//     shared byte, a broadcast with no bank conflict, and computes the same
//     step, so nothing diverges; they split up only the tape stores); warp
//     1 loads the codes.  The two hand requests and completions over two
//     named barriers.
//   * The codes are cut into grid-aligned tiles of TILE_ROWS x TILE_COLS
//     (32 x 48).  A path only moves up and left, so while the walker is in
//     tile (ti, tj) the block holds the 2 x 2 block of tiles {ti-1, ti} x
//     {tj-1, tj}, resident or in flight (cp.async, 16 bytes a lane a load),
//     in a ring of four buffers: tile (r, c) lives in buffer (r & 1, c & 1),
//     so the four tiles of any such block never share one.  Entering a
//     tile, the walker asks for the tiles that enter the block, into the
//     buffers of the tiles that left it, and waits only for the loads it
//     asked for at the crossing before.
//   * Alignment: a row starts at base + i * ld with ld = n + 1 and pairs
//     packed tight, so tile rows are not 16-byte aligned.  Each row segment
//     is loaded from its 16-byte-aligned start (one load more a row) and
//     staged at a row stride that equals ld mod 16 (tile_offset), so every
//     segment lands 16-byte aligned and a step up moves a code's offset by
//     the same amount in every row.  For the same reason (a tensor map
//     needs a 16-byte global stride) TMA is not used.  Only 16-byte loads
//     holding a byte of rows 1..i0, columns 1..j0 of the walk are issued,
//     so no load leaves the pair's codes' granules.
//   * The step loop is software-pipelined (walk): a step's op is its level,
//     so the next code's load issues before the current code is consumed.
//   * The tape: each step's op goes to a ring in shared memory that the
//     walker flushes to ops once it holds 128 ops, a byte a lane a store
//     (coalesced).
//   * Shared memory: four tiles, a guard band and the ring, 10.4 KB a
//     block, under the 48 KB that needs no opt-in; ~21 blocks fit an SM, so
//     a 1024-pair segment is one wave on 132 SMs.
//   * What the design trades: a tile holds TILE_ROWS x TILE_COLS codes of
//     which the path uses a few tens, so the loads move far more bytes
//     than the walk reads; taller or wider tiles give the loader longer to
//     land a tile but move more bytes and take longer to land.
//
// The tile shape and the loader warp were chosen by one-call timings of
// edited copies of this file (PERF.md): 32 x 48 was within a few percent
// of the fastest timed shape on each of the main path's three walk shapes,
// and a walker warp that issued its own loads was slower, its loads in
// flight holding up its shared-memory reads.  The shape is fixed here;
// walk_tile_rows / walk_tile_cols report it.
//
// Ops past count[b] are left as the caller allocated them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_LEFT = 1;  // OP_DIAG = 0
constexpr int OP_UP = 2;
constexpr int DESC_WORDS = 8;  // int64 words of a ragged pair descriptor

constexpr int TILE_ROWS = 32;
constexpr int TILE_COLS = 48;
static_assert(TILE_ROWS >= 1 && TILE_COLS >= 16 && TILE_COLS % 16 == 0,
              "tiles are whole 16-byte loads wide");
constexpr int CHUNKS = TILE_COLS / 16 + 1;  // 16-byte loads a tile row
// A tile row is staged at a stride of TILE_COLS + 16 + (ld & 15) bytes
// (the pair's stride, at most TILE_COLS + 31): see tile_offset.
constexpr int TILE_BYTES = (TILE_ROWS * (TILE_COLS + 31) + 16 + 15) / 16 * 16;
constexpr int RING = 128;  // tape bytes a flush (the ring holds 2 more)
constexpr int THREADS = 64;  // a walker warp and a loader warp
// A walk's shared memory: a guard band (a step's speculative load lands
// in it, never below it), the four tile buffers, the tape ring, then the
// walker's request to the loader (five ints).
constexpr int GUARD = TILE_COLS + 32;
constexpr int RING_AT = GUARD + 4 * TILE_BYTES;
constexpr int META_AT = RING_AT + RING + 16;
constexpr int SMEM_BYTES = META_AT + 32;
constexpr int NONE = 1 << 30;  // a tile coordinate no block holds
static_assert(SMEM_BYTES <= 48 * 1024,
              "a block's shared memory fits without an opt-in");
// A step's change of shared-memory offset, biased into a byte (byte l for
// level l): looked up with one byte permute.  A tile row's stride (at most
// TILE_COLS + 31) plus one has to fit under the bias.
constexpr int STEP_BIAS = 255;
static_assert(TILE_COLS + 32 <= STEP_BIAS, "a step's offset fits a byte");

extern __shared__ __align__(16) uint8_t smem[];

__device__ __forceinline__ int buffer_of(int ti, int tj) {
  return ((ti & 1) << 1) | (tj & 1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Waits until this thread's cp.async loads have landed.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One pair's codes: row i at mv + i * ld; the walk reads rows 1..i0 and
// columns 1..j0 only (it starts at (i0, j0) and moves up and left).
struct Codes {
  const uint8_t* mv;
  long long ld;
  int i0, j0;
  int stride;  // a tile row's staging stride: TILE_COLS + 16 + (ld & 15)
};

// The alignment shift of row i's first code, (mv + i * ld) & 15.
__device__ __forceinline__ int shift_of(const Codes& c, int i) {
  return (int)((uintptr_t)(c.mv + i * c.ld) & 15);
}

// Where code (i, j) of tile (ti, tj) lies in shared memory: row r = i - r0
// of the tile at r * stride + 16 + shift_of(r0), then column j - c0.  The
// stride is congruent to the pair's ld mod 16, so every row's 16-byte-
// aligned segment lands 16-byte aligned, and a step up moves any code's
// offset by exactly -stride (a step left by -1).
__device__ __forceinline__ int tile_offset(const Codes& c, int ti, int tj,
                                           int i, int j) {
  const int r0 = ti * TILE_ROWS;
  return GUARD + buffer_of(ti, tj) * TILE_BYTES + (i - r0) * c.stride + 16 +
         shift_of(c, r0) + j - tj * TILE_COLS;
}

// Issues this lane's share of tile (ti, tj)'s loads: each row from the
// 16-byte-aligned start of its segment, at tile_offset.
__device__ __forceinline__ void load_tile(const Codes& c, int ti, int tj,
                                          int lane) {
  const int r0 = ti * TILE_ROWS, c0 = tj * TILE_COLS;
  const int lo = max(c0, 1), hi = min(c0 + TILE_COLS - 1, c.j0);
  if (lo > hi) return;
  uint8_t* tile = smem + tile_offset(c, ti, tj, r0, c0);  // code (r0, c0)
  for (int k = lane; k < TILE_ROWS * CHUNKS; k += 32) {
    const int r = k / CHUNKS, q = k - r * CHUNKS;
    const int i = r0 + r;
    if (i < 1 || i > c.i0) continue;
    const uintptr_t row = (uintptr_t)(c.mv + i * c.ld);
    const uintptr_t g = ((row + c0) & ~(uintptr_t)15) + 16 * q;
    if (g + 15 < row + lo || g > row + hi) continue;
    cp_async16(tile + r * c.stride - shift_of(c, i) + 16 * q, (const void*)g);
  }
}

// Issues the loads of the tiles of (ti, tj)'s block that (oti, otj)'s
// block lacks (every tile of it when oti is NONE), this lane's share.
__device__ __forceinline__ void load_block(const Codes& c, int ti, int tj,
                                           int oti, int otj, int lane) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    const int tr = ti - (d >> 1), tc = tj - (d & 1);
    if (tr < 0 || tc < 0 || (tr >= oti - 1 && tc >= otj - 1)) continue;
    load_tile(c, tr, tc, lane);
  }
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(64) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(64) : "memory");
}

// Writes the tape ring's first n bytes to dst, a byte a lane a store (out
// of line, as every step's rare path is: the step loop stays short).
__device__ __noinline__ void flush(uint8_t* __restrict__ dst,
                                   const uint8_t* ring, int n, int lane) {
  __syncwarp();
  for (int k = lane; k < n; k += 32) dst[k] = ring[k];
  __syncwarp();
}

// One code byte from shared memory (a shared-window address) into a full
// register: its first use, not a byte merge, waits for it.
__device__ __forceinline__ int lds_u8(unsigned addr) {
  unsigned v;
  asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return (int)v;
}

// The loader warp: serves the walker's requests, one a tile the walker
// enters (barrier 1), each answered when its loads have landed (barrier
// 2), until the walker asks it to stop.
__device__ __forceinline__ void serve_loads(const Codes c, int lane) {
  volatile int* req = (volatile int*)(smem + META_AT);
  for (;;) {
    named_sync(1);
    if (req[4]) return;
    load_block(c, req[0], req[1], req[2], req[3], lane);
    cp_async_wait_all();
    __threadfence_block();
    named_arrive(2);
  }
}

struct Exit {
  int count, j, level;
};

// The walker's tile state: the tile it is in, and whether it has a
// request whose loads it has not waited for.
struct Tiles {
  int ti, tj;
  bool pending;
};

// Moves the walker from tile (s->ti, s->tj) into the tile of (i, j), the
// one above, left or above-left: waits for the loads it asked for at the
// last crossing (they hold that tile) and asks the loader for the tiles
// that enter its block.  Returns the shared memory offset of code (i, j).
__device__ __noinline__ int enter_tile(const Codes c, int i, int j,
                                       Tiles* s) {
  volatile int* req = (volatile int*)(smem + META_AT);
  const int ti = i / TILE_ROWS, tj = j / TILE_COLS;
  if (s->pending) named_sync(2);
  req[0] = ti, req[1] = tj, req[2] = s->ti, req[3] = s->tj;
  __threadfence_block();
  named_arrive(1);
  s->pending = true;
  s->ti = ti, s->tj = tj;
  return tile_offset(c, ti, tj, i, j);
}

// The walk of one pair by the walking warp (all 32 lanes, in lockstep):
// from (i0, j0) in `level` up to row 0, its ops into tape; returns the
// step count and where the walk left the codes.
//
// The step loop is short, has no call and one exit test a step, and is
// software-pipelined.  A step's op is its level (OP_DIAG in M, OP_LEFT in
// Ix, OP_UP in Iy), known before its code arrives, so the next code's
// shared-memory address follows from the level alone (a byte permute and
// an add) and its load is issued, before any bounds check, while the
// current code turns into the next level: the chain runs a load a step at
// the cost of two steps' arithmetic.  Unrolled twice, so the two codes in
// flight never need a register move.  The walk's row and column are not
// kept a step: `left` holds, biased by 2^15 in each half, the rows (high)
// and columns (low) it may still go up and left inside its tile, so one
// test of the two bias bits finds a tile edge, row 0 and column 0.
__device__ __forceinline__ Exit walk(const Codes c, int level,
                                     uint8_t* __restrict__ tape) {
  int i = c.i0, j = c.j0;
  const int lane = threadIdx.x & 31;
  uint8_t* ring = smem + RING_AT;
  volatile int* req = (volatile int*)(smem + META_AT);
  int t = 0, at = 0;  // ops flushed; ops in the ring
  Tiles s{i / TILE_ROWS, j / TILE_COLS, false};
  if (i > 0 && j > 0) {  // ask for the first tile's block and wait for it
    req[0] = s.ti, req[1] = s.tj, req[2] = NONE, req[3] = NONE, req[4] = 0;
    __threadfence_block();
    named_arrive(1);
    named_sync(2);
    const int stride = c.stride;
    const unsigned steps = (unsigned)(STEP_BIAS - stride - 1) |
                           (unsigned)(STEP_BIAS - 1) << 8 |
                           (unsigned)(STEP_BIAS - stride) << 16;
    const unsigned base = (unsigned)__cvta_generic_to_shared(smem);
    unsigned p = base + tile_offset(c, s.ti, s.tj, i, j);  // code (i, j)
    // the first row and column of the tile the walk may step to (row 0 and
    // column 0 end the tiled walk)
    int ilo = max(s.ti * TILE_ROWS, 1), jlo = max(s.tj * TILE_COLS, 1);
    unsigned left = (unsigned)(i - ilo + 0x8000) << 16 | (j - jlo + 0x8000);
    int cur = lds_u8(p), nxt;
    bool out;
// One step from the code `a`, loading the next code into `b`; `out` at a
// tile edge, row 0 or column 0.
#define WALK_STEP(a, b)                                                    \
  {                                                                        \
    const int op = level;                                                  \
    p += __byte_perm(steps, 0, 0x4440 | op) - STEP_BIAS;                   \
    b = lds_u8(p);                                                         \
    level = (a >> (2 * op)) & 3;                                           \
    ring[at++] = (uint8_t)op;                                              \
    left -= op == OP_LEFT ? 1u : op == OP_UP ? 0x10000u : 0x10001u;        \
    out = (~left & 0x80008000u) != 0;                                      \
  }
    for (;;) {
      for (;;) {  // two steps a trip, until an edge or a full ring
        WALK_STEP(cur, nxt)
        if (out) break;
        WALK_STEP(nxt, cur)
        if (out || at >= RING) break;
      }
      if (at >= RING) {  // a full ring (128 or 129 ops)
        flush(tape + t, ring, at, lane);
        t += at, at = 0;
      }
      if (!out) continue;
      i = ilo + (int)(left >> 16) - 0x8000;
      j = jlo + (int)(left & 0xffff) - 0x8000;
      if (i == 0 || j == 0) break;
      p = base + enter_tile(c, i, j, &s);
      ilo = max(s.ti * TILE_ROWS, 1), jlo = max(s.tj * TILE_COLS, 1);
      left = (unsigned)(i - ilo + 0x8000) << 16 | (j - jlo + 0x8000);
      cur = lds_u8(p);
    }
#undef WALK_STEP
  }
  for (; i > 0; --i) {  // column 0: up moves, the level holds, no code read
    ring[at++] = (uint8_t)OP_UP;
    if (at >= RING) {
      flush(tape + t, ring, at, lane);
      t += at, at = 0;
    }
  }
  flush(tape + t, ring, at, lane);
  if (s.pending) named_sync(2);  // no load outlives the walk
  req[4] = 1;                    // the loader stops
  __threadfence_block();
  named_arrive(1);
  return Exit{t + at, j, level};
}

__global__ void __launch_bounds__(THREADS)
    walk_block_kernel(const uint8_t* __restrict__ moves,
                      const int* __restrict__ i_entry,
                      const int* __restrict__ j_entry,
                      const int* __restrict__ level_entry,
                      uint8_t* __restrict__ ops, int* __restrict__ count,
                      int* __restrict__ j_exit, int* __restrict__ level_exit,
                      int K, int N, int L) {
  const int b = blockIdx.x;
  const long long ld = N + 1;
  const Codes c{moves + (long long)b * (K + 1) * ld, ld, i_entry[b],
                j_entry[b], TILE_COLS + 16 + (int)(ld & 15)};
  if (threadIdx.x >= 32) {
    serve_loads(c, threadIdx.x & 31);
    return;
  }
  const Exit e = walk(c, level_entry[b], ops + (long long)b * L);
  if (threadIdx.x == 0) {
    count[b] = e.count;
    j_exit[b] = e.j;
    level_exit[b] = e.level;
  }
}

__global__ void __launch_bounds__(THREADS)
    walk_ragged_kernel(const long long* __restrict__ desc,
                       const uint8_t* __restrict__ moves,
                       const int* __restrict__ final3,
                       uint8_t* __restrict__ ops, int* __restrict__ count,
                       int* __restrict__ j_exit, int L) {
  const long long* d = desc + (long long)blockIdx.x * DESC_WORDS;
  const long long r = d[6];
  const Codes c{moves + d[4], d[5], (int)d[2], (int)d[3],
                TILE_COLS + 16 + (int)(d[5] & 15)};
  if (threadIdx.x >= 32) {
    serve_loads(c, threadIdx.x & 31);
    return;
  }
  const int f0 = final3[3 * r], f1 = final3[3 * r + 1], f2 = final3[3 * r + 2];
  // argmin's first index: ties go M > Ix > Iy
  const int level = f0 <= f1 && f0 <= f2 ? 0 : (f1 <= f2 ? 1 : 2);
  const Exit e = walk(c, level, ops + r * L);
  if (threadIdx.x == 0) {
    count[r] = e.count;
    j_exit[r] = e.j;
  }
}

}  // namespace

extern "C" {

// Launches the walks of B pairs on `stream`, a thread block each.  moves is
// (B, K+1, N+1) uint8; i_entry, j_entry, level_entry, count, j_exit and
// level_exit are (B,) int32; ops is (B, L) uint8 with L >= K + N (a walk
// takes at most K up and N left steps).  Entries must lie in [0, K] /
// [0, N] / [0, 2] (the caller checks the rows; the columns and levels come
// from a fill).
int walk_block_launch(const void* moves, const void* i_entry,
                      const void* j_entry, const void* level_entry, void* ops,
                      void* count, void* j_exit, void* level_exit, int B,
                      int K, int N, int L, void* stream) {
  if (B < 1 || K < 0 || N < 0 || L < K + N) return (int)cudaErrorInvalidValue;
  walk_block_kernel<<<B, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)moves, (const int*)i_entry, (const int*)j_entry,
      (const int*)level_entry, (uint8_t*)ops, (int*)count, (int*)j_exit,
      (int*)level_exit, K, N, L);
  return (int)cudaGetLastError();
}

// Launches the ragged walks of B pairs on `stream`, a thread block each:
// desc ((B, DESC_WORDS) int64), moves (the packed codes) and final3 ((R, 3)
// int32) on the card; ops (R, L) uint8 with L >= m + n of every pair, count
// and j_exit (R,) int32, R covering every descriptor's final3 row (the
// caller checks).
int walk_ragged_launch(const void* desc, const void* moves,
                       const void* final3, void* ops, void* count,
                       void* j_exit, int B, int L, void* stream) {
  if (B < 1 || L < 0) return (int)cudaErrorInvalidValue;
  walk_ragged_kernel<<<B, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      (const long long*)desc, (const uint8_t*)moves, (const int*)final3,
      (uint8_t*)ops, (int*)count, (int*)j_exit, L);
  return (int)cudaGetLastError();
}

// The shape of the code tiles both kernels stage: rows, columns.
int walk_tile_rows() { return TILE_ROWS; }
int walk_tile_cols() { return TILE_COLS; }

const char* walk_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
