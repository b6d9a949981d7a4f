// walk_block.cu — the traceback walk over a block of move codes, on the
// card, one thread per pair.
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
// 2^31 bytes, globalign_tpu/batch.py:944-948).
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
// What bounds it on this card: every step is a dependent load of one code
// byte (latency, not bandwidth), so a walk of s steps costs about s device
// memory latencies; one thread per pair keeps a batch of walks in flight
// together.  Ops past count[b] are left as the caller allocated them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_DIAG = 0;
constexpr int OP_LEFT = 1;
constexpr int OP_UP = 2;
constexpr int DESC_WORDS = 8;  // int64 words of a ragged pair descriptor

// Walks one pair's codes (row i at mv + i * ld) from (i, j) in `level` up to
// row 0, writing its ops to tape; returns the step count and leaves j and
// level where the walk left the codes.
__device__ __forceinline__ int walk(const uint8_t* __restrict__ mv,
                                    long long ld, int i, int& j, int& level,
                                    uint8_t* __restrict__ tape) {
  int t = 0;
  while (i > 0) {
    int op;
    if (j == 0) {
      op = OP_UP;
    } else {
      const int code = mv[i * ld + j];
      op = level == 0 ? OP_DIAG : (level == 1 ? OP_LEFT : OP_UP);
      level = (code >> (2 * level)) & 3;
    }
    tape[t++] = (uint8_t)op;
    if (op != OP_LEFT) --i;
    if (op != OP_UP) --j;
  }
  return t;
}

__global__ void walk_block_kernel(const uint8_t* __restrict__ moves,
                                  const int* __restrict__ i_entry,
                                  const int* __restrict__ j_entry,
                                  const int* __restrict__ level_entry,
                                  uint8_t* __restrict__ ops,
                                  int* __restrict__ count,
                                  int* __restrict__ j_exit,
                                  int* __restrict__ level_exit, int B, int K,
                                  int N, int L) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long ld = N + 1;
  int j = j_entry[b];
  int level = level_entry[b];
  count[b] = walk(moves + (long long)b * (K + 1) * ld, ld, i_entry[b], j,
                  level, ops + (long long)b * L);
  j_exit[b] = j;
  level_exit[b] = level;
}

__global__ void walk_ragged_kernel(const long long* __restrict__ desc,
                                   const uint8_t* __restrict__ moves,
                                   const int* __restrict__ final3,
                                   uint8_t* __restrict__ ops,
                                   int* __restrict__ count,
                                   int* __restrict__ j_exit, int B, int L) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long* d = desc + (long long)b * DESC_WORDS;
  const long long r = d[6];
  const int f0 = final3[3 * r], f1 = final3[3 * r + 1], f2 = final3[3 * r + 2];
  // argmin's first index: ties go M > Ix > Iy
  int level = f0 <= f1 && f0 <= f2 ? 0 : (f1 <= f2 ? 1 : 2);
  int j = (int)d[3];
  count[r] = walk(moves + d[4], d[5], (int)d[2], j, level, ops + r * L);
  j_exit[r] = j;
}

}  // namespace

extern "C" {

// Launches the walks of B pairs on `stream`.  moves is (B, K+1, N+1)
// uint8; i_entry, j_entry, level_entry, count, j_exit and level_exit are
// (B,) int32; ops is (B, L) uint8 with L >= K + N (a walk takes at most K
// up and N left steps).  Entries must lie in [0, K] / [0, N] / [0, 2]
// (the caller checks the rows; the columns and levels come from a fill).
int walk_block_launch(const void* moves, const void* i_entry,
                      const void* j_entry, const void* level_entry, void* ops,
                      void* count, void* j_exit, void* level_exit, int B,
                      int K, int N, int L, void* stream) {
  if (B < 1 || K < 0 || N < 0 || L < K + N) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  walk_block_kernel<<<(B + threads - 1) / threads, threads, 0,
                      (cudaStream_t)stream>>>(
      (const uint8_t*)moves, (const int*)i_entry, (const int*)j_entry,
      (const int*)level_entry, (uint8_t*)ops, (int*)count, (int*)j_exit,
      (int*)level_exit, B, K, N, L);
  return (int)cudaGetLastError();
}

// Launches the ragged walks of B pairs on `stream`: desc ((B, DESC_WORDS)
// int64), moves (the packed codes) and final3 ((R, 3) int32) on the card;
// ops (R, L) uint8 with L >= m + n of every pair, count and j_exit (R,)
// int32, R covering every descriptor's final3 row (the caller checks).
int walk_ragged_launch(const void* desc, const void* moves,
                       const void* final3, void* ops, void* count,
                       void* j_exit, int B, int L, void* stream) {
  if (B < 1 || L < 0) return (int)cudaErrorInvalidValue;
  const int threads = 32;
  walk_ragged_kernel<<<(B + threads - 1) / threads, threads, 0,
                       (cudaStream_t)stream>>>(
      (const long long*)desc, (const uint8_t*)moves, (const int*)final3,
      (uint8_t*)ops, (int*)count, (int*)j_exit, B, L);
  return (int)cudaGetLastError();
}

const char* walk_block_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
