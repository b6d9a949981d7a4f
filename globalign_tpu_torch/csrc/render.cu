// render.cu — a traceback segment's alignment lines, on the card: every
// pair of a segment in one launch, a warp a pair.
//
// What it replaces.  The native runtime's ga_render_ops
// (native/runtime.cpp:227), which the JAX package's align_pairs runs on the
// host a pair at a time (globalign_tpu/batch.py:1097), and the port's host
// render (ops/linear_tb.render_many over tapes fetched to the host and
// reversed there).  Here the op tapes that walk_block's ragged kernel
// wrote stay on the card, the letters are already there (ops/packed.py:
// one upload a call), and only the three finished lines of every pair come
// back, in the call's one fetch.
//
// What it computes.  Pair p's forward op tape is j_exit[p] OP_LEFT moves
// (the walk stops at row 0 and leaves them to the caller) and then
// ops[p, count[p] - 1 .. 0], the walk tape reversed: len = count + j_exit
// ops.  Op t of it writes letter t of the three lines at starts[p] + t of
// rows 0, 1 and 2 of lines ((3, stride), int64 offsets): OP_DIAG (0) the
// next letter of each sequence and '|' where they are equal, '*' where not;
// OP_LEFT (1) a gap '-' over the next letter of seq_2, ' ' between; any
// other op the next letter of seq_1 over a gap.  desc ((P, 2) int64) holds
// each pair's seq_1 and seq_2 offsets in the letters: bytes (ASCII text)
// or UTF-32 code points, and the lines are the same type.
//
// What bounds it on this card.  Bytes: the tapes and letters read once,
// three lines written once; a few integer operations a letter.  The
// design: a warp takes a pair and goes along its forward tape 32 ops at a
// time, lane l on op t0 + l, so the tape loads (descending addresses) and
// the line stores are coalesced.  Where each lane's letters come from is a
// prefix count over the warp: __ballot_sync of the ops that consume seq_1
// (op != OP_LEFT) and of those that consume seq_2 (OP_DIAG or OP_LEFT),
// __popc of the bits below the lane, added to the counts of the chunks
// before.  No shared memory and no block barrier; 8 warps a block,
// grid-stride over pairs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int OP_DIAG = 0;
constexpr int OP_LEFT = 1;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int MAX_GRID = 1 << 16;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GAP_CHAR = '-';
constexpr int MATCH_GLYPH = '|';
constexpr int MISMATCH_GLYPH = '*';
constexpr int GAP_GLYPH = ' ';

template <typename T>
__global__ void __launch_bounds__(THREADS)
    render_kernel(const long long* __restrict__ desc,
                  const uint8_t* __restrict__ ops, long long ld,
                  const int* __restrict__ count,
                  const int* __restrict__ j_exit,
                  const long long* __restrict__ starts,
                  const T* __restrict__ letters, T* __restrict__ lines,
                  long long stride, int pairs) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  for (int p = blockIdx.x * WARPS + (threadIdx.x >> 5); p < pairs;
       p += gridDim.x * WARPS) {
    const long long steps = count[p], left = j_exit[p];
    const long long len = steps + left;
    const T* seq_1 = letters + desc[2 * (long long)p];
    const T* seq_2 = letters + desc[2 * (long long)p + 1];
    const uint8_t* tape = ops + ld * p;
    T* out = lines + starts[p];
    long long i = 0, j = 0;  // letters of seq_1 / seq_2 consumed so far
    for (long long t0 = 0; t0 < len; t0 += 32) {
      const long long t = t0 + lane;
      const bool live = t < len;
      int op = OP_LEFT;
      if (live && t >= left) op = tape[steps - 1 - (t - left)];
      const bool from_1 = live && op != OP_LEFT;
      const bool from_2 = live && (op == OP_DIAG || op == OP_LEFT);
      const unsigned took_1 = __ballot_sync(FULL, from_1);
      const unsigned took_2 = __ballot_sync(FULL, from_2);
      if (live) {
        const T a = from_1 ? seq_1[i + __popc(took_1 & below)] : (T)GAP_CHAR;
        const T b = from_2 ? seq_2[j + __popc(took_2 & below)] : (T)GAP_CHAR;
        out[t] = a;
        out[stride + t] =
            op == OP_DIAG ? (T)(a == b ? MATCH_GLYPH : MISMATCH_GLYPH)
                          : (T)GAP_GLYPH;
        out[2 * stride + t] = b;
      }
      i += __popc(took_1);
      j += __popc(took_2);
    }
  }
}

}  // namespace

extern "C" {

// Launches the render of `pairs` pairs on `stream`: desc ((pairs, 2)
// int64), ops ((pairs, ld) uint8), count and j_exit ((pairs,) int32),
// starts ((pairs,) int64), letters and lines (uint8, or int32 when wide;
// lines (3, stride)) on the card.  Each pair's lines must fit its row from
// its start (the caller sizes the buffer by m + n a pair).
int render_ragged_launch(const void* desc, const void* ops, long long ld,
                         const void* count, const void* j_exit,
                         const void* starts, const void* letters, int wide,
                         void* lines, long long stride, int pairs,
                         void* stream) {
  if (pairs < 1 || ld < 0 || stride < 0) return (int)cudaErrorInvalidValue;
  int grid = (pairs + WARPS - 1) / WARPS;
  if (grid > MAX_GRID) grid = MAX_GRID;
  if (wide) {
    render_kernel<int><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)desc, (const uint8_t*)ops, ld, (const int*)count,
        (const int*)j_exit, (const long long*)starts, (const int*)letters,
        (int*)lines, stride, pairs);
  } else {
    render_kernel<uint8_t><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        (const long long*)desc, (const uint8_t*)ops, ld, (const int*)count,
        (const int*)j_exit, (const long long*)starts,
        (const uint8_t*)letters, (uint8_t*)lines, stride, pairs);
  }
  return (int)cudaGetLastError();
}

const char* render_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
