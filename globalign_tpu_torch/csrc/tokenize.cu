// tokenize.cu — a batch call's letters to tokens, on the card: every
// sequence of an align_pairs call in one launch.
//
// What it replaces.  The native runtime's ga_tokenize
// (native/runtime.cpp:159), which the JAX package runs on the host a
// sequence at a time, and the port's host encode of a bucket
// (globalign_tpu_torch/batch.py:_encode_bucket, a lookup table in numpy a
// bucket, two uploads a bucket).  Here the host packs the call's letters
// once (ops/packed.py:pack_call) and uploads them in one copy; this kernel
// writes every bucket's token rows into one int32 arena, whose slices the
// fill wrappers take as their (B, M+1) / (B, N+1) token tensors.
//
// What it computes.  Row r of desc ((R, 4) int64: letters offset, length,
// arena offset, width) gets arena[dst + 0] = 0, arena[dst + c] = the token
// of letters[src + c - 1] for 1 <= c <= length, and 0 up to width: the
// 1-origin padded row of utils/tokenize.encode_padded.  Letters are bytes
// (ASCII text) looked up in a 256-entry table, or UTF-32 code points
// searched among the alphabet's letters (table[k] = token k's code point);
// a letter the table does not hold gives 0 (the host refused such letters
// before packing).
//
// What bounds it on this card.  Bytes: each letter is read once (1 byte,
// or 4) and each token written once (4 bytes); the arithmetic is a table
// lookup a letter.  The design: a thread block a row at a time (grid-
// stride over rows), its 256 threads on consecutive columns, so loads and
// stores are coalesced; the table sits in shared memory (1 KB for bytes,
// 4 bytes a letter for code points), loaded once a block.  No
// synchronisation after the table load; nothing is staged.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_GRID = 1 << 16;  // rows past it are taken grid-stride
constexpr int WORDS = 4;  // int64 words of a row descriptor

template <bool WIDE>
__global__ void __launch_bounds__(THREADS)
    tokenize_kernel(const long long* __restrict__ desc, int rows,
                    const void* __restrict__ letters,
                    const int* __restrict__ table, int table_len,
                    int* __restrict__ arena) {
  extern __shared__ int s_table[];
  for (int k = threadIdx.x; k < table_len; k += THREADS) s_table[k] = table[k];
  __syncthreads();
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    const long long* d = desc + (long long)WORDS * r;
    const long long src = d[0], length = d[1], dst = d[2], width = d[3];
    for (long long c = threadIdx.x; c < width; c += THREADS) {
      int token = 0;
      if (c >= 1 && c <= length) {
        if (WIDE) {
          const int point = static_cast<const int*>(letters)[src + c - 1];
          for (int k = 0; k < table_len; ++k) {
            if (s_table[k] == point) {
              token = k;
              break;
            }
          }
        } else {
          token = s_table[static_cast<const uint8_t*>(letters)[src + c - 1]];
        }
      }
      arena[dst + c] = token;
    }
  }
}

}  // namespace

extern "C" {

// Launches the tokenize of `rows` row descriptors on `stream`: desc
// ((rows, 4) int64), letters (uint8, or int32 when wide), table (int32:
// 256 entries, or table_len code points when wide) and arena (int32) on the
// card.  Rows may not overlap (the caller lays them out).
int tokenize_ragged_launch(const void* desc, int rows, const void* letters,
                           int wide, const void* table, int table_len,
                           void* arena, void* stream) {
  if (rows < 1 || table_len < 0 || table_len > 4096 ||
      (!wide && table_len != 256))
    return (int)cudaErrorInvalidValue;
  const int grid = rows < MAX_GRID ? rows : MAX_GRID;
  const size_t smem = sizeof(int) * (size_t)table_len;
  if (wide) {
    tokenize_kernel<true><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const long long*)desc, rows, letters, (const int*)table, table_len,
        (int*)arena);
  } else {
    tokenize_kernel<false><<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        (const long long*)desc, rows, letters, (const int*)table, table_len,
        (int*)arena);
  }
  return (int)cudaGetLastError();
}

const char* tokenize_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
