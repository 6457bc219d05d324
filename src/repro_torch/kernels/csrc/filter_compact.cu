// Filter compaction on Hopper (sm_90a): the port of
// repro/kernels/filter_compact.py.
//
// Replaces two Pallas TPU kernels:
//   block_counts  (_count_kernel,   filter_compact.py:27) -> block_counts_kernel
//   block_compact (_compact_kernel, filter_compact.py:57) -> block_compact_kernel
//
// What bounds it on this card: bytes. Per row the pair reads one mask byte
// twice and writes one int32 index; there is no arithmetic to speak of.
//
// What the design does about that: the TPU version builds a (bn x bn)
// one-hot permutation per block and leaves the stitch (scatter of 0-padded
// tiles to their base offsets) to XLA. Here each warp takes 32 rows with one
// __ballot_sync, its survivors' slots come from __popc of the ballot below
// each lane plus the counts of the warps before it (shared memory), and every
// survivor's global row index is written straight to
// offsets[block] + slot. So the stitch is fused away, nothing is written
// twice, and the tail (positions >= total survivors) is filled with n - 1 in
// the same kernel. The ragged last block is masked here: no host padding.
//
// Plain C interface for ctypes: pointers from data_ptr(), the stream, and
// the launch status (cudaGetLastError) as the return value. Nothing is
// allocated and nothing synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// One thread block per row block of `bn` rows: survivors in the block.
__global__ void block_counts_kernel(const uint8_t* __restrict__ mask,
                                    int32_t* __restrict__ counts,
                                    int64_t n, int64_t bn) {
  const int64_t start = static_cast<int64_t>(blockIdx.x) * bn;
  int total = 0;
  for (int64_t c = 0; c < bn; c += kThreads) {
    const int64_t j = c + threadIdx.x;
    const int64_t row = start + j;
    const int alive = (j < bn && row < n) ? (mask[row] != 0) : 0;
    total += __syncthreads_count(alive);
  }
  if (threadIdx.x == 0) counts[blockIdx.x] = total;
}

// offsets: (n_blocks + 1,) exclusive scan of the block counts, the last
// entry being the total. out: (n,) survivors ascending, then n - 1.
__global__ void block_compact_kernel(const uint8_t* __restrict__ mask,
                                     const int64_t* __restrict__ offsets,
                                     int32_t* __restrict__ out,
                                     int64_t n, int64_t bn) {
  __shared__ int warp_counts[kWarps];
  const int64_t start = static_cast<int64_t>(blockIdx.x) * bn;
  const int64_t base = offsets[blockIdx.x];
  const int64_t total = offsets[gridDim.x];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  int64_t running = 0;  // survivors in the earlier chunks of this block
  for (int64_t c = 0; c < bn; c += kThreads) {
    const int64_t j = c + threadIdx.x;
    const int64_t row = start + j;
    const bool alive = j < bn && row < n && mask[row] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0;
    int chunk = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int cw = warp_counts[w];
      before += (w < warp) ? cw : 0;
      chunk += cw;
    }
    if (alive) {
      out[base + running + before + __popc(ballot & below)] =
          static_cast<int32_t>(row);
    }
    running += chunk;
    __syncthreads();  // warp_counts is rewritten by the next chunk
  }
  // positions past the last survivor: the same n - 1 fill as ops.compact
  for (int64_t j = threadIdx.x; j < bn; j += kThreads) {
    const int64_t pos = start + j;
    if (pos < n && pos >= total) out[pos] = static_cast<int32_t>(n - 1);
  }
}

}  // namespace

extern "C" {

const char* bp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// mask: (n,) uint8/bool, counts: (ceil(n / bn),) int32.
int bp_block_counts(const void* mask, void* counts, long long n, long long bn,
                    void* stream) {
  if (n <= 0 || bn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = (n + bn - 1) / bn;
  block_counts_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<int32_t*>(counts), n, bn);
  return static_cast<int>(cudaGetLastError());
}

// mask: (n,), offsets: (ceil(n / bn) + 1,) int64, out: (n,) int32.
int bp_block_compact(const void* mask, const void* offsets, void* out,
                     long long n, long long bn, void* stream) {
  if (n <= 0 || bn <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n_blocks = (n + bn - 1) / bn;
  block_compact_kernel<<<static_cast<unsigned>(n_blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(mask), static_cast<const int64_t*>(offsets),
      static_cast<int32_t*>(out), n, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
