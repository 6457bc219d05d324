// Group-by aggregation and the combine of per-shard states on Hopper
// (sm_90a): the port of repro/kernels/groupby_agg.py.
//
// Replaces two Pallas TPU kernels:
//   groupby_pallas (_gb_kernel,      groupby_agg.py:101) -> groupby_kernel
//   combine_pallas (_combine_kernel, groupby_agg.py:79)  -> combine_kernel
// Both support sum / count / min / max (mean is sum / count in ops.py) and
// start from the neutral elements of groupby_agg.py:20; accumulators are
// float32, as in the reference.
//
// What bounds them on this card: bytes. group-by reads a float32 value and
// an int32 code per row for one add (or min/max); combine reads P x G
// float32 partial states for (P - 1) x G operations.
//
// What the design does about that:
// - group-by: the TPU grid runs in order and carries one VMEM accumulator
//   through a one-hot (rows x groups) reduction. Blocks here run in no order,
//   so each block walks a grid-stride slice of the rows (coalesced reads of
//   values and codes) into a private accumulator in shared memory with
//   shared-memory atomics, then folds it into the output with one global
//   atomic per group. With few groups (the paper's query has 6) all 256
//   threads would hit the same few words, so each warp gets its own copy of
//   the accumulator while 8 copies fit in 48 KB. Up to the card's opt-in
//   shared memory one copy is kept; beyond that the rows go straight to
//   global atomics. min / max use the ordered-integer trick on the float
//   bits (atomicMin on int for non-negative floats, atomicMax on unsigned
//   for negative ones, and the reverse for max).
//   Codes outside [0, n_groups) are dropped, as the Pallas wrapper's padding
//   drops them, so no padding of rows or groups is needed.
// - combine: one thread per group column loops over the P parts, so a warp
//   reads 32 neighbouring floats of one part row at a time (coalesced along
//   G), with 8 rows' loads in flight before they are merged in order (a
//   loop of dependent load-then-add would wait out the memory latency once
//   per part). No padding of P or G.
//
// Plain C interface for ctypes: pointers from data_ptr(), the stream, and
// the launch status (cudaGetLastError) as the return value. Nothing is
// allocated and nothing synchronises.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr long long kDefaultSmem = 48 * 1024;

enum Fn : int { kSum = 0, kCount = 1, kMin = 2, kMax = 3 };

template <int FN>
__device__ __forceinline__ float neutral() {
  return FN == kMin ? __int_as_float(0x7f800000)      // +inf
       : FN == kMax ? __int_as_float(0xff800000)      // -inf
                    : 0.0f;
}

template <int FN>
__device__ __forceinline__ float merge(float a, float b) {
  if (FN == kMin) return fminf(a, b);
  if (FN == kMax) return fmaxf(a, b);
  return a + b;
}

// Works on shared and global addresses alike.
template <int FN>
__device__ __forceinline__ void atomic_merge(float* addr, float v) {
  if (FN == kSum || FN == kCount) {
    atomicAdd(addr, v);
  } else if (FN == kMin) {
    if (__float_as_int(v) >= 0) {
      atomicMin(reinterpret_cast<int*>(addr), __float_as_int(v));
    } else {
      atomicMax(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
    }
  } else {
    if (__float_as_int(v) >= 0) {
      atomicMax(reinterpret_cast<int*>(addr), __float_as_int(v));
    } else {
      atomicMin(reinterpret_cast<unsigned*>(addr), __float_as_uint(v));
    }
  }
}

template <int FN>
__global__ void fill_neutral_kernel(float* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) out[i] = neutral<FN>();
}

// copies: accumulator copies in shared memory (kWarps, 1, or 0 for global
// atomics only). out must hold the neutral element on entry.
template <int FN>
__global__ void groupby_kernel(const float* __restrict__ vals,
                               const int32_t* __restrict__ codes,
                               float* __restrict__ out, int64_t n,
                               int64_t n_groups, int copies) {
  extern __shared__ float acc[];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (copies == 0) {
    for (int64_t i = first; i < n; i += stride) {
      const int32_t c = codes[i];
      if (c >= 0 && c < n_groups) {
        atomic_merge<FN>(out + c, FN == kCount ? 1.0f : vals[i]);
      }
    }
    return;
  }
  const int64_t cells = static_cast<int64_t>(copies) * n_groups;
  for (int64_t k = threadIdx.x; k < cells; k += blockDim.x) acc[k] = neutral<FN>();
  __syncthreads();
  float* mine = acc + static_cast<int64_t>((threadIdx.x >> 5) % copies) * n_groups;
  for (int64_t i = first; i < n; i += stride) {
    const int32_t c = codes[i];
    if (c >= 0 && c < n_groups) {
      atomic_merge<FN>(mine + c, FN == kCount ? 1.0f : vals[i]);
    }
  }
  __syncthreads();
  for (int64_t g = threadIdx.x; g < n_groups; g += blockDim.x) {
    float v = acc[g];
    for (int k = 1; k < copies; ++k) v = merge<FN>(v, acc[k * n_groups + g]);
    if (v != neutral<FN>()) atomic_merge<FN>(out + g, v);
  }
}

template <int FN>
__global__ void combine_kernel(const float* __restrict__ parts,
                               float* __restrict__ out, int64_t p, int64_t g) {
  constexpr int kDepth = 8;
  const int64_t col = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (col >= g) return;
  float acc = neutral<FN>();
  int64_t r = 0;
  // kDepth loads in flight at once, merged in row order: the result is the
  // sequential loop's, bit for bit
  for (; r + kDepth <= p; r += kDepth) {
    float v[kDepth];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) v[k] = parts[(r + k) * g + col];
#pragma unroll
    for (int k = 0; k < kDepth; ++k) acc = merge<FN>(acc, v[k]);
  }
  for (; r < p; ++r) acc = merge<FN>(acc, parts[r * g + col]);
  out[col] = acc;
}

template <int FN>
int launch_groupby(const float* vals, const int32_t* codes, float* out,
                   long long n, long long n_groups, cudaStream_t stream) {
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const long long group_bytes = n_groups * static_cast<long long>(sizeof(float));
  int copies = 0;
  if (group_bytes * kWarps <= kDefaultSmem) {
    copies = kWarps;
  } else if (group_bytes <= optin) {
    copies = 1;
  }
  const size_t smem = static_cast<size_t>(group_bytes) * copies;
  if (smem > static_cast<size_t>(kDefaultSmem)) {
    cudaFuncSetAttribute(groupby_kernel<FN>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  const int fill_blocks = static_cast<int>((n_groups + kThreads - 1) / kThreads);
  fill_neutral_kernel<FN><<<fill_blocks, kThreads, 0, stream>>>(out, n_groups);
  // a few resident blocks per SM; one when a block takes most of the SM's
  // shared memory
  const long long per_sm = smem > static_cast<size_t>(kDefaultSmem) ? 1 : 8;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > sms * per_sm) blocks = sms * per_sm;
  groupby_kernel<FN><<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(
      vals, codes, out, n, n_groups, copies);
  return static_cast<int>(cudaGetLastError());
}

template <int FN>
int launch_combine(const float* parts, float* out, long long p, long long g,
                   cudaStream_t stream) {
  const long long blocks = (g + kThreads - 1) / kThreads;
  combine_kernel<FN><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      parts, out, p, g);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* bp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// vals: (n,) float32, codes: (n,) int32, out: (n_groups,) float32.
// fn: 0 sum, 1 count, 2 min, 3 max.
int bp_groupby(const void* vals, const void* codes, void* out, long long n,
               long long n_groups, int fn, void* stream) {
  if (n <= 0 || n_groups <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* v = static_cast<const float*>(vals);
  const auto* c = static_cast<const int32_t*>(codes);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fn) {
    case kSum: return launch_groupby<kSum>(v, c, o, n, n_groups, s);
    case kCount: return launch_groupby<kCount>(v, c, o, n, n_groups, s);
    case kMin: return launch_groupby<kMin>(v, c, o, n, n_groups, s);
    case kMax: return launch_groupby<kMax>(v, c, o, n, n_groups, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// parts: (p, g) float32 row-major, out: (g,) float32.
// fn: 0 sum, 1 count (both add), 2 min, 3 max.
int bp_combine(const void* parts, void* out, long long p, long long g, int fn,
               void* stream) {
  if (p <= 0 || g <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* x = static_cast<const float*>(parts);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  switch (fn) {
    case kSum: return launch_combine<kSum>(x, o, p, g, s);
    case kCount: return launch_combine<kCount>(x, o, p, g, s);
    case kMin: return launch_combine<kMin>(x, o, p, g, s);
    case kMax: return launch_combine<kMax>(x, o, p, g, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
