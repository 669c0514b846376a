// Hopper (sm_90a) kernel for the histogram counts of the GDS entropy
// estimator.
//
// It replaces the Pallas TPU kernel of repro/kernels/entropy_hist.py
// (hist_counts, _hist_kernel): counts[i] = #{x : clip(int((x - lo) * inv_w),
// 0, bins - 1) == i} over a flat sample x, with (lo, inv_w) given. The bin
// index is one fp32 subtract and one fp32 multiply, converted toward zero
// (__float2int_rz, which saturates, so values far out of range and
// infinities land in the end bins; NaN converts to 0) and clipped.
//
//   hist_kernel<T>   x (n,) fp32 / bf16 / fp16 -> counts (bins,) uint64,
//                    added into a zeroed output
//
// Design (H100 SXM: 3.35 TB/s HBM). One read of x and a few operations per
// element: bound by bytes. Blocks stride over x in 16-byte vectors (the
// ragged tail and an unaligned x take a scalar loop, so no padding is
// needed), and each warp counts into its own shared-memory histogram with
// shared atomics, which keeps the warps of a block from contending on the
// few central bins a gradient sample fills. At the end each block sums its
// warps' counts and adds them into the output with one 64-bit integer
// atomic per non-empty bin. Integer sums are exact and do not depend on
// block order (the TPU kernel summed fp32 one-hot rows, exact only up to
// 2**24 per bin). The wrapper converts to fp32 once.
//
// The C entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrapper raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxBins = 1024;   // kWarps * kMaxBins * 4 bytes = 32 KB of shared memory

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const T* __restrict__ x, long long n, const float* __restrict__ scal,
            unsigned long long* __restrict__ counts, int bins, bool vec) {
  extern __shared__ unsigned int sh[];   // [kWarps][bins]
  for (int i = threadIdx.x; i < kWarps * bins; i += kThreads) sh[i] = 0u;
  __syncthreads();

  const float lo = scal[0], inv_w = scal[1];
  unsigned int* mine = sh + (threadIdx.x / 32) * bins;
  auto count = [&](float v) {
    const float t = (v - lo) * inv_w;
    const int i = min(max(__float2int_rz(t), 0), bins - 1);
    atomicAdd(&mine[i], 1u);
  };

  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long tail = 0;
  if (vec) {
    const long long nvec = n / kVec;
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    for (long long i = first; i < nvec; i += stride) {
      const uint4 raw = xv[i];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < kVec; ++j) count(to_f32(e[j]));
    }
    tail = nvec * kVec;
  }
  for (long long i = tail + first; i < n; i += stride) count(to_f32(x[i]));
  __syncthreads();

  for (int i = threadIdx.x; i < bins; i += kThreads) {
    unsigned long long sum = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += sh[w * bins + i];
    if (sum) atomicAdd(&counts[i], sum);
  }
}

template <typename T>
cudaError_t run(const void* x, long long n, const float* scal,
                unsigned long long* counts, int bins, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  constexpr int kVec = 16 / sizeof(T);
  // enough blocks to fill the card, each with at least ~16 vectors a thread
  const long long want = (n + (long long)kThreads * kVec * 16 - 1) / ((long long)kThreads * kVec * 16);
  const int grid = (int)(want < 8LL * sms ? (want > 0 ? want : 1) : 8LL * sms);
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15u) == 0;
  const size_t smem = sizeof(unsigned int) * kWarps * bins;
  hist_kernel<T><<<grid, kThreads, smem, stream>>>(static_cast<const T*>(x), n, scal,
                                                   counts, bins, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// counts (bins,) uint64 += histogram of x (n,) under scal = (lo, inv_w) fp32
// on the device. dtype 0 = fp32, 1 = bf16, 2 = fp16; 1 <= bins <= 1024.
int repro_hist_counts(const void* x, long long n, const void* scal, void* counts,
                      int bins, int dtype, void* stream) {
  if (n <= 0 || bins < 1 || bins > kMaxBins) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scal);
  unsigned long long* c = static_cast<unsigned long long*>(counts);
  switch (dtype) {
    case 0: return (int)run<float>(x, n, sc, c, bins, s);
    case 1: return (int)run<__nv_bfloat16>(x, n, sc, c, bins, s);
    case 2: return (int)run<__half>(x, n, sc, c, bins, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
