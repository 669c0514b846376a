// Hopper (sm_90a) kernels for the PowerSGD hot spots of the EDGC sync.
//
// They replace the batched Pallas TPU kernels of repro/kernels/lowrank.py
// (ef_lowrank_p_batched, ef_lowrank_q_batched, decompress_residual_batched,
// gram_schmidt_panel_batched); the 2-D forms are the E = 1 case.
//
//   ef_factor_kernel<T, false>  P[e] = (G[e] + E[e]) . Q[e]     (E,m,n)x(E,n,r)
//   ef_factor_kernel<T, true>   Q[e] = (G[e] + E[e])^T . P[e]   (E,m,n)x(E,m,r)
//   decompress_kernel<T>        ghat = P Q^T,  E' = (G + E) - ghat
//   gram_schmidt_kernel         classical Gram-Schmidt of each (m, r) panel
//
// All arithmetic is fp32 FMA on the CUDA cores: no tensor-core TF32, since
// the factors must agree with an fp32 reference. No atomics: every output
// element is summed by one thread in a fixed order, and split reductions
// are summed by a second pass in split order, so results do not depend on
// launch order. Ragged edges (m, n, r not multiples of the tiles) are
// masked, so every shape runs the kernel.
//
// Each C entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrappers raise on a non-zero code.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kTileRows = 64;  // output rows per block
constexpr int kTileRank = 64;  // factor columns per block
constexpr int kTileK = 32;     // reduction depth staged per iteration

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// out[s][e] (rows x r) = sum over k in split s of A(row, k) * F(k, c), where
// A = G + E read as (m x n) when !TRANS (rows = m, K = n) and as its
// transpose when TRANS (rows = n, K = m); F is the (K x r) factor.
// With splits == 1, `out` is the (E, rows, r) result itself.
template <typename T, bool TRANS>
__global__ void __launch_bounds__(kThreads)
ef_factor_kernel(const T* __restrict__ g, const T* __restrict__ e,
                 const float* __restrict__ f, float* __restrict__ out,
                 int num_e, int m, int n, int r, int splits, int kchunk) {
  const int rows = TRANS ? n : m;
  const int K = TRANS ? m : n;
  const int be = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int row0 = blockIdx.x * kTileRows;
  const int c0 = blockIdx.y * kTileRank;
  const int kbeg = sp * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const size_t mn = (size_t)m * n;
  const T* G = g + (size_t)be * mn;
  const T* Eb = e + (size_t)be * mn;
  const float* F = f + (size_t)be * K * r;

  __shared__ float As[kTileK][kTileRows + 1];
  __shared__ float Fs[kTileK][kTileRank];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = kbeg; k0 < kend; k0 += kTileK) {
    // Stage the (G + E) tile; the error-feedback add happens on load, in
    // fp32. Neighbouring threads read neighbouring addresses either way.
#pragma unroll
    for (int l = 0; l < (kTileRows * kTileK) / kThreads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int rr = TRANS ? idx % kTileRows : idx / kTileK;
      const int kk = TRANS ? idx / kTileRows : idx % kTileK;
      const int grow = row0 + rr;
      const int gk = k0 + kk;
      float v = 0.f;
      if (grow < rows && gk < kend) {
        const size_t off = TRANS ? (size_t)gk * n + grow : (size_t)grow * n + gk;
        v = to_f32(G[off]) + to_f32(Eb[off]);
      }
      As[kk][rr] = v;
    }
#pragma unroll
    for (int l = 0; l < (kTileK * kTileRank) / kThreads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int cc = idx % kTileRank;
      const int kk = idx / kTileRank;
      const int gk = k0 + kk;
      const int gc = c0 + cc;
      Fs[kk][cc] = (gk < kend && gc < r) ? F[(size_t)gk * r + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Fs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* O = out + ((size_t)sp * num_e + be) * rows * r;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = c0 + tx + 16 * j;
      if (c < r) O[(size_t)row * r + c] = acc[i][j];
    }
  }
}

// out[i] = sum_s partial[s][i], summed in split order (deterministic).
__global__ void split_sum_kernel(const float* __restrict__ partial,
                                 float* __restrict__ out, size_t total,
                                 int splits) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * total + i];
    out[i] = s;
  }
}

// One (64 x 64) tile of ghat = P Q^T per block, inner dimension r staged
// 32 columns at a time; G and E are read once, ghat and E' written once.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decompress_kernel(const float* __restrict__ p, const float* __restrict__ q,
                  const T* __restrict__ g, const T* __restrict__ e,
                  T* __restrict__ ghat, T* __restrict__ err_out,
                  int m, int n, int r) {
  const int be = blockIdx.z;
  const int row0 = blockIdx.y * kTileRows;
  const int col0 = blockIdx.x * kTileRows;
  const float* P = p + (size_t)be * m * r;
  const float* Q = q + (size_t)be * n * r;

  __shared__ float Ps[kTileK][kTileRows + 1];
  __shared__ float Qs[kTileK][kTileRows + 1];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < r; c0 += kTileK) {
#pragma unroll
    for (int l = 0; l < (kTileRows * kTileK) / kThreads; ++l) {
      const int idx = threadIdx.x + l * kThreads;
      const int cc = idx % kTileK;
      const int rr = idx / kTileK;
      const int gc = c0 + cc;
      Ps[cc][rr] = (row0 + rr < m && gc < r) ? P[(size_t)(row0 + rr) * r + gc] : 0.f;
      Qs[cc][rr] = (col0 + rr < n && gc < r) ? Q[(size_t)(col0 + rr) * r + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int cc = 0; cc < kTileK; ++cc) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ps[cc][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Qs[cc][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const size_t base = (size_t)be * m * n;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= n) continue;
      const size_t off = base + (size_t)row * n + col;
      const float mv = to_f32(g[off]) + to_f32(e[off]);
      ghat[off] = from_f32<T>(acc[i][j]);
      err_out[off] = from_f32<T>(mv - acc[i][j]);
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum of v over the block, returned to every thread. `red` holds one float
// per warp.
__device__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  v = warp_sum(v);
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    float t = lane < nwarps ? red[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) red[0] = t;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;
}

// Classical Gram-Schmidt of one (m, r) panel per block, as the TPU kernel
// computes it: for column i, coef = U^T v against all previous columns at
// once, v -= U coef, v /= (||v|| + eps). The panel lives column-major in
// device memory (`work`, L2-resident), so each dot product and each column
// update reads contiguous memory; shared memory holds only the r
// coefficients and the per-warp partial sums.
__global__ void gram_schmidt_kernel(const float* __restrict__ p,
                                    float* __restrict__ out,
                                    float* __restrict__ work,
                                    int m, int r, float eps) {
  extern __shared__ float smem[];
  float* coef = smem;        // r
  float* red = smem + r;     // one per warp
  const size_t mr = (size_t)m * r;
  const float* P = p + blockIdx.x * mr;
  float* O = out + blockIdx.x * mr;
  float* C = work + blockIdx.x * mr;   // C[k * m + row] = panel[row][k]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;

  for (size_t idx = threadIdx.x; idx < mr; idx += blockDim.x)
    C[(idx % r) * m + idx / r] = P[idx];
  __syncthreads();

  for (int i = 0; i < r; ++i) {
    float* v = C + (size_t)i * m;
    for (int k = warp; k < i; k += nwarps) {
      const float* u = C + (size_t)k * m;
      float s = 0.f;
      for (int row = lane; row < m; row += 32) s = fmaf(u[row], v[row], s);
      s = warp_sum(s);
      if (lane == 0) coef[k] = s;
    }
    __syncthreads();
    float ss = 0.f;
    for (int row = threadIdx.x; row < m; row += blockDim.x) {
      float x = v[row];
      for (int k = 0; k < i; ++k) x = fmaf(-C[(size_t)k * m + row], coef[k], x);
      v[row] = x;
      ss = fmaf(x, x, ss);
    }
    const float denom = sqrtf(block_sum(ss, red)) + eps;
    for (int row = threadIdx.x; row < m; row += blockDim.x) v[row] = v[row] / denom;
    __syncthreads();
  }

  for (size_t idx = threadIdx.x; idx < mr; idx += blockDim.x)
    O[idx] = C[(idx % r) * m + idx / r];
}

template <typename T, bool TRANS>
int launch_factor(const void* g, const void* e, const void* f, void* out,
                  void* partial, int num_e, int m, int n, int r, int splits,
                  cudaStream_t stream) {
  const int rows = TRANS ? n : m;
  const int K = TRANS ? m : n;
  // split the reduction into chunks of whole k-tiles
  int kchunk = (K + splits - 1) / splits;
  kchunk = ((kchunk + kTileK - 1) / kTileK) * kTileK;
  dim3 grid((rows + kTileRows - 1) / kTileRows, (r + kTileRank - 1) / kTileRank,
            num_e * splits);
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  ef_factor_kernel<T, TRANS><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const T*>(e),
      static_cast<const float*>(f), dst, num_e, m, n, r, splits, kchunk);
  cudaError_t rc = cudaGetLastError();
  if (rc != cudaSuccess || splits == 1) return (int)rc;
  const size_t total = (size_t)num_e * rows * r;
  const int blocks = (int)((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  split_sum_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(out), total, splits);
  return (int)cudaGetLastError();
}

template <bool TRANS>
int dispatch_factor(const void* g, const void* e, const void* f, void* out,
                    void* partial, int num_e, int m, int n, int r, int splits,
                    int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_factor<float, TRANS>(g, e, f, out, partial, num_e, m, n, r, splits, s);
  if (dtype == 1)
    return launch_factor<__nv_bfloat16, TRANS>(g, e, f, out, partial, num_e, m, n, r,
                                               splits, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// P[e] = (G[e] + E[e]) Q[e]: g, e (E, m, n) of `dtype` (0 fp32, 1 bf16);
// q (E, n, r) fp32; out (E, m, r) fp32; partial (splits, E, m, r) fp32
// scratch, unused when splits == 1.
int repro_lowrank_p(const void* g, const void* e, const void* q, void* out,
                    void* partial, int num_e, int m, int n, int r, int splits,
                    int dtype, void* stream) {
  return dispatch_factor<false>(g, e, q, out, partial, num_e, m, n, r, splits,
                                dtype, stream);
}

// Q[e] = (G[e] + E[e])^T P[e]: p (E, m, r) fp32; out (E, n, r) fp32;
// partial (splits, E, n, r) fp32 scratch, unused when splits == 1.
int repro_lowrank_q(const void* g, const void* e, const void* p, void* out,
                    void* partial, int num_e, int m, int n, int r, int splits,
                    int dtype, void* stream) {
  return dispatch_factor<true>(g, e, p, out, partial, num_e, m, n, r, splits,
                               dtype, stream);
}

// ghat = P Q^T and err_out = (G + E) - ghat, both (E, m, n) in `dtype`;
// p (E, m, r) and q (E, n, r) fp32.
int repro_decompress_residual(const void* p, const void* q, const void* g,
                              const void* e, void* ghat, void* err_out,
                              int num_e, int m, int n, int r, int dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((n + kTileRows - 1) / kTileRows, (m + kTileRows - 1) / kTileRows, num_e);
  if (dtype == 0) {
    decompress_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(q),
        static_cast<const float*>(g), static_cast<const float*>(e),
        static_cast<float*>(ghat), static_cast<float*>(err_out), m, n, r);
  } else if (dtype == 1) {
    decompress_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(p), static_cast<const float*>(q),
        static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(e),
        static_cast<__nv_bfloat16*>(ghat), static_cast<__nv_bfloat16*>(err_out), m, n, r);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Orthonormalize each (m, r) slice of p (E, m, r) fp32 into out; work is
// (E, r, m) fp32 scratch.
int repro_gram_schmidt(const void* p, void* out, void* work, int num_e, int m,
                       int r, float eps, void* stream) {
  const int threads = 512;
  const size_t smem = (size_t)(r + threads / 32) * sizeof(float);
  gram_schmidt_kernel<<<num_e, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p), static_cast<float*>(out),
      static_cast<float*>(work), m, r, eps);
  return (int)cudaGetLastError();
}

}  // extern "C"
