// Hopper (sm_90a) kernels for flash attention: the forward (with the
// log-sum-exp rows when asked) and the recompute-form backward (dQ, dK/dV).
//
// They replace the Pallas TPU kernels of repro/kernels/flash_attention.py
// (flash_attention, _flash_kernel) and repro/kernels/flash_attention_bwd.py
// (_fwd_with_stats / _fwd_kernel, _bwd / _dq_kernel and _dkv_kernel):
//
//   flash_fwd_kernel   o = softmax(q k^T * scale) v, online over k tiles;
//                      lse = m + log(l) per query row when lse != NULL
//   flash_dq_kernel    dQ = sum_k dS K * scale over k tiles, with
//                      P = exp(S * scale - L), dP = dO V^T, dS = P (dP - D)
//   flash_dkv_kernel   dV = sum P^T dO, dK = sum dS^T Q * scale over the q
//                      tiles of every query head that shares the kv head
//
// q, dO: (B, Tq, H, Dh); k, v: (B, Tk, Hkv, Dh), read in place through their
// batch, time and head strides (the head dimension is contiguous); query
// head h reads kv head h / (H / Hkv). o, dq: (B, Tq, H, Dh) and dk, dv:
// (B, Tk, Hkv, Dh), contiguous, in the inputs' dtype; lse and D: (B, H, Tq)
// fp32. Every product runs in fp32, as the TPU kernels cast every tile
// (.astype(F32)). The kernels here take fp32 only: bf16 inputs run the
// tensor-core kernels of flash_fwd_sm90.cu (forward) and flash_bwd_sm90.cu
// (dQ, dK/dV), and the entry points here refuse them, so each dtype has
// exactly one kernel per function. Masked scores are -1e30, the row sum
// is clamped at 1e-30, and scale = 1/sqrt(Dh) multiplies the dot, as
// there. Ragged edges (T not a multiple of 64) are masked here, so every T
// runs the kernel.
//
// Design (H100 SXM: 67 TFLOP/s fp32 FMA, 3.35 TB/s HBM). At Dh = 64..128 a
// tile does 64 FLOP per byte it reads, so the fp32 FMA path is bound by
// operations: a first, simple version that is right. One block of 256
// threads owns a 64-row tile of queries (forward, dQ) or keys (dK/dV) and
// keeps it in shared memory as fp32; the other side streams through in
// 64-row tiles. Warp w owns rows 8w..8w+7 of the block's tile: it holds
// their 8 x 64 scores in registers (two columns per lane), takes the row
// max and sum with warp shuffles, and writes P (or dS) only to its own rows
// of a 64 x 64 shared tile, so the online softmax needs no block barrier.
// A tile read by lane index is padded to a pitch of Dh + 1 floats (no bank
// conflicts); a tile read by row is read as float4 broadcasts. dK/dV sums
// the GQA group inside the block (the TPU reference wrote fp32 (B*H, Tk,
// Dh) per query head and summed afterwards), so no atomics are needed and
// the result does not depend on scheduling. Causal tiles wholly above the
// diagonal are skipped, as _fwd_kernel:65-66 skips them.
//
// Each C entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrappers raise on a non-zero code.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;       // rows of a query tile and of a key tile
constexpr int kThreads = 256;   // 8 warps
constexpr int kRows = 8;        // tile rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }

struct Strides {   // in elements; the head dimension has stride 1
  long long b, t, h;
};

struct Shape {
  int B, Tq, Tk, H, Hkv, rep;
  int causal;
  float scale;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows [row0, row0 + 64) of head h, batch b of a (B, T, heads, D) tensor into
// an fp32 shared tile of pitch P; rows at or past T are zero.
template <typename T, int D, int P>
__device__ __forceinline__ void load_tile(float* dst, const T* src, Strides st,
                                          int b, int h, int row0, int rows) {
  const T* base = src + b * st.b + h * st.h;
  for (int i = threadIdx.x; i < kTile * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int t = row0 + r;
    dst[r * P + d] = t < rows ? to_f32(base[(long long)t * st.t + d]) : 0.f;
  }
}

// acc[r][j] += A[row r of this warp] . B[column lane + 32 j]: A is a shared
// tile of pitch D read as float4 broadcasts, B one of pitch D + 1 read by lane.
template <int D>
__device__ __forceinline__ void rows_dot_lanes(float (&acc)[kRows][2],
                                               const float* a, const float* bt,
                                               int warp, int lane) {
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float bv[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) bv[j][e] = bt[(lane + 32 * j) * (D + 1) + d + e];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 av = *reinterpret_cast<const float4*>(a + (warp * kRows + r) * D + d);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float x = acc[r][j];
        x = fmaf(av.x, bv[j][0], x);
        x = fmaf(av.y, bv[j][1], x);
        x = fmaf(av.z, bv[j][2], x);
        x = fmaf(av.w, bv[j][3], x);
        acc[r][j] = x;
      }
    }
  }
}

// out[r][c] += sum_t W[row r of this warp][t] * M[t][lane + 32 c] over the 64
// rows t of M: W is the warp's rows of a 64 x 64 shared tile, M a shared
// tile of pitch P.
template <int D, int P>
__device__ __forceinline__ void rows_times_tile(float (&out)[kRows][D / 32],
                                                const float* w, const float* m,
                                                int warp, int lane) {
  constexpr int C = D / 32;
#pragma unroll 2
  for (int t0 = 0; t0 < kTile; t0 += 4) {
    float mv[4][C];
#pragma unroll
    for (int e = 0; e < 4; ++e)
#pragma unroll
      for (int c = 0; c < C; ++c) mv[e][c] = m[(t0 + e) * P + lane + 32 * c];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float4 wv = *reinterpret_cast<const float4*>(w + (warp * kRows + r) * kTile + t0);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float x = out[r][c];
        x = fmaf(wv.x, mv[0][c], x);
        x = fmaf(wv.y, mv[1][c], x);
        x = fmaf(wv.z, mv[2][c], x);
        x = fmaf(wv.w, mv[3][c], x);
        out[r][c] = x;
      }
    }
  }
}

// Number of key tiles query tile qt reads: all of them, or under the causal
// mask those that start at or before its last row.
__device__ __forceinline__ int key_tiles(const Shape& s, int qt) {
  const int all = (s.Tk + kTile - 1) / kTile;
  return s.causal ? min(all, qt + 1) : all;
}

// ------------------------------------------------------------------ forward
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, Shape s, Strides sq, Strides sk,
                 Strides sv) {
  constexpr int C = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // [64][D]
  float* sK = sQ + kTile * D;             // [64][D + 1]
  float* sV = sK + kTile * (D + 1);       // [64][D]
  float* sP = sV + kTile * D;             // [64][64]
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / s.rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTile;

  load_tile<T, D, D>(sQ, q, sq, b, h, q0, s.Tq);
  float acc[kRows][C], m[kRows], l[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int nk = key_tiles(s, qt);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();   // every warp is done with the previous K/V tile
    load_tile<T, D, D + 1>(sK, k, sk, b, g, kt * kTile, s.Tk);
    load_tile<T, D, D>(sV, v, sv, b, g, kt * kTile, s.Tk);
    __syncthreads();

    float sc[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r][0] = sc[r][1] = 0.f;
    rows_dot_lanes<D>(sc, sQ, sK, warp, lane);

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ki = kt * kTile + lane + 32 * j;
        x[j] = sc[r][j] * s.scale;
        if (ki >= s.Tk || (s.causal && qi < ki)) x[j] = kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new), p1 = expf(x[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = l[r] * alpha + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < C; ++c) acc[r][c] *= alpha;
      sP[(warp * kRows + r) * kTile + lane] = p0;
      sP[(warp * kRows + r) * kTile + lane + 32] = p1;
    }
    __syncwarp();
    rows_times_tile<D, D>(acc, sP, sV, warp, lane);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= s.Tq) continue;
    const float lc = fmaxf(l[r], 1e-30f);
    T* orow = o + (((long long)b * s.Tq + qi) * s.H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) orow[lane + 32 * c] = from_f32<T>(acc[r][c] / lc);
    if (lse != nullptr && lane == 0)
      lse[((long long)b * s.H + h) * s.Tq + qi] = m[r] + logf(lc);
  }
}

// ----------------------------------------------------------------------- dQ
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dq, Shape s, Strides sq, Strides sk, Strides sv,
                Strides sdo) {
  constexpr int C = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                       // [64][D]
  float* sdO = sQ + kTile * D;            // [64][D]
  float* sK = sdO + kTile * D;            // [64][D + 1]
  float* sV = sK + kTile * (D + 1);       // [64][D + 1]
  float* sS = sV + kTile * (D + 1);       // [64][64]: dS * scale
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h / s.rep;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = qt * kTile;

  load_tile<T, D, D>(sQ, q, sq, b, h, q0, s.Tq);
  load_tile<T, D, D>(sdO, dout, sdo, b, h, q0, s.Tq);
  float L[kRows], Dl[kRows], acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    const long long row = ((long long)b * s.H + h) * s.Tq + qi;
    L[r] = qi < s.Tq ? lse[row] : 0.f;
    Dl[r] = qi < s.Tq ? delta[row] : 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) acc[r][c] = 0.f;
  }

  const int nk = key_tiles(s, qt);
  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();
    load_tile<T, D, D + 1>(sK, k, sk, b, g, kt * kTile, s.Tk);
    load_tile<T, D, D + 1>(sV, v, sv, b, g, kt * kTile, s.Tk);
    __syncthreads();

    float sc[kRows][2], dp[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.f;
    rows_dot_lanes<D>(sc, sQ, sK, warp, lane);
    rows_dot_lanes<D>(dp, sdO, sV, warp, lane);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qi = q0 + warp * kRows + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int ki = kt * kTile + lane + 32 * j;
        float x = sc[r][j] * s.scale;
        if (s.causal && qi < ki) x = kNegInf;
        const float p = ki < s.Tk ? expf(x - L[r]) : 0.f;
        sS[(warp * kRows + r) * kTile + lane + 32 * j] = p * (dp[r][j] - Dl[r]) * s.scale;
      }
    }
    __syncwarp();
    rows_times_tile<D, D + 1>(acc, sS, sK, warp, lane);
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qi = q0 + warp * kRows + r;
    if (qi >= s.Tq) continue;
    T* row = dq + (((long long)b * s.Tq + qi) * s.H + h) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) row[lane + 32 * c] = from_f32<T>(acc[r][c]);
  }
}

// -------------------------------------------------------------------- dK/dV
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 T* __restrict__ dk, T* __restrict__ dv, Shape s, Strides sq,
                 Strides sk, Strides sv, Strides sdo) {
  constexpr int C = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;                       // [64][D]
  float* sV = sK + kTile * D;             // [64][D]
  float* sQ = sV + kTile * D;             // [64][D + 1]
  float* sdO = sQ + kTile * (D + 1);      // [64][D + 1]
  float* sP = sdO + kTile * (D + 1);      // [64][64]: P^T, then dS^T * scale
  float* sL = sP + kTile * kTile;         // [64]
  float* sD = sL + kTile;                 // [64]
  const int kt = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = kt * kTile;

  load_tile<T, D, D>(sK, k, sk, b, g, k0, s.Tk);
  load_tile<T, D, D>(sV, v, sv, b, g, k0, s.Tk);
  float dk_acc[kRows][C], dv_acc[kRows][C];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int c = 0; c < C; ++c) dk_acc[r][c] = dv_acc[r][c] = 0.f;

  const int nq = (s.Tq + kTile - 1) / kTile;
  // under the causal mask, query tiles that end before this key tile
  // starts contribute nothing
  const int first = s.causal ? kt : 0;
  for (int hr = 0; hr < s.rep; ++hr) {
    const int h = g * s.rep + hr;
    for (int qt = first; qt < nq; ++qt) {
      const int q0 = qt * kTile;
      __syncthreads();
      load_tile<T, D, D + 1>(sQ, q, sq, b, h, q0, s.Tq);
      load_tile<T, D, D + 1>(sdO, dout, sdo, b, h, q0, s.Tq);
      if (threadIdx.x < kTile) {
        const int qi = q0 + threadIdx.x;
        const long long row = ((long long)b * s.H + h) * s.Tq + qi;
        sL[threadIdx.x] = qi < s.Tq ? lse[row] : 0.f;
        sD[threadIdx.x] = qi < s.Tq ? delta[row] : 0.f;
      }
      __syncthreads();

      float sc[kRows][2], dp[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) sc[r][0] = sc[r][1] = dp[r][0] = dp[r][1] = 0.f;
      rows_dot_lanes<D>(sc, sK, sQ, warp, lane);    // S^T: keys x queries
      rows_dot_lanes<D>(dp, sV, sdO, warp, lane);   // dP^T
      float ds[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int ki = k0 + warp * kRows + r;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = lane + 32 * j;
          const int qi = q0 + col;
          float x = sc[r][j] * s.scale;
          if (s.causal && qi < ki) x = kNegInf;
          const float p = qi < s.Tq ? expf(x - sL[col]) : 0.f;
          ds[r][j] = p * (dp[r][j] - sD[col]) * s.scale;
          sP[(warp * kRows + r) * kTile + col] = p;
        }
      }
      __syncwarp();
      rows_times_tile<D, D + 1>(dv_acc, sP, sdO, warp, lane);
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        sP[(warp * kRows + r) * kTile + lane] = ds[r][0];
        sP[(warp * kRows + r) * kTile + lane + 32] = ds[r][1];
      }
      __syncwarp();
      rows_times_tile<D, D + 1>(dk_acc, sP, sQ, warp, lane);
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int ki = k0 + warp * kRows + r;
    if (ki >= s.Tk) continue;
    const long long off = (((long long)b * s.Tk + ki) * s.Hkv + g) * D;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      dk[off + lane + 32 * c] = from_f32<T>(dk_acc[r][c]);
      dv[off + lane + 32 * c] = from_f32<T>(dv_acc[r][c]);
    }
  }
}

// ------------------------------------------------------------------ launches
constexpr size_t fwd_smem(int d) { return sizeof(float) * (kTile * (3 * d + 1) + kTile * kTile); }
constexpr size_t dq_smem(int d) { return sizeof(float) * (kTile * (4 * d + 2) + kTile * kTile); }
constexpr size_t dkv_smem(int d) { return dq_smem(d) + sizeof(float) * 2 * kTile; }

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse_in, *delta;
  void *out0, *out1;
  float* lse_out;
  Shape s;
  Strides sq, sk, sv, sdo;
  cudaStream_t stream;
};

template <typename T, int D>
cudaError_t run_fwd(const Args& a) {
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t e = allow_smem(kern, fwd_smem(D));
  if (e != cudaSuccess) return e;
  dim3 grid((a.s.Tq + kTile - 1) / kTile, a.s.H, a.s.B);
  kern<<<grid, kThreads, fwd_smem(D), a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.out0, a.lse_out, a.s,
      a.sq, a.sk, a.sv);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dq(const Args& a) {
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t e = allow_smem(kern, dq_smem(D));
  if (e != cudaSuccess) return e;
  dim3 grid((a.s.Tq + kTile - 1) / kTile, a.s.H, a.s.B);
  kern<<<grid, kThreads, dq_smem(D), a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse_in,
      a.delta, (T*)a.out0, a.s, a.sq, a.sk, a.sv, a.sdo);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t run_dkv(const Args& a) {
  auto kern = flash_dkv_kernel<T, D>;
  cudaError_t e = allow_smem(kern, dkv_smem(D));
  if (e != cudaSuccess) return e;
  dim3 grid((a.s.Tk + kTile - 1) / kTile, a.s.Hkv, a.s.B);
  kern<<<grid, kThreads, dkv_smem(D), a.stream>>>(
      (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.dout, a.lse_in,
      a.delta, (T*)a.out0, (T*)a.out1, a.s, a.sq, a.sk, a.sv, a.sdo);
  return cudaGetLastError();
}

enum Which { kFwd, kDq, kDkv };

template <typename T>
cudaError_t dispatch_d(Which w, int d, const Args& a) {
#define REPRO_FLASH_CASE(DH)                              \
  case DH:                                                \
    return w == kFwd ? run_fwd<T, DH>(a)                  \
         : w == kDq  ? run_dq<T, DH>(a) : run_dkv<T, DH>(a);
  switch (d) {
    REPRO_FLASH_CASE(32)
    REPRO_FLASH_CASE(64)
    REPRO_FLASH_CASE(96)
    REPRO_FLASH_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_FLASH_CASE
}

int dispatch(Which w, int d, int dtype, Args& a, int B, int Tq, int Tk, int H,
             int Hkv, int causal, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  // scale rounded once from double, as 1.0 / math.sqrt(Dh) is in Python
  a.s = Shape{B, Tq, Tk, H, Hkv, H / Hkv, causal ? 1 : 0,
              (float)(1.0 / sqrt((double)d))};
  a.stream = static_cast<cudaStream_t>(stream);
  // dtype 1 (bf16) is refused: it runs the tensor-core kernels of
  // flash_fwd_sm90.cu and flash_bwd_sm90.cu
  if (dtype == 0) return (int)dispatch_d<float>(w, d, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// o (B, Tq, H, D) and, when lse != NULL, lse (B, H, Tq) fp32 <- q, k, v.
// dtype 0 = fp32 (1 = bf16 is refused: flash_fwd_sm90.cu); D in {32, 64,
// 96, 128}.
int repro_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, int B, int Tq, int Tk, int H, int Hkv, int D,
                    int causal, int dtype, long long qb, long long qt,
                    long long qh, long long kb, long long kt, long long kh,
                    long long vb, long long vt, long long vh, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.out0 = o; a.lse_out = static_cast<float*>(lse);
  a.sq = Strides{qb, qt, qh}; a.sk = Strides{kb, kt, kh}; a.sv = Strides{vb, vt, vh};
  return dispatch(kFwd, D, dtype, a, B, Tq, Tk, H, Hkv, causal, stream);
}

// dq (B, Tq, H, D) <- q, k, v, dO and the forward's lse and D = rowsum(dO o).
// dtype 0 = fp32 (1 = bf16 is refused: flash_bwd_sm90.cu), as for dk, dv.
int repro_flash_dq(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int Tq, int Tk, int H, int Hkv, int D,
                   int causal, int dtype, long long qb, long long qt,
                   long long qh, long long kb, long long kt, long long kh,
                   long long vb, long long vt, long long vh, long long ob,
                   long long ot, long long oh, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.out0 = dq;
  a.lse_in = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.sq = Strides{qb, qt, qh}; a.sk = Strides{kb, kt, kh}; a.sv = Strides{vb, vt, vh};
  a.sdo = Strides{ob, ot, oh};
  return dispatch(kDq, D, dtype, a, B, Tq, Tk, H, Hkv, causal, stream);
}

// dk, dv (B, Tk, Hkv, D), each summed over the H / Hkv query heads of its kv
// head, <- q, k, v, dO, lse and D.
int repro_flash_dkv(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int Tq, int Tk, int H, int Hkv,
                    int D, int causal, int dtype, long long qb, long long qt,
                    long long qh, long long kb, long long kt, long long kh,
                    long long vb, long long vt, long long vh, long long ob,
                    long long ot, long long oh, void* stream) {
  Args a{};
  a.q = q; a.k = k; a.v = v; a.dout = dout; a.out0 = dk; a.out1 = dv;
  a.lse_in = static_cast<const float*>(lse); a.delta = static_cast<const float*>(delta);
  a.sq = Strides{qb, qt, qh}; a.sk = Strides{kb, kt, kh}; a.sv = Strides{vb, vt, vh};
  a.sdo = Strides{ob, ot, oh};
  return dispatch(kDkv, D, dtype, a, B, Tq, Tk, H, Hkv, causal, stream);
}

}  // extern "C"
