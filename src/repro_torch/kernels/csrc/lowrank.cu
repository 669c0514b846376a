// Hopper (sm_90a) kernels for the PowerSGD hot spots of the EDGC sync.
//
// They replace the batched Pallas TPU kernels of repro/kernels/lowrank.py
// (ef_lowrank_p_batched :188, ef_lowrank_q_batched :218,
// decompress_residual_batched :247, gram_schmidt_panel_batched :288); the
// 2-D forms (:47, :78, :108, :155, reached through ops.py) are E = 1.
//
//   ef_factor_kernel<T, false, V>  P[e] = (G[e] + E[e]) . Q[e]     (E,m,n)x(E,n,r)
//   ef_factor_kernel<T, true, V>   Q[e] = (G[e] + E[e])^T . P[e]   (E,m,n)x(E,m,r)
//   decompress_kernel<T>           ghat = P Q^T,  E' = (G + E) - ghat
//   gram_schmidt_kernel            classical Gram-Schmidt of each (m, r) panel
//
// All arithmetic is fp32 FMA on the CUDA cores: no tensor-core TF32, since
// the factors must agree with an fp32 reference. No atomics: every output
// element is summed by one thread in a fixed order, and split reductions
// are summed by a second pass in split order, so results do not depend on
// launch order. Ragged edges (m, n, r not multiples of the tiles) are
// masked, so every shape runs the kernel.
//
// ef_factor_kernel reads G and E once and does 2r FLOP per element: at
// r = 64 in fp32 that is 128 FLOP per 8 bytes, 16 FLOP/B, just under the
// H100's fp32 ridge (67 TFLOP/s over 3.35 TB/s = 20 FLOP/B). It is bound by
// bytes, but only just: it must keep the FMA pipes about 80% busy merely
// to keep pace with memory, so its design is the register-blocked SGEMM
// shaped for r <= 64, with the loads overlapped with the FMAs:
//   * one block of 128 threads owns a 128-row x 64-rank tile of the
//     output (all of r at r <= 64, so G + E is read once; larger r takes
//     more column tiles); each thread holds 8 x 8 accumulators and, per k,
//     reads its 8 A values and 8 F values as four 16-byte shared loads for
//     64 FFMA;
//   * k-tiles are double-buffered with one __syncthreads() per tile: while
//     tile k is multiplied, each thread holds tile k+1's G and E in
//     registers (16-byte loads, 4 fp32 or 8 bf16), adds them in fp32 after
//     the FMA loop and stores the sum into the other buffer; the F panel
//     (Q or P-hat, fp32, L2-resident) goes there by cp.async, without
//     registers. P stores the sum transposed; Q stores it straight;
//   * P's 16-byte path takes k-tiles of 32, so that each tile reads whole
//     128-byte lines of G's rows (16-deep tiles read half lines, and P ran
//     slower than Q); the rest take 16. The A tile's rows are XOR-swizzled
//     in groups of 4 instead of padded: P's transposed stores then hit 32
//     banks per warp, and two 32-deep stages fit the 48 KB of static
//     shared memory;
//   * a scalar path (one element per load) serves rows that 16-byte loads
//     cannot read: n not a multiple of 4 (fp32) or 8 (bf16), or G or E not
//     16-byte aligned. The host picks it, as kernels/lowrank.py's
//     factor_plan does;
//   * the registers are capped for two resident blocks per SM (under a cap
//     for three, ptxas spilled); the host plan splits the reduction only
//     where that makes fewer waves of resident blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // decompress: 16 x 16 threads, 4 x 4 outputs each
constexpr int kTileRows = 64;  // decompress: output rows (and columns) per block
constexpr int kTileK = 32;     // decompress: inner depth staged per iteration

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// ------------------------------------------------------- ef_factor_kernel
namespace factor {
constexpr int kThreads = 128;      // 16 row groups x 8 column groups
constexpr int kRows = 128;         // output rows per block
constexpr int kRank = 64;          // factor columns per block
constexpr int kMinBlocks = 2;      // resident blocks per SM the register cap keeps
// Reduction depth per k-tile: 32 where P reads rows of G with 16-byte
// loads (128 bytes of each row per tile: whole L2 lines), else 16.
template <bool TRANS, bool VEC>
__host__ __device__ constexpr int k_tile() { return !TRANS && VEC ? 32 : 16; }
}  // namespace factor

// Where A-tile element (k, row) sits in its k row of 128: rows permuted in
// groups of 4 by an XOR with k's group of 4. The transposed stores of P
// then hit 32 banks per warp (P's vector path), and every fragment load
// stays one aligned 16-byte vector.
__device__ __forceinline__ int a_col(int k, int row) {
  return row ^ (((k >> 2) & 7) << 2);
}

// Elements of T in one 16-byte load, and their fp32 values.
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ __forceinline__ static void unpack(const uint4& v, float* x) {
    x[0] = __uint_as_float(v.x); x[1] = __uint_as_float(v.y);
    x[2] = __uint_as_float(v.z); x[3] = __uint_as_float(v.w);
  }
};
template <> struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ __forceinline__ static void unpack(const uint4& v, float* x) {
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {   // low half first (little endian); exact
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// A 16-byte load of data read once: not kept in L1, and the L2 fetches the
// whole 128-byte line (a bf16 row segment of P's k-tile is 64 bytes, so
// the next tile's bytes are then in L2).
__device__ __forceinline__ uint4 ldg_stream(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.L2::128B.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// cp.async of 16 or 4 bytes into shared memory; `bytes` 0 writes zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" :: "r"(d), "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// One thread's share of a k-tile of G and E, held in registers between its
// load (before the FMA loop) and its store into shared memory (after).
// VEC: 16-byte loads; else one element per load. Both index maps put
// neighbouring threads on neighbouring addresses.
template <typename T, bool TRANS, bool VEC>
struct GEStage {
  static constexpr int kK = factor::k_tile<TRANS, VEC>();
  static constexpr int kV = VEC ? Vec16<T>::kN : 1;       // elements per load
  static constexpr int kLoads = factor::kRows * kK / factor::kThreads / kV;
  // vectors per A-tile line: along k (P, a row of G) or along rows (Q)
  static constexpr int kLine = (TRANS ? factor::kRows : kK) / kV;
  uint4 gv[VEC ? kLoads : 1], ev[VEC ? kLoads : 1];
  T gs[VEC ? 1 : kLoads], es[VEC ? 1 : kLoads];

  // tile position of load l: (row in the block's tile, k in the k-tile)
  __device__ __forceinline__ static void where(int l, int& rr, int& kk) {
    const int idx = threadIdx.x + l * factor::kThreads;
    if (TRANS) { kk = idx / kLine; rr = (idx % kLine) * kV; }
    else       { rr = idx / kLine; kk = (idx % kLine) * kV; }
  }

  __device__ __forceinline__ void load(const T* G, const T* E, int n, int rows,
                                       int row0, int k0, int kend) {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      int rr, kk;
      where(l, rr, kk);
      const int grow = row0 + rr, gk = k0 + kk;
      // vector path: n % kV == 0 and kend % kV == 0, so a vector is all
      // inside or all outside
      const bool ok = grow < rows && gk < kend;
      const size_t off = TRANS ? (size_t)gk * n + grow : (size_t)grow * n + gk;
      if (VEC) {
        gv[l] = ok ? ldg_stream(G + off) : make_uint4(0, 0, 0, 0);
        ev[l] = ok ? ldg_stream(E + off) : make_uint4(0, 0, 0, 0);
      } else {
        gs[l] = ok ? G[off] : from_f32<T>(0.f);
        es[l] = ok ? E[off] : from_f32<T>(0.f);
      }
    }
  }

  // As[k][a_col(k, row)] = G + E, in fp32
  __device__ __forceinline__ void store(float (*As)[factor::kRows]) const {
#pragma unroll
    for (int l = 0; l < kLoads; ++l) {
      int rr, kk;
      where(l, rr, kk);
      float x[kV];
      if (VEC) {
        float y[kV];
        Vec16<T>::unpack(gv[l], x);
        Vec16<T>::unpack(ev[l], y);
#pragma unroll
        for (int j = 0; j < kV; ++j) x[j] += y[j];
      } else {
        x[0] = to_f32(gs[l]) + to_f32(es[l]);
      }
      if (TRANS && VEC) {
#pragma unroll
        for (int j = 0; j < kV; j += 4)
          *reinterpret_cast<float4*>(&As[kk][a_col(kk, rr + j)]) =
              make_float4(x[j], x[j + 1], x[j + 2], x[j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < kV; ++j) {
          const int k = kk + (TRANS ? 0 : j);
          As[k][a_col(k, rr + (TRANS ? j : 0))] = x[j];
        }
      }
    }
  }
};

// A k-tile of the (K x r) fp32 factor F straight into shared memory by
// cp.async (no registers), zeros where masked: 16-byte copies when r % 4 ==
// 0 and F is aligned (fvec), else 4-byte ones.
template <int KK>
__device__ __forceinline__ void copy_f_tile(float (*Fs)[factor::kRank],
                                            const float* F, int r, int c0,
                                            int k0, int kend, bool fvec) {
  constexpr int kPer = KK * factor::kRank / factor::kThreads;   // floats a thread copies
  if (fvec) {
#pragma unroll
    for (int l = 0; l < kPer / 4; ++l) {
      const int idx = threadIdx.x + l * factor::kThreads;
      const int kk = idx / (factor::kRank / 4), cc = (idx % (factor::kRank / 4)) * 4;
      const int gk = k0 + kk, gc = c0 + cc;
      const bool ok = gk < kend && gc < r;
      cp_async16(&Fs[kk][cc], ok ? F + (size_t)gk * r + gc : F, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int l = 0; l < kPer; ++l) {
      const int idx = threadIdx.x + l * factor::kThreads;
      const int kk = idx / factor::kRank, cc = idx % factor::kRank;
      const int gk = k0 + kk, gc = c0 + cc;
      const bool ok = gk < kend && gc < r;
      cp_async4(&Fs[kk][cc], ok ? F + (size_t)gk * r + gc : F, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// out[s][e] (rows x r) = sum over k in split s of A(row, k) * F(k, c), where
// A = G + E read as (m x n) when !TRANS (rows = m, K = n) and as its
// transpose when TRANS (rows = n, K = m); F is the (K x r) factor. Split s
// covers k in [s * kchunk, min(K, (s + 1) * kchunk)), kchunk a multiple of
// the k-tile. With splits == 1, `out` is the (E, rows, r) result itself.
// Thread (ty, tx) = (tid / 8, tid % 8) owns rows 4 ty + i and 64 + 4 ty + i
// and columns 4 tx + j and 32 + 4 tx + j (i, j < 4): each of its four
// 16-byte fragment loads per k reads 4 (A) or 8 (F) distinct vectors per
// warp, free of bank conflicts.
template <typename T, bool TRANS, bool VEC>
__global__ void __launch_bounds__(factor::kThreads, factor::kMinBlocks)
ef_factor_kernel(const T* __restrict__ g, const T* __restrict__ e,
                 const float* __restrict__ f, float* __restrict__ out,
                 int num_e, int m, int n, int r, int splits, int kchunk,
                 int fvec) {
  using factor::kRows;
  using factor::kRank;
  constexpr int kK = factor::k_tile<TRANS, VEC>();
  const int rows = TRANS ? n : m;
  const int K = TRANS ? m : n;
  const int be = blockIdx.z / splits;
  const int sp = blockIdx.z % splits;
  const int row0 = blockIdx.x * kRows;
  const int c0 = blockIdx.y * kRank;
  const int kbeg = sp * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const size_t mn = (size_t)m * n;
  const T* G = g + (size_t)be * mn;
  const T* Eb = e + (size_t)be * mn;
  const float* F = f + (size_t)be * K * r;

  __shared__ __align__(16) float As[2][kK][kRows];
  __shared__ __align__(16) float Fs[2][kK][kRank];
  const int tx = threadIdx.x % 8;
  const int ty = threadIdx.x / 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  GEStage<T, TRANS, VEC> ge;
  ge.load(G, Eb, n, rows, row0, kbeg, kend);
  copy_f_tile<kK>(Fs[0], F, r, c0, kbeg, kend, fvec);
  ge.store(As[0]);
  cp_async_wait_all();
  __syncthreads();

  int buf = 0;
  for (int k0 = kbeg; k0 < kend; k0 += kK) {
    const bool more = k0 + kK < kend;
    if (more) {   // tile k+1 on its way: the loads fly during the FMAs
      ge.load(G, Eb, n, rows, row0, k0 + kK, kend);
      copy_f_tile<kK>(Fs[buf ^ 1], F, r, c0, k0 + kK, kend, fvec);
    }
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][kk][a_col(kk, 4 * ty)]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&As[buf][kk][a_col(kk, 64 + 4 * ty)]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Fs[buf][kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Fs[buf][kk][32 + 4 * tx]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (more) ge.store(As[buf ^ 1]);   // every thread left it at the last sync
    cp_async_wait_all();
    __syncthreads();
    buf ^= 1;
  }

  float* O = out + ((size_t)sp * num_e + be) * rows * r;
  const bool ovec = (r % 4 == 0) && (reinterpret_cast<uintptr_t>(out) % 16 == 0);
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (row >= rows) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 32 * h + 4 * tx;
      float* dst = O + (size_t)row * r + c;
      if (ovec && c + 3 < r) {
        *reinterpret_cast<float4*>(dst) = make_float4(
            acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c + j < r) dst[j] = acc[i][4 * h + j];
      }
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

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The host side of kernels/lowrank.py's factor_plan: the plan picks
// `splits`; this derives the rest by the same rules. Each split covers
// kchunk = ceil(K / splits) rounded up to whole k-tiles, and a launch whose
// last split would be empty is refused (the plan never asks for one).
template <typename T, bool TRANS>
int launch_factor(const void* g, const void* e, const void* f, void* out,
                  void* partial, int num_e, int m, int n, int r, int splits,
                  cudaStream_t stream) {
  using factor::kRows;
  using factor::kRank;
  const int rows = TRANS ? n : m;
  const int K = TRANS ? m : n;
  if (num_e < 1 || m < 1 || n < 1 || r < 1 || splits < 1)
    return (int)cudaErrorInvalidValue;
  // 16-byte loads of G and E need whole vectors per row and aligned bases;
  // of F, r % 4 == 0 and an aligned base
  const bool vec = n % Vec16<T>::kN == 0 && aligned16(g) && aligned16(e);
  const int fvec = r % 4 == 0 && aligned16(f);
  const int kt = vec ? factor::k_tile<TRANS, true>() : factor::k_tile<TRANS, false>();
  int kchunk = (K + splits - 1) / splits;
  kchunk = ((kchunk + kt - 1) / kt) * kt;
  const int col_tiles = (r + kRank - 1) / kRank;
  if ((long long)(splits - 1) * kchunk >= K || (long long)num_e * splits > 65535 ||
      col_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  dim3 grid((rows + kRows - 1) / kRows, col_tiles, num_e * splits);
  float* dst = splits == 1 ? static_cast<float*>(out) : static_cast<float*>(partial);
  const T* gt = static_cast<const T*>(g);
  const T* et = static_cast<const T*>(e);
  const float* ft = static_cast<const float*>(f);
  if (vec)
    ef_factor_kernel<T, TRANS, true><<<grid, factor::kThreads, 0, stream>>>(
        gt, et, ft, dst, num_e, m, n, r, splits, kchunk, fvec);
  else
    ef_factor_kernel<T, TRANS, false><<<grid, factor::kThreads, 0, stream>>>(
        gt, et, ft, dst, num_e, m, n, r, splits, kchunk, fvec);
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
