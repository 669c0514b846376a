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
//   gram_schmidt_kernel<S>         classical Gram-Schmidt of each (m, r) panel,
//                                  one thread-block cluster per panel
//
// All arithmetic is fp32 FMA on the CUDA cores: no tensor-core TF32, since
// the factors must agree with an fp32 reference. No atomics: every output
// element is summed by one thread in a fixed order, split reductions are
// summed by a second pass in split order, and a cluster's partial sums in
// block order, so results do not depend on launch order. Ragged edges (m, n, r not multiples of the tiles) are
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

#include "sm90_common.cuh"   // mbarrier helpers

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

// ---------------------------------------------------- gram_schmidt_kernel
namespace gs {
constexpr int kMaxCluster = 16;    // blocks per panel (non-portable above 8)
constexpr int kThreads = 256;      // a block of 8 warps:
constexpr int kMainWarps = 4;      // the step's chain: wait, sums, update
constexpr int kLookWarps = 4;      // the next column's other dot products, alongside
// Resident blocks per SM that the register cap keeps: 3 for shared slabs
// (80 registers), 2 for device-memory ones (128: under 80 they spill).
template <bool SHARED> constexpr int min_blocks() { return SHARED ? 3 : 2; }
constexpr int kGroup = 8;          // dot products a warp sums per pass (warp_sum8)

// Column stride of a block's slab: its rows rounded up to 4 mod 8, so that
// each column is whole 16-byte row chunks and the transposing load and
// store (4 rows x 8 columns a warp) hit 32 banks.
__host__ __device__ inline int ld_of(int rows) { return (rows + 3) / 8 * 8 + 4; }

// Dynamic shared memory of one block, in bytes (kernels/lowrank.py's
// gs_smem states the same): two mbarriers, the slab (shared path), X[2][C]
// [r + 1] (every block's partial sums for one step: r coefficients and
// ||v||^2, two steps' worth), coef[r], the columns' denominators dn[r],
// pre[2][r + 1] (this block's partials, staged before they are sent) and
// red[2][kMainWarps] (the main warps' shares of two sums).
__host__ __device__ inline size_t smem_bytes(bool shared, int rows, int r, int cluster) {
  const size_t slab = shared ? (size_t)ld_of(rows) * r : 0;
  return 16 + 4 * (slab + 2 * ((size_t)cluster + 1) * (r + 1) + 2 * (size_t)r +
                   2 * kMainWarps);
}
}  // namespace gs

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}
__device__ __forceinline__ unsigned cluster_size() {
  unsigned v;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(v));
  return v;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n\t"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
// The shared::cluster address of shared address `local` in cluster block
// `rank`.
__device__ __forceinline__ uint32_t mapa(uint32_t local, unsigned rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(local), "r"(rank));
  return remote;
}
// Store v at shared::cluster address `dst` and count its 4 bytes on the
// mbarrier at shared::cluster address `bar` of the same block (complete_tx):
// no barrier of the whole cluster, the receiver waits on its own mbarrier.
__device__ __forceinline__ void st_async(uint32_t dst, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               :: "r"(dst), "r"(__float_as_uint(v)), "r"(bar) : "memory");
}
// A barrier of the main warps alone (named barrier 1).
__device__ __forceinline__ void bar_main() {
  asm volatile("bar.sync 1, %0;" :: "n"(gs::kMainWarps * 32) : "memory");
}
// p[0] + p[stride] + ... + p[(C - 1) stride], in that order: the blocks'
// partials in block order, so every block gets the same bits.
__device__ __forceinline__ float ordered_sum(const float* p, unsigned C, int stride) {
  float part[gs::kMaxCluster];
#pragma unroll
  for (unsigned c = 0; c < gs::kMaxCluster; ++c)   // all loads in flight at once
    part[c] = c < C ? p[c * stride] : 0.f;
  float s = part[0];
#pragma unroll
  for (unsigned c = 1; c < gs::kMaxCluster; ++c)
    if (c < C) s += part[c];
  return s;
}
// The sums over the warp of acc[0..8), in 9 shuffles instead of 40: the
// lanes halve the slots they hold at each of three exchanges, then sum the
// last one across 4 lanes. Lane l returns the sum of slot (l >> 2) & 7, in
// a fixed order.
__device__ __forceinline__ float warp_sum8(const float (&acc)[gs::kGroup], int lane) {
  const bool h4 = lane & 16, h3 = lane & 8, h2 = lane & 4;
  float a4[4], a2[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {     // slot j + 4 h4
    const float send = h4 ? acc[j] : acc[j + 4];
    a4[j] = (h4 ? acc[j + 4] : acc[j]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {     // slot j + 2 h3 + 4 h4
    const float send = h3 ? a4[j] : a4[j + 2];
    a2[j] = (h3 ? a4[j + 2] : a4[j]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  const float send = h2 ? a2[0] : a2[1];
  float s = (h2 ? a2[1] : a2[0]) + __shfl_xor_sync(0xffffffffu, send, 4);
  s += __shfl_xor_sync(0xffffffffu, s, 2);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}
// A warp's share of n <= 8 dot products over the block's rows: acc[j] = sum
// over its row chunks q (lane, lane + 32, ...) of column (kb + j nwarps) .
// a, the four rows of a chunk in order; acc[n..8) = 0. All of a chunk's
// loads are issued before its FMAs: a loop that waits for each shared load
// is latency-bound.
__device__ __forceinline__ void dots(float (&acc)[gs::kGroup], const float4* S4,
                                     const float4* a4, int ld4, int kb, int nwarps,
                                     int n, int q4, int lane) {
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int j = 0; j < gs::kGroup; ++j) acc[j] = 0.f;
  for (int q = lane; q < q4; q += 32) {
    const float4 x = a4[q];
    float4 w[gs::kGroup];
#pragma unroll
    for (int j = 0; j < gs::kGroup; ++j)
      w[j] = j < n ? S4[(kb + j * nwarps) * ld4 + q] : zero;
#pragma unroll
    for (int j = 0; j < gs::kGroup; ++j) {
      acc[j] = fmaf(w[j].x, x.x, acc[j]);
      acc[j] = fmaf(w[j].y, x.y, acc[j]);
      acc[j] = fmaf(w[j].z, x.z, acc[j]);
      acc[j] = fmaf(w[j].w, x.w, acc[j]);
    }
  }
}

// Classical Gram-Schmidt of each (m, r) panel by one thread-block cluster,
// as the TPU kernel computes it: for column i, coef = U^T v against all
// previous columns at once (v as it came in), v -= U coef, v /= (||v|| +
// eps). It replaces a kernel whose one block per panel re-read the whole
// panel from L2 for every column, on at most 32 of the 132 SMs.
//
// What bounds it is the column chain: r steps, each needing sums over all
// m rows, so its time is r times the latency of one step. The panel is
// split by rows over the C blocks of a cluster (block c owns rows [c rows,
// min((c + 1) rows, m)); the ragged end, and a block past it, are masked),
// and each step costs one exchange of partial sums. A barrier of the whole
// cluster (barrier.cluster) costs several times what the exchange needs,
// so the exchange is point to point: every block stores its partials into
// every block's shared memory with st.async, which counts the bytes on the
// receiver's mbarrier, and each block waits on its own. The columns stay
// unnormalized, v_k, during the sweep, each with its denominator d_k =
// ||v_k|| + eps, and the coefficient of u_k = v_k / d_k is taken as (a_i .
// v_k) / d_k, so the update v_i -= u_k coef_k is v_i -= v_k (a_i . v_k) /
// (d_k d_k): the same classical Gram-Schmidt, with no division on the slab
// inside the chain.
// Step i, on each block, two groups of warps side by side:
//   main  1. wait for step i's partials; thread k sums a_i . v_k over the
//            blocks in block order (the same bits in every block), and
//            thread i - 1 also ||v_{i-1}||^2, giving d_{i-1}; then cf_k =
//            (a_i . v_k) / (d_k d_k);
//         2. on its rows, a 16-byte chunk of four rows a thread: v_i = a_i
//            - sum_k v_k cf_k, and from the same registers the chunk's
//            shares of a_{i+1} . v_i and ||v_i||^2, summed over the main
//            warps;
//   look  a_{i+1} . v_k for k < i over its rows: they need no column of
//         this step, so they run while the main warps wait and update
//         (warp w takes w, w + W, ..., eight at a time);
//   all   send the block's step i+1 partials (staged in pre) to every
//         block of the cluster.
// Dot products over the rows are summed over a warp's lanes by warp_sum8.
// So the exchange that delivers column i's norm also delivers the next
// column's coefficients. At the end each column is divided by its
// denominator, u_k = v_k / d_k, on its way out. The partials and the
// mbarriers are double-buffered by step parity; a block can only send step
// s + 2's partials after it received every block's step s + 1 partials,
// which each block sends after it has read its step s buffer.
//
// SHARED: the block's slab of the panel lives column-major in shared memory,
// read once from p and written once to out. Otherwise (panels that do not
// fit at C = 16) the same algorithm runs on the block's slab in device
// memory, `work` (E C, r, ld), which stays in L2. Rows are handled in
// 16-byte chunks of four (the pad rows of the last chunk are zeros).
//
// fp32 FMA only, no atomics, every sum in a fixed order: two calls agree
// bit for bit.
template <bool SHARED>
__global__ void __launch_bounds__(gs::kThreads, gs::min_blocks<SHARED>())
gram_schmidt_kernel(const float* __restrict__ p, float* __restrict__ out,
                    float* __restrict__ work, int m, int r, int rows, float eps) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem_raw);   // [2], by step parity
  float* base = reinterpret_cast<float*>(smem_raw + 16);
  const unsigned C = cluster_size();
  const unsigned rank = cluster_rank();
  const size_t panel = blockIdx.x / C;
  const int row0 = (int)rank * rows;
  const int nrows = max(0, min(rows, m - row0));
  const int q4 = (nrows + 3) / 4;                // 16-byte row chunks
  const int ld = gs::ld_of(rows);
  const int ld4 = ld / 4;
  const int xs = r + 1;                          // floats a block sends per step
  float* S = SHARED ? base : work + (size_t)blockIdx.x * r * ld;
  float4* S4 = reinterpret_cast<float4*>(S);
  float* X = base + (SHARED ? r * ld : 0);       // [2][C][r + 1]
  float* coef = X + 2 * C * xs;                  // [r]: cf_k of the step
  float* dn = coef + r;                          // [r]: d_k = ||v_k|| + eps
  float* pre = dn + r;                           // [2][r + 1]: partials to send
  float* red = pre + 2 * xs;                     // [2][kMainWarps]
  const float* P = p + panel * m * r + (size_t)row0 * r;
  float* O = out + panel * m * r + (size_t)row0 * r;
  constexpr int T = gs::kThreads;
  constexpr int nwarps = T / 32;
  constexpr int TM = gs::kMainWarps * 32;       // main threads
  const int lc = __ffs(C) - 1;                   // C = 2^lc
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;

  // the slab, transposed in tiles of 4 rows x 8 columns (a warp each), and
  // zeros in the pad rows of the last chunk
  const int kt = (r + 7) / 8;
  for (int t = warp; t < q4 * kt; t += nwarps) {
    const int row = t / kt * 4 + (lane & 3), k = t % kt * 8 + (lane >> 2);
    if (k < r) S[k * ld + row] = row < nrows ? P[(size_t)row * r + k] : 0.f;
  }
  if (tid == 0) {
    mbar_init(smem_u32(&bars[0]), 1);
    mbar_init(smem_u32(&bars[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();   // every block has started and set up its mbarriers

  for (int i = 0; i <= r; ++i) {
    const int nb = (i + 1) & 1;                  // parity of step i + 1
    float* staged = pre + nb * xs;
    if (warp < gs::kMainWarps) {
      // 1. step i's partials (sent in step i-1), summed in block order;
      // thread k keeps d_k (k % TM == tid at every step)
      if (i > 0) {
        const int buf = i & 1;
        const uint32_t bar = smem_u32(&bars[buf]);
        if (tid == 0) mbar_expect_tx(bar, 4 * C * (i < r ? i + 1 : 1));
        mbar_wait(bar, ((i - 1) >> 1) & 1);
        const float* Xi = X + buf * C * xs;
        for (int k = tid; k < i; k += TM) {
          if (k == i - 1) dn[k] = sqrtf(ordered_sum(Xi + r, C, xs)) + eps;
          if (i < r) coef[k] = ordered_sum(Xi + k, C, xs) / (dn[k] * dn[k]);
        }
        if (i == r) break;
        bar_main();
      }
      // 2. this block's rows, a 16-byte chunk a thread: v_i = a_i - sum_k
      // v_k cf_k, the sum over k in groups of four columns (one
      // accumulator each), each group's loads issued before its FMAs; then,
      // from the same registers, the chunk's shares of a_{i+1} . v_i and
      // ||v_i||^2
      const bool last = i + 1 == r;
      float dp = 0.f, ss = 0.f;
      for (int q = tid; q < q4; q += TM) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        float4 y[4] = {zero, zero, zero, zero};
        for (int g = 0; g < i; g += 4) {
          float4 w[4];
          float c[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const bool ok = g + u < i;
            w[u] = ok ? S4[(g + u) * ld4 + q] : zero;
            c[u] = ok ? coef[g + u] : 0.f;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            y[u].x = fmaf(w[u].x, c[u], y[u].x);
            y[u].y = fmaf(w[u].y, c[u], y[u].y);
            y[u].z = fmaf(w[u].z, c[u], y[u].z);
            y[u].w = fmaf(w[u].w, c[u], y[u].w);
          }
        }
        float4 x = S4[i * ld4 + q];
        x.x -= (y[0].x + y[1].x) + (y[2].x + y[3].x);
        x.y -= (y[0].y + y[1].y) + (y[2].y + y[3].y);
        x.z -= (y[0].z + y[1].z) + (y[2].z + y[3].z);
        x.w -= (y[0].w + y[1].w) + (y[2].w + y[3].w);
        S4[i * ld4 + q] = x;
        ss = fmaf(x.x, x.x, ss);
        ss = fmaf(x.y, x.y, ss);
        ss = fmaf(x.z, x.z, ss);
        ss = fmaf(x.w, x.w, ss);
        if (!last) {
          const float4 a = S4[(i + 1) * ld4 + q];
          dp = fmaf(x.x, a.x, dp);
          dp = fmaf(x.y, a.y, dp);
          dp = fmaf(x.z, a.z, dp);
          dp = fmaf(x.w, a.w, dp);
        }
      }
      // 3. the two sums over the main warps, in warp order
      ss = warp_sum(ss);
      dp = warp_sum(dp);
      if (lane == 0) {
        red[warp] = ss;
        red[gs::kMainWarps + warp] = dp;
      }
      bar_main();
      if (tid < 2 && (tid == 0 || !last)) {
        const float* rw = red + tid * gs::kMainWarps;
        float sum = rw[0];
#pragma unroll
        for (int w = 1; w < gs::kMainWarps; ++w) sum += rw[w];
        staged[tid == 0 ? r : i] = sum;
      }
    } else if (i + 1 < r) {
      // look: a_{i+1} . v_k, k < i
      const int lw = warp - gs::kMainWarps;
      constexpr int nl = gs::kLookWarps;
      for (int kb = lw; kb < i; kb += nl * gs::kGroup) {
        float acc[gs::kGroup];
        dots(acc, S4, S4 + (i + 1) * ld4, ld4, kb, nl,
             min(gs::kGroup, (i - 1 - kb) / nl + 1), q4, lane);
        const float s = warp_sum8(acc, lane);
        const int k = kb + ((lane >> 2) & 7) * nl;
        if (k < i && (lane & 3) == 0) staged[k] = s;
      }
    } else if (i == r) {
      break;
    }
    __syncthreads();
    // send the staged partials: k <= i, then ||v_i||^2 at r
    const int nv = i + 1 < r ? i + 2 : 1;
    const uint32_t xdst = smem_u32(X + (nb * C + rank) * xs);
    const uint32_t bdst = smem_u32(&bars[nb]);
    for (int t = tid; t < nv << lc; t += T) {
      const int j = t >> lc, c = t & (C - 1);
      const int k = j == nv - 1 ? r : j;
      st_async(mapa(xdst + 4 * k, c), staged[k], mapa(bdst, c));
    }
  }
  // the slab back out, each column divided by its denominator
  __syncthreads();
  for (int t = warp; t < q4 * kt; t += nwarps) {
    const int row = t / kt * 4 + (lane & 3), k = t % kt * 8 + (lane >> 2);
    if (k < r && row < nrows) O[(size_t)row * r + k] = S[k * ld + row] / dn[k];
  }
  cluster_sync();   // no block leaves while a store to it may be in flight
}

// Cluster size and dynamic shared memory above the portable limits, set
// once per instance and device.
template <bool SHARED>
cudaError_t gs_prepare() {
  static unsigned long long done = 0;   // one bit per device
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0;
  if (done & bit) return cudaSuccess;
  rc = cudaFuncSetAttribute(gram_schmidt_kernel<SHARED>,
                            cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(gram_schmidt_kernel<SHARED>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)kSmemLimit);
  if (rc == cudaSuccess) done |= bit;
  return rc;
}

// One launch configuration: `blocks` blocks in clusters of `cluster`.
struct GSConfig {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  GSConfig(int blocks, int cluster, size_t smem, cudaStream_t stream) {
    cfg = cudaLaunchConfig_t{};
    cfg.gridDim = dim3(blocks, 1, 1);
    cfg.blockDim = dim3(gs::kThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cluster;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
  }
};

bool gs_valid_cluster(int cluster) {
  return cluster >= 1 && cluster <= gs::kMaxCluster && (cluster & (cluster - 1)) == 0;
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

// Orthonormalize each (m, r) slice of p (E, m, r) fp32 into out, one
// cluster of `cluster` blocks of 256 threads per slice, `rows` =
// ceil(m / cluster) rows per block, as kernels/lowrank.py's gs_plan
// decides. shared != 0: each block's slab in shared memory; else in work,
// (E cluster, r, ld) fp32 scratch, ld = gs::ld_of(rows) (unused on the
// shared path).
int repro_gram_schmidt(const void* p, void* out, void* work, int num_e, int m,
                       int r, int cluster, int rows, int shared, float eps,
                       void* stream) {
  if (num_e < 1 || m < 1 || r < 1 || !gs_valid_cluster(cluster) ||
      rows != (m + cluster - 1) / cluster ||
      (long long)num_e * cluster > 0x7fffffffLL || (long long)m * r > 0x7fffffffLL ||
      (!shared && work == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gs::smem_bytes(shared != 0, rows, r, cluster);
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  const float* pt = static_cast<const float*>(p);
  float* ot = static_cast<float*>(out);
  float* wt = static_cast<float*>(work);
  GSConfig c(num_e * cluster, cluster, smem, static_cast<cudaStream_t>(stream));
  cudaError_t rc = shared ? gs_prepare<true>() : gs_prepare<false>();
  if (rc == cudaSuccess)
    rc = shared ? cudaLaunchKernelEx(&c.cfg, gram_schmidt_kernel<true>, pt, ot, wt, m, r, rows, eps)
                : cudaLaunchKernelEx(&c.cfg, gram_schmidt_kernel<false>, pt, ot, wt, m, r, rows, eps);
  const cudaError_t last = cudaGetLastError();   // clears a refused launch's error
  return (int)(rc != cudaSuccess ? rc : last);
}

// out[0]: clusters of `cluster` blocks that can be resident at once
// (cudaOccupancyMaxActiveClusters) for that launch of gram_schmidt_kernel;
// out[1]: its dynamic shared memory in bytes; out[2]: the slab's column
// stride (gs::ld_of). out is int[3].
int repro_gs_occupancy(int shared, int cluster, int rows, int r, void* out) {
  int* o = static_cast<int*>(out);
  o[0] = 0;
  o[1] = 0;
  o[2] = gs::ld_of(rows);
  if (rows < 1 || r < 1 || !gs_valid_cluster(cluster))
    return (int)cudaErrorInvalidValue;
  const size_t smem = gs::smem_bytes(shared != 0, rows, r, cluster);
  o[1] = (int)(smem < 0x7fffffff ? smem : 0x7fffffff);
  if (smem > (size_t)kSmemLimit) return (int)cudaSuccess;   // never resident
  GSConfig c(cluster, cluster, smem, nullptr);
  cudaError_t rc = shared ? gs_prepare<true>() : gs_prepare<false>();
  if (rc == cudaSuccess)
    rc = shared ? cudaOccupancyMaxActiveClusters(&o[0], gram_schmidt_kernel<true>, &c.cfg)
                : cudaOccupancyMaxActiveClusters(&o[0], gram_schmidt_kernel<false>, &c.cfg);
  return (int)rc;
}

}  // extern "C"
