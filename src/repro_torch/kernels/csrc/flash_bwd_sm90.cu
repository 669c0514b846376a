// Hopper (sm_90a) flash attention backward for bf16 inputs, on the tensor
// cores, in the recompute form: dQ, and dK with dV.
//
// It replaces, for bf16 inputs, the Pallas TPU kernels of
// repro/kernels/flash_attention_bwd.py:186 (_bwd): _dq_kernel (:88) and
// _dkv_kernel (:118). fp32 inputs run flash_dq_kernel / flash_dkv_kernel of
// flash.cu: wgmma has no fp32 mode and TF32 keeps about three decimal
// digits, short of the fp32 bar. Each dtype has exactly one kernel per
// gradient; flash.cu refuses a bf16 dQ or dK/dV.
//
// The functions are ref.flash_dq's and ref.flash_dkv's: q, dO (B, Tq, H, Dh)
// and k, v (B, Tk, Hkv, Dh) read in place through their batch, time and head
// strides; query head h reads kv head h / (H / Hkv); lse and D = rowsum(dO o)
// (B, H, Tq) fp32 contiguous; scale = 1/sqrt(Dh) rounded once from double.
//   P  = exp(S * scale - L), S = Q K^T, masked (causal, ragged) to 0
//   dS = P (dP - D),         dP = dO V^T
//   dQ = sum_k dS K * scale                   (B, Tq, H, Dh) bf16
//   dV = sum_q P^T dO, dK = sum_q dS^T Q * scale, per query head
// At H = Hkv dK and dV are written in bf16 (B, Tk, Hkv, Dh). Under GQA
// (H > Hkv) the kernel writes fp32 partials (B, Tk, H, Dh), one per query
// head, and the wrapper sums each kv head's group in torch, as the
// reference sums them in jnp outside its kernel (:243-246): no atomics, so
// the result does not depend on scheduling.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// gpt2-2.5b widths (B 8, T 1024, 20 heads of 96, causal) dQ does three
// products per (query, key) pair the mask keeps (48.4 GFLOP, 0.049 ms) and
// dK/dV four (64.5 GFLOP, 0.065 ms); each moves 159-190 MB (0.047-0.057
// ms), so operations bound both.
//
// Design. A block is two warpgroups (256 threads); each owns 64 rows of
// the block's 128 and keeps their accumulators in registers. The block's
// own rows come once and the other side's tiles stream through a ring of
// 2-4 shared-memory stages (as many as fit) by TMA over the strided 4-D
// view (Dh, heads, T, B), with one full mbarrier per stage and an empty one
// that the eight warps release. Rows past T arrive as zeros. Thread 0
// issues the loads: after releasing tile r it waits for the other warps to
// release tile r - 1, one tile behind (seldom a stall), and loads tile
// r - 1 + stages into that stage.
//   dQ: a block owns 128 query rows of one (batch, query head); Q and dO
//   come once, K and V tiles of n keys through the ring. Per key tile:
//   S = Q K^T and dP = dO V^T are wgmma with A and B from shared memory,
//   both K-major; P and dS are computed on the accumulator fragments (L and
//   D of the thread's two rows sit in registers); dS * scale is packed to
//   bf16 in place, so the S fragment is the A fragment of dQ += dS K, whose
//   B = K is read MN-major (the transpose bit). Query tiles launch heaviest
//   first; key tiles wholly past a warpgroup's rows are skipped.
//   dK/dV: a block owns 128 keys of one (batch, query head); K and V come
//   once, Q and dO tiles of n queries through the ring, with their L and D
//   rows, which warp 0 copies into the stage by cp.async (zeros past Tq)
//   while lane 0 issues the tiles' TMA; the stage is full once both have
//   landed. Per query tile: S^T = K Q^T and dP^T = V dO^T (both K-major);
//   P^T and dS^T on the fragments, L and D read by column from shared
//   memory; dV += P^T dO and dK += dS^T Q with dO and Q read MN-major from
//   the same shared tiles that fed S^T and dP^T. Key tile 0, the heaviest
//   under the causal mask, launches first; query tiles wholly before a
//   warpgroup's keys are skipped.
// Registers: a thread holds its accumulators (dQ: Dh/2 floats; dK/dV: Dh)
// and the S and dP fragments of one tile (n/2 each), then the packed bf16
// A fragments (n/4 registers each). A warp takes its registers from one of
// the SM's four sub-partitions (16,384 each); the eight warps put two on
// each, so a thread may use 255 (a separate producer warp, nine warps,
// would put three on one and cap a thread at 168: there dK/dV at Dh 128
// spilled and ptxas serialized its wgmma). The plan takes the widest tile
// of 128, 64 and 32 rows whose accumulators and fragments fit 160 floats
// (kFragBudget): dQ n = 128 up to Dh 64 and 64 above; dK/dV n = 128 at Dh
// 32, 64 at Dh 64 and 96, 32 at Dh 128. The kernels need 140-250
// registers and spill none.
// P and dS are rounded to bf16 before the products that take them as A:
// the one place where the kernels round unlike the reference, which
// multiplies fp32, as with the forward's P. Shared-memory tiles are column
// chunks of one swizzle span (sm90_common.cuh). The Python wrapper's
// flash_attention_bwd.sm90_bwd_plan states the same plan and passes it in;
// a launch whose plan differs from the compiled one is refused.
//
// Each C entry point launches on the stream it is given and returns 0 or an
// error code that repro_cuda_error_string explains.

#include "sm90_common.cuh"

namespace {

constexpr int kBlock = 128;      // rows a block owns: query rows (dQ) or keys (dK/dV)
constexpr int kThreads = 256;    // two warpgroups of 64 rows; thread 0 also issues the loads
constexpr int kMaxStages = 4;    // ring depth, at most
constexpr int kBarBytes = 128;   // the mbarriers, after the tiles
constexpr int kFragBudget = 160; // accumulator and fragment floats of a thread

template <int D, bool kDq>
struct BwdPlan : Chunking<D> {
  // floats a thread holds at a streamed tile of n rows: its accumulators
  // (dQ, or dK and dV) and the S and dP fragments
  static constexpr int frag(int n) { return (kDq ? D / 2 : D) + n; }
  // rows of a streamed tile: the widest of 128, 64 and 32 within the budget
  static constexpr int kTile = frag(128) <= kFragBudget  ? 128
                               : frag(64) <= kFragBudget ? 64
                                                         : 32;
  static constexpr int kFixedBytes = 2 * kBlock * D * 2;   // Q and dO (dQ), K and V (dK/dV)
  static constexpr int kTileBytes = kTile * D * 2;         // one streamed tile
  static constexpr int kRowBytes = kDq ? 0 : 2 * kTile * 4;   // L and D of a query tile
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's period
  static constexpr int smem(int stages) {
    return 1024 + kFixedBytes + stages * (2 * kTileBytes + kRowBytes) + kBarBytes;
  }
  static constexpr int kStages = smem(kMaxStages) <= kSmemLimit   ? kMaxStages
                                 : smem(kMaxStages - 1) <= kSmemLimit ? kMaxStages - 1
                                                                      : 2;
  static constexpr int kSmem = smem(kStages);
  static_assert(kSmem <= kSmemLimit, "over the 227 KB a block may use");
  static_assert(8 * (1 + 2 * kStages) <= kBarBytes, "room for the mbarriers");
};

struct Shape {
  int B, Tq, Tk, H, Hkv, rep, causal;
  float scale;
};

// K-major descriptor of the 16 columns from kk * 16 of a chunked tile of
// `rows` rows, starting `row` rows in.
template <int D>
__device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows, int row, int kk) {
  using C = Chunking<D>;
  const uint32_t chunk = kk * 16 / C::kCols, off = (kk * 16 % C::kCols) * 2;
  return smem_desc(tile + (chunk * rows + row) * C::kSwizzle + off, 16, C::kSbo, C::kLayout);
}

// MN-major descriptor of rows kk * 16 .. + 15 of a chunked tile of `rows`
// rows, all D columns: chunks rows * kSwizzle bytes apart (LBO), 8 rows
// kSbo apart (SBO).
template <int D>
__device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows, int kk) {
  using C = Chunking<D>;
  return smem_desc(tile + kk * 16 * C::kSwizzle, rows * C::kSwizzle, C::kSbo, C::kLayout);
}

template <int N>
__device__ __forceinline__ void pack_fragment(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
  // the accumulator fragment of columns 16kk..16kk+15 is the A fragment of k-step kk
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) a[kk][e] = pack_bf16(x[8 * kk + 2 * e], x[8 * kk + 2 * e + 1]);
}

__device__ __forceinline__ void init_barriers(uint32_t once, uint32_t full, uint32_t empty,
                                              int stages, uint32_t full_count) {
  mbar_init(once, 1);
  for (int st = 0; st < stages; ++st) {
    mbar_init(full + 8 * st, full_count);
    mbar_init(empty + 8 * st, kThreads / 32);   // one arrival per warp
  }
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// 4 bytes from global src to shared dst, or 4 zero bytes when !valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
// Arrive on bar once this thread's cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// ---------------------------------------------------------------------- dQ
// Accumulator fragments (wgmma m64nN f32): element 4j + e of a thread is
// row 16 warp + quad + 8 (e >> 1) of the warpgroup's 64, column
// 8j + 2 tq + (e & 1).
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                     const __grid_constant__ CUtensorMap map_k,
                     const __grid_constant__ CUtensorMap map_v,
                     const __grid_constant__ CUtensorMap map_do,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, Shape s) {
  using P = BwdPlan<D, true>;
  constexpr int kN = P::kTile, kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sdO = sQ + kBlock * D * 2;
  const uint32_t sK = sdO + kBlock * D * 2;              // stage st at + st * kTileBytes
  const uint32_t sV = sK + kStages * P::kTileBytes;
  const uint32_t qbar = sV + kStages * P::kTileBytes;    // then full, empty
  const uint32_t full = qbar + 8, empty = full + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlock;   // heaviest causal tiles first
  const int hk = h / s.rep;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane / 4, tq = lane % 4;

  const int all_tiles = (s.Tk + kN - 1) / kN;
  const int nk = s.causal ? min(all_tiles, (min(q0 + kBlock, s.Tq) - 1) / kN + 1) : all_tiles;

  // thread 0 loads key tile t into stage t % kStages
  auto load_kv = [&](int t) {
    const int st = t % kStages;
    mbar_expect_tx(full + 8 * st, 2 * P::kTileBytes);
    load_tile<D>(sK + st * P::kTileBytes, &map_k, full + 8 * st, hk, t * kN, b, kN);
    load_tile<D>(sV + st * P::kTileBytes, &map_v, full + 8 * st, hk, t * kN, b, kN);
  };
  if (tid == 0) {
    init_barriers(qbar, full, empty, kStages, 1);
    mbar_expect_tx(qbar, P::kFixedBytes);
    load_tile<D>(sQ, &map_q, qbar, h, q0, b, kBlock);
    load_tile<D>(sdO, &map_do, qbar, h, q0, b, kBlock);
    for (int t = 0; t < min(nk, kStages); ++t) load_kv(t);
  }
  __syncthreads();

  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + quad;   // this thread's rows: row0, row0 + 8
  const float scale_log2 = s.scale * kLog2e;
  float lse2[2], dlt[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    const long long i = ((long long)b * s.H + h) * s.Tq + row;
    lse2[r] = row < s.Tq ? lse[i] * kLog2e : 0.f;
    dlt[r] = row < s.Tq ? delta[i] : 0.f;
  }
  // key tiles the warpgroup's rows reach: under the causal mask, those that
  // start at or before its last row
  const int wg_nk = wg_row0 >= s.Tq ? 0
                    : s.causal      ? min(nk, (min(wg_row0 + 64, s.Tq) - 1) / kN + 1)
                                    : nk;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  mbar_wait(qbar, 0);
  float sc[kN / 2], dp[kN / 2];
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    mbar_wait(full + 8 * st, (j / kStages) & 1);
    if (j < wg_nk) {
      const uint32_t k_st = sK + st * P::kTileBytes, v_st = sV + st * P::kTileBytes;
      // S = Q K^T and dP = dO V^T over Dh in k16 steps
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, kmajor<D>(sQ, kBlock, wg * 64, kk), kmajor<D>(k_st, kN, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, kmajor<D>(sdO, kBlock, wg * 64, kk), kmajor<D>(v_st, kN, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P = exp(S scale - L), masked on diagonal and edge tiles only;
      // dS scale = P (dP - D) scale, in place of S
      const int k0 = j * kN;
      const bool masked = k0 + kN > s.Tk || (s.causal && k0 + kN - 1 > wg_row0);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (masked) {
          const int col = k0 + (i >> 2) * 8 + 2 * tq + (i & 1);
          if (col >= s.Tk || (s.causal && col > row0 + 8 * r)) p = 0.f;
        }
        sc[i] = p * (dp[i] - dlt[r]) * s.scale;
      }
      uint32_t da[kN / 16][4];
      pack_fragment<kN>(da, sc);

      // dQ += dS K over the tile's keys in k16 steps, K read MN-major
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs(acc, da[kk], mnmajor<D>(k_st, kN, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    // thread 0 refills the stage of tile j - 1, one tile behind, so that
    // its wait for the other warps' release seldom stalls
    if (tid == 0 && j >= 1 && j - 1 + kStages < nk) {
      mbar_wait(empty + 8 * ((j - 1) % kStages), ((j - 1) / kStages) & 1);
      load_kv(j - 1 + kStages);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= s.Tq) continue;
    __nv_bfloat16* out = dq + (((long long)b * s.Tq + row) * s.H + h) * D + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * r], acc[4 * jj + 2 * r + 1]);
  }
}

// -------------------------------------------------------------------- dK/dV
// Fragments as in dQ, with keys for rows and queries for columns.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      const __grid_constant__ CUtensorMap map_do,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      void* __restrict__ dk, void* __restrict__ dv, Shape s) {
  using P = BwdPlan<D, false>;
  constexpr int kN = P::kTile, kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_u32(smem_raw);
  const uint32_t sK = (base + 1023) & ~1023u;
  const uint32_t sV = sK + kBlock * D * 2;
  const uint32_t sQ = sV + kBlock * D * 2;               // stage st at + st * kTileBytes
  const uint32_t sdO = sQ + kStages * P::kTileBytes;
  const uint32_t sRows = sdO + kStages * P::kTileBytes;  // stage st: L, then D
  const uint32_t kvbar = sRows + kStages * P::kRowBytes;  // then full, empty
  const uint32_t full = kvbar + 8, empty = full + 8 * kStages;
  float* rows = reinterpret_cast<float*>(smem_raw + (sRows - base));

  const int h = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBlock;   // key tile 0, the heaviest under the causal mask, first
  const int hk = h / s.rep;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane / 4, tq = lane % 4;

  // query tiles wholly before the key tile contribute nothing under the mask
  const int nq = (s.Tq + kN - 1) / kN;
  const int first = s.causal ? min(k0 / kN, nq) : 0;
  const int nt = nq - first;

  // Warp 0 loads query tile first + t into stage t % kStages: lane 0 Q and
  // dO by TMA, every lane its share of the tile's L and D rows by cp.async
  // (zeros past Tq). The stage is full once the TMA bytes have landed and
  // the 32 lanes' copies have arrived.
  const float* lse_bh = lse + ((long long)b * s.H + h) * s.Tq;
  const float* delta_bh = delta + ((long long)b * s.H + h) * s.Tq;
  auto load_q = [&](int t) {
    const int st = t % kStages, q0 = (first + t) * kN;
    if (lane == 0) {
      mbar_expect_tx(full + 8 * st, 2 * P::kTileBytes);
      load_tile<D>(sQ + st * P::kTileBytes, &map_q, full + 8 * st, h, q0, b, kN);
      load_tile<D>(sdO + st * P::kTileBytes, &map_do, full + 8 * st, h, q0, b, kN);
    }
    const uint32_t ls = sRows + st * P::kRowBytes;
    for (int i = lane; i < kN; i += 32) {
      const int q = min(q0 + i, s.Tq - 1);
      cp_async4(ls + 4 * i, lse_bh + q, q0 + i < s.Tq);
      cp_async4(ls + 4 * (kN + i), delta_bh + q, q0 + i < s.Tq);
    }
    cp_async_arrive(full + 8 * st);
  };
  if (tid == 0) {
    init_barriers(kvbar, full, empty, kStages, 1 + 32);
    mbar_expect_tx(kvbar, P::kFixedBytes);
    load_tile<D>(sK, &map_k, kvbar, hk, k0, b, kBlock);
    load_tile<D>(sV, &map_v, kvbar, hk, k0, b, kBlock);
  }
  __syncthreads();
  if (tid < 32)
    for (int t = 0; t < min(nt, kStages); ++t) load_q(t);

  const int wg_k0 = k0 + wg * 64;
  const int key0 = wg_k0 + warp * 16 + quad;   // this thread's keys: key0, key0 + 8
  const float scale_log2 = s.scale * kLog2e;
  // the first query tile the warpgroup's keys reach (none past Tk)
  const int wg_first = wg_k0 >= s.Tk ? nq : s.causal ? max(first, wg_k0 / kN) : first;
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  mbar_wait(kvbar, 0);
  float sc[kN / 2], dp[kN / 2];
  for (int t = 0; t < nt; ++t) {
    const int st = t % kStages, qt = first + t, q0 = qt * kN;
    mbar_wait(full + 8 * st, (t / kStages) & 1);
    if (qt >= wg_first) {
      const uint32_t q_st = sQ + st * P::kTileBytes, do_st = sdO + st * P::kTileBytes;
      // S^T = K Q^T and dP^T = V dO^T over Dh in k16 steps
      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(sc, kmajor<D>(sK, kBlock, wg * 64, kk), kmajor<D>(q_st, kN, 0, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss(dp, kmajor<D>(sV, kBlock, wg * 64, kk), kmajor<D>(do_st, kN, 0, kk), kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(sc);
      fence_regs(dp);

      // P^T and dS^T = P^T (dP^T - D), L and D by column (query)
      const float* ls = rows + st * 2 * kN;
      const bool masked = q0 + kN > s.Tq || (s.causal && q0 < wg_k0 + 63);
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int c = (i >> 2) * 8 + 2 * tq + (i & 1);
        float p = ex2(fmaf(sc[i], scale_log2, -ls[c] * kLog2e));
        if (masked) {
          const int q = q0 + c;
          if (q >= s.Tq || (s.causal && q < key0 + 8 * ((i >> 1) & 1))) p = 0.f;
        }
        dp[i] = p * (dp[i] - ls[kN + c]);
        sc[i] = p;
      }
      uint32_t pa[kN / 16][4], da[kN / 16][4];
      pack_fragment<kN>(pa, sc);
      pack_fragment<kN>(da, dp);

      // dV += P^T dO and dK += dS^T Q over the tile's queries in k16 steps,
      // dO and Q read MN-major
      fence_regs(dv_acc);
      fence_regs(dk_acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs(dv_acc, pa[kk], mnmajor<D>(do_st, kN, kk));
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) wgmma_rs(dk_acc, da[kk], mnmajor<D>(q_st, kN, kk));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(dv_acc);
      fence_regs(dk_acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
    // warp 0 refills the stage of tile t - 1, one tile behind, so that its
    // wait for the other warps' release seldom stalls
    if (tid < 32 && t >= 1 && t - 1 + kStages < nt) {
      mbar_wait(empty + 8 * ((t - 1) % kStages), ((t - 1) / kStages) & 1);
      load_q(t - 1 + kStages);
    }
  }

  // dK * scale and dV: bf16 at (b, key, hk) when H = Hkv, else fp32
  // partials at (b, key, h) that the wrapper sums over the group
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= s.Tk) continue;
    if (s.rep == 1) {
      const long long at = (((long long)b * s.Tk + key) * s.Hkv + hk) * D + 2 * tq;
      __nv_bfloat16* ok = static_cast<__nv_bfloat16*>(dk) + at;
      __nv_bfloat16* ov = static_cast<__nv_bfloat16*>(dv) + at;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int i = 4 * jj + 2 * r;
        *reinterpret_cast<__nv_bfloat162*>(ok + 8 * jj) =
            __floats2bfloat162_rn(dk_acc[i] * s.scale, dk_acc[i + 1] * s.scale);
        *reinterpret_cast<__nv_bfloat162*>(ov + 8 * jj) =
            __floats2bfloat162_rn(dv_acc[i], dv_acc[i + 1]);
      }
    } else {
      const long long at = (((long long)b * s.Tk + key) * s.H + h) * D + 2 * tq;
      float* ok = static_cast<float*>(dk) + at;
      float* ov = static_cast<float*>(dv) + at;
#pragma unroll
      for (int jj = 0; jj < D / 8; ++jj) {
        const int i = 4 * jj + 2 * r;
        *reinterpret_cast<float2*>(ok + 8 * jj) =
            make_float2(dk_acc[i] * s.scale, dk_acc[i + 1] * s.scale);
        *reinterpret_cast<float2*>(ov + 8 * jj) = make_float2(dv_acc[i], dv_acc[i + 1]);
      }
    }
  }
}

// -------------------------------------------------------------------- host
struct Call {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *out0, *out1;
  int B, Tq, Tk, H, Hkv, causal;
  long long sq[3], sk[3], sv[3], sdo[3];   // (b, t, h) strides, in elements
  int block, tile, threads, swizzle, stages, smem;
  cudaStream_t stream;
};

template <int D, bool kDq>
int run(const Call& c) {
  using P = BwdPlan<D, kDq>;
  if (c.block != kBlock || c.tile != P::kTile || c.threads != kThreads ||
      c.swizzle != P::kSwizzle || c.stages != P::kStages || c.smem != P::kSmem)
    return kErrPlan;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  // the block's own rows come in boxes of kBlock rows, the streamed side's
  // in tiles of kTile rows
  const int qrows = kDq ? kBlock : P::kTile, krows = kDq ? P::kTile : kBlock;
  CUtensorMap mq, mk, mv, mdo;
  int rc = make_map(&mq, enc, c.q, D, c.H, c.Tq, c.B, c.sq[2], c.sq[1], c.sq[0], P::kCols, qrows,
                    P::kSwizzle);
  if (rc == 0)
    rc = make_map(&mdo, enc, c.dout, D, c.H, c.Tq, c.B, c.sdo[2], c.sdo[1], c.sdo[0], P::kCols,
                  qrows, P::kSwizzle);
  if (rc == 0)
    rc = make_map(&mk, enc, c.k, D, c.Hkv, c.Tk, c.B, c.sk[2], c.sk[1], c.sk[0], P::kCols, krows,
                  P::kSwizzle);
  if (rc == 0)
    rc = make_map(&mv, enc, c.v, D, c.Hkv, c.Tk, c.B, c.sv[2], c.sv[1], c.sv[0], P::kCols, krows,
                  P::kSwizzle);
  if (rc != 0) return rc;
  // scale rounded once from double, as 1.0 / math.sqrt(Dh) is in Python
  const Shape s{c.B, c.Tq, c.Tk, c.H, c.Hkv, c.H / c.Hkv, c.causal ? 1 : 0,
                (float)(1.0 / sqrt((double)D))};
  const float* lse = static_cast<const float*>(c.lse);
  const float* delta = static_cast<const float*>(c.delta);
  cudaError_t e;
  if constexpr (kDq) {
    auto kern = flash_dq_sm90_kernel<D>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(c.H, c.B, (c.Tq + kBlock - 1) / kBlock);
    kern<<<grid, kThreads, P::kSmem, c.stream>>>(mq, mk, mv, mdo, lse, delta,
                                                 static_cast<__nv_bfloat16*>(c.out0), s);
  } else {
    auto kern = flash_dkv_sm90_kernel<D>;
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(c.H, c.B, (c.Tk + kBlock - 1) / kBlock);
    kern<<<grid, kThreads, P::kSmem, c.stream>>>(mq, mk, mv, mdo, lse, delta, c.out0, c.out1, s);
  }
  return (int)cudaGetLastError();
}

template <bool kDq>
int dispatch(int D, const Call& c) {
  const int rows = kDq ? c.Tq : c.Tk;
  if (c.B <= 0 || c.Tq <= 0 || c.Tk <= 0 || c.H <= 0 || c.Hkv <= 0 || c.H % c.Hkv != 0 ||
      c.B > 65535 || (rows + kBlock - 1) / kBlock > 65535)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 32: return run<32, kDq>(c);
    case 64: return run<64, kDq>(c);
    case 96: return run<96, kDq>(c);
    case 128: return run<128, kDq>(c);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) { return error_string(code); }

// dq (B, Tq, H, D) bf16 <- bf16 q, k, v, dO with the given (b, t, h)
// element strides and the forward's lse and D = rowsum(dO o), (B, H, Tq)
// fp32; D in {32, 64, 96, 128}. block, tile, threads, swizzle, stages and
// smem restate the plan (flash_attention_bwd.sm90_bwd_plan(D, "dq")); a
// launch whose plan differs is refused.
int repro_flash_dq_sm90(const void* q, const void* k, const void* v, const void* dout,
                        const void* lse, const void* delta, void* dq, int B, int Tq, int Tk,
                        int H, int Hkv, int D, int causal, long long qb, long long qt,
                        long long qh, long long kb, long long kt, long long kh, long long vb,
                        long long vt, long long vh, long long ob, long long ot, long long oh,
                        int block, int tile, int threads, int swizzle, int stages, int smem,
                        void* stream) {
  const Call c{q, k, v, dout, lse, delta, dq, nullptr, B, Tq, Tk, H, Hkv, causal,
               {qb, qt, qh}, {kb, kt, kh}, {vb, vt, vh}, {ob, ot, oh},
               block, tile, threads, swizzle, stages, smem, static_cast<cudaStream_t>(stream)};
  return dispatch<true>(D, c);
}

// dk, dv from the same inputs: bf16 (B, Tk, Hkv, D) when H = Hkv, else fp32
// (B, Tk, H, D) partials, one per query head, for the caller to sum over
// each kv head's H / Hkv query heads. The plan is sm90_bwd_plan(D, "dkv").
int repro_flash_dkv_sm90(const void* q, const void* k, const void* v, const void* dout,
                         const void* lse, const void* delta, void* dk, void* dv, int B, int Tq,
                         int Tk, int H, int Hkv, int D, int causal, long long qb, long long qt,
                         long long qh, long long kb, long long kt, long long kh, long long vb,
                         long long vt, long long vh, long long ob, long long ot, long long oh,
                         int block, int tile, int threads, int swizzle, int stages, int smem,
                         void* stream) {
  const Call c{q, k, v, dout, lse, delta, dk, dv, B, Tq, Tk, H, Hkv, causal,
               {qb, qt, qh}, {kb, kt, kh}, {vb, vt, vh}, {ob, ot, oh},
               block, tile, threads, swizzle, stages, smem, static_cast<cudaStream_t>(stream)};
  return dispatch<false>(D, c);
}

}  // extern "C"
