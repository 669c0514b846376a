// Hopper (sm_90a) flash attention forward for bf16 inputs, on the tensor
// cores: o = softmax(q k^T * scale) v, online over key tiles, and the
// log-sum-exp rows lse = m + log(l) when lse != NULL.
//
// It replaces, for bf16 inputs, the Pallas TPU kernels of
// repro/kernels/flash_attention.py:75 (flash_attention, _flash_kernel) and
// repro/kernels/flash_attention_bwd.py:153 (_fwd_with_stats, _fwd_kernel).
// fp32 inputs run flash_fwd_kernel<float, D> of flash.cu: wgmma has no fp32
// mode and TF32 keeps about three decimal digits, short of the fp32 bar.
// Each dtype has exactly one kernel; flash.cu refuses a bf16 forward.
//
// The function is ref.flash_fwd's: q (B, Tq, H, Dh) and k, v (B, Tk, Hkv, Dh)
// read in place through their batch, time and head strides; query head h
// reads kv head h / (H / Hkv); scale = 1/sqrt(Dh) rounded once from double
// multiplies the fp32 dot product; masked scores are -1e30; the row sum is
// clamped at 1e-30; o (B, Tq, H, Dh) bf16 contiguous, lse (B, H, Tq) fp32.
// Ragged Tq and Tk are masked; Tq != Tk works (causal rows align at the
// top left, as the reference's mask does).
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense): at
// gpt2-2.5b widths (B 8, T 1024, 20 heads of 96, causal) the forward moves
// 126 MB and does 32.2 GFLOP, so bytes bound it (0.0376 ms against 0.0326
// ms of operations); at qwen2-0.5b widths (14 query heads on 2 kv heads of
// 64) the kv tensors are small and operations bound it (0.0152 ms).
//
// Design. One block of two consumer warpgroups (256 threads) and one
// producer warp owns a 128-row query tile of one (batch, head); consumer
// warpgroup w owns rows 64w..64w+63. The grid puts the query tile on its
// slowest axis in reverse order, so the long causal rows start first. The
// producer brings Q once and K and V through a ring of 2-4 shared-memory
// stages (as many as fit) by TMA (cp.async.bulk.tensor over the strided 4-D
// view (Dh, heads, T, B), no transpose or copy), with one full mbarrier per
// K or V tile and an empty mbarrier per stage that the eight consumer warps
// release, so loads run ahead of the products. Rows past T arrive as zeros
// (TMA's out-of-bounds fill). The kernel needs 117-167 registers a thread
// (Dh 32-128) and spills none, so all 288 threads fit the register file
// without setmaxnreg. (Issuing the next tile's S before this tile's
// softmax, as FA3 does, needed more registers than a 288- or 384-thread
// block leaves, spilled, and ran slower: later work.)
//   S = Q K^T is wgmma m64n128k16 (bf16 in, fp32 out) with A = Q and B = K
//   from shared memory, both K-major. Products of bf16 values are exact in
//   fp32, so S is the reference's fp32 dot of the upcast tiles up to the
//   order of the sum.
//   The online softmax runs on the accumulator fragment: scale, then the
//   causal/ragged mask on diagonal and edge tiles only; each row lives in
//   the four threads of a quad (row max by two shuffles; the row sum is kept
//   per thread and summed once at the end). exp(x - m) is computed as
//   ex2.approx(x log2(e) - m log2(e)), one FMA and the SFU's exp2; the LSE
//   bar of 1e-5 relative holds (the card tests and chip_smoke.py hold it).
//   O += P V is wgmma m64nDhk16 with A = P from registers (the accumulator
//   fragment of S is the A fragment of P, converted to bf16 in place) and B
//   = V from shared memory, MN-major (the transpose bit). Rounding P to
//   bf16 is the one place where the kernel rounds differently from the
//   reference, which multiplies fp32 P: a relative error of at most 2^-9
//   per weight, far inside the 1e-2 bar on o.
// Shared-memory tiles are stored as column chunks of one swizzle span each
// (128 bytes, 64 columns, for Dh 64 and 128; 64 bytes, 32 columns, for Dh
// 32 and 96, whose 64- and 192-byte rows do not divide into 128-byte spans),
// one TMA box per chunk; the wgmma descriptors walk the chunks. The Python
// wrapper's flash_attention.sm90_plan states the same plan and passes it
// in; a launch whose plan differs from the compiled one is refused.
//
// The tensor maps are encoded per call on the host through
// cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint(ByVersion), so
// the library links no -lcuda. TMA needs a 16-byte-aligned base and strides in
// multiples of 16 bytes; the wrapper copies a tensor that breaks that.
//
// The C entry point launches on the stream it is given and returns 0 or an
// error code that repro_cuda_error_string explains.

#include "sm90_common.cuh"

namespace {

constexpr int kBlockM = 128;     // query rows of a block, 64 per warpgroup
constexpr int kBlockN = 128;     // key rows of a tile
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxStages = 4;    // K/V ring depth, at most
constexpr int kBarBytes = 128;   // the mbarriers, after the tiles

template <int D>
struct Plan : Chunking<D> {
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;         // one K or V tile
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's period
  static constexpr int smem(int stages) {
    return 1024 + kQBytes + 2 * stages * kTileBytes + kBarBytes;
  }
  // the deepest ring, up to kMaxStages, that fits the 227 KB of a block
  static constexpr int kStages = smem(kMaxStages) <= kSmemLimit   ? kMaxStages
                                 : smem(kMaxStages - 1) <= kSmemLimit ? kMaxStages - 1
                                                                      : 2;
  static constexpr int kSmem = smem(kStages);
  static_assert(kSmem <= kSmemLimit, "over the 227 KB a block may use");
  static_assert(8 * (1 + 3 * kStages) <= kBarBytes, "room for the mbarriers");
};

struct Shape {
  int B, Tq, Tk, H, rep, causal;
  float scale;
};

// ------------------------------------------------------------------ kernel
template <int D, bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap map_q,
                      const __grid_constant__ CUtensorMap map_k,
                      const __grid_constant__ CUtensorMap map_v,
                      __nv_bfloat16* __restrict__ o, float* __restrict__ lse, Shape s) {
  using P = Plan<D>;
  constexpr int kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t sK = sQ + P::kQBytes;                   // stage st at + st * kTileBytes
  const uint32_t sV = sK + kStages * P::kTileBytes;
  const uint32_t qbar = sV + kStages * P::kTileBytes;    // then kfull, vfull, empty
  const uint32_t kfull = qbar + 8, vfull = kfull + 8 * kStages, empty = vfull + 8 * kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBlockM;   // heaviest causal tiles first
  const int hk = h / s.rep;
  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int quad = lane / 4, tq = lane % 4;

  const int all_tiles = (s.Tk + kBlockN - 1) / kBlockN;
  const int nk = s.causal ? min(all_tiles, (min(q0 + kBlockM, s.Tq) - 1) / kBlockN + 1)
                          : all_tiles;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(kfull + 8 * st, 1);
      mbar_init(vfull + 8 * st, 1);
      mbar_init(empty + 8 * st, kConsumers / 32);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // The producer warp (one thread): Q, then key tile t into stage
    // t % kStages once the consumer warps have released the tile that
    // stage held (t - kStages).
    if (tid == kConsumers) {
      mbar_expect_tx(qbar, P::kQBytes);
      load_tile<D>(sQ, &map_q, qbar, h, q0, b, kBlockM);
      for (int t = 0; t < nk; ++t) {
        const int st = t % kStages;
        if (t >= kStages) mbar_wait(empty + 8 * st, ((t / kStages) - 1) & 1);
        mbar_expect_tx(kfull + 8 * st, P::kTileBytes);
        load_tile<D>(sK + st * P::kTileBytes, &map_k, kfull + 8 * st, hk, t * kBlockN, b,
                     kBlockN);
        mbar_expect_tx(vfull + 8 * st, P::kTileBytes);
        load_tile<D>(sV + st * P::kTileBytes, &map_v, vfull + 8 * st, hk, t * kBlockN, b,
                     kBlockN);
      }
    }
    return;
  }

  // Accumulator fragments (wgmma m64nN f32): element 4j + e of a thread is
  // row 16 warp + quad + 8 (e >> 1) of the warpgroup's 64, column
  // 8j + 2 tq + (e & 1).
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {kNegInf, kNegInf}, l_run[2] = {0.f, 0.f};
  const int wg_row0 = q0 + wg * 64;
  const int row0 = wg_row0 + warp * 16 + quad;             // this thread's rows: row0, row0 + 8
  const uint32_t q_wg = sQ + wg * 64 * P::kSwizzle;         // the warpgroup's 64 rows

  mbar_wait(qbar, 0);
  float sc[kBlockN / 2];
  for (int j = 0; j < nk; ++j) {
    const int st = j % kStages;
    const uint32_t parity = (j / kStages) & 1;

    // S = Q K^T over Dh in k16 steps; each step sits inside one chunk
    mbar_wait(kfull + 8 * st, parity);
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t chunk = kk * 16 / P::kCols, off = (kk * 16 % P::kCols) * 2;
      const uint64_t da = smem_desc(q_wg + chunk * kBlockM * P::kSwizzle + off, 16, P::kSbo,
                                    P::kLayout);
      const uint64_t db = smem_desc(sK + st * P::kTileBytes + chunk * kBlockN * P::kSwizzle + off,
                                    16, P::kSbo, P::kLayout);
      wgmma_ss(sc, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // scale, mask (diagonal and edge tiles only), online softmax
    const int k0 = j * kBlockN;
    const bool masked = k0 + kBlockN > s.Tk || (s.causal && k0 + kBlockN - 1 > wg_row0);
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      float x = sc[i] * s.scale;
      if (masked) {
        const int col = k0 + (i >> 2) * 8 + 2 * tq + (i & 1);
        const int row = row0 + 8 * ((i >> 1) & 1);
        if (col >= s.Tk || (s.causal && col > row)) x = kNegInf;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float alpha[2], m_log2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = ex2((m_run[r] - mx[r]) * kLog2e);
      m_run[r] = mx[r];
      m_log2[r] = mx[r] * kLog2e;
      l_run[r] *= alpha[r];
    }
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) {
      const int r = (i >> 1) & 1;
      const float p = ex2(fmaf(sc[i], kLog2e, -m_log2[r]));
      sc[i] = p;
      l_run[r] += p;
    }
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];

    // P in bf16, in registers: the S fragment of columns 16kk..16kk+15 is
    // the A fragment of k-step kk
    uint32_t pa[kBlockN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

    // O += P V over the tile's keys in k16 steps: V is MN-major, its chunks
    // kBlockN * kSwizzle bytes apart (LBO), 8 key rows kSbo apart (SBO)
    mbar_wait(vfull + 8 * st, parity);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk)
      wgmma_rs(acc, pa[kk],
               smem_desc(sV + st * P::kTileBytes + kk * 16 * P::kSwizzle,
                         kBlockN * P::kSwizzle, P::kSbo, P::kLayout));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + 8 * st);
  }

  // epilogue: o = acc / max(l, 1e-30) in bf16, rows >= Tq masked; lse rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_run[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float lc = fmaxf(l, 1e-30f);
    const int row = row0 + 8 * r;
    if (row >= s.Tq) continue;
    __nv_bfloat16* out = o + (((long long)b * s.Tq + row) * s.H + h) * D + 2 * tq;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * jj) =
          __floats2bfloat162_rn(acc[4 * jj + 2 * r] / lc, acc[4 * jj + 2 * r + 1] / lc);
    if (kLse && tq == 0) lse[((long long)b * s.H + h) * s.Tq + row] = m_run[r] + logf(lc);
  }
}

// -------------------------------------------------------------------- host
struct Call {
  const void *q, *k, *v;
  void *o, *lse;
  int B, Tq, Tk, H, Hkv, causal;
  long long sq[3], sk[3], sv[3];   // (b, t, h) strides of q, k, v, in elements
  int block_m, block_n, threads, swizzle, stages, smem;
  cudaStream_t stream;
};

template <int D, bool kLse>
int launch_d(const Call& c, const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
             const Shape& s) {
  auto kern = flash_fwd_sm90_kernel<D, kLse>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Plan<D>::kSmem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(c.H, c.B, (c.Tq + kBlockM - 1) / kBlockM);
  kern<<<grid, kThreads, Plan<D>::kSmem, c.stream>>>(mq, mk, mv,
                                                     static_cast<__nv_bfloat16*>(c.o),
                                                     static_cast<float*>(c.lse), s);
  return (int)cudaGetLastError();
}

template <int D>
int run(const Call& c) {
  using P = Plan<D>;
  if (c.block_m != kBlockM || c.block_n != kBlockN || c.threads != kThreads ||
      c.swizzle != P::kSwizzle || c.stages != P::kStages || c.smem != P::kSmem)
    return kErrPlan;
  EncodeTiled enc = encoder();
  if (enc == nullptr) return kErrNoEncoder;
  CUtensorMap mq, mk, mv;
  int rc = make_map(&mq, enc, c.q, D, c.H, c.Tq, c.B, c.sq[2], c.sq[1], c.sq[0], P::kCols,
                    kBlockM, P::kSwizzle);
  if (rc == 0)
    rc = make_map(&mk, enc, c.k, D, c.Hkv, c.Tk, c.B, c.sk[2], c.sk[1], c.sk[0], P::kCols,
                  kBlockN, P::kSwizzle);
  if (rc == 0)
    rc = make_map(&mv, enc, c.v, D, c.Hkv, c.Tk, c.B, c.sv[2], c.sv[1], c.sv[0], P::kCols,
                  kBlockN, P::kSwizzle);
  if (rc != 0) return rc;
  // scale rounded once from double, as 1.0 / math.sqrt(Dh) is in Python
  const Shape s{c.B, c.Tq, c.Tk, c.H, c.H / c.Hkv, c.causal ? 1 : 0,
                (float)(1.0 / sqrt((double)D))};
  return c.lse != nullptr ? launch_d<D, true>(c, mq, mk, mv, s)
                          : launch_d<D, false>(c, mq, mk, mv, s);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) { return error_string(code); }

// o (B, Tq, H, D) bf16 and, when lse != NULL, lse (B, H, Tq) fp32 <- bf16
// q, k, v with the given (b, t, h) element strides; D in {32, 64, 96, 128}.
// block_m, block_n, threads, swizzle, stages and smem restate the plan
// (flash_attention.sm90_plan); a launch whose plan differs is refused.
int repro_flash_fwd_sm90(const void* q, const void* k, const void* v, void* o, void* lse, int B,
                         int Tq, int Tk, int H, int Hkv, int D, int causal, long long qb,
                         long long qt, long long qh, long long kb, long long kt, long long kh,
                         long long vb, long long vt, long long vh, int block_m, int block_n,
                         int threads, int swizzle, int stages, int smem, void* stream) {
  if (B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || B > 65535 ||
      (Tq + kBlockM - 1) / kBlockM > 65535)
    return (int)cudaErrorInvalidValue;
  const Call c{q, k, v, o, lse, B, Tq, Tk, H, Hkv, causal,
               {qb, qt, qh}, {kb, kt, kh}, {vb, vt, vh},
               block_m, block_n, threads, swizzle, stages, smem,
               static_cast<cudaStream_t>(stream)};
  switch (D) {
    case 32: return run<32>(c);
    case 64: return run<64>(c);
    case 96: return run<96>(c);
    case 128: return run<128>(c);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
