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

#include <cuda.h>          // CUtensorMap and its enums; no driver library is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <stdio.h>

namespace {

constexpr int kBlockM = 128;     // query rows of a block, 64 per warpgroup
constexpr int kBlockN = 128;     // key rows of a tile
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 32;   // and one producer warp
constexpr int kMaxStages = 4;    // K/V ring depth, at most
constexpr int kBarBytes = 128;   // the mbarriers, after the tiles
constexpr int kSmemLimit = 232448;
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kErrEncode = 100000;    // + the CUresult of cuTensorMapEncodeTiled
constexpr int kErrNoEncoder = 200000;
constexpr int kErrPlan = 300000;

template <int D>
struct Plan {
  static constexpr int kSwizzle = D % 64 == 0 ? 128 : 64;   // bytes of a chunk row
  static constexpr int kCols = kSwizzle / 2;                 // bf16 columns of a chunk
  static constexpr int kChunks = D / kCols;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kTileBytes = kBlockN * D * 2;         // one K or V tile
  static constexpr uint64_t kLayout = kSwizzle == 128 ? 1 : 2;   // wgmma swizzle mode
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

// ------------------------------------------------------------- PTX helpers
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of parity `parity`. A
// wait that outlasts 2^22 polls (about 17 s on an H100; a real one takes
// microseconds) traps, so a protocol fault ends the launch with an error
// instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 22)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One TMA box of a 4-D map (Dh, heads, T, B) into shared memory at dst.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle mode.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accumulator reads or writes across a wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x = lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// d (64 x 128) = [d +] A B: A and B from shared memory, both K-major;
// acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

// d (64 x 32) += A B: A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 64) += A B: A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 96) += A B: A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[48], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 128) += A B: A from registers, B from shared memory, MN-major.
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The (rows x D) tile at (head, row0, b) as kChunks boxes of kCols columns,
// chunk c at dst + c * rows * kSwizzle.
template <int D>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int head, int row0, int b, int rows) {
  using P = Plan<D>;
#pragma unroll
  for (int c = 0; c < P::kChunks; ++c)
    tma_load(dst + c * rows * P::kSwizzle, map, bar, c * P::kCols, head, row0, b);
}

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
  constexpr uint32_t kSbo = 8 * P::kSwizzle;               // 8 rows of a chunk

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
      const uint64_t da = smem_desc(q_wg + chunk * kBlockM * P::kSwizzle + off, 16, kSbo,
                                    P::kLayout);
      const uint64_t db = smem_desc(sK + st * P::kTileBytes + chunk * kBlockN * P::kSwizzle + off,
                                    16, kSbo, P::kLayout);
      wgmma_ss_n128(sc, da, db, kk > 0);
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
                         kBlockN * P::kSwizzle, kSbo, P::kLayout));
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
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a bf16 (B, T, heads, D) tensor as the 4-D view (D, heads, T, B),
// strides in elements; boxes of (cols, 1, rows, 1).
int make_map(CUtensorMap* map, EncodeTiled enc, const void* ptr, int D, int heads, int T, int B,
             long long sh, long long st, long long sb, int cols, int rows, int swizzle) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)T, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)st * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {(cuuint32_t)cols, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                         strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                         swizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + (int)r;
}

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

const char* repro_cuda_error_string(int code) {
  static char buf[96];
  if (code >= kErrPlan) return "launch plan differs from the plan the kernel was built with";
  if (code >= kErrNoEncoder) return "cuTensorMapEncodeTiled not found in the CUDA driver";
  if (code >= kErrEncode) {
    snprintf(buf, sizeof buf, "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
             code - kErrEncode);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

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
