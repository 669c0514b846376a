// Hopper (sm_90a) kernels for the bit packing of the coded wire format.
//
// They replace the Pallas TPU kernels of repro/kernels/pack.py
// (pack_words, unpack_words). Both compute the function of
// repro/kernels/ops.py pack_bits / unpack_bits: word w holds codes
// [w*epw, (w+1)*epw) in its bit fields, low bits first, epw = 32 / bits,
// and a partial tail word is zero-padded. The TPU wrapper laid the codes
// out slot-major, (epw, nwords), only so that its kernel could slice rows;
// these kernels read and write the flat layout directly.
//
//   pack_kernel<BITS>    int32 codes (n,) -> uint32 words (ceil(n/epw),)
//   unpack_kernel<BITS>  uint32 words -> the first n int32 codes
//
// One thread per word. Both move 4 bytes per code and 4 per word once and
// do a few integer operations per byte, so they are bound by memory
// bandwidth: each thread moves its epw codes as 16-byte vectors (one at 8
// bits, two at 4 bits) when the code array is 16-byte aligned, and the
// last, partial word is masked. Codes are not masked on pack, as the TPU
// kernel does not mask them: the wire codec makes them in range.
//
// Each C entry point launches on the stream it is given and returns
// cudaGetLastError(); the Python wrappers raise on a non-zero code.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int BITS>
__global__ void __launch_bounds__(kThreads)
pack_kernel(const int32_t* __restrict__ codes, uint32_t* __restrict__ words,
            long long n, long long nwords, bool vec) {
  constexpr int EPW = 32 / BITS;
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= nwords) return;
  const long long base = w * EPW;
  uint32_t word = 0;
  if (vec && base + EPW <= n) {
    const int4* src = reinterpret_cast<const int4*>(codes + base);
#pragma unroll
    for (int v = 0; v < EPW / 4; ++v) {
      const int4 c = src[v];
      word |= (uint32_t)c.x << ((4 * v + 0) * BITS);
      word |= (uint32_t)c.y << ((4 * v + 1) * BITS);
      word |= (uint32_t)c.z << ((4 * v + 2) * BITS);
      word |= (uint32_t)c.w << ((4 * v + 3) * BITS);
    }
  } else {
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      if (base + j < n) word |= (uint32_t)codes[base + j] << (j * BITS);
    }
  }
  words[w] = word;
}

template <int BITS>
__global__ void __launch_bounds__(kThreads)
unpack_kernel(const uint32_t* __restrict__ words, int32_t* __restrict__ codes,
              long long n, long long nwords, bool vec) {
  constexpr int EPW = 32 / BITS;
  constexpr uint32_t kMask = (1u << BITS) - 1u;
  const long long w = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (w >= nwords) return;
  const long long base = w * EPW;
  const uint32_t word = words[w];
  if (vec && base + EPW <= n) {
    int4* dst = reinterpret_cast<int4*>(codes + base);
#pragma unroll
    for (int v = 0; v < EPW / 4; ++v) {
      dst[v] = make_int4((int)((word >> ((4 * v + 0) * BITS)) & kMask),
                         (int)((word >> ((4 * v + 1) * BITS)) & kMask),
                         (int)((word >> ((4 * v + 2) * BITS)) & kMask),
                         (int)((word >> ((4 * v + 3) * BITS)) & kMask));
    }
  } else {
#pragma unroll
    for (int j = 0; j < EPW; ++j) {
      if (base + j < n) codes[base + j] = (int)((word >> (j * BITS)) & kMask);
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

unsigned grid_for(long long nwords) {
  return (unsigned)((nwords + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// words (ceil(n / (32 / bits)),) uint32 <- codes (n,) int32; bits 4 or 8.
int repro_pack_words(const void* codes, void* words, long long n, int bits,
                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int epw = bits > 0 ? 32 / bits : 0;
  if ((bits != 4 && bits != 8) || n <= 0) return (int)cudaErrorInvalidValue;
  const long long nwords = (n + epw - 1) / epw;
  const int32_t* c = static_cast<const int32_t*>(codes);
  uint32_t* w = static_cast<uint32_t*>(words);
  const bool vec = aligned16(codes);
  if (bits == 8) {
    pack_kernel<8><<<grid_for(nwords), kThreads, 0, s>>>(c, w, n, nwords, vec);
  } else {
    pack_kernel<4><<<grid_for(nwords), kThreads, 0, s>>>(c, w, n, nwords, vec);
  }
  return (int)cudaGetLastError();
}

// codes (n,) int32 <- the first n codes of words (ceil(n / (32 / bits)),).
int repro_unpack_words(const void* words, void* codes, long long n, int bits,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int epw = bits > 0 ? 32 / bits : 0;
  if ((bits != 4 && bits != 8) || n <= 0) return (int)cudaErrorInvalidValue;
  const long long nwords = (n + epw - 1) / epw;
  const uint32_t* w = static_cast<const uint32_t*>(words);
  int32_t* c = static_cast<int32_t*>(codes);
  const bool vec = aligned16(codes);
  if (bits == 8) {
    unpack_kernel<8><<<grid_for(nwords), kThreads, 0, s>>>(w, c, n, nwords, vec);
  } else {
    unpack_kernel<4><<<grid_for(nwords), kThreads, 0, s>>>(w, c, n, nwords, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
