// Shared building blocks of the hand-written Hopper kernels (sm_90a).
//
// Every kernel runs 256 threads (8 warps) per block and works on a block of
// whole token rows: a row of C channels never splits across blocks, so the
// LayerNorms that close each stage see a full row in shared memory.
//
// Matrix products: bf16 operands go through the tensor cores with
// nvcuda::wmma 16x16x16 fragments and fp32 accumulation; fp32 operands use
// plain FMAs (the fp32 path exists for parity checks, not for speed).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace d3dp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;  // output columns per block-GEMM step
constexpr int kBK = 64;  // rows of B staged in shared memory per step

using bf16 = __nv_bfloat16;

template <typename T> struct Cfg;
// bf16: 32 token rows per block; rows padded by 8 elements (16 bytes) so
// wmma fragment loads from consecutive rows fall on different banks.
template <> struct Cfg<bf16> {
  static constexpr int BM = 32;
  static constexpr int PAD = 8;
};
// fp32: 16 token rows per block (the fp32 rows take twice the bytes).
template <> struct Cfg<float> {
  static constexpr int BM = 16;
  static constexpr int PAD = 4;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch and JAX do
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr size_t align128(size_t n) { return (n + 127) & ~size_t(127); }

// LayerNorm of one C-wide row held by one warp: lane l owns channels
// l, l+32, ... (C <= 1024, C % 32 == 0). Two-pass statistics in fp32:
// mean, then the mean of squared deviations, as the reference computes them.
// On return v[k] holds the normalised, scaled and shifted channel 32k+lane.
__device__ __forceinline__ void warp_layernorm(float (&v)[32], int C, const float* s,
                                               const float* b, float eps, int lane) {
  const int n = C / 32;
  float acc = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < n) acc += v[k];
  const float mu = warp_sum(acc) / C;
  acc = 0.f;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < n) {
      const float d = v[k] - mu;
      acc += d * d;
    }
  const float var = warp_sum(acc) / C;
  const float rs = rsqrtf(var + eps);
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < n) {
      const int c = 32 * k + lane;
      v[k] = (v[k] - mu) * rs * s[c] + b[c];
    }
}

// Copy `rows` rows of `cols` elements (global, row stride ldg) into shared
// memory (row stride lds); rows at or past `valid` are zero-filled. Moves
// 16-byte vectors where every row start is 16-byte aligned (base pointers
// are: the callers pass 16-byte-aligned buffers and offsets).
template <typename T>
__device__ __forceinline__ void load_rows(T* dst, int lds, const T* src, int ldg, int rows,
                                          int valid, int cols) {
  constexpr int vec = 16 / sizeof(T);
  if (cols % vec == 0 && lds % vec == 0 && ldg % vec == 0) {
    const int vc = cols / vec;
    for (int i = threadIdx.x; i < rows * vc; i += kThreads) {
      const int r = i / vc, c = (i % vc) * vec;
      *reinterpret_cast<uint4*>(dst + r * lds + c) =
          r < valid ? *reinterpret_cast<const uint4*>(src + (size_t)r * ldg + c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    dst[r * lds + c] = r < valid ? src[(size_t)r * ldg + c] : from_f<T>(0.f);
  }
}

// B slabs stream through shared memory with cp.async, kStages deep: the
// copy of slab k+kStages-1 is in flight while slab k is multiplied.
constexpr int kStages = 3;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Start copying a kBK x kBN slab of row-major B (global, row stride ldb)
// into one stage of Bs (row stride kBN + PAD).
template <typename T>
__device__ __forceinline__ void stage_b_async(T* Bs, const T* B, int ldb) {
  constexpr int ldbs = kBN + Cfg<T>::PAD;
  constexpr int vec = 16 / sizeof(T);
#pragma unroll
  for (int i = 0; i < (kBK * kBN / vec) / kThreads; ++i) {
    const int v = threadIdx.x + i * kThreads;
    const int r = v / (kBN / vec), c = (v % (kBN / vec)) * vec;
    cp_async16(Bs + r * ldbs + c, B + (size_t)r * ldb + c);
  }
}

template <typename T>
__host__ __device__ constexpr int slab_elems() {
  return kBK * (kBN + Cfg<T>::PAD);
}

// The slab pipeline shared by both GEMM flavours: calls mma(slab, k0) for
// every kBK-deep slab of B in order, with the next slabs' copies in flight.
template <typename T, typename Mma>
__device__ __forceinline__ void pipeline_b(const T* B, int ldb, int K, T* Bs, Mma mma) {
  const int nk = K / kBK;
  __syncthreads();  // every stage of Bs is free (earlier users are done)
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) stage_b_async(Bs + s * slab_elems<T>(), B + (size_t)s * kBK * ldb, ldb);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's copies of slab kt landed
    __syncthreads();               // everyone's did; slab kt-1 is consumed
    const int nxt = kt + kStages - 1;
    if (nxt < nk)
      stage_b_async(Bs + (nxt % kStages) * slab_elems<T>(), B + (size_t)nxt * kBK * ldb, ldb);
    cp_async_commit();  // possibly empty: keeps the group count uniform
    mma(Bs + (kt % kStages) * slab_elems<T>(), kt * kBK);
  }
  cp_async_wait<0>();
}

// Block GEMM: Out[BM x kBN] (fp32, shared, row stride ldo) =
//   As[BM x K] (shared, row stride lda) @ B[K x kBN] (global, row stride ldb).
// K % kBK == 0; B streams through the kStages slabs of Bs.
// bf16: each of the 8 warps owns one 16x16 accumulator fragment of the
// 32x64 output.
__device__ __forceinline__ void gemm_rowblock(const bf16* As, int lda, const bf16* B, int ldb,
                                              int K, bf16* Bs, float* Out, int ldo) {
  using namespace nvcuda;
  constexpr int ldbs = kBN + Cfg<bf16>::PAD;
  const int warp = threadIdx.x / 32;
  const int wr = warp / 4, wc = warp % 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
  wmma::fill_fragment(acc, 0.f);
  pipeline_b(B, ldb, K, Bs, [&](const bf16* slab, int k0) {
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, As + wr * 16 * lda + k0 + kk, lda);
      wmma::load_matrix_sync(b, slab + kk * ldbs + wc * 16, ldbs);
      wmma::mma_sync(acc, a, b, acc);
    }
  });
  wmma::store_matrix_sync(Out + wr * 16 * ldo + wc * 16, acc, ldo, wmma::mem_row_major);
}
// fp32: thread t owns row t/16 and the four columns 4*(t%16)..+3.
__device__ __forceinline__ void gemm_rowblock(const float* As, int lda, const float* B, int ldb,
                                              int K, float* Bs, float* Out, int ldo) {
  constexpr int ldbs = kBN + Cfg<float>::PAD;
  const int r = threadIdx.x / 16, c = (threadIdx.x % 16) * 4;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  pipeline_b(B, ldb, K, Bs, [&](const float* slab, int k0) {
    const float* a = As + r * lda + k0;
#pragma unroll 8
    for (int k = 0; k < kBK; ++k) {
      const float av = a[k];
      const float4 bv = *reinterpret_cast<const float4*>(slab + k * ldbs + c);
      acc[0] = fmaf(av, bv.x, acc[0]);
      acc[1] = fmaf(av, bv.y, acc[1]);
      acc[2] = fmaf(av, bv.z, acc[2]);
      acc[3] = fmaf(av, bv.w, acc[3]);
    }
  });
#pragma unroll
  for (int j = 0; j < 4; ++j) Out[r * ldo + c + j] = acc[j];
}

// bytes of the kStages B slabs
template <typename T>
__host__ __device__ constexpr size_t bs_bytes() {
  return align128(sizeof(T) * kStages * slab_elems<T>());
}

}  // namespace d3dp
