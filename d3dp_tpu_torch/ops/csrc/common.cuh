// Shared building blocks of the hand-written Hopper kernels (sm_90a).
//
// Every kernel runs 256 threads (8 warps) per block and works on a block of
// whole token rows: a row of C channels never splits across blocks, so the
// LayerNorms that close each stage see a full row in shared memory.
//
// Matrix products: bf16 operands go through the tensor cores with
// nvcuda::wmma 16x16x16 fragments and fp32 accumulation; fp32 operands use
// plain FMAs (the fp32 path exists for parity checks, not for speed).
// The per-head attention kernel at the end (`attend_kernel`) works on one
// (sequence, head, query block) instead of token rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <algorithm>
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

// ------------------------------------------------------- per-head attention
// Shared by the attention stage (attention_stage.cu), the attention block
// (attention_block.cu) and the attention cores (attention_qkv.cu): softmax
// attention of one head, read from q, k and v rows of `ld` elements (the
// packed (R, N, 3C) qkv layout, q | k | v with heads of 64 packed along each
// third, has ld = 3C and k, v at +C, +2C; separate (R, N, C) tensors have
// ld = C), written to (R, N, C).
constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 256;
// grouped attention (mask_block > 0) folds sequences of at most this many
// tokens (JAX `_attention_stage_fwd` groups only stages of N <= 32)
constexpr int kMaxMaskBlock = 32;

// The lab switches of the TPU stage kernels that change the attention math,
// as the C entry points take them: one int of flags and the mask block.
//   kOptNormFirst  (D3DP_SOFTMAX_FOLD != 1, bf16): p / l rounded to bf16
//                  before P.V, where production folds 1/l into the output;
//   kOptBf16Exp    (D3DP_ATTN_VARIANT=bf16exp, bf16): p = bf16(exp(bf16(s - m))),
//                  l summed in fp32 from that p;
//   kOptNoY2       (D3DP_ATTN_VARIANT=noy2): LN2 and the y2 write skipped;
//   mask_block > 0 (D3DP_SPATIAL_GROUP): query i sees key j only where
//                  i / mask_block == j / mask_block, JAX's additive -1e30
//                  block-diagonal mask (p of every other key is 0 exactly).
// All off (0, 0) is the production math.
constexpr int kOptNormFirst = 1;
constexpr int kOptBf16Exp = 2;
constexpr int kOptNoY2 = 4;

struct AttnOpts {
  bool norm_first = false;
  bool bf16_exp = false;
  int mask_block = 0;
};

inline AttnOpts attn_opts(int opts, int mask_block) {
  AttnOpts o;
  o.norm_first = opts & kOptNormFirst;
  o.bf16_exp = opts & kOptBf16Exp;
  o.mask_block = mask_block;
  return o;
}

// The attention cores' order (K3, K6, K7): p / l before P.V.
inline AttnOpts norm_first_opts() { return attn_opts(kOptNormFirst, 0); }

// Whether an attention of N tokens (under mask_block) fits the tile: all
// N <= kMaxKeys keys, or N whole blocks of at most kMaxMaskBlock tokens.
inline bool attn_keys_ok(int N, int mask_block) {
  return mask_block > 0
             ? mask_block <= kMaxMaskBlock && N % mask_block == 0 && cdiv(N, 64) <= 65535
             : N <= kMaxKeys;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

struct AttnLayout {
  int QB, NK, ldq, ldk, ldv, lds, ldp;
  size_t q, k, v, s, p, linv, total;
};

// NK: the keys a tile holds, rounded up to 16. Unmasked, all N. Under a mask
// of block mb, only the blocks its QB queries span: at most (QB - 1) / mb + 2
// of them (a query block starts anywhere in a block).
template <typename T>
AttnLayout attn_layout(int N, int mask_block = 0) {
  constexpr bool f32 = std::is_same<T, float>::value;
  AttnLayout L;
  const int NQ = cdiv(N, 16) * 16;
  L.QB = NQ < 64 ? NQ : 64;
  int keys = N;
  if (mask_block > 0) keys = std::min(N, ((L.QB - 1) / mask_block + 2) * mask_block);
  L.NK = cdiv(keys, 16) * 16;
  // fp32 reads K transposed (thread j walks row j): an odd row stride keeps
  // those reads on distinct banks. bf16 rows keep wmma's 16-byte multiple.
  L.ldq = f32 ? kHeadDim + 1 : kHeadDim + 8;
  L.ldk = f32 ? kHeadDim + 1 : kHeadDim + 8;
  L.ldv = f32 ? kHeadDim : kHeadDim + 8;
  L.lds = L.NK + 4;
  L.ldp = L.NK + 8;
  size_t off = 0;
  L.q = off; off += align128(sizeof(T) * L.QB * L.ldq);
  L.k = off; off += align128(sizeof(T) * L.NK * L.ldk);
  L.v = off; off += align128(sizeof(T) * L.NK * L.ldv);
  // the logits buffer doubles as the bf16 path's fp32 P.V output
  L.s = off; off += align128(sizeof(float) * L.QB * (L.lds > kHeadDim + 4 ? L.lds : kHeadDim + 4));
  L.p = off; off += f32 ? 0 : align128(sizeof(bf16) * L.QB * L.ldp);
  L.linv = off; off += align128(sizeof(float) * L.QB);
  L.total = off;
  return L;
}

// One tile: (sequence `seq`, head `h`, query block `qb`). q, k, v: rows of ld
// elements, N rows per sequence; out: (R, N, C).
// One block holds <=64 queries and all their keys (tail zero-filled) with
// the fp32 logits, so the softmax is exact over the whole row: all <=256
// keys of the sequence, or under a mask only the window of whole blocks the
// queries span (attn_layout), every key outside it having p = 0 exactly.
// fp32 always divides p by l before P.V. For bf16, opts.norm_first picks
// the order: true rounds p / l to bf16 before P.V (the TPU attention core's
// `_attn_head`, and the stage under D3DP_SOFTMAX_FOLD=0); false runs P.V on
// the unnormalised bf16 p and folds 1/l into the output (the TPU attention
// stage's order). opts.bf16_exp (bf16 only) and opts.mask_block: AttnOpts.
// The tile functions here take their tile coordinates as arguments and the
// block's dynamic shared memory as `smem`, so a kernel may run one tile
// (the `__global__` wrappers) or walk many (the depth-resident kernel,
// resident.cu). Their pointers carry no __restrict__: in resident.cu a
// buffer one tile reads was written by other blocks earlier in the same
// launch, which rules out the read-only data path.
template <typename T>
__device__ __forceinline__ void attend_tile(const T* q, const T* k, const T* v, int ld, T* out,
                                            int N, int C, float scale, const AttnLayout& L,
                                            const AttnOpts& opts, unsigned char* smem, int seq,
                                            int h, int qb) {
  constexpr bool f32 = std::is_same<T, float>::value;
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* linv = reinterpret_cast<float*>(smem + L.linv);

  const int q0 = qb * L.QB;
  const int QB = L.QB, NK = L.NK;
  const int nq = min(QB, N - q0);
  // the keys [k0, k0 + nk) of the sequence this tile reads
  const int mb = opts.mask_block;
  int k0 = 0, nk = N;
  if (mb > 0) {
    k0 = q0 / mb * mb;
    nk = min(N, (q0 + nq - 1) / mb * mb + mb) - k0;
  }
  const size_t off = (size_t)seq * N * ld + h * kHeadDim;
  load_rows(Qs, L.ldq, q + off + (size_t)q0 * ld, ld, QB, N - q0, kHeadDim);
  load_rows(Ks, L.ldk, k + off + (size_t)k0 * ld, ld, NK, nk, kHeadDim);
  load_rows(Vs, L.ldv, v + off + (size_t)k0 * ld, ld, NK, nk, kHeadDim);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // S = Q K^T (unscaled), fp32
  if constexpr (f32) {
    for (int i = threadIdx.x; i < QB * NK; i += kThreads) {
      const int qi = i / NK, kj = i % NK;
      const float* a = Qs + qi * L.ldq;
      const float* b = Ks + kj * L.ldk;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHeadDim; ++d) acc = fmaf(a[d], b[d], acc);
      Ss[qi * L.lds + kj] = acc;
    }
  } else {
    using namespace nvcuda;
    const int nfj = NK / 16;
    for (int f = warp; f < (QB / 16) * nfj; f += kWarps) {
      const int fi = f / nfj, fj = f % nfj;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHeadDim; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + fi * 16 * L.ldq + kk, L.ldq);
        wmma::load_matrix_sync(b, Ks + fj * 16 * L.ldk + kk, L.ldk);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + fi * 16 * L.lds + fj * 16, acc, L.lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // exact softmax over the keys [j0, j1) of each row, its own block under a
  // mask: s = dot * scale, m = max(s), p = exp(s - m) (p = 0 elsewhere),
  // l = sum(p)
  const bool bf16_exp = !f32 && opts.bf16_exp;
  for (int r = warp; r < QB; r += kWarps) {
    float* srow = Ss + r * L.lds;
    int j0 = 0, j1 = nk;
    if (mb > 0 && r < nq) {
      j0 = (q0 + r) / mb * mb - k0;
      j1 = min(j0 + mb, nk);
    }
    float m = -INFINITY;
    for (int j = j0 + lane; j < j1; j += 32) {
      const float s = srow[j] * scale;
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < NK; j += 32) {
      float p = 0.f;
      if (j >= j0 && j < j1) {
        const float z = srow[j] - m;
        p = bf16_exp ? bf16_round(expf(bf16_round(z))) : expf(z);
      }
      srow[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if constexpr (f32) {
      for (int j = lane; j < nk; j += 32) srow[j] = srow[j] / l;
    } else {
      bf16* prow = reinterpret_cast<bf16*>(smem + L.p) + r * L.ldp;
      for (int j = lane; j < NK; j += 32)
        prow[j] = __float2bfloat16(opts.norm_first ? srow[j] / l : srow[j]);
      if (lane == 0) linv[r] = opts.norm_first ? 1.0f : 1.0f / l;
    }
  }
  __syncthreads();

  T* orow0 = out + ((size_t)seq * N + q0) * C + h * kHeadDim;
  if constexpr (f32) {
    // O = (P / l) V, written straight out
    for (int i = threadIdx.x; i < nq * kHeadDim; i += kThreads) {
      const int qi = i / kHeadDim, d = i % kHeadDim;
      const float* p = Ss + qi * L.lds;
      float acc = 0.f;
      for (int j = 0; j < nk; ++j) acc = fmaf(p[j], Vs[j * L.ldv + d], acc);
      orow0[(size_t)qi * C + d] = acc;
    }
  } else {
    // O = P V on the tensor cores into the (now free) logits buffer, then
    // scaled by 1/l (or by 1 where p was normalised first) and rounded to
    // bf16 on the way out
    using namespace nvcuda;
    const bf16* Ps = reinterpret_cast<const bf16*>(smem + L.p);
    float* Os = Ss;
    constexpr int ldo = kHeadDim + 4;
    for (int f = warp; f < (QB / 16) * (kHeadDim / 16); f += kWarps) {
      const int fi = f / (kHeadDim / 16), fj = f % (kHeadDim / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < NK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + fi * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(b, Vs + kk * L.ldv + fj * 16, L.ldv);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + fi * 16 * ldo + fj * 16, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nq * kHeadDim; i += kThreads) {
      const int qi = i / kHeadDim, d = i % kHeadDim;
      orow0[(size_t)qi * C + d] = __float2bfloat16(Os[qi * ldo + d] * linv[qi]);
    }
  }
}

// grid (sequence, head, query block): one tile per block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              int ld, T* __restrict__ out, int N, int C, float scale, AttnLayout L,
              AttnOpts opts) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend_tile<T>(q, k, v, ld, out, N, C, scale, L, opts, smem, blockIdx.x, blockIdx.y,
                 blockIdx.z);
}

// Launch attend_kernel<T> over R sequences of N tokens.
template <typename T>
cudaError_t launch_attend(const T* q, const T* k, const T* v, int ld, T* out, int R, int N,
                          int C, int heads, float scale, const AttnOpts& opts,
                          cudaStream_t stream) {
  const AttnLayout L = attn_layout<T>(N, opts.mask_block);
  cudaError_t e = cudaFuncSetAttribute(attend_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  dim3 grid(R, heads, cdiv(N, L.QB));
  attend_kernel<T><<<grid, kThreads, L.total, stream>>>(q, k, v, ld, out, N, C, scale, L, opts);
  return cudaGetLastError();
}

// The packed (R, N, 3C) qkv layout: q | k | v thirds of each token row.
template <typename T>
cudaError_t launch_attend_packed(const T* qkv, T* out, int R, int N, int C, int heads,
                                 float scale, const AttnOpts& opts, cudaStream_t stream) {
  return launch_attend<T>(qkv, qkv + C, qkv + 2 * C, 3 * C, out, R, N, C, heads, scale, opts,
                          stream);
}

// ------------------------------------------------ out-projection + residual + LN
// Shared by the attention stage (attention_stage.cu) and the attention block
// (attention_block.cu): x2 = x + (o @ Wp + bp), y2 = LN2(x2), over token
// rows; 32-token row blocks (16 in fp32): o @ Wp into an fp32 row buffer,
// then the residual add and LN2 per row.
// One tile: the row block `tile` (BM token rows from BM * tile).
// DropPath: with dp, the branch (projection and its bias) of token row r is
// scaled by dp[r / dp_div] in fp32 before the residual add (dp_div = N: one
// scale per sequence); dp == nullptr leaves the arithmetic as it is without.
// with_y2 = false (kOptNoY2) writes x2 only: no LN2, y2 left as it was.
template <typename T>
__device__ __forceinline__ void proj_ln2_tile(const T* o, const T* x, const T* wp,
                                              const float* bp, const float* ln2s,
                                              const float* ln2b, T* x2, T* y2, int M, int C,
                                              float eps, unsigned char* smem, int tile,
                                              const float* dp = nullptr, int dp_div = 1,
                                              bool with_y2 = true) {
  constexpr int BM = Cfg<T>::BM;
  const int lda = C + Cfg<T>::PAD;
  const int ldx = C + 4;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + align128(sizeof(T) * BM * lda));
  float* Xs = reinterpret_cast<float*>(smem + align128(sizeof(T) * BM * lda) + bs_bytes<T>());

  const int row0 = tile * BM;
  load_rows(As, lda, o + (size_t)row0 * C, C, BM, M - row0, C);
  __syncthreads();
  for (int n0 = 0; n0 < C; n0 += kBN) gemm_rowblock(As, lda, wp + n0, C, C, Bs, Xs + n0, ldx);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    if (row >= M) continue;
    const T* xr = x + (size_t)row * C;
    T* x2r = x2 + (size_t)row * C;
    const float keep = dp ? dp[row / dp_div] : 1.f;
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) {
        const int c = 32 * k + lane;
        const float branch = Xs[r * ldx + c] + bp[c];
        // x + (proj + bp), or x + dp * (proj + bp) rounded apart (no FMA)
        v[k] = dp ? to_f(xr[c]) + __fmul_rn(branch, keep) : to_f(xr[c]) + branch;
        x2r[c] = from_f<T>(v[k]);
      }
    if (!with_y2) continue;
    warp_layernorm(v, C, ln2s, ln2b, eps, lane);
    T* y2r = y2 + (size_t)row * C;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) y2r[32 * k + lane] = from_f<T>(v[k]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_ln2_kernel(const T* __restrict__ o, const T* __restrict__ x, const T* __restrict__ wp,
                const float* __restrict__ bp, const float* __restrict__ ln2s,
                const float* __restrict__ ln2b, T* __restrict__ x2, T* __restrict__ y2, int M,
                int C, float eps, const float* __restrict__ dp, int dp_div, bool with_y2) {
  extern __shared__ __align__(128) unsigned char smem[];
  proj_ln2_tile<T>(o, x, wp, bp, ln2s, ln2b, x2, y2, M, C, eps, smem, blockIdx.x, dp, dp_div,
                   with_y2);
}

template <typename T>
size_t proj_ln2_smem(int C) {
  return align128(sizeof(T) * Cfg<T>::BM * (C + Cfg<T>::PAD)) + bs_bytes<T>() +
         align128(sizeof(float) * Cfg<T>::BM * (C + 4));
}

// Launch proj_ln2_kernel over M token rows (dp, dp_div, with_y2: see
// proj_ln2_tile).
template <typename T>
cudaError_t launch_proj_ln2(const T* o, const T* x, const T* wp, const float* bp,
                            const float* ln2s, const float* ln2b, T* x2, T* y2, int M, int C,
                            float eps, cudaStream_t stream, const float* dp = nullptr,
                            int dp_div = 1, bool with_y2 = true) {
  const size_t smem = proj_ln2_smem<T>(C);
  cudaError_t e = cudaFuncSetAttribute(proj_ln2_kernel<T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  proj_ln2_kernel<T><<<cdiv(M, Cfg<T>::BM), kThreads, smem, stream>>>(o, x, wp, bp, ln2s, ln2b,
                                                                      x2, y2, M, C, eps, dp,
                                                                      dp_div, with_y2);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- LN1 + qkv
// The attention stage's first step (attention_stage.cu, resident.cu):
// qkv = LN1(x) @ Wqkv + bqkv over token rows; one tile is the row block
// `tile`: LN1 into shared memory, then the qkv projection in 64-column steps
// on the tensor cores; qkv is rounded to the compute type after its bias (as
// the TPU kernel does).
// kHeadMajor (the head-major stage): Wqkv is stacked (h, C, 3d) and bqkv
// (h, 3d), head h's q | k | v columns side by side, and qkv is written
// head-major, (h, M, 3d). Each 64-column step then covers the same columns,
// in the same k order, as the packed layout's step for them, so the values
// are the packed ones, bit for bit.
template <typename T, bool kHeadMajor = false>
__device__ __forceinline__ void ln_qkv_tile(const T* x, const T* wqkv, const float* bqkv,
                                            const float* ln1s, const float* ln1b, T* qkv, int M,
                                            int C, float eps, unsigned char* smem, int tile) {
  constexpr int BM = Cfg<T>::BM;
  const int lda = C + Cfg<T>::PAD;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + align128(sizeof(T) * BM * lda));
  float* Cs = reinterpret_cast<float*>(smem + align128(sizeof(T) * BM * lda) + bs_bytes<T>());
  constexpr int ldc = kBN + 4;

  const int row0 = tile * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    if (row < M) {
      float v[32];
      const T* xr = x + (size_t)row * C;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < C / 32) v[k] = to_f(xr[32 * k + lane]);
      warp_layernorm(v, C, ln1s, ln1b, eps, lane);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < C / 32) As[r * lda + 32 * k + lane] = from_f<T>(v[k]);
    } else {
      for (int c = lane; c < C; c += 32) As[r * lda + c] = from_f<T>(0.f);
    }
  }
  __syncthreads();

  const int N3 = 3 * C;
  for (int n0 = 0; n0 < N3; n0 += kBN) {
    // this step's weight columns (row stride ldw) and output columns (row
    // stride ldq); the bias index is n0 + c in both layouts
    const T* w = wqkv + n0;
    T* q = qkv + n0;
    int ldw = N3, ldq = N3;
    if constexpr (kHeadMajor) {
      constexpr int d3 = 3 * kHeadDim;
      const int h = n0 / d3, c0 = n0 % d3;
      w = wqkv + (size_t)h * C * d3 + c0;
      q = qkv + (size_t)h * M * d3 + c0;
      ldw = ldq = d3;
    }
    gemm_rowblock(As, lda, w, ldw, C, Bs, Cs, ldc);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      if (row0 + r < M)
        q[(size_t)(row0 + r) * ldq + c] = from_f<T>(Cs[r * ldc + c] + bqkv[n0 + c]);
    }
  }
}

template <typename T>
size_t ln_qkv_smem(int C) {
  return align128(sizeof(T) * Cfg<T>::BM * (C + Cfg<T>::PAD)) + bs_bytes<T>() +
         align128(sizeof(float) * Cfg<T>::BM * (kBN + 4));
}

}  // namespace d3dp
