// Shared building blocks of the hand-written Hopper kernels (sm_90a).
//
// Every kernel runs 256 threads (8 warps) per block and works on a block of
// whole token rows: a row of C channels never splits across blocks, so the
// LayerNorms that close each stage see a full row in one block.
//
// Matrix products: every GEMM runs on Hopper's wgmma, 64 rows a
// warpgroup, its weights fed to shared memory by TMA: the MLP walk
// (mlp.cuh) and the stage's ln_qkv and proj_ln2 walks (stage.cuh), whole or
// as a tensor-parallel rank's share. fp32, the default dtype of every entry
// point, multiplies in three TF32 passes from the weights' hi and lo planes
// (tf32x3, mlp.cuh), the Hopper form of the TPU kernels' fp32 products at
// Precision.HIGHEST.
// The per-head attention (`attend_short_walk`, `attend_mma_walk`,
// `attend_f32_walk`) works on sequences and heads
// instead of token rows. It replaces the attention inside the TPU kernels of
// d3dp_tpu/ops/attention.py
// (`_attn_kernel`, `_attn_fused_qkv_kernel`, `_attn_block_kernel`,
// `_attn_stage_kernel`, `_attn_stage_kernel_hm`) and d3dp_tpu/ops/resident.py
// (`_resident_kernel`). Bytes bound it (N / 2 FLOPs a byte: 8.5 at 17 keys,
// 121.5 at 243, under the card's ~295; in fp32 the three TF32 passes make
// the temporal shape's tensor-core time the larger). Which body runs:
//   * N <= 32 unmasked keys (the spatial stages, N = 17), both dtypes: the
//     short tile, a sequence with all its heads a tile, its rows brought by
//     1-D bulk copies on mbarriers into a ring of stages that runs ahead of
//     the warps, a warp a head: bf16 on mma.sync registers, fp32 on FMAs
//     (`attend_short_walk`); the launches and the depth-resident kernel run
//     the same walk;
//   * fp32 masked (the grouped lab switch, blocks of mask_block <= 32
//     tokens): the same short tile on the unfolded view, each block of
//     mask_block tokens one sequence: every key outside a query's block has
//     p = 0 exactly under the mask, so the masked softmax over the fold is
//     the softmax over the query's own block (`launch_attend`);
//   * bf16 above 32 keys, or masked: the tensor-core
//     tile, one (sequence, head) a tile, its key and value rows read once
//     with cp.async in 64-key groups, the logits, the exact softmax and P in
//     mma.sync m16n8k16 registers (`attend_mma_compute`). At 255 registers a
//     thread one block fills an SM, so the launches and the depth-resident
//     kernel walk the tiles from a persistent grid and copy the next tile
//     into a second buffer while the current one computes
//     (`attend_mma_walk`); the depth-resident kernel computes S in parts;
//   * fp32 above 32 keys: the tensor-core walk (`attend_f32_walk`), the
//     bf16 walk's structure with the keys and values streamed in 64-key
//     cp.async groups through two buffers, three TF32 passes a product.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace d3dp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

using bf16 = __nv_bfloat16;

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

// A team of kTeam threads that share a piece of work: the block (kThreads)
// or one warp (32). team_tid: this thread's index in its team; team_sync:
// the team's barrier.
template <int kTeam>
__device__ __forceinline__ int team_tid() {
  return kTeam == kThreads ? (int)threadIdx.x : (int)threadIdx.x % kTeam;
}
template <int kTeam>
__device__ __forceinline__ void team_sync() {
  static_assert(kTeam == kThreads || kTeam == 32, "a team is the block or one warp");
  if constexpr (kTeam == kThreads) __syncthreads();
  else __syncwarp();
}

// Copy `rows` rows of `cols` elements (global, row stride ldg) into shared
// memory (row stride lds) on a team of kTeam threads; rows at or past
// `valid` are zero-filled. Moves 16-byte vectors where every row start is
// 16-byte aligned (base pointers are: the callers pass 16-byte-aligned
// buffers and offsets).
template <typename T, int kTeam = kThreads>
__device__ __forceinline__ void load_rows(T* dst, int lds, const T* src, int ldg, int rows,
                                          int valid, int cols) {
  constexpr int vec = 16 / sizeof(T);
  if (cols % vec == 0 && lds % vec == 0 && ldg % vec == 0) {
    const int vc = cols / vec;
    for (int i = team_tid<kTeam>(); i < rows * vc; i += kTeam) {
      const int r = i / vc, c = (i % vc) * vec;
      *reinterpret_cast<uint4*>(dst + r * lds + c) =
          r < valid ? *reinterpret_cast<const uint4*>(src + (size_t)r * ldg + c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }
  for (int i = team_tid<kTeam>(); i < rows * cols; i += kTeam) {
    const int r = i / cols, c = i % cols;
    dst[r * lds + c] = r < valid ? src[(size_t)r * ldg + c] : from_f<T>(0.f);
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// the same, writing 16 zero bytes (and reading nothing) where !valid
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem, bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
// wait_group with a count known only after unrolling (0..4)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    default: cp_async_wait<4>(); break;
  }
}

// load_rows with every 16-byte copy in flight at once (cp.async, no commit):
// the caller commits and waits before its barrier. Rows that are not 16-byte
// vectors take load_rows.
template <typename T, int kTeam>
__device__ __forceinline__ void load_rows_async(T* dst, int lds, const T* src, int ldg, int rows,
                                                int valid, int cols) {
  constexpr int vec = 16 / sizeof(T);
  if (cols % vec || lds % vec || ldg % vec) {
    load_rows<T, kTeam>(dst, lds, src, ldg, rows, valid, cols);
    return;
  }
  const int vc = cols / vec;
  for (int i = team_tid<kTeam>(); i < rows * vc; i += kTeam) {
    const int r = i / vc, c = (i % vc) * vec;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * lds + c, src + (size_t)(ok ? r : 0) * ldg + c, ok);
  }
}

// ------------------------------------------------------ Hopper primitives
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers, by shared address
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_inval(uint32_t bar) {
  asm volatile("mbarrier.inval.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}
// spin until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}

// order this thread's generic-proxy shared-memory writes before later
// async-proxy accesses (wgmma operand reads, TMA writes)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Bulk copy of `bytes` (a multiple of 16) from shared address src to global
// dst, in this thread's bulk group; the waits: until the group has read its
// shared memory, and until its writes are done.
__device__ __forceinline__ void bulk_store(void* dst, uint32_t src, uint32_t bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(src), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// order this thread's completed bulk-copy writes to global memory (the async
// proxy) before its later generic accesses, and so before a barrier after
// which other blocks read them (the depth-resident kernel's next phase)
__device__ __forceinline__ void fence_proxy_async_global() {
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
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

// The bf16 tensor-core tile (`attend_mma_compute`): each warp owns 16 query
// rows, so a pass of the 8 warps covers kPassRows queries; it takes the
// attentions of more than kShortMaxKeys keys, and every masked one. The
// short tile (`attend_short_walk`) takes the rest in bf16: N <= kShortMaxKeys
// unmasked keys.
constexpr int kPassRows = 16 * kWarps;
constexpr int kShortMaxKeys = 32;
// bf16 rows of 64 in shared memory, padded by 16 bytes: the 8 row addresses
// of one ldmatrix fall on distinct banks
constexpr int kLdh = kHeadDim + 8;

// Whether a bf16 attention of N keys under mask_block runs the short tile.
__host__ __device__ inline bool attend_short_ok(int N, int mask_block) {
  return mask_block == 0 && N <= kShortMaxKeys;
}

struct AttnLayout {
  int QB, NK;
  int nkf;  // 16-key fragments of the tensor-core tile (4, 8 or 16)
  size_t q, k, v, total;
};

// The key-fragment count of the tensor-core tile for N unmasked keys. Under
// a mask of block mb <= 32 a warp's 16 rows span at most
// (15 / mb + 2) * mb <= 64 keys: 4 fragments.
inline int attn_key_frags(int N, int mask_block) {
  return mask_block > 0 || N <= 64 ? 4 : N <= 128 ? 8 : 16;
}

// Tensor-core tile (bf16, N > kShortMaxKeys or masked): Q, K and V rows of
// kLdh, nothing else. Unmasked, one tile holds all N queries (QB = N rounded
// to 16) and all keys (NK = 16 * nkf). Under a mask of block mb a tile holds
// one pass of queries and the whole blocks they span (at most
// (QB - 1) / mb + 2 of them), plus 16 * nkf zero rows, since a warp reads
// 16 * nkf rows from its own window's start.
inline AttnLayout attn_layout_mma(int N, int mask_block) {
  AttnLayout L;
  const int NQ = cdiv(N, 16) * 16;
  L.nkf = attn_key_frags(N, mask_block);
  if (mask_block > 0) {
    L.QB = std::min(NQ, kPassRows);
    const int win = std::min(N, ((L.QB - 1) / mask_block + 2) * mask_block);
    L.NK = cdiv(win, 16) * 16 + 16 * L.nkf;
  } else {
    L.QB = NQ;
    L.NK = 16 * L.nkf;
  }
  size_t off = 0;
  L.q = off; off += align128(sizeof(bf16) * L.QB * kLdh);
  L.k = off; off += align128(sizeof(bf16) * L.NK * kLdh);
  L.v = off; off += align128(sizeof(bf16) * L.NK * kLdh);
  L.total = off;
  return L;
}

// ------------------------------------------ tensor-core walk (fp32, tf32x3)
// fp32 unmasked attention of more than kShortMaxKeys keys (the temporal
// stages, N = 243) on the tensor cores: mma.sync m16n8k8 in TF32, three
// passes into each fp32 product (lo(A) hi(B), hi(A) lo(B), hi(A) hi(B),
// every operand split as the GEMM walks split theirs: tf32x3, mlp.cuh). What
// bounds it on the H100: the tensor cores, at 3 x 82.2 GFLOP (0.498 ms at
// the eval shape, 680 sequences of 243 tokens) against 1.354 GB of qkv and o
// (0.404 ms). The structure is the bf16 tensor-core walk's
// (`attend_mma_walk`), with the keys streamed:
//   * a tile is one (sequence, head); a persistent grid of one block an SM
//     walks them. Its query rows (128 or 256, zero past N, rows of kLdf so
//     that a warp's fragment reads fall on distinct banks) stay in shared
//     memory for the tile; its keys and values go in groups of kF32Keys
//     through two buffers, copied with cp.async: group g + 1 (or the next
//     tile's queries and first group) lands while group g computes;
//   * each thread splits the key and value elements it copied into hi and lo
//     planes in place, once a group (so no warp splits a B operand), then
//     one barrier a group hands the group to the warps and frees the other
//     buffer;
//   * warp w owns the 16-row query blocks w and w + 8 (RB = 2 at N > 128),
//     so every B fragment it loads feeds 2 RB products; its logits for the
//     group stay in registers (RB x 8 m16n8 fragments), the A fragments of Q
//     are split as they are read;
//   * the softmax is exact in fp32 and online across the groups: s = dot *
//     scale (keys past N at -inf), the row max m by quad shuffles, O and the
//     thread's share of l scaled by exp(m_old - m) where m grows, p = exp(s
//     - m), O += P V with P split in registers (the m16n8 accumulator's keys
//     2t, 2t + 1 are the A fragment's columns t, t + 4, and V's rows 2t,
//     2t + 1 its B rows, so P never leaves the registers); at the end O / l.
// A row's arithmetic does not depend on R, the walk, or which block or warp
// takes it, so K8 equals K1 and the depth-resident kernel the launches.
// Shared memory: 256 (RB = 2) or 128 query rows of kLdf floats, and two
// group buffers of four 64-row planes (K hi, K lo, V hi, V lo): 204 KB at
// RB = 2.
constexpr int kLdf = kHeadDim + 4;
constexpr int kF32Keys = 64;                                  // keys a group
constexpr int kF32KvPlane = kF32Keys * kLdf;                  // floats a plane
constexpr size_t kF32KvBuf = 4 * sizeof(float) * kF32KvPlane;  // bytes a group buffer

struct F32AttnLayout {
  int rb;        // 16-row query blocks a warp: 1 (N <= 128) or 2
  size_t kv;     // byte offset of the group buffers (the query rows at 0)
  size_t total;  // bytes a block
};

inline F32AttnLayout f32_attn_layout(int N) {
  F32AttnLayout L;
  L.rb = N <= 16 * kWarps ? 1 : 2;
  L.kv = align128(sizeof(float) * 16 * kWarps * L.rb * kLdf);
  L.total = L.kv + 2 * kF32KvBuf;
  return L;
}

// d += a b for one m16n8k8 TF32 product: a 16 x 8 (row), b 8 x 8 (col), d
// 16 x 8 fp32. Thread (g = lane / 4, t = lane % 4): a[0] (g, t), a[1] (g + 8,
// t), a[2] (g, t + 4), a[3] (g + 8, t + 4); b0 (k t, n g), b1 (k t + 4, n g);
// d[0..1] row g, columns 2t, 2t + 1, d[2..3] row g + 8.
__device__ __forceinline__ void mma_1688_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// v rounded to TF32 (cvt.rna: to nearest, ties away from zero)
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = tf32(v), lo = tf32(v - hi): v - hi is exact
__device__ __forceinline__ void tf32_split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(__fsub_rn(v, __uint_as_float(hi)));
}

// An A fragment's hi and lo parts
struct Tf32Frag {
  uint32_t hi[4], lo[4];
};

__device__ __forceinline__ Tf32Frag tf32_frag(float a0, float a1, float a2, float a3) {
  const float a[4] = {a0, a1, a2, a3};
  Tf32Frag f;
#pragma unroll
  for (int i = 0; i < 4; ++i) tf32_split(a[i], f.hi[i], f.lo[i]);
  return f;
}

// d += a b in tf32x3 from b's hi (bh) and lo (bl) parts: lo(a) hi(b),
// hi(a) lo(b), hi(a) hi(b)
__device__ __forceinline__ void mma_1688_x3(float (&d)[4], const Tf32Frag& a, uint32_t bh0,
                                            uint32_t bh1, uint32_t bl0, uint32_t bl1) {
  mma_1688_tf32(d, a.lo, bh0, bh1);
  mma_1688_tf32(d, a.hi, bl0, bl1);
  mma_1688_tf32(d, a.hi, bh0, bh1);
}

// Start copying rows [r0, r0 + rows) of one head (64 fp32 a row, global row
// stride ld) into shared rows of kLdf; rows at or past N are zero-filled.
// Thread i of a block of kTeam copies the 16-byte pieces i, i + kTeam, ...
// (`split_rows_f32` walks the same ones).
template <int kTeam = kThreads>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* src, int ld, int r0,
                                              int rows, int N) {
  for (int i = threadIdx.x; i < rows * 16; i += kTeam) {
    const int r = i / 16, c = (i % 16) * 4;
    const bool ok = r0 + r < N;
    cp_async16_zfill(dst + r * kLdf + c, ok ? src + (size_t)(r0 + r) * ld + c : src, ok);
  }
}

// The pieces this thread copied with copy_rows_f32 into the plane at hi,
// landed: hi = tf32 of each element in place, lo = tf32 of the remainder.
template <int kTeam = kThreads>
__device__ __forceinline__ void split_rows_f32(float* hi, float* lo, int rows) {
  for (int i = threadIdx.x; i < rows * 16; i += kTeam) {
    const int o = (i / 16) * kLdf + (i % 16) * 4;
    const float4 x = *reinterpret_cast<const float4*>(hi + o);
    uint4 h, l;
    tf32_split(x.x, h.x, l.x);
    tf32_split(x.y, h.y, l.y);
    tf32_split(x.z, h.z, l.z);
    tf32_split(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(hi + o) = h;
    *reinterpret_cast<uint4*>(lo + o) = l;
  }
}

// Walk the tiles blockIdx.x, + gridDim.x, ... of R sequences x heads (head
// fastest); q, k, v, hs, ld as launch_attend's; N > kShortMaxKeys keys. Every
// thread of the block calls it, with no cp.async group of its own in flight;
// smem: L.total bytes, free again on return.
template <int RB>
__device__ __forceinline__ void attend_f32_walk(const float* q, const float* k, const float* v,
                                                long long hs, int ld, float* out, int R, int N,
                                                int C, int heads, float scale,
                                                const F32AttnLayout& L, unsigned char* smem) {
  const int ntiles = R * heads, groups = cdiv(N, kF32Keys);
  float* Qs = reinterpret_cast<float*>(smem);
  auto kvbuf = [&](int b) { return reinterpret_cast<float*>(smem + L.kv + b * kF32KvBuf); };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // start tile tl's key group grp (with its queries where grp = 0) into buffer b
  auto issue = [&](int tl, int grp, int b) {
    const size_t o = (size_t)(tl / heads) * N * ld + (tl % heads) * (kHeadDim + hs);
    if (grp == 0) copy_rows_f32(Qs, q + o, ld, 0, 16 * kWarps * RB, N);
    float* kb = kvbuf(b);
    copy_rows_f32(kb, k + o, ld, kF32Keys * grp, kF32Keys, N);
    copy_rows_f32(kb + 2 * kF32KvPlane, v + o, ld, kF32Keys * grp, kF32Keys, N);
    cp_async_commit();
  };
  if ((int)blockIdx.x < ntiles) issue(blockIdx.x, 0, 0);
  int buf = 0;
  for (int tl = blockIdx.x; tl < ntiles; tl += gridDim.x) {
    float o[RB][kHeadDim / 8][4], m[RB][2], l[RB][2];
#pragma unroll
    for (int i = 0; i < RB; ++i) {
#pragma unroll
      for (int d = 0; d < kHeadDim / 8; ++d) o[i][d][0] = o[i][d][1] = o[i][d][2] = o[i][d][3] = 0.f;
      m[i][0] = m[i][1] = -INFINITY;
      l[i][0] = l[i][1] = 0.f;
    }
    for (int grp = 0; grp < groups; ++grp, buf ^= 1) {
      float* kb = kvbuf(buf);
      cp_async_wait<0>();  // this thread's copies of the group landed
      split_rows_f32(kb, kb + kF32KvPlane, kF32Keys);
      split_rows_f32(kb + 2 * kF32KvPlane, kb + 3 * kF32KvPlane, kF32Keys);
      __syncthreads();  // the group is split; every warp is done with the other buffer
      const bool last = grp + 1 == groups;
      if (!last) issue(tl, grp + 1, buf ^ 1);

      // S = Q K^T (unscaled) of the warp's rows against the group's keys
      float s[RB][8][4];
#pragma unroll
      for (int i = 0; i < RB; ++i)
#pragma unroll
        for (int n = 0; n < 8; ++n) s[i][n][0] = s[i][n][1] = s[i][n][2] = s[i][n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kHeadDim / 8; ++kk) {
        Tf32Frag a[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) {
          const float* qa = Qs + (16 * (warp + kWarps * i) + g) * kLdf + 8 * kk + t;
          a[i] = tf32_frag(qa[0], qa[8 * kLdf], qa[4], qa[8 * kLdf + 4]);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* kp = kb + (8 * n + g) * kLdf + 8 * kk + t;
          const uint32_t bh0 = __float_as_uint(kp[0]), bh1 = __float_as_uint(kp[4]);
          const uint32_t bl0 = __float_as_uint(kp[kF32KvPlane]);
          const uint32_t bl1 = __float_as_uint(kp[kF32KvPlane + 4]);
#pragma unroll
          for (int i = 0; i < RB; ++i) mma_1688_x3(s[i][n], a[i], bh0, bh1, bl0, bl1);
        }
      }
      if (last) {
        __syncthreads();  // every warp has read the queries
        if (tl + (int)gridDim.x < ntiles) issue(tl + gridDim.x, 0, buf ^ 1);
      }

      // online softmax of rows g (e = 0, 1) and g + 8 (e = 2, 3) of each block
      const int k0 = kF32Keys * grp;
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float x = k0 + 8 * n + 2 * t + (e & 1) < N ? s[i][n][e] * scale : -INFINITY;
            s[i][n][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          const float mn = fmaxf(m[i][r], mx[r]);
          const float alpha = expf(m[i][r] - mn);  // 0 at the first group
          m[i][r] = mn;
          l[i][r] *= alpha;
#pragma unroll
          for (int d = 0; d < kHeadDim / 8; ++d) {
            o[i][d][2 * r] *= alpha;
            o[i][d][2 * r + 1] *= alpha;
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float p = expf(s[i][n][e] - m[i][e >> 1]);
            s[i][n][e] = p;
            l[i][e >> 1] += p;
          }
      }

      // O += P V, 8 keys a step
      const float* vb = kb + 2 * kF32KvPlane;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        Tf32Frag a[RB];
#pragma unroll
        for (int i = 0; i < RB; ++i) a[i] = tf32_frag(s[i][n][0], s[i][n][2], s[i][n][1], s[i][n][3]);
#pragma unroll
        for (int d = 0; d < kHeadDim / 8; ++d) {
          const float* vp = vb + (8 * n + 2 * t) * kLdf + 8 * d + g;
          const uint32_t bh0 = __float_as_uint(vp[0]), bh1 = __float_as_uint(vp[kLdf]);
          const uint32_t bl0 = __float_as_uint(vp[kF32KvPlane]);
          const uint32_t bl1 = __float_as_uint(vp[kF32KvPlane + kLdf]);
#pragma unroll
          for (int i = 0; i < RB; ++i) mma_1688_x3(o[i][d], a[i], bh0, bh1, bl0, bl1);
        }
      }
    }

    // O / l, rows past N dropped
    const int seq = tl / heads, h = tl % heads;
#pragma unroll
    for (int i = 0; i < RB; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float lr = l[i][r];
        lr += __shfl_xor_sync(0xffffffffu, lr, 1);
        lr += __shfl_xor_sync(0xffffffffu, lr, 2);
        const int row = 16 * (warp + kWarps * i) + g + 8 * r;
        if (row >= N) continue;
        float* orow = out + ((size_t)seq * N + row) * C + h * kHeadDim + 2 * t;
#pragma unroll
        for (int d = 0; d < kHeadDim / 8; ++d)
          *reinterpret_cast<float2*>(orow + 8 * d) =
              make_float2(o[i][d][2 * r] / lr, o[i][d][2 * r + 1] / lr);
      }
  }
  __syncthreads();  // the memory is free for the caller
}

// ------------------------------------------- tensor-core tile (bf16, mma.sync)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
// d += a b for one m16n8k16 product: a 16 x 16 bf16 (row), b 16 x 8 bf16
// (col), d 16 x 8 fp32. Thread (g = lane / 4, t = lane % 4) holds d[0..1] at
// row g, columns 2t, 2t + 1, and d[2..3] at row g + 8.
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// 2^x on the special-function unit (ex2.approx, 2 ulp), subnormal results
// flushed to zero: one instruction, where exp2f adds a predicated rescale
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Start copying rows [r0, r1) of one head (64 bf16 a row, global row stride
// ld) into shared rows of kLdh; rows at or past `valid` are zero-filled.
__device__ __forceinline__ void copy_head_rows(bf16* dst, const bf16* src, int ld, int r0, int r1,
                                               int valid) {
  for (int i = threadIdx.x; i < (r1 - r0) * 8; i += kThreads) {
    const int r = r0 + i / 8, c = (i % 8) * 8;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * kLdh + c, ok ? src + (size_t)r * ld + c : src, ok);
  }
}

// The bf16 tile on the tensor cores, NKF 16-key fragments (attn_layout_mma).
// Unmasked, one tile is a whole (sequence, head): its K and V rows are read
// once and its queries go in passes of kPassRows. Each warp owns 16 query
// rows and keeps S for all its keys in registers (2 * NKF m16n8 fp32
// fragments; in parts in the depth-resident kernel); the row max and sum
// come from quad shuffles; keys at or past nk, and outside the query's own
// block under a mask, get s = -inf by index, so p = 0 exactly. The accumulator layout of m16n8k16 is its A layout, so P
// goes from S to bf16 A fragments in registers, and P.V reads V with
// ldmatrix.trans. Each output row's arithmetic (the MMA order along keys,
// the shuffle order of m and l) is the same whatever the tile's other rows,
// R, or the caller's tile walk.

// Where one tile's queries and keys lie: queries [q0, q0 + nq) of its
// sequence (nqr: nq rounded up to 16) and keys [k0, k0 + nk).
struct MmaTile {
  int q0, nq, nqr, k0, nk;
};

__device__ __forceinline__ MmaTile mma_tile(int N, const AttnLayout& L, int mb, int qb) {
  MmaTile t;
  t.q0 = qb * L.QB;
  t.nq = min(L.QB, N - t.q0);
  t.nqr = cdiv(t.nq, 16) * 16;
  t.k0 = 0;
  t.nk = N;
  if (mb > 0) {
    t.k0 = t.q0 / mb * mb;
    t.nk = min(N, (t.q0 + t.nq - 1) / mb * mb + mb) - t.k0;
  }
  return t;
}

// Start the tile's copies into smem as NKF / 4 + 1 cp.async groups: pass 0's
// queries with keys 0-63, one group per further 64 keys (at NKF = 4, and so
// under a mask, one group of all keys), then V and the later passes'
// queries, so Q.K^T on the first keys starts while the rest land.
template <int NKF>
__device__ __forceinline__ void attend_mma_copy(const bf16* q, const bf16* k, const bf16* v,
                                                int ld, int N, const AttnLayout& L, int mb,
                                                unsigned char* smem, int seq, int h, int qb) {
  constexpr int kKeyGroups = NKF / 4;
  const MmaTile t = mma_tile(N, L, mb, qb);
  bf16* Qs = reinterpret_cast<bf16*>(smem + L.q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + L.k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + L.v);
  const size_t off = (size_t)seq * N * ld + h * kHeadDim;
  const bf16* qg = q + off + (size_t)t.q0 * ld;
  const bf16* kg = k + off + (size_t)t.k0 * ld;
  const int nr0 = min(t.nqr, kPassRows);
  const int kchunk = kKeyGroups == 1 ? L.NK : 64;
  copy_head_rows(Qs, qg, ld, 0, nr0, t.nq);
#pragma unroll
  for (int c = 0; c < kKeyGroups; ++c) {
    copy_head_rows(Ks, kg, ld, c * kchunk, min(L.NK, (c + 1) * kchunk), t.nk);
    cp_async_commit();
  }
  copy_head_rows(Vs, v + off + (size_t)t.k0 * ld, ld, 0, L.NK, t.nk);
  copy_head_rows(Qs, qg, ld, nr0, t.nqr, t.nq);
  cp_async_commit();
}

// S = Q K^T (unscaled) of a warp's 16 query rows (A fragments qa) against KF
// 16-key fragments from Kh, the first of their key rows in shared memory:
// s[j][e] holds key 8j + 2(lane % 4) + (e & 1) of row lane / 4 + 8(e >> 1).
template <int KF>
__device__ __forceinline__ void mma_logits(float (&s)[2 * KF][4],
                                           const uint32_t (&qa)[kHeadDim / 16][4],
                                           const bf16* Kh, int lane) {
  const int lrow = lane % 8, lmat = lane / 8;
#pragma unroll
  for (int j = 0; j < 2 * KF; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int f = 0; f < KF; ++f)
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
      uint32_t b[4];
      ldsm_x4(b, Kh + (16 * f + (lmat >> 1) * 8 + lrow) * kLdh + ks * 16 + (lmat & 1) * 8);
      mma_16816(s[2 * f], qa[ks], b[0], b[1]);
      mma_16816(s[2 * f + 1], qa[ks], b[2], b[3]);
    }
}

// s = dot * scale, and s = -inf (so p = 0 exactly) for every key outside the
// row's [j0, j1) of the warp's window, by index; kbase: the window index of
// s's first key. Unmasked, only the fragments reaching past j1 are checked.
template <int KF>
__device__ __forceinline__ void scale_mask(float (&s)[2 * KF][4], float scale, int kbase, int tq,
                                           const int (&j0)[2], const int (&j1)[2], bool masked) {
#pragma unroll
  for (int j = 0; j < 2 * KF; ++j) {
    const bool edge = masked || kbase + 8 * j + 8 > j1[0];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = kbase + 8 * j + 2 * tq + (e & 1), i = e >> 1;
      float x = s[j][e] * scale;
      if (edge && (key < j0[i] || key >= j1[i])) x = -INFINITY;
      s[j][e] = x;
    }
  }
}

// p = exp(s - m) in place, and l += p key by key where `sum`. exp(s - m) as
// 2^(s log2(e) - m log2(e)), one FMA and one ex2 a key; under bf16_exp
// p = bf16(exp(bf16(s - m))).
template <int KF>
__device__ __forceinline__ void softmax_exp(float (&s)[2 * KF][4], const float (&m)[2],
                                            float (&l)[2], bool bf16_exp, bool sum) {
  constexpr float kLog2e = 1.4426950408889634f;
  const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
  if (bf16_exp) {
#pragma unroll
    for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = bf16_round(expf(bf16_round(s[j][e] - m[e >> 1])));
        if (sum) l[e >> 1] += s[j][e];
      }
  } else {
#pragma unroll
    for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2_ftz(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
        if (sum) l[e >> 1] += s[j][e];
      }
  }
}

// P (times 1/l first where `norm`) rounded to bf16 as the A fragments of
// P.V's 16-key steps: the accumulator layout of S is the A layout.
template <int KF>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[KF][4], const float (&p)[2 * KF][4],
                                       const float (&inv)[2], bool norm) {
  const float c0 = norm ? inv[0] : 1.f, c1 = norm ? inv[1] : 1.f;
#pragma unroll
  for (int f = 0; f < KF; ++f) {
    pa[f][0] = pack_bf16(p[2 * f][0] * c0, p[2 * f][1] * c0);
    pa[f][1] = pack_bf16(p[2 * f][2] * c1, p[2 * f][3] * c1);
    pa[f][2] = pack_bf16(p[2 * f + 1][0] * c0, p[2 * f + 1][1] * c0);
    pa[f][3] = pack_bf16(p[2 * f + 1][2] * c1, p[2 * f + 1][3] * c1);
  }
}

// O += P V over KF 16-key steps from Vh (the first of their value rows), V
// read with ldmatrix.trans.
template <int KF>
__device__ __forceinline__ void mma_pv(float (&o)[kHeadDim / 8][4], const uint32_t (&pa)[KF][4],
                                       const bf16* Vh, int lane) {
  const int lrow = lane % 8, lmat = lane / 8;
#pragma unroll
  for (int f = 0; f < KF; ++f)
#pragma unroll
    for (int dp = 0; dp < kHeadDim / 16; ++dp) {
      uint32_t b[4];
      ldsm_x4_trans(b, Vh + (16 * f + (lmat & 1) * 8 + lrow) * kLdh + dp * 16 + (lmat >> 1) * 8);
      mma_16816(o[2 * dp], pa[f], b[0], b[1]);
      mma_16816(o[2 * dp + 1], pa[f], b[2], b[3]);
    }
}

// The tile's arithmetic on the copies attend_mma_copy started into smem,
// which are the only cp.async groups in flight, with S kept whole in
// registers (the standalone launches). `loaded()` runs once all of them have
// landed (after pass 0's softmax), on every thread: a caller that walks
// tiles starts the next tile's copies there, into another buffer.
template <int NKF, typename Loaded>
__device__ __forceinline__ void attend_mma_compute(bf16* out, int N, int C, float scale,
                                                   const AttnLayout& L, const AttnOpts& opts,
                                                   unsigned char* smem, int seq, int h, int qb,
                                                   Loaded&& loaded) {
  constexpr int kKeyGroups = NKF / 4;
  constexpr int kGroupFrags = NKF / kKeyGroups;
  constexpr float kLog2e = 1.4426950408889634f;
  const bf16* Qs = reinterpret_cast<const bf16*>(smem + L.q);
  const bf16* Ks = reinterpret_cast<const bf16*>(smem + L.k);
  const bf16* Vs = reinterpret_cast<const bf16*>(smem + L.v);
  const int mb = opts.mask_block;
  const MmaTile t = mma_tile(N, L, mb, qb);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int lrow = lane % 8, lmat = lane / 8;
  bf16* orow = out + ((size_t)seq * N + t.q0) * C + h * kHeadDim;
  for (int pass = 0; pass * kPassRows < t.nqr; ++pass) {
    const int r0 = pass * kPassRows + warp * 16;  // the warp's first row in the tile
    const bool active = r0 < t.nq;
    // the warp's keys: rows [kw, kw + 16 * NKF) of Ks and Vs
    const int kw = mb > 0 && active ? (t.q0 + r0) / mb * mb - t.k0 : 0;

    // S = Q K^T (unscaled), fp32, in registers
    float s[2 * NKF][4];
#pragma unroll
    for (int j = 0; j < 2 * NKF; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    uint32_t qa[kHeadDim / 16][4];
#pragma unroll
    for (int f = 0; f < NKF; ++f) {
      if (f % kGroupFrags == 0) {
        if (pass == 0) {
          // this thread's copies of key group f / kGroupFrags landed, then everyone's
          cp_async_wait_upto(kKeyGroups - f / kGroupFrags);
          __syncthreads();
        }
        if (f == 0 && active) {
#pragma unroll
          for (int ks = 0; ks < kHeadDim / 16; ++ks)
            ldsm_x4(qa[ks], Qs + (r0 + (lmat & 1) * 8 + lrow) * kLdh + ks * 16 + (lmat >> 1) * 8);
        }
      }
      if (!active) continue;
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, Ks + (kw + 16 * f + (lmat >> 1) * 8 + lrow) * kLdh + ks * 16 + (lmat & 1) * 8);
        mma_16816(s[2 * f], qa[ks], b[0], b[1]);
        mma_16816(s[2 * f + 1], qa[ks], b[2], b[3]);
      }
    }

    // exact softmax of rows r0 + g (e = 0, 1) and r0 + g + 8 (e = 2, 3) over
    // their keys [j0, j1) of the warp's window: s = dot * scale, m = max(s),
    // p = exp(s - m), l = sum(p), then P rounded to bf16 as the A fragments
    // of P.V's 16-key steps
    float inv[2] = {1.f, 1.f};
    uint32_t pa[NKF][4];
    if (active) {
      int j0[2] = {0, 0}, j1[2] = {t.nk - kw, t.nk - kw};
      if (mb > 0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          j0[i] = (t.q0 + r0 + g + 8 * i) / mb * mb - t.k0 - kw;
          j1[i] = min(j0[i] + mb, t.nk - kw);
        }
      }
      float m[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 2 * NKF; ++j) {
        // unmasked, only the fragments reaching past nk hold keys to drop
        const bool edge = mb > 0 || 8 * j + 8 > t.nk;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = 8 * j + 2 * tq + (e & 1), i = e >> 1;
          float x = s[j][e] * scale;
          if (edge && (key < j0[i] || key >= j1[i])) x = -INFINITY;
          s[j][e] = x;
          m[i] = fmaxf(m[i], x);
        }
      }
      float l[2] = {0.f, 0.f};
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
        m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      }
      if (opts.bf16_exp) {
#pragma unroll
        for (int j = 0; j < 2 * NKF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = bf16_round(expf(bf16_round(s[j][e] - m[e >> 1])));
            l[e >> 1] += s[j][e];
          }
      } else {
        // exp(s - m) as 2^(s log2(e) - m log2(e)): one FMA and one ex2 a key
        const float ml[2] = {m[0] * kLog2e, m[1] * kLog2e};
#pragma unroll
        for (int j = 0; j < 2 * NKF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = ex2_ftz(fmaf(s[j][e], kLog2e, -ml[e >> 1]));
            l[e >> 1] += s[j][e];
          }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv[i] = 1.0f / l[i];
      }
      if (opts.norm_first) {
        // p / l, as p times 1 / l, before the rounding
#pragma unroll
        for (int j = 0; j < 2 * NKF; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
        inv[0] = inv[1] = 1.f;
      }
#pragma unroll
      for (int f = 0; f < NKF; ++f) {
        pa[f][0] = pack_bf16(s[2 * f][0], s[2 * f][1]);
        pa[f][1] = pack_bf16(s[2 * f][2], s[2 * f][3]);
        pa[f][2] = pack_bf16(s[2 * f + 1][0], s[2 * f + 1][1]);
        pa[f][3] = pack_bf16(s[2 * f + 1][2], s[2 * f + 1][3]);
      }
    }

    if (pass == 0) {
      cp_async_wait<0>();  // V and the later passes' queries
      __syncthreads();
      loaded();
    }
    if (!active) continue;
    // O = P V
    float o[kHeadDim / 8][4];
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int f = 0; f < NKF; ++f) {
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, Vs + (kw + 16 * f + (lmat & 1) * 8 + lrow) * kLdh + dp * 16 +
                             (lmat >> 1) * 8);
        mma_16816(o[2 * dp], pa[f], b[0], b[1]);
        mma_16816(o[2 * dp + 1], pa[f], b[2], b[3]);
      }
    }
    // scaled by 1/l (or by 1 where p was normalised first), rounded to bf16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r >= t.nq) continue;
      bf16* orr = orow + (size_t)r * C + 2 * tq;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j)
        *reinterpret_cast<uint32_t*>(orr + 8 * j) =
            pack_bf16(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
    }
  }
}

// The same arithmetic as attend_mma_compute, for the depth-resident kernel,
// which inlines the tile beside its other phases and shares their
// registers: the keys go in parts of KF 16-key fragments, and S is computed
// again for each use (the row max; l, where p / l comes first; P.V), so a
// thread holds 8 * KF logits, not 8 * NKF. The bits are those of S kept
// whole: each key's s and p come from the same operations, l adds the keys
// in the same order, and P.V takes the 16-key steps in the same order.
template <int NKF, int KF, typename Loaded>
__device__ __forceinline__ void attend_mma_compute_parts(bf16* out, int N, int C, float scale,
                                                         const AttnLayout& L,
                                                         const AttnOpts& opts,
                                                         unsigned char* smem, int seq, int h,
                                                         int qb, Loaded&& loaded) {
  constexpr int kKeyGroups = NKF / 4;
  constexpr int kParts = NKF / KF;
  const bf16* Qs = reinterpret_cast<const bf16*>(smem + L.q);
  const bf16* Ks = reinterpret_cast<const bf16*>(smem + L.k);
  const bf16* Vs = reinterpret_cast<const bf16*>(smem + L.v);
  const int mb = opts.mask_block;
  const MmaTile t = mma_tile(N, L, mb, qb);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  bf16* orow = out + ((size_t)seq * N + t.q0) * C + h * kHeadDim;
  for (int pass = 0; pass * kPassRows < t.nqr; ++pass) {
    const int r0 = pass * kPassRows + warp * 16;  // the warp's first row in the tile
    const bool active = r0 < t.nq;
    // the warp's keys: rows [kw, kw + 16 * NKF) of Ks and Vs; row r0 + g +
    // 8i sees its keys [j0[i], j1[i]) of them
    const int kw = mb > 0 && active ? (t.q0 + r0) / mb * mb - t.k0 : 0;
    int j0[2] = {0, 0}, j1[2] = {t.nk - kw, t.nk - kw};
    if (mb > 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        j0[i] = (t.q0 + r0 + g + 8 * i) / mb * mb - t.k0 - kw;
        j1[i] = min(j0[i] + mb, t.nk - kw);
      }
    }
    const bf16* Kw = Ks + kw * kLdh;
    const bf16* Vw = Vs + kw * kLdh;
    uint32_t qa[kHeadDim / 16][4];
    float s[2 * KF][4];
    uint32_t pa[KF][4];
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2] = {1.f, 1.f};

    // 1. m = the row max of s = dot * scale over the row's keys
#pragma unroll 1
    for (int pt = 0; pt < kParts; ++pt) {
      if (pass == 0) {
        // this thread's copies of the part's key groups landed, then everyone's
        cp_async_wait_upto(kKeyGroups + 1 - cdiv((pt + 1) * KF, 4));
        __syncthreads();
      }
      if (!active) continue;
      if (pt == 0) {
        const int lrow = lane % 8, lmat = lane / 8;
#pragma unroll
        for (int ks = 0; ks < kHeadDim / 16; ++ks)
          ldsm_x4(qa[ks], Qs + (r0 + (lmat & 1) * 8 + lrow) * kLdh + ks * 16 + (lmat >> 1) * 8);
      }
      mma_logits<KF>(s, qa, Kw + 16 * KF * pt * kLdh, lane);
      scale_mask<KF>(s, scale, 16 * KF * pt, tq, j0, j1, mb > 0);
#pragma unroll
      for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }

    // 2. p = exp(s - m) and l = sum(p) before P.V where p / l comes first
    if (active && opts.norm_first) {
#pragma unroll 1
      for (int pt = 0; pt < kParts; ++pt) {
        mma_logits<KF>(s, qa, Kw + 16 * KF * pt * kLdh, lane);
        scale_mask<KF>(s, scale, 16 * KF * pt, tq, j0, j1, mb > 0);
        softmax_exp<KF>(s, m, l, opts.bf16_exp, true);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv[i] = 1.0f / l[i];
      }
    }

    if (pass == 0) {
      cp_async_wait<0>();  // V and the later passes' queries
      __syncthreads();
      loaded();
    }
    if (!active) continue;
    // 3. O = P V: p / l rounded to bf16 under norm_first (the output then
    // scaled by 1), else the unnormalised p, and 1/l on the output
    float o[kHeadDim / 8][4];
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll 1
    for (int pt = 0; pt < kParts; ++pt) {
      mma_logits<KF>(s, qa, Kw + 16 * KF * pt * kLdh, lane);
      scale_mask<KF>(s, scale, 16 * KF * pt, tq, j0, j1, mb > 0);
      softmax_exp<KF>(s, m, l, opts.bf16_exp, !opts.norm_first);
      pack_p<KF>(pa, s, inv, opts.norm_first);
      mma_pv<KF>(o, pa, Vw + 16 * KF * pt * kLdh, lane);
    }
    if (opts.norm_first) {
      inv[0] = inv[1] = 1.f;
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
        inv[i] = 1.0f / l[i];
      }
    }
    // scaled by 1/l (or by 1 where p was normalised first), rounded to bf16
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + g + 8 * i;
      if (r >= t.nq) continue;
      bf16* orr = orow + (size_t)r * C + 2 * tq;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j)
        *reinterpret_cast<uint32_t*>(orr + 8 * j) =
            pack_bf16(o[j][2 * i] * inv[i], o[j][2 * i + 1] * inv[i]);
    }
  }
}

// ------------------------------------------ short tile (N <= 32 keys)
// bf16 and fp32 attention over N <= kShortMaxKeys unmasked keys: the spatial stages
// (N = 17 joints) of K1, K1-dp, K8, K6, K3, K7 and the depth-resident
// kernel. What bounds it on the H100: bytes. At the eval shape (9,720
// sequences of 17 tokens, C = 512) it reads 0.508 GB of qkv and writes 0.169
// GB of o, 0.202 ms at 3.35 TB/s, against 5.75 GFLOP (8.5 FLOPs a byte; the
// card's ridge is about 295). Design:
//   * a tile is one sequence with all its heads: its qkv is one contiguous
//     N x 3C slab (52 KB at N = 17, C = 512) in the packed layout;
//   * one thread of warp 0 arms a stage's mbarrier with the tile's bytes and
//     the warp's lanes start 1-D bulk copies (cp.async.bulk, no tensor map)
//     of its rows into a ring of stages, each source row (the packed
//     layout's q | k | v row of 3C; separate q, k and v rows of C each; a
//     head-major slab's row of 3 x 64) to a shared row padded by 16 bytes,
//     so the 8 row addresses of an ldmatrix fall on distinct banks (one copy
//     of the whole slab would put them on one bank). The persistent grid
//     walks the sequences; a stage is refilled with the tile `stages` further
//     on once every warp has released it, so the next tiles' copies run
//     while the current one computes;
//   * warp w takes head w (heads w, w + 8, ... where there are more): S,
//     the exact softmax and P live in mma.sync m16n8k16 registers (32 query
//     rows x 32 keys, or 16 x 16 at N <= 16; the helpers of the tensor-core
//     tile), rows and keys at or past N are read from a zero row by index
//     and keys past N get s = -inf, so p = 0 exactly; P is repacked in
//     registers as the A operand of P.V;
//   * O is scaled and rounded in registers, staged in the warp's own head's
//     q columns of the stage (read already) and written as whole 128-byte
//     lines with 16-byte stores.
// Each output row's arithmetic (the MMA order along keys, the shuffle order
// of m and l) depends on neither R, the walk, nor the source layout, so K8
// equals K1 and level 5 level 4, bit for bit.
// fp32 runs the same ring on rows of fp32 (104 KB a stage at N = 17, C =
// 512: two stages and one block an SM), bytes bound at 1.354 GB (0.404 ms
// at the eval shape) against 5.8 GFLOP, so the per-head math is FMAs
// (`attend_short_head_f32`): lane j holds key row j in registers, query
// rows are read as broadcasts, four at a time, s_j = q . k_j, the exact
// softmax across the lanes (p / l before P.V, the fp32 order), p staged
// over the query's own row, then lanes d and d + 32 take O's columns from
// the value columns they hold in registers, written straight out.
constexpr int kShortStages = 2;     // the standalone launch's ring,
constexpr int kShortBlocks = 2;     // with two blocks an SM (bf16)
constexpr int kShortMaxStages = 4;  // the most the depth-resident kernel's smem holds
constexpr int kShortPadBytes = 16;  // padding each shared row
// shared memory before the ring: full and empty mbarriers of each stage,
// then a zero row of kHeadDim bf16
constexpr int kShortZero = 2 * kShortMaxStages * 8;
constexpr int kShortHeader = 256;
constexpr size_t kSmemPerBlock = 232448;  // 227 KB, the most a block may use

// where a tile's rows come from
constexpr int kShortPacked = 0;     // (R, N, 3C): q | k | v, ld = 3C
constexpr int kShortSeparate = 1;   // three (R, N, C) tensors, ld = C
constexpr int kShortHeadMajor = 2;  // (heads, R * N, 3 x 64) slabs, ld = 3 x 64

struct ShortLayout {
  int src, N, C, heads, ld;
  long long hstride;  // head-major: elements from one head's slab to the next
  // shared, in elements: head h's q row r at h * sh + r * sr, its k and
  // v rows at + ko and + vo; the copies of one source row o (separate: q, k,
  // v; head-major: the heads) dso apart
  int sr, sh, ko, vo, dso;
  int ncopy, copy_bytes;  // a tile's bulk copies and each one's bytes
  int tile_bytes, stage_bytes, stages;
  int total;  // the dynamic shared memory of a block
};

// The layout of a short tile of T over `src` rows with as many stages as
// fit in smem_max bytes, at most max_stages; false where not one fits.
template <typename T = bf16>
inline bool short_layout(ShortLayout& L, int src, int N, int C, int heads, int ld,
                         long long hstride, size_t smem_max, int max_stages) {
  constexpr int kShortPad = kShortPadBytes / sizeof(T);
  L.src = src;
  L.N = N;
  L.C = C;
  L.heads = heads;
  L.ld = ld;
  L.hstride = hstride;
  if (src == kShortHeadMajor) {
    L.sr = 3 * kHeadDim + kShortPad;
    L.sh = L.dso = N * L.sr;
    L.ko = kHeadDim;
    L.vo = 2 * kHeadDim;
    L.ncopy = heads * N;
    L.copy_bytes = 3 * kHeadDim * sizeof(T);
  } else {
    L.sr = 3 * C + kShortPad;
    L.sh = kHeadDim;
    L.ko = L.dso = C;
    L.vo = 2 * C;
    L.ncopy = src == kShortPacked ? N : 3 * N;
    L.copy_bytes = (src == kShortPacked ? 3 * C : C) * sizeof(T);
  }
  L.tile_bytes = N * 3 * C * sizeof(T);
  L.stage_bytes = (int)align128(sizeof(T) * (src == kShortHeadMajor ? heads : 1) * N * L.sr);
  const long long room = (long long)smem_max - kShortHeader;
  L.stages = (int)std::min<long long>(max_stages, room > 0 ? room / L.stage_bytes : 0);
  L.total = kShortHeader + L.stages * L.stage_bytes;
  return L.stages >= 1;
}

// Global 16-byte src to shared address dst, `bytes` (a multiple of 16),
// completing on the mbarrier bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename T>
struct ShortArgsT {
  const T *q, *k, *v;  // see launch_attend_short
  T* out;              // (R, N, C)
  int R;
  float scale;
  AttnOpts opts;
};
using ShortArgs = ShortArgsT<bf16>;

// Head h of the tile in the stage at st, on one warp: O into the head's q
// columns of the stage, then out to sequence seq's rows.
__device__ __forceinline__ void attend_short_head(const ShortLayout& L, const ShortArgs& a,
                                                  bf16* st, const bf16* zero, int seq, int h,
                                                  int lane) {
  const int N = L.N;
  const int g = lane / 4, tq = lane % 4, lrow = lane % 8, lmat = lane / 8;
  bf16* qh = st + h * L.sh;
  // the lane's ldmatrix row: row r of the head's q, k or v, or the zero row
  auto at = [&](int r, int col) -> const bf16* { return r < N ? qh + r * L.sr + col : zero; };
  const bool two = N > 16;  // a second 16-row block of queries and of keys
  const int j0[2] = {0, 0}, j1[2] = {N, N};
#pragma unroll 1
  for (int rb = 0; rb < (two ? 2 : 1); ++rb) {
    uint32_t qa[kHeadDim / 16][4];
    const bf16* qp = at(16 * rb + (lmat & 1) * 8 + lrow, 0);
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) ldsm_x4(qa[ks], qp + ks * 16 + (lmat >> 1) * 8);
    // S = Q K^T (unscaled): s[j][e] holds key 8j + 2tq + (e & 1) of row
    // 16rb + g + 8(e >> 1)
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      if (f == 1 && !two) break;
      const bf16* kp = at(16 * f + (lmat >> 1) * 8 + lrow, L.ko);
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        uint32_t b[4];
        ldsm_x4(b, kp + ks * 16 + (lmat & 1) * 8);
        mma_16816(s[2 * f], qa[ks], b[0], b[1]);
        mma_16816(s[2 * f + 1], qa[ks], b[2], b[3]);
      }
    }
    // the exact softmax of rows 16rb + g (e = 0, 1) and + 8 (e = 2, 3)
    scale_mask<2>(s, a.scale, 0, tq, j0, j1, false);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, inv[2];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
    }
    softmax_exp<2>(s, m, l, a.opts.bf16_exp, true);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
      inv[i] = 1.0f / l[i];
    }
    // P (p / l first under norm_first) as P.V's A fragments; O = P V
    uint32_t pa[2][4];
    pack_p<2>(pa, s, inv, a.opts.norm_first);
    float o[kHeadDim / 8][4];
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
    for (int f = 0; f < 2; ++f) {
      if (f == 1 && !two) break;
      const bf16* vp = at(16 * f + (lmat & 1) * 8 + lrow, L.vo);
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vp + dp * 16 + (lmat >> 1) * 8);
        mma_16816(o[2 * dp], pa[f], b[0], b[1]);
        mma_16816(o[2 * dp + 1], pa[f], b[2], b[3]);
      }
    }
    // scaled by 1/l (or by 1 where p was normalised first), rounded to bf16,
    // staged over the rows' q, which this warp alone reads and has read
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * rb + g + 8 * i;
      const float c = a.opts.norm_first ? 1.f : inv[i];
      if (r >= N) continue;
      bf16* d = qh + r * L.sr + 2 * tq;
#pragma unroll
      for (int j = 0; j < kHeadDim / 8; ++j)
        *reinterpret_cast<uint32_t*>(d + 8 * j) = pack_bf16(o[j][2 * i] * c, o[j][2 * i + 1] * c);
    }
  }
  __syncwarp();
  // the head's N x 64 outputs, 8 lanes a 128-byte row
  bf16* og = a.out + (size_t)seq * N * L.C + h * kHeadDim;
  for (int i = lane; i < N * 8; i += 32) {
    const int r = i / 8, c = (i % 8) * 8;
    *reinterpret_cast<uint4*>(og + (size_t)r * L.C + c) =
        *reinterpret_cast<const uint4*>(qh + r * L.sr + c);
  }
}

// fp32: head h of the tile in the stage at st, on one warp (the FMA body
// above): key row `lane` and value columns lane, lane + 32 in registers;
// then kShortQueries query rows at a time (independent chains: the warp's
// latency, not its issue, set the pace one row at a time), for each: s =
// q_i . k_lane in two interleaved partial sums over d (keys past N: -inf),
// m, p = exp(s - m), l by butterfly shuffles, p / l into q_i's first N
// floats (read already, by this warp alone), then O_i's columns lane and
// lane + 32 out.
constexpr int kShortQueries = 4;
__device__ __forceinline__ void attend_short_head_f32(const ShortLayout& L,
                                                      const ShortArgsT<float>& a, float* st,
                                                      int seq, int h, int lane) {
  constexpr int Q = kShortQueries;
  const int N = L.N;
  float* qh = st + h * L.sh;
  float kr[kHeadDim];
  const float* kp = qh + L.ko + lane * L.sr;
#pragma unroll
  for (int d = 0; d < kHeadDim; d += 4) {
    const float4 x = lane < N ? *reinterpret_cast<const float4*>(kp + d)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
    kr[d] = x.x;
    kr[d + 1] = x.y;
    kr[d + 2] = x.z;
    kr[d + 3] = x.w;
  }
  float vr[kShortMaxKeys][2];
#pragma unroll
  for (int j = 0; j < kShortMaxKeys; ++j)
    if (j < N) {
      vr[j][0] = qh[L.vo + j * L.sr + lane];
      vr[j][1] = qh[L.vo + j * L.sr + lane + 32];
    }
  float* og = a.out + (size_t)seq * N * L.C + h * kHeadDim;
  for (int i0 = 0; i0 < N; i0 += Q) {
    // the rows i0 .. i0 + Q - 1, those past N read as row N - 1 (and dropped)
    float* qi[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) qi[q] = qh + min(i0 + q, N - 1) * L.sr;
    float s0[Q], s1[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) s0[q] = s1[q] = 0.f;
#pragma unroll
    for (int d = 0; d < kHeadDim; d += 4)
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(qi[q] + d);
        s0[q] = fmaf(x.x, kr[d], s0[q]);
        s1[q] = fmaf(x.y, kr[d + 1], s1[q]);
        s0[q] = fmaf(x.z, kr[d + 2], s0[q]);
        s1[q] = fmaf(x.w, kr[d + 3], s1[q]);
      }
    float p[Q], m[Q], l[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) m[q] = p[q] = lane < N ? (s0[q] + s1[q]) * a.scale : -INFINITY;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < Q; ++q) m[q] = fmaxf(m[q], __shfl_xor_sync(0xffffffffu, m[q], o));
#pragma unroll
    for (int q = 0; q < Q; ++q) l[q] = p[q] = lane < N ? expf(p[q] - m[q]) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int q = 0; q < Q; ++q) l[q] += __shfl_xor_sync(0xffffffffu, l[q], o);
    __syncwarp();  // every lane has read the rows
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (lane < N && i0 + q < N) qi[q][lane] = p[q] / l[q];
    __syncwarp();
    float o0[Q], o1[Q];
#pragma unroll
    for (int q = 0; q < Q; ++q) o0[q] = o1[q] = 0.f;
#pragma unroll
    for (int j = 0; j < kShortMaxKeys; j += 4) {
      if (j >= N) break;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 pp = *reinterpret_cast<const float4*>(qi[q] + j);
        const float pj[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < N) {
            o0[q] = fmaf(pj[e], vr[j + e][0], o0[q]);
            o1[q] = fmaf(pj[e], vr[j + e][1], o1[q]);
          }
      }
    }
#pragma unroll
    for (int q = 0; q < Q; ++q)
      if (i0 + q < N) {
        og[(size_t)(i0 + q) * L.C + lane] = o0[q];
        og[(size_t)(i0 + q) * L.C + lane + 32] = o1[q];
      }
  }
}

// The short tile's walk over the a.R sequences: blocks take the tiles
// blockIdx.x, + gridDim.x, ..., through the ring of L.stages stages at
// smem + kShortHeader (L.total bytes in all). Every thread of the block
// calls it; the memory is free for the caller on return. The inputs may
// have been written by other blocks before a grid barrier (the
// depth-resident kernel), the outputs are plain stores.
template <typename T>
__device__ __forceinline__ void attend_short_walk(const ShortLayout& L, const ShortArgsT<T>& a,
                                                  unsigned char* smem) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const uint32_t bars = smem_addr(smem);
  bf16* zero = reinterpret_cast<bf16*>(smem + kShortZero);
  unsigned char* ring = smem + kShortHeader;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kShortMaxStages + s); };
  // on warp 0: start tile t's copies into stage s
  auto issue = [&](int t, int s) {
    if (lane == 0) mbar_expect_tx(full(s), L.tile_bytes);
    __syncwarp();
    const uint32_t dst = smem_addr(ring + (size_t)s * L.stage_bytes);
    for (int c = lane; c < L.ncopy; c += 32) {
      const int o = c / L.N, r = c - o * L.N;
      const T* src = L.src == kShortPacked     ? a.q
                     : L.src == kShortSeparate ? (o == 0 ? a.q : o == 1 ? a.k : a.v)
                                               : a.q + o * L.hstride;
      bulk_load(dst + sizeof(T) * (o * L.dso + r * L.sr), src + ((size_t)t * L.N + r) * L.ld,
                L.copy_bytes, full(s));
    }
  };
  if (threadIdx.x < kHeadDim * sizeof(bf16) / 16)
    reinterpret_cast<uint4*>(zero)[threadIdx.x] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();  // earlier generic writes to the ring before the copies'
  if (threadIdx.x == 0) {
    for (int s = 0; s < L.stages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == 0) {
    fence_proxy_async_global();  // inputs other blocks wrote, before the copies read them
    for (int i = 0; i < L.stages; ++i)
      if (blockIdx.x + i * gridDim.x < a.R) issue(blockIdx.x + i * gridDim.x, i);
  }
  for (int i = 0, t = blockIdx.x; t < a.R; ++i, t += gridDim.x) {
    const int s = i % L.stages;
    const uint32_t parity = (i / L.stages) & 1;
    mbar_wait(full(s), parity);
    T* st = reinterpret_cast<T*>(ring + (size_t)s * L.stage_bytes);
    for (int h = warp; h < L.heads; h += kWarps) {
      if constexpr (std::is_same<T, float>::value)
        attend_short_head_f32(L, a, st, t, h, lane);
      else
        attend_short_head(L, a, st, zero, t, h, lane);
    }
    fence_proxy_async();  // the staged outputs before the stage's next copies
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    const int tn = t + L.stages * gridDim.x;
    if (warp == 0 && tn < a.R) {
      mbar_wait(empty(s), parity);
      issue(tn, s);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0)
    for (int s = 0; s < L.stages; ++s) {
      mbar_inval(full(s));
      mbar_inval(empty(s));
    }
  __syncthreads();
}

// The short tile's launch: a persistent grid, kMinBlocks blocks an SM (the
// registers' cap: kShortBlocks in bf16, 1 in fp32).
template <typename T, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
attend_short_kernel(const __grid_constant__ ShortArgsT<T> a,
                    const __grid_constant__ ShortLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend_short_walk(L, a, smem);
}

// fp32's tensor-core walk, a persistent grid of one block an SM
// (f32_attn_layout)
template <int RB>
__global__ void __launch_bounds__(kThreads, 1)
attend_f32_kernel(const float* q, const float* k, const float* v, long long hs, int ld,
                  float* out, int R, int N, int C, int heads, float scale, F32AttnLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend_f32_walk<RB>(q, k, v, hs, ld, out, R, N, C, heads, scale, L, smem);
}

// The tensor-core tile's walk: blocks take the tiles blockIdx.x, + gridDim.x,
// ... (head fastest, then sequence, then query block) with two buffers of
// L.total bytes at smem. Each tile starts the next one's copies into the
// other buffer once its own have landed, so pass 0's P.V and the later
// passes run while the next tile's keys and values arrive: one block fills
// an SM (255 registers a thread), so no other block hides the copies.
// KF == NKF keeps S whole in registers (the standalone launch); KF <
// NKF computes it in parts of KF fragments (the depth-resident kernel, which
// inlines the walk beside its other phases), with the same bits. hs: see
// launch_attend.
constexpr int kResidentFrags = 4;
template <int NKF, int KF>
__device__ __forceinline__ void attend_mma_walk(const bf16* q, const bf16* k, const bf16* v,
                                                long long hs, int ld, bf16* out, int R, int N,
                                                int C, int heads, float scale, const AttnLayout& L,
                                                const AttnOpts& opts, unsigned char* smem) {
  const int n = R * heads * cdiv(N, L.QB);
  auto copy = [&](int t, unsigned char* buf) {
    const int h = t % heads;
    const long long o = h * hs;
    attend_mma_copy<NKF>(q + o, k + o, v + o, ld, N, L, opts.mask_block, buf, t / heads % R, h,
                         t / (heads * R));
  };
  int t = blockIdx.x;
  if (t < n) copy(t, smem);
  for (int i = 0; t < n; ++i, t += gridDim.x) {
    const int tn = t + gridDim.x;
    auto next = [&] {
      if (tn < n) copy(tn, smem + ((i + 1) & 1) * L.total);
    };
    unsigned char* buf = smem + (i & 1) * L.total;
    if constexpr (KF == NKF)
      attend_mma_compute<NKF>(out, N, C, scale, L, opts, buf, t / heads % R, t % heads,
                              t / (heads * R), next);
    else
      attend_mma_compute_parts<NKF, KF>(out, N, C, scale, L, opts, buf, t / heads % R,
                                        t % heads, t / (heads * R), next);
    __syncthreads();  // the tile after next overwrites this buffer
  }
}

// The tensor-core tile's launch: a persistent grid of one block an SM.
template <int NKF>
__global__ void __launch_bounds__(kThreads)
attend_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, long long hs, int ld, bf16* __restrict__ out,
                  int R, int N, int C, int heads, float scale, AttnLayout L, AttnOpts opts) {
  extern __shared__ __align__(128) unsigned char smem[];
  attend_mma_walk<NKF, NKF>(q, k, v, hs, ld, out, R, N, C, heads, scale, L, opts, smem);
}

// The blocks of a persistent grid over n_tiles tiles: as many as fit on
// the device's SMs at smem bytes a block (one an SM for the bf16 walks), at
// most n_tiles; also raises the kernel's dynamic shared-memory limit.
template <typename Kernel>
cudaError_t persistent_grid(Kernel kernel, int smem, int n_tiles, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int dev = 0, sms = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem)) !=
      cudaSuccess)
    return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = std::min(n_tiles, per_sm * sms);
  return cudaSuccess;
}

template <int RB>
cudaError_t launch_attend_f32(const float* q, const float* k, const float* v, long long hs,
                              int ld, float* out, int R, int N, int C, int heads, float scale,
                              const F32AttnLayout& L, cudaStream_t stream) {
  const long long n = (long long)R * heads;
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = persistent_grid(attend_f32_kernel<RB>, (int)L.total, (int)n, &blocks);
  if (e != cudaSuccess) return e;
  attend_f32_kernel<RB><<<blocks, kThreads, L.total, stream>>>(q, k, v, hs, ld, out, R, N, C,
                                                               heads, scale, L);
  return cudaGetLastError();
}

template <int NKF>
cudaError_t launch_attend_mma(const bf16* q, const bf16* k, const bf16* v, long long hs, int ld,
                              bf16* out, int R, int N, int C, int heads, float scale,
                              const AttnLayout& L, const AttnOpts& opts, cudaStream_t stream) {
  const long long n = (long long)R * heads * cdiv(N, L.QB);
  if (n > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = (int)(2 * L.total);
  int blocks = 0;
  const cudaError_t e = persistent_grid(attend_mma_kernel<NKF>, smem, (int)n, &blocks);
  if (e != cudaSuccess) return e;
  attend_mma_kernel<NKF><<<blocks, kThreads, smem, stream>>>(q, k, v, hs, ld, out, R, N, C,
                                                             heads, scale, L, opts);
  return cudaGetLastError();
}

// The short tile over R sequences (launch_attend's arguments): q, k, v are
// the packed layout (hs = 0, ld = 3C, k = q + C, v = q + 2C), separate
// tensors (hs = 0, ld = C) or head-major slabs (hs != 0, ld = 3 x 64,
// k = q + 64, v = q + 128); anything else, or a pointer off 16 bytes, is an
// error to the caller. (A template, so that only the sources that launch
// it compile the kernel.)
template <typename T, int kMinBlocks = std::is_same<T, bf16>::value ? kShortBlocks : 1>
cudaError_t launch_attend_short(const T* q, const T* k, const T* v, long long hs, int ld, T* out,
                                int R, int N, int C, int heads, float scale,
                                const AttnOpts& opts, cudaStream_t stream) {
  int src;
  if (hs != 0)
    src = ld == 3 * kHeadDim && k == q + kHeadDim && v == q + 2 * kHeadDim ? kShortHeadMajor : -1;
  else if (ld == 3 * C && k == q + C && v == q + 2 * C)
    src = kShortPacked;
  else
    src = ld == C ? kShortSeparate : -1;
  auto off16 = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
  if (src < 0 || R < 1 || N < 1 || heads * kHeadDim != C || off16(q) || off16(k) || off16(v) ||
      off16(out))
    return cudaErrorInvalidValue;
  ShortLayout L;
  if (!short_layout<T>(L, src, N, C, heads, ld, hs + kHeadDim, kSmemPerBlock, kShortStages))
    return cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t e = persistent_grid(attend_short_kernel<T, kMinBlocks>, L.total, R, &blocks);
  if (e != cudaSuccess) return e;
  attend_short_kernel<T, kMinBlocks><<<blocks, kThreads, L.total, stream>>>(
      ShortArgsT<T>{q, k, v, out, R, scale, opts}, L);
  return cudaGetLastError();
}

// Launch the attention over R sequences of N tokens, heads of kHeadDim. A
// tile reads head h at column h * kHeadDim of rows of ld elements; hs is a
// further offset of h * hs elements (0 for token rows holding every head;
// the head-major slabs of attention_stage.cu, one per head, M * 3d apart).
// Unmasked at N <= 32 keys, the short tile (both dtypes); else bf16 its
// tensor-core tile, fp32 its tensor-core walk (tf32x3). fp32 masked (the
// grouped lab switch): the short tile over the R * N / mask_block blocks of
// mask_block tokens, which the rows hold in order (a sequence of N is N /
// mask_block of them): under JAX's -1e30 block mask p of every key outside a
// query's own block is 0 exactly, so the fold's softmax is its block's, and
// the tile reads no masked key.
template <typename T>
cudaError_t launch_attend(const T* q, const T* k, const T* v, int ld, T* out, int R, int N,
                          int C, int heads, float scale, const AttnOpts& opts,
                          cudaStream_t stream, long long hs = 0) {
  if (attend_short_ok(N, opts.mask_block))
    return launch_attend_short<T>(q, k, v, hs, ld, out, R, N, C, heads, scale, opts, stream);
  if constexpr (std::is_same<T, bf16>::value) {
    const AttnLayout L = attn_layout_mma(N, opts.mask_block);
    switch (L.nkf) {
      case 4:
        return launch_attend_mma<4>(q, k, v, hs, ld, out, R, N, C, heads, scale, L, opts, stream);
      case 8:
        return launch_attend_mma<8>(q, k, v, hs, ld, out, R, N, C, heads, scale, L, opts, stream);
      default:
        return launch_attend_mma<16>(q, k, v, hs, ld, out, R, N, C, heads, scale, L, opts,
                                     stream);
    }
  } else if (opts.mask_block == 0) {
    const F32AttnLayout L = f32_attn_layout(N);
    if (L.rb == 1)
      return launch_attend_f32<1>(q, k, v, hs, ld, out, R, N, C, heads, scale, L, stream);
    return launch_attend_f32<2>(q, k, v, hs, ld, out, R, N, C, heads, scale, L, stream);
  } else {
    const int mb = opts.mask_block;
    if (mb > kShortMaxKeys || N % mb || (long long)R * (N / mb) > 0x7fffffffLL)
      return cudaErrorInvalidValue;
    AttnOpts blocks = opts;
    blocks.mask_block = 0;
    return launch_attend_short<T>(q, k, v, hs, ld, out, R * (N / mb), mb, C, heads, scale,
                                  blocks, stream);
  }
}

// The packed (R, N, 3C) qkv layout: q | k | v thirds of each token row.
template <typename T>
cudaError_t launch_attend_packed(const T* qkv, T* out, int R, int N, int C, int heads,
                                 float scale, const AttnOpts& opts, cudaStream_t stream) {
  return launch_attend<T>(qkv, qkv + C, qkv + 2 * C, 3 * C, out, R, N, C, heads, scale, opts,
                          stream);
}

}  // namespace d3dp
