// MixSTE attention core of the training path, forward and backward, for
// Hopper (sm_90a). Heads of 64, packed qkv layout (R, N, 3C) = q | k | v.
//
//   forward  o = softmax(q k^T * scale) v per head          (R, N, 3C) -> (R, N, C)
//   backward (qkv, dO) -> d(qkv), softmax recomputed        -> (R, N, 3C)
//
// Replaces the TPU kernels of d3dp_tpu/ops/attention.py:
//   `_attn_fused_qkv_kernel` (launcher `fused_attention_qkv`), and
//   `_attn_bwd_kernel` (launcher `_fused_attention_qkv_bwd`),
// the two halves of `fused_attention_qkv_ad`; and
//   `_attn_kernel` (launcher `fused_attention_packed`), the same forward
// read from three separate packed (R, N, h*d) tensors q, k, v.
//
// What bounds them on the H100: at MixSTE's shapes (N = 17 or 243 tokens,
// d = 64) both move more bytes than the tensor cores need time for: the
// forward reads qkv and writes o (about 1.8 FLOPs per byte at N=17 and 30
// at N=243, both far under the card's ~295), the backward reads qkv and dO
// and writes d(qkv). Logits never leave the chip.
//
// Forward: `attend_kernel` (common.cuh), shared with the attention stage
// and block, with p divided by l BEFORE the cast to the compute type, as the
// TPU kernel's `_attn_head` does (the stage folds 1/l in after P.V instead).
// The packed-qkv forward reads rows of 3C; the separate-q/k/v forward (K7)
// reads rows of C: same kernel, same bound (bytes: 4*T*C elements moved
// against 4*T*N*C FLOPs). What the tile does about it: in bf16 above 32 keys
// a tile is a whole (sequence, head), so each key and value row is read
// once (cp.async in 64-key groups, the products on the first keys start
// while the rest land), and the logits, the exact softmax and P never leave
// registers (mma.sync m16n8k16, 16 query rows a warp); a persistent grid
// copies the next tile while the current one computes. At 17 keys the
// shared-memory body stays: one 32-query block per (sequence, head), small
// enough for several per SM.
// `d3dp_attend_packed_*` launches the same tile in the stage's order, with
// its switches: K1's attend launch alone, for timing and tests.
//
// Backward. The TPU kernel holds a whole (sequence, head) in VMEM: P, dP and
// the dK, dV sums over all query rows. At N=243 that does not fit a block's
// 227 KB (the fp32 dK and dV sums alone are 128 KB), and blocks run in
// parallel with no order, so nothing can be carried from one query block to
// the next. The backward therefore runs as two launches over the same grid
// (sequence, head, block of RB rows), RB = 32 in bf16 and 16 in fp32, each
// block holding its own RB rows and ALL rows of the other side (<=256, tail
// zero-filled) in shared memory:
//   1. query pass: for RB query rows against all keys, S = Q K^T and
//      dP = dO V^T, the exact softmax P = exp(S*scale - m) / l, the row sum
//      D = rowsum(dP o P), dS = P o (dP - D) * scale (cast to the compute
//      type) and dQ = dS K. Writes dQ and the row statistics (m, l, D) to a
//      scratch buffer (3 floats per query row and head).
//   2. key pass: for RB key rows against all queries, S^T = K Q^T and
//      dP^T = V dO^T; P^T is recomputed from S^T with the saved (m, l), then
//      dS^T from dP^T and the saved D; dV = bf16(P)^T dO and dK = dS^T Q.
// Every output element is written once, by one block: no atomics, and the
// result does not depend on the blocks' order. Keys and queries past N are
// zero rows with P = 0 and dS = 0, and rows past N are not written.
// bf16 products run on the tensor cores (wmma 16x16x16, fp32 accumulation);
// fp32 runs in plain fp32 FMAs (the TPU kernel's Precision.HIGHEST).
#include "common.cuh"

namespace d3dp {

// --------------------------------------------------------- block products
// Out[r][c] (fp32, ldo) = sum_d A[r][d] * B[c][d] over the 64-wide head,
// for r < R, c < NC (multiples of 16 for bf16).
__device__ __forceinline__ void mm_abt(const float* A, int lda, const float* B, int ldb, int R,
                                       int NC, float* Out, int ldo) {
  for (int i = threadIdx.x; i < R * NC; i += kThreads) {
    const int r = i / NC, c = i % NC;
    const float* a = A + r * lda;
    const float* b = B + c * ldb;
    float acc = 0.f;
#pragma unroll 16
    for (int d = 0; d < kHeadDim; ++d) acc = fmaf(a[d], b[d], acc);
    Out[r * ldo + c] = acc;
  }
}
__device__ __forceinline__ void mm_abt(const bf16* A, int lda, const bf16* B, int ldb, int R,
                                       int NC, float* Out, int ldo) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  const int nfc = NC / 16;
  for (int f = warp; f < (R / 16) * nfc; f += kWarps) {
    const int fr = f / nfc, fc = f % nfc;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < kHeadDim; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
      wmma::load_matrix_sync(a, A + fr * 16 * lda + kk, lda);
      wmma::load_matrix_sync(b, B + fc * 16 * ldb + kk, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Out + fr * 16 * ldo + fc * 16, acc, ldo, wmma::mem_row_major);
  }
}

// Out[r][d] (fp32, ldo) = sum_{c < NC} P[r][c] * B[c][d], d < 64.
__device__ __forceinline__ void mm_pb(const float* P, int ldp, const float* B, int ldb, int R,
                                      int NC, float* Out, int ldo) {
  for (int i = threadIdx.x; i < R * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    const float* p = P + r * ldp;
    float acc = 0.f;
    for (int c = 0; c < NC; ++c) acc = fmaf(p[c], B[c * ldb + d], acc);
    Out[r * ldo + d] = acc;
  }
}
__device__ __forceinline__ void mm_pb(const bf16* P, int ldp, const bf16* B, int ldb, int R,
                                      int NC, float* Out, int ldo) {
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  constexpr int nfd = kHeadDim / 16;
  for (int f = warp; f < (R / 16) * nfd; f += kWarps) {
    const int fr = f / nfd, fd = f % nfd;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < NC; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
      wmma::load_matrix_sync(a, P + fr * 16 * ldp + kk, ldp);
      wmma::load_matrix_sync(b, B + kk * ldb + fd * 16, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(Out + fr * 16 * ldo + fd * 16, acc, ldo, wmma::mem_row_major);
  }
}

// ------------------------------------------------------------- backward
// Shared-memory layout of one backward block: RB own rows (X1, X2) against
// the NP (padded) rows of the other side (Y1, Y2).
struct BwdLayout {
  int RB, NP, ldx, lds, ldp;
  size_t x1, x2, y1, y2, s, dp, pb, dsb, o1, o2, stats, total;
};

constexpr int kLdo = kHeadDim + 4;

template <typename T>
BwdLayout bwd_layout(int N) {
  constexpr bool f32 = std::is_same<T, float>::value;
  BwdLayout L;
  L.NP = cdiv(N, 16) * 16;
  const int rows = f32 ? kF32Rows : 32;  // own rows a block: 16 in fp32, 32 in bf16
  L.RB = rows < L.NP ? rows : L.NP;
  // fp32 walks rows of both X and Y per thread: an odd stride spreads them
  // over the banks. bf16 rows keep wmma's 16-byte multiple.
  L.ldx = f32 ? kHeadDim + 1 : kHeadDim + 8;
  L.lds = L.NP + 4;
  L.ldp = L.NP + 8;
  size_t off = 0;
  L.x1 = off; off += align128(sizeof(T) * L.RB * L.ldx);
  L.x2 = off; off += align128(sizeof(T) * L.RB * L.ldx);
  L.y1 = off; off += align128(sizeof(T) * L.NP * L.ldx);
  L.y2 = off; off += align128(sizeof(T) * L.NP * L.ldx);
  L.s = off; off += align128(sizeof(float) * L.RB * L.lds);
  L.dp = off; off += align128(sizeof(float) * L.RB * L.lds);
  L.pb = off; off += f32 ? 0 : align128(sizeof(bf16) * L.RB * L.ldp);
  L.dsb = off; off += f32 ? 0 : align128(sizeof(bf16) * L.RB * L.ldp);
  L.o1 = off; off += align128(sizeof(float) * L.RB * kLdo);
  L.o2 = off; off += align128(sizeof(float) * L.RB * kLdo);
  L.stats = off; off += align128(sizeof(float) * 3 * L.NP);
  L.total = off;
  return L;
}

// grid (sequence, head, row block). kKeys = false: the query pass (dQ and
// the row statistics); true: the key pass (dK, dV). stats: per (sequence,
// head) three runs of N floats, m | l | D.
template <typename T, bool kKeys>
__global__ void __launch_bounds__(kThreads)
attn_bwd_kernel(const T* __restrict__ qkv, const T* __restrict__ dout, T* __restrict__ dqkv,
                float* __restrict__ stats, int N, int C, float scale, BwdLayout L) {
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* X1 = reinterpret_cast<T*>(smem + L.x1);
  T* X2 = reinterpret_cast<T*>(smem + L.x2);
  T* Y1 = reinterpret_cast<T*>(smem + L.y1);
  T* Y2 = reinterpret_cast<T*>(smem + L.y2);
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* dP = reinterpret_cast<float*>(smem + L.dp);
  float* O1 = reinterpret_cast<float*>(smem + L.o1);
  float* O2 = reinterpret_cast<float*>(smem + L.o2);
  float* Ms = reinterpret_cast<float*>(smem + L.stats);
  float* Ls = Ms + L.NP;
  float* Ds = Ls + L.NP;

  const int seq = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * L.RB;
  const int RB = L.RB, NP = L.NP, ldx = L.ldx, lds = L.lds, ldp = L.ldp;
  const int ld3 = 3 * C;
  const T* qb = qkv + (size_t)seq * N * ld3 + h * kHeadDim;  // q; k at +C, v at +2C
  const T* ob = dout + (size_t)seq * N * C + h * kHeadDim;
  // own rows X1, X2 and the other side's Y1, Y2:
  //   query pass: X = (Q, dO), Y = (K, V);  key pass: X = (K, V), Y = (Q, dO)
  const T* x1g = kKeys ? qb + C : qb;
  const T* x2g = kKeys ? qb + 2 * C : ob;
  const int ldx2 = kKeys ? ld3 : C;
  const T* y1g = kKeys ? qb : qb + C;
  const T* y2g = kKeys ? ob : qb + 2 * C;
  const int ldy2 = kKeys ? C : ld3;
  load_rows(X1, ldx, x1g + (size_t)r0 * ld3, ld3, RB, N - r0, kHeadDim);
  load_rows(X2, ldx, x2g + (size_t)r0 * ldx2, ldx2, RB, N - r0, kHeadDim);
  load_rows(Y1, ldx, y1g, ld3, NP, N, kHeadDim);
  load_rows(Y2, ldx, y2g, ldy2, NP, N, kHeadDim);
  float* st = stats + ((size_t)seq * gridDim.y + h) * 3 * N;
  if constexpr (kKeys) {
    for (int i = threadIdx.x; i < NP; i += kThreads) {
      Ms[i] = i < N ? st[i] : 0.f;
      Ls[i] = i < N ? st[N + i] : 1.f;
      Ds[i] = i < N ? st[2 * N + i] : 0.f;
    }
  }
  __syncthreads();

  mm_abt(X1, ldx, Y1, ldx, RB, NP, S, lds);   // Q K^T  | K Q^T
  mm_abt(X2, ldx, Y2, ldx, RB, NP, dP, lds);  // dO V^T | V dO^T
  __syncthreads();

  bf16* Pb = reinterpret_cast<bf16*>(smem + L.pb);
  bf16* dSb = reinterpret_cast<bf16*>(smem + L.dsb);
  if constexpr (!kKeys) {
    // one warp per query row: exact softmax, D = rowsum(dP o P), dS
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int r = warp; r < RB; r += kWarps) {
      float* srow = S + r * lds;
      float* drow = dP + r * lds;
      float m = -INFINITY;
      for (int j = lane; j < N; j += 32) {
        const float s = srow[j] * scale;
        srow[j] = s;
        m = fmaxf(m, s);
      }
      m = warp_max(m);
      float l = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float e = expf(srow[j] - m);
        srow[j] = e;
        l += e;
      }
      l = warp_sum(l);
      float dsum = 0.f;
      for (int j = lane; j < N; j += 32) {
        const float p = srow[j] / l;
        srow[j] = p;
        dsum += drow[j] * p;
      }
      dsum = warp_sum(dsum);
      for (int j = lane; j < NP; j += 32) {
        const float ds = j < N ? srow[j] * (drow[j] - dsum) * scale : 0.f;
        if constexpr (f32) drow[j] = ds;
        else dSb[r * ldp + j] = __float2bfloat16(ds);
      }
      if (lane == 0 && r0 + r < N) {
        st[r0 + r] = m;
        st[N + r0 + r] = l;
        st[2 * N + r0 + r] = dsum;
      }
    }
  } else {
    // P^T and dS^T from the query rows' saved statistics; the product is
    // rounded before the subtraction, as in the query pass
    for (int i = threadIdx.x; i < RB * NP; i += kThreads) {
      const int r = i / NP, c = i % NP;
      float p = 0.f, ds = 0.f;
      if (c < N) {
        const float s = __fmul_rn(S[r * lds + c], scale);
        p = expf(s - Ms[c]) / Ls[c];
        ds = p * (dP[r * lds + c] - Ds[c]) * scale;
      }
      if constexpr (f32) {
        S[r * lds + c] = p;
        dP[r * lds + c] = ds;
      } else {
        Pb[r * ldp + c] = __float2bfloat16(p);
        dSb[r * ldp + c] = __float2bfloat16(ds);
      }
    }
  }
  __syncthreads();

  const T* dSop;
  const T* Pop;
  if constexpr (f32) {
    dSop = dP;
    Pop = S;
  } else {
    dSop = dSb;
    Pop = Pb;
  }
  const int ldop = f32 ? lds : ldp;
  mm_pb(dSop, ldop, Y1, ldx, RB, NP, O1, kLdo);                // dQ = dS K | dK = dS^T Q
  if constexpr (kKeys) mm_pb(Pop, ldop, Y2, ldx, RB, NP, O2, kLdo);  // dV = P^T dO
  __syncthreads();

  const int nown = min(RB, N - r0);
  T* g = dqkv + ((size_t)seq * N + r0) * ld3 + h * kHeadDim + (kKeys ? C : 0);
  for (int i = threadIdx.x; i < nown * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    g[(size_t)r * ld3 + d] = from_f<T>(O1[r * kLdo + d]);
    if constexpr (kKeys) g[(size_t)r * ld3 + C + d] = from_f<T>(O2[r * kLdo + d]);
  }
}

// ---------------------------------------------------------------- host entry
inline bool shapes_ok(int R, int N, int C, int heads) {
  return R >= 1 && N >= 1 && N <= kMaxKeys && C % 64 == 0 && heads * kHeadDim == C &&
         heads <= 65535 && (size_t)R * N * 3 * C < ((size_t)1 << 40);
}

template <typename T>
int attention_qkv_fwd(const void* qkv, void* out, int R, int N, int C, int heads, float scale,
                      void* stream) {
  if (!shapes_ok(R, N, C, heads)) return (int)cudaErrorInvalidValue;
  return (int)launch_attend_packed<T>((const T*)qkv, (T*)out, R, N, C, heads, scale,
                                      norm_first_opts(), static_cast<cudaStream_t>(stream));
}

// K7: the same attention core read from separate packed q, k, v (R, N, C).
template <typename T>
int attention_packed(const void* q, const void* k, const void* v, void* out, int R, int N, int C,
                     int heads, float scale, void* stream) {
  if (!shapes_ok(R, N, C, heads)) return (int)cudaErrorInvalidValue;
  return (int)launch_attend<T>((const T*)q, (const T*)k, (const T*)v, C, (T*)out, R, N, C, heads,
                               scale, norm_first_opts(), static_cast<cudaStream_t>(stream));
}

// The attention stage's attend launch alone (K1's second launch) on a packed
// qkv, with the stage's lab switches: opts (kOpt* flags) and mask_block.
template <typename T>
int attend_packed(const void* qkv, void* out, int R, int N, int C, int heads, int opts,
                  int mask_block, float scale, void* stream) {
  if (R < 1 || N < 1 || !attn_keys_ok(N, mask_block) || C % 64 != 0 || heads * kHeadDim != C ||
      heads > 65535 || R > 0x7fffffff / N)
    return (int)cudaErrorInvalidValue;
  return (int)launch_attend_packed<T>((const T*)qkv, (T*)out, R, N, C, heads, scale,
                                      attn_opts(opts, mask_block),
                                      static_cast<cudaStream_t>(stream));
}

template <typename T, bool kKeys>
cudaError_t launch_bwd(const BwdLayout& L, dim3 grid, const T* qkv, const T* dout, T* dqkv,
                       float* stats, int N, int C, float scale, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_kernel<T, kKeys>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  attn_bwd_kernel<T, kKeys><<<grid, kThreads, L.total, stream>>>(qkv, dout, dqkv, stats, N, C,
                                                                scale, L);
  return cudaGetLastError();
}

// stats: scratch of R * heads * 3 * N floats, written by the query pass and
// read by the key pass (same stream, so in order).
template <typename T>
int attention_qkv_bwd(const void* qkv, const void* dout, void* dqkv, void* stats, int R, int N,
                      int C, int heads, float scale, void* stream_) {
  if (!shapes_ok(R, N, C, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const BwdLayout L = bwd_layout<T>(N);
  const dim3 grid(R, heads, cdiv(N, L.RB));
  cudaError_t e = launch_bwd<T, false>(L, grid, (const T*)qkv, (const T*)dout, (T*)dqkv,
                                       (float*)stats, N, C, scale, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_bwd<T, true>(L, grid, (const T*)qkv, (const T*)dout, (T*)dqkv,
                                  (float*)stats, N, C, scale, stream);
}

}  // namespace d3dp

extern "C" {

int d3dp_attention_qkv_fwd_bf16(const void* qkv, void* out, int R, int N, int C, int heads,
                                float scale, void* stream) {
  return d3dp::attention_qkv_fwd<d3dp::bf16>(qkv, out, R, N, C, heads, scale, stream);
}

int d3dp_attention_qkv_fwd_f32(const void* qkv, void* out, int R, int N, int C, int heads,
                               float scale, void* stream) {
  return d3dp::attention_qkv_fwd<float>(qkv, out, R, N, C, heads, scale, stream);
}

int d3dp_attention_packed_bf16(const void* q, const void* k, const void* v, void* out, int R,
                               int N, int C, int heads, float scale, void* stream) {
  return d3dp::attention_packed<d3dp::bf16>(q, k, v, out, R, N, C, heads, scale, stream);
}

int d3dp_attention_packed_f32(const void* q, const void* k, const void* v, void* out, int R,
                              int N, int C, int heads, float scale, void* stream) {
  return d3dp::attention_packed<float>(q, k, v, out, R, N, C, heads, scale, stream);
}

int d3dp_attend_packed_bf16(const void* qkv, void* out, int R, int N, int C, int heads, int opts,
                            int mask_block, float scale, void* stream) {
  return d3dp::attend_packed<d3dp::bf16>(qkv, out, R, N, C, heads, opts, mask_block, scale,
                                         stream);
}

int d3dp_attend_packed_f32(const void* qkv, void* out, int R, int N, int C, int heads, int opts,
                           int mask_block, float scale, void* stream) {
  return d3dp::attend_packed<float>(qkv, out, R, N, C, heads, opts, mask_block, scale, stream);
}

int d3dp_attention_qkv_bwd_bf16(const void* qkv, const void* dout, void* dqkv, void* stats,
                                int R, int N, int C, int heads, float scale, void* stream) {
  return d3dp::attention_qkv_bwd<d3dp::bf16>(qkv, dout, dqkv, stats, R, N, C, heads, scale,
                                             stream);
}

int d3dp_attention_qkv_bwd_f32(const void* qkv, const void* dout, void* dqkv, void* stats,
                               int R, int N, int C, int heads, float scale, void* stream) {
  return d3dp::attention_qkv_bwd<float>(qkv, dout, dqkv, stats, R, N, C, heads, scale, stream);
}

}  // extern "C"
