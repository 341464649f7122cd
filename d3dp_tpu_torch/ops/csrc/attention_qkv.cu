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
// forward reads qkv and writes o (N / 2 FLOPs per byte: 8.5 at N=17 and
// 121.5 at N=243, both under the card's ~295), the backward reads qkv and dO
// and writes d(qkv). Logits never leave the chip.
//
// Forward: `launch_attend` (common.cuh), shared with the attention stage
// and block, with p divided by l BEFORE the cast to the compute type, as the
// TPU kernel's `_attn_head` does (the stage folds 1/l in after P.V instead).
// The packed-qkv forward reads rows of 3C; the separate-q/k/v forward (K7)
// reads rows of C: same kernel, same bound (bytes: 4*T*C elements moved
// against 4*T*N*C FLOPs). What the tile does about it: in bf16 above 32 keys
// a tile is a whole (sequence, head), so each key and value row is read
// once (cp.async in 64-key groups, the products on the first keys start
// while the rest land), and the logits, the exact softmax and P never leave
// registers (mma.sync m16n8k16, 16 query rows a warp); a persistent grid
// copies the next tile while the current one computes. At 32 keys or fewer
// (the spatial 17) the short tile: a sequence with all its heads a tile,
// its rows brought by bulk copies into a ring that runs ahead of the
// warps, a warp a head (`attend_short_walk`). fp32 runs its tensor-core
// tile in three TF32 passes (`attend_f32_walk`; masked: the shared-memory
// body).
// `d3dp_attend_packed_*` launches the same tile in the stage's order, with
// its switches: K1's attend launch alone, for timing and tests.
//
// Backward, `_attn_bwd_kernel`: d(qkv) from qkv and dO, softmax recomputed.
// It reads qkv and dO once and writes d(qkv) once: 118 MB at the train
// step's shapes (68 x 243 or 972 x 17 tokens, C = 512), 0.035 ms at the
// card's 3.35 TB/s, against 20.6 GFLOP (0.021 ms of bf16 tensor-core time;
// 36.5 GFLOP as the tiles pad 243 keys to 256). Bytes bound it, so each
// operand row is read once per (sequence, head) and nothing else goes
// through device memory.
//
// bf16: one launch, and one tile is one (sequence, head): its Q, K, V and dO
// rows (<=256 each, tail zero-filled) are read once into shared memory by
// cp.async, Q and K first, so the logits start while V and dO land. The
// fp32 logits, P, dP and dS never leave registers: an accumulator's layout
// is the A layout of the next product, so P and dS become bf16 A fragments
// where they are formed, and the row statistics (m, 1 / l, D) stay in
// shared memory.
//   1. query phase, by 64 (or 16) query rows: S = Q K^T whole in registers,
//      the exact softmax by row (quad shuffles), P = e / l as e times 1 / l;
//      dP = dO V^T in 64-key blocks and D = rowsum(dP o P) from the fp32
//      values; then the blocks again, dP recomputed (cheaper than a second
//      whole-row accumulator), dS = bf16(P o (dP - D) * scale) and
//      dQ += dS K_block. dQ goes out, the statistics to shared memory.
//   2. key phase, after one barrier, by 64 (or 16) key rows, over 64-query
//      blocks: S^T = K Q_b^T and dP^T = V dO_b^T, P^T and dS^T elementwise
//      from the queries' statistics (phase 1's operations, so the same p),
//      dV += bf16(P^T) dO_b and dK += dS^T Q_b.
// That is 8 products of N x N x 64 a tile, all on the tensor cores. Above
// 32 keys a block of two warpgroups
// takes a tile: the rows in the 128-byte swizzled layout (128 KB at 256
// keys), every product a wgmma m64n64k16, S^T, dP^T, S and dP with both
// operands in shared memory, dQ, dV and dK with A (dS, P) from registers;
// one block an SM, one block a tile (the scheduler refills each SM as a
// tile ends: no second tile's buffers fit beside it). At 32 keys or fewer
// a warp takes a tile on mma.sync m16n8k16 from ldmatrix fragments, rows
// of kLdh, every product over all keys at once; 4 tiles a block, 3 blocks
// an SM. Every output element is written once, by one warp: no atomics,
// and the result does not depend on the order of tiles or on R. Keys past
// N get s = -inf (p = 0), queries past N p = dS = 0 by index, and rows past
// N are not written.
//
// fp32 (the Precision.HIGHEST parity path) keeps two launches of plain FMAs
// over the grid (sequence, head, block of 16 rows), each block holding its
// own rows and all rows of the other side: a query pass (dQ, and the row
// statistics (m, l, D) to a scratch of 3 floats a query row and head) and a
// key pass (dK, dV from the saved statistics). Q, K, V and dO of 256 rows
// in fp32 (256 KB) exceed a block's 227 KB, so one tile cannot hold them.
#include "mlp.cuh"

namespace d3dp {

// ------------------------------------------------------- backward, fp32
// Out[r][c] (ldo) = sum_d A[r][d] * B[c][d] over the 64-wide head, r < R,
// c < NC.
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

// Out[r][d] (ldo) = sum_{c < NC} P[r][c] * B[c][d], d < 64.
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

// Shared-memory layout of one fp32 backward block: RB own rows (X1, X2)
// against the NP (padded) rows of the other side (Y1, Y2).
struct BwdLayout {
  int RB, NP, ldx, lds;
  size_t x1, x2, y1, y2, s, dp, o1, o2, stats, total;
};

constexpr int kLdo = kHeadDim + 4;

inline BwdLayout bwd_layout_f32(int N) {
  BwdLayout L;
  L.NP = cdiv(N, 16) * 16;
  L.RB = kF32Rows < L.NP ? kF32Rows : L.NP;
  // threads walk rows of both X and Y: an odd stride spreads them over the
  // banks
  L.ldx = kHeadDim + 1;
  L.lds = L.NP + 4;
  size_t off = 0;
  L.x1 = off; off += align128(sizeof(float) * L.RB * L.ldx);
  L.x2 = off; off += align128(sizeof(float) * L.RB * L.ldx);
  L.y1 = off; off += align128(sizeof(float) * L.NP * L.ldx);
  L.y2 = off; off += align128(sizeof(float) * L.NP * L.ldx);
  L.s = off; off += align128(sizeof(float) * L.RB * L.lds);
  L.dp = off; off += align128(sizeof(float) * L.RB * L.lds);
  L.o1 = off; off += align128(sizeof(float) * L.RB * kLdo);
  L.o2 = off; off += align128(sizeof(float) * L.RB * kLdo);
  L.stats = off; off += align128(sizeof(float) * 3 * L.NP);
  L.total = off;
  return L;
}

// grid (sequence, head, row block). kKeys = false: the query pass (dQ and
// the row statistics); true: the key pass (dK, dV). stats: per (sequence,
// head) three runs of N floats, m | l | D.
template <bool kKeys>
__global__ void __launch_bounds__(kThreads)
attn_bwd_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                    float* __restrict__ dqkv, float* __restrict__ stats, int N, int C,
                    float scale, BwdLayout L) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* X1 = reinterpret_cast<float*>(smem + L.x1);
  float* X2 = reinterpret_cast<float*>(smem + L.x2);
  float* Y1 = reinterpret_cast<float*>(smem + L.y1);
  float* Y2 = reinterpret_cast<float*>(smem + L.y2);
  float* S = reinterpret_cast<float*>(smem + L.s);
  float* dP = reinterpret_cast<float*>(smem + L.dp);
  float* O1 = reinterpret_cast<float*>(smem + L.o1);
  float* O2 = reinterpret_cast<float*>(smem + L.o2);
  float* Ms = reinterpret_cast<float*>(smem + L.stats);
  float* Ls = Ms + L.NP;
  float* Ds = Ls + L.NP;

  const int seq = blockIdx.x, h = blockIdx.y, r0 = blockIdx.z * L.RB;
  const int RB = L.RB, NP = L.NP, ldx = L.ldx, lds = L.lds;
  const int ld3 = 3 * C;
  const float* qb = qkv + (size_t)seq * N * ld3 + h * kHeadDim;  // q; k at +C, v at +2C
  const float* ob = dout + (size_t)seq * N * C + h * kHeadDim;
  // own rows X1, X2 and the other side's Y1, Y2:
  //   query pass: X = (Q, dO), Y = (K, V);  key pass: X = (K, V), Y = (Q, dO)
  const float* x1g = kKeys ? qb + C : qb;
  const float* x2g = kKeys ? qb + 2 * C : ob;
  const int ldx2 = kKeys ? ld3 : C;
  const float* y1g = kKeys ? qb : qb + C;
  const float* y2g = kKeys ? ob : qb + 2 * C;
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
      for (int j = lane; j < NP; j += 32)
        drow[j] = j < N ? srow[j] * (drow[j] - dsum) * scale : 0.f;
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
      S[r * lds + c] = p;
      dP[r * lds + c] = ds;
    }
  }
  __syncthreads();

  mm_pb(dP, lds, Y1, ldx, RB, NP, O1, kLdo);                // dQ = dS K | dK = dS^T Q
  if constexpr (kKeys) mm_pb(S, lds, Y2, ldx, RB, NP, O2, kLdo);  // dV = P^T dO
  __syncthreads();

  const int nown = min(RB, N - r0);
  float* g = dqkv + ((size_t)seq * N + r0) * ld3 + h * kHeadDim + (kKeys ? C : 0);
  for (int i = threadIdx.x; i < nown * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim, d = i % kHeadDim;
    g[(size_t)r * ld3 + d] = O1[r * kLdo + d];
    if constexpr (kKeys) g[(size_t)r * ld3 + C + d] = O2[r * kLdo + d];
  }
}

// ------------------------------------------------------- backward, bf16
// The elementwise arithmetic of both bf16 tiles, on a warp's 16 rows held
// as m16n8 fragments: x[j][e] at row g + 8 (e >> 1) (g = lane / 4) and
// column 8 j + 2 tq + (e & 1) (tq = lane % 4); a wgmma m64nN accumulator
// holds each warp's 16 rows of its 64 in the same layout.
constexpr float kLog2e = 1.4426950408889634f;

// a row's max, or sum, over the quad of lanes holding it
__device__ __forceinline__ void quad_max(float (&v)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 1));
    v[i] = fmaxf(v[i], __shfl_xor_sync(0xffffffffu, v[i], 2));
  }
}
__device__ __forceinline__ void quad_sum(float (&v)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 1);
    v[i] += __shfl_xor_sync(0xffffffffu, v[i], 2);
  }
}

// S (unscaled logits against keys 0, 1, ...) -> P = exp(s - m) / l in
// place, s = dot * scale, -inf past N, p / l as p times 1 / l; returns m as
// m log2(e), and 1 / l, by row
template <int KF>
__device__ __forceinline__ void bwd_softmax(float (&s)[2 * KF][4], float scale, int N, int tq,
                                            float (&ml)[2], float (&inv)[2]) {
  const int j0[2] = {0, 0}, j1[2] = {N, N};
  scale_mask<KF>(s, scale, 0, tq, j0, j1, false);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[j][e]);
  quad_max(m);
  softmax_exp<KF>(s, m, l, false, true);
  quad_sum(l);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    ml[i] = m[i] * kLog2e;  // as softmax_exp forms it
    inv[i] = 1.0f / l[i];
  }
#pragma unroll
  for (int j = 0; j < 2 * KF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
}

// D += rowsum(dP o P) over a block of keys (this thread's share)
template <int CF>
__device__ __forceinline__ void bwd_rowdot(float (&D)[2], const float (&dp)[2 * CF][4],
                                           const float (*p)[4]) {
#pragma unroll
  for (int j = 0; j < 2 * CF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) D[e >> 1] = fmaf(dp[j][e], p[j][e], D[e >> 1]);
}

// dS = bf16(P o (dP - D) * scale) as the A fragments of the next product
template <int CF>
__device__ __forceinline__ void bwd_ds(uint32_t (&dsa)[CF][4], float (&dp)[2 * CF][4],
                                       const float (*p)[4], const float (&D)[2], float scale) {
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int j = 0; j < 2 * CF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - D[e >> 1]) * scale;
  pack_p<CF>(dsa, dp, one, false);
}

// The key side: S^T and dP^T of 16 keys against queries q0 + 8 j + 2 tq +
// (e & 1) -> the A fragments of bf16(P^T) and bf16(dS^T), from the query
// rows' statistics (m log2(e) | 1 / l | D at Ml, Il, Dd): the query side's
// operations, so the same p; p = dS = 0 for queries past N.
template <int CF>
__device__ __forceinline__ void bwd_key_p_ds(uint32_t (&pa)[CF][4], uint32_t (&dsa)[CF][4],
                                             float (&st)[2 * CF][4], float (&dpt)[2 * CF][4],
                                             const float* Ml, const float* Il, const float* Dd,
                                             int q0, int N, int tq, float scale) {
  const float one[2] = {1.f, 1.f};
#pragma unroll
  for (int j = 0; j < 2 * CF; ++j) {
    const int q = q0 + 8 * j + 2 * tq;
    const float2 ml = *reinterpret_cast<const float2*>(Ml + q);
    const float2 il = *reinterpret_cast<const float2*>(Il + q);
    const float2 dd = *reinterpret_cast<const float2*>(Dd + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e & 1;
      const float x = st[j][e] * scale;
      float p = ex2_ftz(fmaf(x, kLog2e, -(hi ? ml.y : ml.x))) * (hi ? il.y : il.x);
      float ds = p * (dpt[j][e] - (hi ? dd.y : dd.x)) * scale;
      if (q + hi >= N) p = ds = 0.f;
      st[j][e] = p;
      dpt[j][e] = ds;
    }
  }
  pack_p<CF>(pa, st, one, false);
  pack_p<CF>(dsa, dpt, one, false);
}

// the statistics of rows r0 + g and r0 + g + 8, from the quad's first lane
__device__ __forceinline__ void bwd_store_stats(float* Ml, float* Il, float* Dd, int r0,
                                                const float (&ml)[2], const float (&inv)[2],
                                                const float (&D)[2], int lane) {
  if (lane % 4) return;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + lane / 4 + 8 * i;
    Ml[r] = ml[i];
    Il[r] = inv[i];
    Dd[r] = D[i];
  }
}

// Rows r0 + g and r0 + g + 8 (those below N) of a warp's 16 x 64 fp32
// accumulator, rounded to bf16, to rows of ld elements at dst.
__device__ __forceinline__ void store_rows(bf16* dst, int ld, const float (&o)[kHeadDim / 8][4],
                                           int r0, int N, int lane) {
  const int g = lane / 4, tq = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= N) continue;
    bf16* row = dst + (size_t)r * ld + 2 * tq;
#pragma unroll
    for (int j = 0; j < kHeadDim / 8; ++j)
      *reinterpret_cast<uint32_t*>(row + 8 * j) = pack_bf16(o[j][2 * i], o[j][2 * i + 1]);
  }
}

template <int J>
__device__ __forceinline__ void zero(float (&x)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// ---------------------------------------- bf16, 32 keys or fewer (mma.sync)
// A warp takes one tile: the Q, K, V and dO rows of one (sequence, head),
// NP = 16 * NKF rows of kLdh each (rows past N zero), then the query rows'
// statistics m log2(e) | 1 / l | D, NP floats each.
template <int NKF>
struct BwdWarpTile {
  static constexpr int NP = 16 * NKF;
  static constexpr size_t kRows = sizeof(bf16) * NP * kLdh;
  static constexpr size_t q = 0, k = kRows, v = 2 * kRows, o = 3 * kRows, stats = 4 * kRows;
  static constexpr size_t bytes = 4 * kRows + sizeof(float) * 3 * NP;  // a multiple of 16
};

// A warp's 16-row A fragments (m16n8k16, k = the 64-wide head) of rows
// [r0, r0 + 16) of Xs.
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[kHeadDim / 16][4], const bf16* Xs,
                                            int r0, int lane) {
  const int lrow = lane % 8, lmat = lane / 8;
#pragma unroll
  for (int ks = 0; ks < kHeadDim / 16; ++ks)
    ldsm_x4(a[ks], Xs + (r0 + (lmat & 1) * 8 + lrow) * kLdh + ks * 16 + (lmat >> 1) * 8);
}

// NKF = 1 or 2 (N <= 16 NKF): every product of all keys (or queries) at
// once, so dP is computed once.
template <int NKF>
__device__ __forceinline__ void attn_bwd_warp_tile(const bf16* qkv, const bf16* dout,
                                                   bf16* dqkv, int N, int C, float scale,
                                                   unsigned char* smem, int seq, int h) {
  using Tile = BwdWarpTile<NKF>;
  constexpr int NP = Tile::NP;
  bf16* Qs = reinterpret_cast<bf16*>(smem + Tile::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Tile::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Tile::v);
  bf16* Os = reinterpret_cast<bf16*>(smem + Tile::o);
  float* Ml = reinterpret_cast<float*>(smem + Tile::stats);
  float* Il = Ml + NP;
  float* Dd = Il + NP;
  const int ld3 = 3 * C;
  const bf16* qg = qkv + (size_t)seq * N * ld3 + h * kHeadDim;  // q; k at +C, v at +2C
  bf16* dg = dqkv + (size_t)seq * N * ld3 + h * kHeadDim;
  load_rows_async<bf16, 32>(Qs, kLdh, qg, ld3, NP, N, kHeadDim);
  load_rows_async<bf16, 32>(Ks, kLdh, qg + C, ld3, NP, N, kHeadDim);
  load_rows_async<bf16, 32>(Vs, kLdh, qg + 2 * C, ld3, NP, N, kHeadDim);
  load_rows_async<bf16, 32>(Os, kLdh, dout + (size_t)seq * N * C + h * kHeadDim, C, NP, N,
                            kHeadDim);
  cp_async_commit();
  cp_async_wait<0>();
  __syncwarp();
  const int lane = threadIdx.x % 32, tq = lane % 4;

  // 1. query rows: P, D, dS, dQ
  for (int r0 = 0; r0 < N; r0 += 16) {
    uint32_t a[kHeadDim / 16][4];
    float s[2 * NKF][4], dp[2 * NKF][4], ml[2], inv[2], D[2] = {0.f, 0.f};
    load_a_rows(a, Qs, r0, lane);
    mma_logits<NKF>(s, a, Ks, lane);
    bwd_softmax<NKF>(s, scale, N, tq, ml, inv);
    load_a_rows(a, Os, r0, lane);
    mma_logits<NKF>(dp, a, Vs, lane);
    bwd_rowdot<NKF>(D, dp, s);
    quad_sum(D);
    uint32_t dsa[NKF][4];
    bwd_ds<NKF>(dsa, dp, s, D, scale);
    float dq[kHeadDim / 8][4];
    zero(dq);
    mma_pv<NKF>(dq, dsa, Ks, lane);
    store_rows(dg, ld3, dq, r0, N, lane);
    bwd_store_stats(Ml, Il, Dd, r0, ml, inv, D, lane);
  }
  __syncwarp();

  // 2. key rows: P^T, dS^T, dV, dK
  for (int k0 = 0; k0 < N; k0 += 16) {
    uint32_t a[kHeadDim / 16][4], pa[NKF][4], dsa[NKF][4];
    float st[2 * NKF][4], dpt[2 * NKF][4], dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
    load_a_rows(a, Ks, k0, lane);
    mma_logits<NKF>(st, a, Qs, lane);
    load_a_rows(a, Vs, k0, lane);
    mma_logits<NKF>(dpt, a, Os, lane);
    bwd_key_p_ds<NKF>(pa, dsa, st, dpt, Ml, Il, Dd, 0, N, tq, scale);
    zero(dk);
    zero(dv);
    mma_pv<NKF>(dv, pa, Os, lane);
    mma_pv<NKF>(dk, dsa, Qs, lane);
    store_rows(dg + C, ld3, dk, k0, N, lane);
    store_rows(dg + 2 * C, ld3, dv, k0, N, lane);
  }
}

// ---------------------------------------------- bf16, above 32 keys (wgmma)
// D (+)= A B on one warpgroup, m64n64k16, both operands K-major in the
// 128-byte swizzled layout (A: 64 rows, B: 64 rows of the N side); the
// accumulator layout is wgmma_n64's. scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_n64_kb(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D += A B on one warpgroup, m64n64k16, A from registers (each warp its 16
// rows in the m16n8k16 A fragment layout, as pack_p forms it), B MN-major
// (16 rows of 64 elements, swizzled).
__device__ __forceinline__ void wgmma_n64_rs(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// s[8 kb .. 8 kb + 7] (n8 fragments) as the m64n64 accumulator of keys
// [64 kb, 64 kb + 64): its d[4 j + e] is s[8 kb + j][e]
template <int J>
__device__ __forceinline__ float (&acc64(float (&s)[J][4], int kb))[32] {
  return *reinterpret_cast<float(*)[32]>(&s[8 * kb][0]);
}

// keep the compiler from reusing a register A operand before the wgmmas
// reading it have retired
template <int KF>
__device__ __forceinline__ void fence_frags(uint32_t (&a)[KF][4]) {
#pragma unroll
  for (int f = 0; f < KF; ++f)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[f][i])::"memory");
}
// commit the pending wgmmas, wait for them, and keep the compiler from
// reading the accumulator d before that
__device__ __forceinline__ void wgmma_retire(float (&d)[8][4]) {
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc64(d, 0));
}

// A block takes one tile: Q, K, V and dO of one (sequence, head), NP = 16
// NKF rows each of 128 bytes in the 128-byte swizzled layout (rows past N
// zero) from a 1024-byte boundary, then the statistics as BwdWarpTile's.
template <int NKF>
struct BwdBlockTile {
  static constexpr int NP = 16 * NKF;
  static constexpr uint32_t kRows = NP * 128;
  static constexpr uint32_t q = 0, k = kRows, v = 2 * kRows, o = 3 * kRows, stats = 4 * kRows;
  static constexpr size_t bytes = kAtom + 4 * kRows + sizeof(float) * 3 * NP;  // + alignment
};

// Start copying the NP rows of one head (global row stride ld) into the
// swizzled rows at dst on the block; rows at or past `valid` are zero-filled.
template <int NP>
__device__ __forceinline__ void bwd_copy_swz(unsigned char* dst, const bf16* src, int ld,
                                             int valid) {
  for (int i = threadIdx.x; i < NP * 8; i += kThreads) {
    const int r = i / 8, c = i % 8;
    const bool ok = r < valid;
    cp_async16_zfill(dst + r * 128 + ((c ^ (r & 7)) << 4), src + (size_t)(ok ? r : 0) * ld + 8 * c,
                     ok);
  }
}

// NKF = 4, 8 or 16 (N <= 16 NKF). The two warpgroups take the 64-row query
// groups (phase 1), then the 64-row key groups (phase 2), in turn; a warp
// holds 16 rows of its warpgroup's 64.
template <int NKF>
__device__ __forceinline__ void attn_bwd_block_tile(const bf16* qkv, const bf16* dout,
                                                    bf16* dqkv, int N, int C, float scale,
                                                    unsigned char* smem, int seq, int h) {
  using Tile = BwdBlockTile<NKF>;
  constexpr int NP = Tile::NP;
  constexpr int kBlocks = NKF / 4;  // 64-row blocks of keys (or queries)
  unsigned char* base = mlp_base(smem);
  const uint32_t at = smem_addr(base);
  const uint32_t Qa = at + Tile::q, Ka = at + Tile::k, Va = at + Tile::v, Oa = at + Tile::o;
  float* Ml = reinterpret_cast<float*>(base + Tile::stats);
  float* Il = Ml + NP;
  float* Dd = Il + NP;
  const int ld3 = 3 * C;
  const bf16* qg = qkv + (size_t)seq * N * ld3 + h * kHeadDim;  // q; k at +C, v at +2C
  bf16* dg = dqkv + (size_t)seq * N * ld3 + h * kHeadDim;
  // Q and K, then V and dO: the logits start while the second group lands
  bwd_copy_swz<NP>(base + Tile::q, qg, ld3, N);
  bwd_copy_swz<NP>(base + Tile::k, qg + C, ld3, N);
  cp_async_commit();
  bwd_copy_swz<NP>(base + Tile::v, qg + 2 * C, ld3, N);
  bwd_copy_swz<NP>(base + Tile::o, dout + (size_t)seq * N * C + h * kHeadDim, C, N);
  cp_async_commit();
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32, tq = lane % 4;
  const int wrow = (threadIdx.x / 32) % 4 * 16;  // the warp's first row in its 64

  // 1. query rows [r0, r0 + 64) a warpgroup: P, D, dS, dQ
  for (int pass = 0; pass * 2 < kBlocks; ++pass) {
    const int r0 = (pass * 2 + wg) * 64;
    const bool active = r0 < N;
    if (pass == 0) {
      cp_async_wait<1>();
      fence_proxy_async();
      __syncthreads();
    }
    float s[2 * NKF][4], ml[2], inv[2];
    if (active) {
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < kBlocks; ++kb)
#pragma unroll
        for (int ks = 0; ks < kHeadDim / 16; ++ks)
          wgmma_n64_kb(acc64(s, kb), wgmma_desc(Qa + r0 * 128 + 32 * ks),
                       wgmma_desc(Ka + kb * 64 * 128 + 32 * ks), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kb = 0; kb < kBlocks; ++kb) fence_acc(acc64(s, kb));
      bwd_softmax<NKF>(s, scale, N, tq, ml, inv);
    }
    if (pass == 0) {
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
    }
    if (!active) continue;

    // dP = dO V^T a block of 64 keys at a time: for D, then again for dS
    auto dp_block = [&](float (&dp)[8][4], int kb) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks)
        wgmma_n64_kb(acc64(dp, 0), wgmma_desc(Oa + r0 * 128 + 32 * ks),
                     wgmma_desc(Va + kb * 64 * 128 + 32 * ks), ks > 0);
      wgmma_retire(dp);
    };
    float D[2] = {0.f, 0.f};
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb) {
      if (kb * 64 >= N) break;
      float dp[8][4];
      dp_block(dp, kb);
      bwd_rowdot<4>(D, dp, &s[8 * kb]);
    }
    quad_sum(D);
    float dq[kHeadDim / 8][4];
    zero(dq);
#pragma unroll
    for (int kb = 0; kb < kBlocks; ++kb) {
      if (kb * 64 >= N) break;
      float dp[8][4];
      uint32_t dsa[4][4];
      dp_block(dp, kb);
      bwd_ds<4>(dsa, dp, &s[8 * kb], D, scale);
      fence_acc(acc64(dq, 0));
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < 4; ++f)
        wgmma_n64_rs(acc64(dq, 0), dsa[f], wgmma_desc(Ka + (kb * 64 + 16 * f) * 128));
      wgmma_retire(dq);
      fence_frags(dsa);
    }
    store_rows(dg, ld3, dq, r0 + wrow, N, lane);
    bwd_store_stats(Ml, Il, Dd, r0 + wrow, ml, inv, D, lane);
  }
  __syncthreads();

  // 2. key rows [k0, k0 + 64) a warpgroup, over blocks of 64 queries:
  // P^T, dS^T, dV, dK
  for (int pass = 0; pass * 2 < kBlocks; ++pass) {
    const int k0 = (pass * 2 + wg) * 64;
    if (k0 >= N) break;
    float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
    zero(dk);
    zero(dv);
#pragma unroll 1
    for (int q0 = 0; q0 < N; q0 += 64) {
      float st[8][4], dpt[8][4];
      uint32_t pa[4][4], dsa[4][4];
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        wgmma_n64_kb(acc64(st, 0), wgmma_desc(Ka + k0 * 128 + 32 * ks),
                     wgmma_desc(Qa + q0 * 128 + 32 * ks), ks > 0);
        wgmma_n64_kb(acc64(dpt, 0), wgmma_desc(Va + k0 * 128 + 32 * ks),
                     wgmma_desc(Oa + q0 * 128 + 32 * ks), ks > 0);
      }
      wgmma_retire(st);
      fence_acc(acc64(dpt, 0));
      bwd_key_p_ds<4>(pa, dsa, st, dpt, Ml, Il, Dd, q0, N, tq, scale);
      fence_acc(acc64(dv, 0));
      fence_acc(acc64(dk, 0));
      wgmma_fence();
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        const uint32_t row = (q0 + 16 * f) * 128;
        wgmma_n64_rs(acc64(dv, 0), pa[f], wgmma_desc(Oa + row));
        wgmma_n64_rs(acc64(dk, 0), dsa[f], wgmma_desc(Qa + row));
      }
      wgmma_retire(dv);
      fence_acc(acc64(dk, 0));
      fence_frags(pa);
      fence_frags(dsa);
    }
    store_rows(dg + C, ld3, dk, k0 + wrow, N, lane);
    store_rows(dg + 2 * C, ld3, dv, k0 + wrow, N, lane);
  }
}

// N > 32: a block takes tile blockIdx.x (head fastest).
template <int NKF>
__global__ void __launch_bounds__(kThreads, 1)
attn_bwd_block_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                      bf16* __restrict__ dqkv, int N, int C, int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = blockIdx.x;
  attn_bwd_block_tile<NKF>(qkv, dout, dqkv, N, C, scale, smem, t / heads, t % heads);
}

// N <= 32: each warp of a block takes a tile in its own BwdWarpTile bytes.
constexpr int kBwdWarpTiles = 4;
template <int NKF>
__global__ void __launch_bounds__(32 * kBwdWarpTiles)
attn_bwd_warp_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                     bf16* __restrict__ dqkv, int N, int C, int heads, float scale, int tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w = threadIdx.x / 32, t = blockIdx.x * kBwdWarpTiles + w;
  if (t >= tiles) return;
  attn_bwd_warp_tile<NKF>(qkv, dout, dqkv, N, C, scale, smem + w * BwdWarpTile<NKF>::bytes,
                          t / heads, t % heads);
}

template <int NKF>
cudaError_t launch_bwd_bf16(const bf16* qkv, const bf16* dout, bf16* dqkv, int R, int N, int C,
                            int heads, float scale, cudaStream_t stream) {
  const long long tiles = (long long)R * heads;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaError_t e;
  if constexpr (NKF <= 2) {
    const int smem = (int)(kBwdWarpTiles * BwdWarpTile<NKF>::bytes);
    e = cudaFuncSetAttribute(attn_bwd_warp_kernel<NKF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attn_bwd_warp_kernel<NKF><<<cdiv((int)tiles, kBwdWarpTiles), 32 * kBwdWarpTiles, smem,
                                stream>>>(qkv, dout, dqkv, N, C, heads, scale, (int)tiles);
  } else {
    const int smem = (int)BwdBlockTile<NKF>::bytes;
    e = cudaFuncSetAttribute(attn_bwd_block_kernel<NKF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attn_bwd_block_kernel<NKF><<<(int)tiles, kThreads, smem, stream>>>(qkv, dout, dqkv, N, C,
                                                                       heads, scale);
  }
  return cudaGetLastError();
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

template <bool kKeys>
cudaError_t launch_bwd_f32(const BwdLayout& L, dim3 grid, const float* qkv, const float* dout,
                           float* dqkv, float* stats, int N, int C, float scale,
                           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_f32_kernel<kKeys>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return e;
  attn_bwd_f32_kernel<kKeys><<<grid, kThreads, L.total, stream>>>(qkv, dout, dqkv, stats, N, C,
                                                                 scale, L);
  return cudaGetLastError();
}

// fp32: stats is a scratch of R * heads * 3 * N floats, written by the query
// pass and read by the key pass (same stream, so in order).
int attention_qkv_bwd_f32(const void* qkv, const void* dout, void* dqkv, void* stats, int R,
                          int N, int C, int heads, float scale, void* stream_) {
  if (!shapes_ok(R, N, C, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const BwdLayout L = bwd_layout_f32(N);
  const dim3 grid(R, heads, cdiv(N, L.RB));
  cudaError_t e = launch_bwd_f32<false>(L, grid, (const float*)qkv, (const float*)dout,
                                        (float*)dqkv, (float*)stats, N, C, scale, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)launch_bwd_f32<true>(L, grid, (const float*)qkv, (const float*)dout, (float*)dqkv,
                                   (float*)stats, N, C, scale, stream);
}

// bf16: one launch, no scratch; the tile's key fragments as the forward
// tile's (4, 8, 16 above 32 keys), 1 or 2 at 32 keys or fewer.
int attention_qkv_bwd_bf16(const void* qkv_, const void* dout_, void* dqkv_, int R, int N, int C,
                           int heads, float scale, void* stream_) {
  if (!shapes_ok(R, N, C, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const bf16* qkv = static_cast<const bf16*>(qkv_);
  const bf16* dout = static_cast<const bf16*>(dout_);
  bf16* dqkv = static_cast<bf16*>(dqkv_);
  cudaError_t e;
  if (N <= 16) e = launch_bwd_bf16<1>(qkv, dout, dqkv, R, N, C, heads, scale, stream);
  else if (N <= 32) e = launch_bwd_bf16<2>(qkv, dout, dqkv, R, N, C, heads, scale, stream);
  else if (N <= 64) e = launch_bwd_bf16<4>(qkv, dout, dqkv, R, N, C, heads, scale, stream);
  else if (N <= 128) e = launch_bwd_bf16<8>(qkv, dout, dqkv, R, N, C, heads, scale, stream);
  else e = launch_bwd_bf16<16>(qkv, dout, dqkv, R, N, C, heads, scale, stream);
  return (int)e;
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

int d3dp_attention_qkv_bwd_bf16(const void* qkv, const void* dout, void* dqkv, int R, int N,
                                int C, int heads, float scale, void* stream) {
  return d3dp::attention_qkv_bwd_bf16(qkv, dout, dqkv, R, N, C, heads, scale, stream);
}

int d3dp_attention_qkv_bwd_f32(const void* qkv, const void* dout, void* dqkv, void* stats,
                               int R, int N, int C, int heads, float scale, void* stream) {
  return d3dp::attention_qkv_bwd_f32(qkv, dout, dqkv, stats, R, N, C, heads, scale, stream);
}

}  // extern "C"
