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
// It reads qkv and dO once and writes d(qkv) once: 118 MB in bf16 at the
// train step's shapes (68 x 243 or 972 x 17 tokens, C = 512), 237 MB in
// fp32 (0.035 / 0.071 ms at the card's 3.35 TB/s), against five N x N x 64
// products a head: 20.6 GFLOP temporal, 1.44 spatial. In bf16 that is 0.021
// ms of tensor-core time, so bytes bound it, and each operand row is read
// once per (sequence, head) and nothing else goes through device memory. In
// fp32 each product takes three TF32 passes (0.125 ms temporal at 495
// TFLOP/s), so operations bound the temporal shape and bytes the spatial.
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
// fp32 (the default --dtype; JAX's products at Precision.HIGHEST): every
// product on mma.sync m16n8k8 in three TF32 passes (tf32x3, as the
// forward's `attend_f32_walk`). Its fragments are ldmatrix or single 32-bit
// shared-memory loads from rows of kLdf, so dK = dS^T Q and dV = P^T dO,
// whose reduction runs over queries, read Q and dO rows as they are (a tf32
// wgmma would need them K-major). Q, K, V and dO of 256 fp32 rows (272 KB
// at kLdf) exceed a block's 227 KB, so above 32 keys two launches hand the
// query rows' m | 1 / l | D over through a scratch of R x heads x 3 x N
// (rounded up to 64) floats, 64 rows a block of 4 warps, two blocks an SM:
//   (a) query pass: Q and dO stay, K and V stream by twice in groups of 32
//       rows through two cp.async buffers, each group split once into hi and
//       lo planes; walk 1 S and dP, the statistics online (m, and l and
//       rowsum(dP o e) rescaled as m grows); walk 2 S and dP again, P, dS,
//       dQ += dS K;
//   (b) key pass: K and V stay, Q, dO and the statistics stream by: S^T and
//       dP^T (the query pass's terms in its order), P^T and dS^T with its
//       operations, dV += P^T dO, dK += dS^T Q.
// That is 9 products of N x N x 64 where the bound counts 5, 256 keys for
// 243. At 32 keys or fewer (the spatial 17) one launch and no scratch: two
// warps a (sequence, head), its four operands resident (35 KB at 32 rows),
// every product over all keys at once, 3 tiles a block, 2 blocks an SM.
// As in bf16, every output element is written once, by one warp.
#include "mlp.cuh"

namespace d3dp {

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

// ------------------------------------------------ backward, fp32 (tf32x3)
// Every product is mma.sync m16n8k8 in TF32, three passes into one fp32
// accumulator (tf32x3, `mma_1688_x3`). Its fragments are single 32-bit
// shared-memory loads, so an operand whose reduction runs over the query
// index (dK = dS^T Q, dV = P^T dO) is read from the same rows of kLdf as
// any other, in another index order; a tf32 wgmma would need it K-major.
// A warp holds 16 rows of its side; the m16n8 accumulator's columns 2t,
// 2t + 1 are an A fragment's columns t, t + 4, and rows 2t, 2t + 1 of the
// next B operand its k rows t, t + 4, so P and dS never leave registers.

// The B fragment pair of one k-step (b0 at p, b1 at p + o1) as hi and lo
// parts: read from the hi plane at p and the lo plane kPlane floats on, or,
// where kPlane == 0, split here from fp32 rows.
template <int kPlane>
__device__ __forceinline__ void tf32_b(const float* p, int o1, uint32_t& h0, uint32_t& h1,
                                       uint32_t& l0, uint32_t& l1) {
  if constexpr (kPlane > 0) {
    h0 = __float_as_uint(p[0]);
    h1 = __float_as_uint(p[o1]);
    l0 = __float_as_uint(p[kPlane]);
    l1 = __float_as_uint(p[kPlane + o1]);
  } else {
    tf32_split(p[0], h0, l0);
    tf32_split(p[o1], h1, l1);
  }
}

// acc[n] += X Y^T over one k-step of 8 (kk) of the head's 64 columns: a
// warp's 16 rows of X (fp32 rows of kLdf, split as A fragments) against
// rows 8n .. 8n + 7 of Y, n < J. kSwap: the key side's products (K Q^T,
// V dO^T) take their passes as hi(a) lo(b), lo(a) hi(b), hi(a) hi(b): the
// query side's terms lo(q) hi(k), hi(q) lo(k), hi(q) hi(k), in its order.
template <int J, int kPlane, bool kSwap>
__device__ __forceinline__ void f32_dots_step(float (&acc)[J][4], const float* X, const float* Y,
                                              int kk, int lane) {
  // ldmatrix hands lane (g, t) the 32-bit element (row g, column t) of each
  // 8 x 4 fp32 matrix whose rows lanes 8j .. 8j + 7 point at: for X, rows
  // 0-7 and 8-15 at columns 8kk and 8kk + 4 (the A fragment); for planes,
  // Y's rows 8n .. 8n + 7 at 8kk and 8kk + 4, hi then lo (b0, b1 of each)
  const int g = lane / 4, t = lane % 4, lrow = lane % 8, lmat = lane / 8;
  uint32_t x[4];
  ldsm_x4(x, reinterpret_cast<const bf16*>(X + (lrow + (lmat & 1) * 8) * kLdf + 8 * kk +
                                          (lmat >> 1) * 4));
  const Tf32Frag a = tf32_frag(__uint_as_float(x[0]), __uint_as_float(x[1]),
                               __uint_as_float(x[2]), __uint_as_float(x[3]));
#pragma unroll
  for (int n = 0; n < J; ++n) {
    uint32_t h0, h1, l0, l1;
    if constexpr (kPlane > 0) {
      uint32_t b[4];
      ldsm_x4(b, reinterpret_cast<const bf16*>(Y + (8 * n + lrow) * kLdf + 8 * kk +
                                              (lmat & 1) * 4 + (lmat >> 1) * kPlane));
      h0 = b[0], h1 = b[1], l0 = b[2], l1 = b[3];
    } else {
      tf32_b<0>(Y + (8 * n + g) * kLdf + 8 * kk + t, 4, h0, h1, l0, l1);
    }
    if constexpr (kSwap) {
      mma_1688_tf32(acc[n], a.hi, l0, l1);
      mma_1688_tf32(acc[n], a.lo, h0, h1);
      mma_1688_tf32(acc[n], a.hi, h0, h1);
    } else {
      mma_1688_x3(acc[n], a, h0, h1, l0, l1);
    }
  }
}

// a = X1 Y1^T and b = X2 Y2^T over the head's 64 columns (f32_dots_step's
// operands) in one k loop: twice the independent accumulators in flight
template <int J, int kPlane, bool kSwap>
__device__ __forceinline__ void f32_dots2(float (&a)[J][4], const float* X1, const float* Y1,
                                          float (&b)[J][4], const float* X2, const float* Y2,
                                          int lane) {
  zero(a);
  zero(b);
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 8; ++kk) {
    f32_dots_step<J, kPlane, kSwap>(a, X1, Y1, kk, lane);
    f32_dots_step<J, kPlane, kSwap>(b, X2, Y2, kk, lane);
  }
}

// acc += P Y: P the warp's 16 x 8J accumulator of f32_dots2 (its column
// 8n + 2t + (e & 1) meets row 8n + 2t + (e & 1) of Y), Y rows of kLdf.
template <int J, int kPlane>
__device__ __forceinline__ void f32_pv(float (&acc)[kHeadDim / 8][4], const float (*p)[4],
                                       const float* Y, int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int n = 0; n < J; ++n) {
    const Tf32Frag a = tf32_frag(p[n][0], p[n][2], p[n][1], p[n][3]);
#pragma unroll
    for (int d = 0; d < kHeadDim / 8; ++d) {
      uint32_t h0, h1, l0, l1;
      tf32_b<kPlane>(Y + (8 * n + 2 * t) * kLdf + 8 * d + g, kLdf, h0, h1, l0, l1);
      mma_1688_x3(acc[d], a, h0, h1, l0, l1);
    }
  }
}

// The query side's softmax in place: S (unscaled logits of keys 0, 1, ...)
// -> P = exp(s - m) * (1 / l), s = dot * scale rounded before the
// subtraction, keys at or past N p = 0; m and 1 / l of rows g and g + 8.
template <int J>
__device__ __forceinline__ void f32_softmax(float (&s)[J][4], float scale, int N, int t,
                                            float (&m)[2], float (&inv)[2]) {
  m[0] = m[1] = -INFINITY;
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x = 8 * j + 2 * t + (e & 1) < N ? __fmul_rn(s[j][e], scale) : -INFINITY;
      s[j][e] = x;
      m[e >> 1] = fmaxf(m[e >> 1], x);
    }
  quad_max(m);
  float l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = expf(s[j][e] - m[e >> 1]);
      l[e >> 1] += s[j][e];
    }
  quad_sum(l);
  inv[0] = 1.0f / l[0];
  inv[1] = 1.0f / l[1];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] *= inv[e >> 1];
}

// dS = P o (dP - D) * scale, in place of dP
template <int J>
__device__ __forceinline__ void f32_ds(float (&dp)[J][4], const float (*p)[4], const float (&D)[2],
                                       float scale) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dp[j][e] = p[j][e] * (dp[j][e] - D[e >> 1]) * scale;
}

// The key side: S^T and dP^T of the warp's 16 keys against queries
// q0 + 8n + 2t + (e & 1) -> P^T and dS^T in place, from those queries'
// m | 1 / l | D (Ms, Is, Ds, indexed from q0): the query side's operations,
// so the same p; queries at or past N p = dS = 0.
template <int J>
__device__ __forceinline__ void f32_key_p_ds(float (&st)[J][4], float (&dpt)[J][4],
                                             const float* Ms, const float* Is, const float* Ds,
                                             int q0, int N, int t, float scale) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int q = 8 * j + 2 * t;
    const float2 m = *reinterpret_cast<const float2*>(Ms + q);
    const float2 il = *reinterpret_cast<const float2*>(Is + q);
    const float2 d = *reinterpret_cast<const float2*>(Ds + q);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e & 1;
      float p = expf(__fmul_rn(st[j][e], scale) - (hi ? m.y : m.x)) * (hi ? il.y : il.x);
      float ds = p * (dpt[j][e] - (hi ? d.y : d.x)) * scale;
      if (q0 + q + hi >= N) p = ds = 0.f;
      st[j][e] = p;
      dpt[j][e] = ds;
    }
  }
}

// Rows r0 + g and r0 + g + 8 (those below N) of a warp's 16 x 64 fp32
// accumulator to rows of ld floats at dst.
__device__ __forceinline__ void store_rows_f32(float* dst, int ld,
                                               const float (&o)[kHeadDim / 8][4], int r0, int N,
                                               int lane) {
  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = r0 + g + 8 * i;
    if (r >= N) continue;
    float* row = dst + (size_t)r * ld + 2 * t;
#pragma unroll
    for (int d = 0; d < kHeadDim / 8; ++d)
      *reinterpret_cast<float2*>(row + 8 * d) = make_float2(o[d][2 * i], o[d][2 * i + 1]);
  }
}

// ---------------------------------- fp32, 32 keys or fewer (two warps a tile)
// Two warps take one (sequence, head): its Q, K, V and dO rows, NP = 16 NKF
// fp32 rows of kLdf each (rows past N zero), then the query rows' m | 1 / l
// | D, NP floats each; warp w of the pair takes rows 16w .. 16w + 15 (at
// NKF = 1 the second warp waits). The operands are split into hi and lo as
// they are read.
template <int NKF>
struct BwdShortTileF32 {
  static constexpr int NP = 16 * NKF;
  static constexpr int kRows = NP * kLdf;  // floats
  static constexpr int q = 0, k = kRows, v = 2 * kRows, o = 3 * kRows, stats = 4 * kRows;
  static constexpr size_t bytes = sizeof(float) * (4 * kRows + 3 * NP);  // a multiple of 16
};

// kBwdF32ShortTiles tiles a block, each in its own bytes: 103 KB at 32
// keys, two blocks (12 warps) an SM.
constexpr int kBwdF32ShortTiles = 3;
template <int NKF>
__global__ void __launch_bounds__(64 * kBwdF32ShortTiles, 2)
attn_bwd_short_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          float* __restrict__ dqkv, int N, int C, int heads, float scale,
                          int tiles) {
  using Tile = BwdShortTileF32<NKF>;
  constexpr int NP = Tile::NP, J = 2 * NKF;
  extern __shared__ __align__(128) unsigned char smem[];
  const int tl = blockIdx.x * kBwdF32ShortTiles + threadIdx.x / 64;
  const int lane = threadIdx.x % 32, t = lane % 4, r0 = threadIdx.x / 32 % 2 * 16;
  const bool on = tl < tiles, rows = on && r0 < N;  // this warp has a tile, and rows in it
  float* sm = reinterpret_cast<float*>(smem + threadIdx.x / 64 * Tile::bytes);
  float *Qs = sm + Tile::q, *Ks = sm + Tile::k, *Vs = sm + Tile::v, *Os = sm + Tile::o;
  float* Ml = sm + Tile::stats;
  float* Il = Ml + NP;
  float* Dd = Il + NP;
  const int ld3 = 3 * C, seq = tl / heads, h = tl % heads;
  const float* qg = qkv + (size_t)seq * N * ld3 + h * kHeadDim;  // q; k at +C, v at +2C
  float* dg = dqkv + (size_t)seq * N * ld3 + h * kHeadDim;
  if (on) {
    load_rows_async<float, 64>(Qs, kLdf, qg, ld3, NP, N, kHeadDim);
    load_rows_async<float, 64>(Ks, kLdf, qg + C, ld3, NP, N, kHeadDim);
    load_rows_async<float, 64>(Vs, kLdf, qg + 2 * C, ld3, NP, N, kHeadDim);
    load_rows_async<float, 64>(Os, kLdf, dout + (size_t)seq * N * C + h * kHeadDim, C, NP, N,
                               kHeadDim);
  }
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // 1. the warp's query rows: P, D, dS, dQ, and their statistics
  if (rows) {
    float s[J][4], dp[J][4], m[2], inv[2], D[2] = {0.f, 0.f};
    f32_dots2<J, 0, false>(s, Qs + r0 * kLdf, Ks, dp, Os + r0 * kLdf, Vs, lane);
    f32_softmax<J>(s, scale, N, t, m, inv);
    bwd_rowdot<NKF>(D, dp, s);
    quad_sum(D);
    f32_ds<J>(dp, s, D, scale);
    float dq[kHeadDim / 8][4];
    zero(dq);
    f32_pv<J, 0>(dq, dp, Ks, lane);
    store_rows_f32(dg, ld3, dq, r0, N, lane);
    bwd_store_stats(Ml, Il, Dd, r0, m, inv, D, lane);
  }
  __syncthreads();  // every query row's statistics are in

  // 2. the warp's key rows: P^T, dS^T, dV, dK
  if (rows) {
    float st[J][4], dpt[J][4], dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
    f32_dots2<J, 0, true>(st, Ks + r0 * kLdf, Qs, dpt, Vs + r0 * kLdf, Os, lane);
    f32_key_p_ds<J>(st, dpt, Ml, Il, Dd, 0, N, t, scale);
    zero(dk);
    zero(dv);
    f32_pv<J, 0>(dv, st, Os, lane);
    f32_pv<J, 0>(dk, dpt, Qs, lane);
    store_rows_f32(dg + C, ld3, dk, r0, N, lane);
    store_rows_f32(dg + 2 * C, ld3, dv, r0, N, lane);
  }
}

// ------------------------------------------ fp32, above 32 keys (two passes)
// A block of 4 warps takes 64 rows of one (sequence, head), a warp 16. Its
// own two operands stay in shared memory as fp32 rows; the other side's
// stream through two buffers in groups of 32 rows, each split once into hi
// and lo planes by the threads that copied it (so no warp splits a B
// operand); one barrier a group hands it to the warps and frees the other
// buffer for the next group's copies. 103 KB a block, two blocks an SM.
constexpr int kBwdF32Threads = 128;
constexpr int kBwdF32Rows = 64;                     // a tile's own rows
constexpr int kBwdF32Group = 32;                    // rows a streamed group
constexpr int kBwdF32Plane = kBwdF32Group * kLdf;   // floats a plane
constexpr int kBwdF32Own = 2 * kBwdF32Rows * kLdf;  // floats: the own rows
// a group buffer: X hi, X lo, Y hi, Y lo planes, then (key pass) the
// statistics of the group's queries, m | 1 / l | D
constexpr int kBwdF32Buf = 4 * kBwdF32Plane + 3 * kBwdF32Group;
constexpr size_t kBwdF32Smem = sizeof(float) * (kBwdF32Own + 2 * kBwdF32Buf);

// The tile of block blockIdx.x (its 64-row block fastest, then the head,
// then the sequence) and its shared memory: own rows X, Y, then the buffers.
struct BwdF32Tile {
  int seq, h, r0;
  float *X, *Y;
  __device__ float* buf(int b) const { return X + kBwdF32Own + b * kBwdF32Buf; }
};

__device__ __forceinline__ BwdF32Tile bwd_f32_tile(int N, int heads, unsigned char* smem) {
  const int nrb = cdiv(N, kBwdF32Rows), t = blockIdx.x;
  BwdF32Tile T;
  T.r0 = t % nrb * kBwdF32Rows;
  T.h = t / nrb % heads;
  T.seq = t / nrb / heads;
  T.X = reinterpret_cast<float*>(smem);
  T.Y = T.X + kBwdF32Rows * kLdf;
  return T;
}

// the group this thread copied into the plane at p, landed: split it into
// p (hi) and the next plane (lo)
__device__ __forceinline__ void bwd_f32_split(float* p) {
  split_rows_f32<kBwdF32Threads>(p, p + kBwdF32Plane, kBwdF32Group);
}

// (a) The query pass: K and V stream by twice in groups of 32 keys. Walk
// 1: S = Q K^T and dP = dO V^T of each group, the softmax statistics
// online: the row max m, and l = rowsum(e) and D' = rowsum(dP o e) of e =
// exp(s - m), both rescaled by exp(m_old - m) where m grows; then 1 / l and
// D = D' / l = rowsum(dP o P). Walk 2: S and dP again (the same bits), P =
// exp(s - m) * (1 / l) as the key pass forms it, dS, and dQ += dS K. Writes
// dQ, and each query row's m | 1 / l | D to stats: per (sequence, head)
// three runs of NS floats, NS = N rounded up to 64 (rows past N too).
__global__ void __launch_bounds__(kBwdF32Threads, 2)
attn_bwd_query_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                          float* __restrict__ dqkv, float* __restrict__ stats, int N, int C,
                          int heads, float scale) {
  constexpr int kKv = 2 * kBwdF32Plane;  // K's planes, then V's
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdF32Tile T = bwd_f32_tile(N, heads, smem);
  const int ld3 = 3 * C, ng = cdiv(N, kBwdF32Group), NS = cdiv(N, kBwdF32Rows) * kBwdF32Rows;
  const float* qg = qkv + (size_t)T.seq * N * ld3 + T.h * kHeadDim;  // q; k at +C, v at +2C
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int wr = 16 * warp;  // the warp's first row in the tile
  // item i of the stream: key group i % ng of K and V, into buffer i & 1
  auto issue = [&](int i) {
    if (i >= 2 * ng) return;
    const int r = kBwdF32Group * (i % ng);
    float* b = T.buf(i & 1);
    copy_rows_f32<kBwdF32Threads>(b, qg + C, ld3, r, kBwdF32Group, N);
    copy_rows_f32<kBwdF32Threads>(b + kKv, qg + 2 * C, ld3, r, kBwdF32Group, N);
    cp_async_commit();
  };
  auto land = [&](int i) {
    float* b = T.buf(i & 1);
    cp_async_wait<0>();
    bwd_f32_split(b);
    bwd_f32_split(b + kKv);
    __syncthreads();  // the group is split; every warp is done with the other buffer
    issue(i + 1);
    return static_cast<const float*>(b);
  };
  copy_rows_f32<kBwdF32Threads>(T.X, qg, ld3, T.r0, kBwdF32Rows, N);
  copy_rows_f32<kBwdF32Threads>(T.Y, dout + (size_t)T.seq * N * C + T.h * kHeadDim, C, T.r0,
                                kBwdF32Rows, N);
  issue(0);  // commits the own rows with the first group
  const float* Xw = T.X + wr * kLdf;  // the warp's Q rows
  const float* Yw = T.Y + wr * kLdf;  // and its dO rows

  // walk 1: the statistics of rows g (e = 0, 1) and g + 8 (e = 2, 3)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, D[2] = {0.f, 0.f};
#pragma unroll 1
  for (int i = 0; i < ng; ++i) {
    const float* b = land(i);
    float s[4][4], dp[4][4];
    f32_dots2<4, kBwdF32Plane, false>(s, Xw, b, dp, Yw, b + kKv, lane);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kBwdF32Group * i + 8 * j + 2 * t + (e & 1);
        const float x = key < N ? __fmul_rn(s[j][e], scale) : -INFINITY;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    quad_max(mx);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], mx[r]);
      const float alpha = expf(m[r] - mn);  // 0 at the first group
      m[r] = mn;
      l[r] *= alpha;
      D[r] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = expf(s[j][e] - m[e >> 1]);
        l[e >> 1] += x;
        D[e >> 1] = fmaf(dp[j][e], x, D[e >> 1]);
      }
  }
  quad_sum(l);
  quad_sum(D);
  const float inv[2] = {1.0f / l[0], 1.0f / l[1]};
  D[0] *= inv[0];
  D[1] *= inv[1];
  float* st = stats + ((size_t)T.seq * heads + T.h) * 3 * NS + T.r0;
  if (lane % 4 == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = wr + lane / 4 + 8 * i;
      st[r] = m[i];
      st[NS + r] = inv[i];
      st[2 * NS + r] = D[i];
    }

  // walk 2: P, dS, dQ
  float dq[kHeadDim / 8][4];
  zero(dq);
#pragma unroll 1
  for (int i = 0; i < ng; ++i) {
    const float* b = land(ng + i);
    float s[4][4], dp[4][4];
    f32_dots2<4, kBwdF32Plane, false>(s, Xw, b, dp, Yw, b + kKv, lane);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = kBwdF32Group * i + 8 * j + 2 * t + (e & 1);
        s[j][e] = key < N ? expf(__fmul_rn(s[j][e], scale) - m[e >> 1]) * inv[e >> 1] : 0.f;
      }
    f32_ds<4>(dp, s, D, scale);
    f32_pv<4, kBwdF32Plane>(dq, dp, b, lane);
  }
  store_rows_f32(dqkv + (size_t)T.seq * N * ld3 + T.h * kHeadDim, ld3, dq, T.r0 + wr, N, lane);
}

// (b) The key pass: the tile's K and V rows stay; the queries' Q, dO and
// statistics stream by in groups of 32: S^T = K Q^T and dP^T = V dO^T,
// P^T and dS^T from the statistics, dV += P^T dO, dK += dS^T Q.
__global__ void __launch_bounds__(kBwdF32Threads, 2)
attn_bwd_key_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                        float* __restrict__ dqkv, const float* __restrict__ stats, int N, int C,
                        int heads, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const BwdF32Tile T = bwd_f32_tile(N, heads, smem);
  const int ld3 = 3 * C, ng = cdiv(N, kBwdF32Group), NS = cdiv(N, kBwdF32Rows) * kBwdF32Rows;
  const float* qg = qkv + (size_t)T.seq * N * ld3 + T.h * kHeadDim;
  const float* og = dout + (size_t)T.seq * N * C + T.h * kHeadDim;
  const float* st = stats + ((size_t)T.seq * heads + T.h) * 3 * NS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4;
  const int wr = 16 * warp;
  // group i of the queries into buffer i & 1: Q, dO, and their statistics
  // (three runs of 32 floats, 8 pieces of 16 bytes each)
  auto issue = [&](int i) {
    if (i >= ng) return;
    const int r = kBwdF32Group * i;
    float* b = T.buf(i & 1);
    copy_rows_f32<kBwdF32Threads>(b, qg, ld3, r, kBwdF32Group, N);
    copy_rows_f32<kBwdF32Threads>(b + 2 * kBwdF32Plane, og, C, r, kBwdF32Group, N);
    for (int j = threadIdx.x; j < 3 * kBwdF32Group / 4; j += kBwdF32Threads) {
      const int c = j / (kBwdF32Group / 4), o = 4 * (j % (kBwdF32Group / 4));
      cp_async16(b + 4 * kBwdF32Plane + c * kBwdF32Group + o, st + c * NS + r + o);
    }
    cp_async_commit();
  };
  copy_rows_f32<kBwdF32Threads>(T.X, qg + C, ld3, T.r0, kBwdF32Rows, N);
  copy_rows_f32<kBwdF32Threads>(T.Y, qg + 2 * C, ld3, T.r0, kBwdF32Rows, N);
  issue(0);  // commits the own rows with the first group
  const float* Kw = T.X + wr * kLdf;
  const float* Vw = T.Y + wr * kLdf;
  float dk[kHeadDim / 8][4], dv[kHeadDim / 8][4];
  zero(dk);
  zero(dv);
#pragma unroll 1
  for (int i = 0; i < ng; ++i) {
    float* b = T.buf(i & 1);
    cp_async_wait<0>();
    bwd_f32_split(b);
    bwd_f32_split(b + 2 * kBwdF32Plane);
    __syncthreads();  // as the query pass's land()
    issue(i + 1);
    float sq[4][4], dpt[4][4];
    f32_dots2<4, kBwdF32Plane, true>(sq, Kw, b, dpt, Vw, b + 2 * kBwdF32Plane, lane);
    const float* Ms = b + 4 * kBwdF32Plane;
    f32_key_p_ds<4>(sq, dpt, Ms, Ms + kBwdF32Group, Ms + 2 * kBwdF32Group, kBwdF32Group * i, N,
                    t, scale);
    f32_pv<4, kBwdF32Plane>(dv, sq, b + 2 * kBwdF32Plane, lane);
    f32_pv<4, kBwdF32Plane>(dk, dpt, b, lane);
  }
  float* dg = dqkv + (size_t)T.seq * N * ld3 + T.h * kHeadDim;
  store_rows_f32(dg + C, ld3, dk, T.r0 + wr, N, lane);
  store_rows_f32(dg + 2 * C, ld3, dv, T.r0 + wr, N, lane);
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

// fp32, N <= 32: one launch, two warps a tile; above: the query pass, then
// the key pass (same stream, so in order) through stats, a scratch of
// R * heads * 3 * NS floats (NS = N rounded up to 64).
template <int NKF>
cudaError_t launch_bwd_f32_short(const float* qkv, const float* dout, float* dqkv, int R, int N,
                                 int C, int heads, float scale, cudaStream_t stream) {
  const long long tiles = (long long)R * heads;
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = (int)(kBwdF32ShortTiles * BwdShortTileF32<NKF>::bytes);
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_short_f32_kernel<NKF>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  attn_bwd_short_f32_kernel<NKF><<<cdiv((int)tiles, kBwdF32ShortTiles), 64 * kBwdF32ShortTiles,
                                   smem, stream>>>(qkv, dout, dqkv, N, C, heads, scale,
                                                   (int)tiles);
  return cudaGetLastError();
}

cudaError_t launch_bwd_f32_passes(const float* qkv, const float* dout, float* dqkv, float* stats,
                                  int R, int N, int C, int heads, float scale,
                                  cudaStream_t stream) {
  const long long tiles = (long long)R * heads * cdiv(N, kBwdF32Rows);
  if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int smem = (int)kBwdF32Smem;
  cudaError_t e = cudaFuncSetAttribute(attn_bwd_query_f32_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(attn_bwd_key_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e != cudaSuccess) return e;
  attn_bwd_query_f32_kernel<<<(int)tiles, kBwdF32Threads, smem, stream>>>(
      qkv, dout, dqkv, stats, N, C, heads, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  attn_bwd_key_f32_kernel<<<(int)tiles, kBwdF32Threads, smem, stream>>>(qkv, dout, dqkv, stats, N,
                                                                       C, heads, scale);
  return cudaGetLastError();
}

int attention_qkv_bwd_f32(const void* qkv_, const void* dout_, void* dqkv_, void* stats_, int R,
                          int N, int C, int heads, float scale, void* stream_) {
  if (!shapes_ok(R, N, C, heads)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const float* qkv = static_cast<const float*>(qkv_);
  const float* dout = static_cast<const float*>(dout_);
  float* dqkv = static_cast<float*>(dqkv_);
  float* stats = static_cast<float*>(stats_);
  cudaError_t e;
  if (N <= 16) e = launch_bwd_f32_short<1>(qkv, dout, dqkv, R, N, C, heads, scale, stream);
  else if (N <= 32) e = launch_bwd_f32_short<2>(qkv, dout, dqkv, R, N, C, heads, scale, stream);
  else if (stats == nullptr) e = cudaErrorInvalidValue;
  else e = launch_bwd_f32_passes(qkv, dout, dqkv, stats, R, N, C, heads, scale, stream);
  return (int)e;
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
