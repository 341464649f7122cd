// MixSTE pre-LN attention stage for Hopper (sm_90a):
//   y1 = LN1(x); qkv = y1 @ Wqkv + bqkv; o = softmax(q k^T * scale) v per head;
//   x2 = x + (o @ Wp + bp); y2 = LN2(x2).     Writes x2 and y2.
//
// Replaces the TPU kernels d3dp_tpu/ops/attention.py `_attn_stage_kernel`
// (launcher `_attention_stage_fwd`) with its DropPath input (`has_dp`, API
// `attention_stage_dp_p`: the branch, projection bias included, scaled per
// sequence in fp32 before the residual add; entry points
// `d3dp_attention_stage_dp_*`), and `_attn_stage_kernel_hm` (the `hmqkv`
// variant: qkv weights stacked head-major (h, C, 3d) outside the kernel;
// entry points `d3dp_attention_stage_hm_*`).
//
// The TPU kernel's lab switches arrive as `opts` and `mask_block` (the
// kOpt* flags in common.cuh); 0, 0 is the production math, which the
// `loop`, `batched`, `pipelined` and `phasesplit` schedules all compute:
//   kOptNormFirst (D3DP_SOFTMAX_FOLD != 1, bf16; all three forms): attend
//     rounds p / l to bf16 before P.V instead of folding 1/l into the output;
//   kOptBf16Exp (D3DP_ATTN_VARIANT=bf16exp, bf16; K1 and its DropPath form):
//     attend takes p = bf16(exp(bf16(s - m))) and sums l from it in fp32;
//   kOptNoY2 (noy2; K1 only): proj_ln2 writes x2 alone, y2 stays unwritten;
//   mask_block (D3DP_SPATIAL_GROUP=g; K1 only): the caller folds g sequences
//     of N0 <= 32 tokens into one of g * N0 (a view), and attend masks every
//     key outside the query's own block of N0, as JAX's additive -1e30 mask
//     does. bf16's tile reads only the whole blocks a pass of queries spans;
//     fp32 runs its short tile on each block of N0 alone (p of every other
//     key is 0 exactly), so g * N0 may exceed 256.
//
// What bounds it on the H100: the two projections (2*T*C*3C + 2*T*C*C FLOPs
// over T tokens) dominate; attention adds 4*T*N*C. At the MixSTE shapes
// (C=512, N=17 or 243) the stage is compute-bound in bf16 (about 2,000
// FLOPs per byte of activations), so the tensor cores set the bound.
//
// Design. A temporal sequence (243 x 512) is 249 KB in bf16 and its qkv
// 746 KB, more than a block's 227 KB of shared memory, so the TPU design
// (one whole sequence tile in VMEM) cannot carry over. The stage runs as
// three launches behind one C entry point:
//   1. ln_qkv:   `launch_ln_qkv` (stage.cuh, shared with resident.cu): in
//                bf16 a persistent grid walking 128-row tiles, LN1 into
//                swizzled shared memory, the qkv projection on wgmma
//                m64n128k16 (a warpgroup per 64 rows) in 128-column chunks
//                with Wqkv streamed by TMA through a ring of 16 KB slabs
//                both warpgroups read, + bqkv, bf16, out by TMA stores; qkv
//                goes to a scratch buffer.
//   2. attend:   `launch_attend` (common.cuh, shared with attention_qkv.cu,
//                attention_block.cu and resident.cu). Bytes bound it (qkv
//                in, o out). bf16 above 32 keys: one block per (sequence,
//                head) reads each key and value row once with cp.async in
//                64-key groups; each warp keeps its 16 query rows' fp32
//                logits for all keys (<=256) in mma.sync registers, so the
//                softmax stays exact over the whole row with no online
//                rescaling, and P goes to the P.V product in registers; a
//                persistent grid copies the next tile while one computes.
//                Spatial (17 keys), grouped views excepted: the short tile, a
//                sequence with all its heads a tile on a persistent grid,
//                its rows brought by bulk copies into a ring of stages,
//                a warp a head on mma.sync registers. fp32 runs its
//                tensor-core walk above 32 keys (mma.sync m16n8k8 in three
//                TF32 passes, a (sequence, head) a tile) and the short tile
//                on FMAs at 32 or fewer, masked ones included (each block
//                of mask_block tokens a sequence).
//                fp32: p is divided by l before P.V; bf16: P.V runs on the
//                unnormalised bf16 p and 1/l is folded into the output,
//                which is rounded to bf16 before the projection.
//   3. proj_ln2: `launch_proj_ln2` (stage.cuh, shared with
//                attention_block.cu): in bf16 the same walk shape, o @ Wp on
//                wgmma (m64n256k16 a warpgroup at C = 512) with x loaded
//                beside o, then the residual add and LN2 from the fragments,
//                x2 and y2 out by TMA stores.
//   fp32 runs steps 1 and 3 as the same walks in three TF32 passes
//   (`ln_qkv_walk_f32`, `proj_ln2_walk_f32`: tf32x3, mlp.cuh) from Wqkv's
//   and Wp's hi and lo planes, which the fp32 entry points take in place of
//   the weights (the host makes them once per weight version); its bound is
//   3 x the products at 495 TFLOP/s, 2.14 ms spatial and 2.60 ms temporal
//   at the eval shape.
// The split costs extra device-memory traffic (qkv and o written and read
// back, x read twice); at the eval shape that is about 1 GB a stage, 0.3
// ms at 3.35 TB/s, against the 0.36-0.43 ms the products bound it to.
//
// DropPath form: proj_ln2 scales each token row's branch by dp[row / N].
// Tensor-parallel partial form (`d3dp_attention_stage_partial_*`, the
// stage of a rank holding `heads` of the h heads, heads = h / tp): LN1 on
// the whole row, then ln_qkv over the rank's heads only (Wqkv (C, 3 * C_l),
// C_l = heads * 64: the rank's heads of q, of k and of v), attend on those
// heads, and the projection over the rank's C_l rows of Wp, (C_l, C),
// written raw in fp32 (R, N, C) with no bias, residual or LN2: the caller
// all-reduces the ranks' partials and runs residual_ln.cu. The three
// launches are K1's in either type (`launch_ln_qkv` with `heads` beside C,
// an odd count ending in a 64-column chunk; the projection walk's
// `kPartial` epilogue, `launch_proj_partial`); fp32 takes the rank's
// matrices as their TF32 hi and lo planes, as the whole stage does. The TPU
// package has no such kernel: under its tp mesh XLA runs the stage kernel
// on gathered operands. Bounds as K1's, by the rank's share of the
// products, plus C fp32 partials a token row out (4 bytes a value: the
// all-reduce's operand).
//
// Head-major tensor-parallel form (`d3dp_attention_stage_hm_partial_*`,
// K8-tp, the `hmqkv` variant under tp): K1-tp with the rank's qkv weights
// stacked head-major, (heads, C, 3d) and (heads, 3d): `launch_ln_qkv<T,
// true>` over the rank's heads, attend on their slabs, and the same raw
// projection. No new kernel: the walks are K8's (ln_qkv, attend) and
// K1-tp's (the projection's kPartial epilogue); only the host entry is new.
// The TPU package has none: under its tp mesh XLA runs `_attn_stage_kernel_hm`
// on gathered operands.
//
// Head-major form: ln_qkv loads each 64-column box of the (h, C, 3d) weights
// to where the packed step loads the same columns from (C, 3C), and writes
// qkv head-major, (h, R*N, 3d); attend reads head h's q, k and v from its
// slab with row stride 3d. Same products in the same order as the packed
// stage, so the two forms agree bit for bit.
#include "stage.cuh"

namespace d3dp {

// ---------------------------------------------------------------- host entry
// dp: nullptr, or R fp32 branch scales (one per sequence). kHeadMajor: wqkv
// (h, C, 3d), bqkv (h, 3d) and the qkv scratch (h, R*N, 3d). opts, mask_block:
// the lab switches (file header; 0, 0 for production).
template <typename T, bool kHeadMajor>
int attention_stage(const void* x, const void* wqkv, const void* bqkv, const void* wp,
                    const void* bp, const void* ln1s, const void* ln1b, const void* ln2s,
                    const void* ln2b, const void* dp, void* qkv, void* o, void* x2, void* y2,
                    int R, int N, int C, int heads, int opts, int mask_block, float scale,
                    float eps, void* stream_) {
  if (R < 1 || N < 1 || !attn_keys_ok(N, mask_block) || !stage_shape_ok<T>(C) ||
      heads * kHeadDim != C || R > 0x7fffffff / N || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const AttnOpts ao = attn_opts(opts, mask_block);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int M = R * N;
  int e = launch_ln_qkv<T, kHeadMajor>((const T*)x, (const T*)wqkv, (const float*)bqkv,
                                       (const float*)ln1s, (const float*)ln1b, (T*)qkv, M, C,
                                       heads, eps, stream);
  if (e) return e;
  if constexpr (kHeadMajor) {
    // head h's slab starts at h * M * 3d; the tile adds h * kHeadDim (the
    // head's column in token rows), which a slab does not have
    constexpr int d3 = 3 * kHeadDim;
    const T* slab = (const T*)qkv;
    e = (int)launch_attend<T>(slab, slab + kHeadDim, slab + 2 * kHeadDim, d3, (T*)o, R, N, C,
                              heads, scale, ao, stream, (long long)M * d3 - kHeadDim);
  } else {
    e = (int)launch_attend_packed<T>((const T*)qkv, (T*)o, R, N, C, heads, scale, ao, stream);
  }
  if (e) return e;
  return launch_proj_ln2<T>((const T*)o, (const T*)x, (const T*)wp, (const float*)bp,
                            (const float*)ln2s, (const float*)ln2b, (T*)x2, (T*)y2, M, C, eps,
                            stream, (const float*)dp, N, !(opts & kOptNoY2));
}

// The tensor-parallel partial forms (file header): x (R, N, C); wp (heads *
// 64, C); o (R, N, heads * 64); part (R, N, C) fp32. K1-tp: wqkv (C, 3 *
// heads * 64), qkv scratch (R, N, 3 * heads * 64). K8-tp (kHeadMajor): wqkv
// (heads, C, 3d), bqkv (heads, 3d), qkv scratch (heads, R*N, 3d). fp32 takes
// wqkv and wp as their planes (the whole forms' layouts at the rank's sizes).
template <typename T, bool kHeadMajor>
int attention_stage_partial(const void* x, const void* wqkv, const void* bqkv, const void* ln1s,
                            const void* ln1b, const void* wp, void* qkv, void* o, void* part,
                            int R, int N, int C, int heads, int opts, int mask_block,
                            float scale, float eps, void* stream_) {
  const int Cl = heads * kHeadDim;
  if (R < 1 || N < 1 || !attn_keys_ok(N, mask_block) || !stage_shape_ok<T>(C) || heads < 1 ||
      Cl > C || R > 0x7fffffff / N || (kHeadMajor && mask_block))
    return (int)cudaErrorInvalidValue;
  const AttnOpts ao = attn_opts(opts & ~kOptNoY2, mask_block);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int M = R * N;
  int e = launch_ln_qkv<T, kHeadMajor>((const T*)x, (const T*)wqkv, (const float*)bqkv,
                                       (const float*)ln1s, (const float*)ln1b, (T*)qkv, M, C,
                                       heads, eps, stream);
  if (e) return e;
  if constexpr (kHeadMajor) {
    // as K8: head h's slab starts at h * M * 3d (see attention_stage)
    constexpr int d3 = 3 * kHeadDim;
    const T* slab = (const T*)qkv;
    e = (int)launch_attend<T>(slab, slab + kHeadDim, slab + 2 * kHeadDim, d3, (T*)o, R, N, Cl,
                              heads, scale, ao, stream, (long long)M * d3 - kHeadDim);
  } else {
    e = (int)launch_attend_packed<T>((const T*)qkv, (T*)o, R, N, Cl, heads, scale, ao, stream);
  }
  if (e) return e;
  return launch_proj_partial<T>((const T*)o, (const T*)wp, (float*)part, M, Cl, C, stream);
}

}  // namespace d3dp

#define D3DP_STAGE_ARGS                                                                         \
  const void *x, const void *wqkv, const void *bqkv, const void *wp, const void *bp,           \
      const void *ln1s, const void *ln1b, const void *ln2s, const void *ln2b
#define D3DP_STAGE_TAIL                                                                         \
  void *qkv, void *o, void *x2, void *y2, int R, int N, int C, int heads, int opts,           \
      int mask_block, float scale, float eps, void *stream
#define D3DP_STAGE_CALL(T, HM, DP)                                                              \
  d3dp::attention_stage<T, HM>(x, wqkv, bqkv, wp, bp, ln1s, ln1b, ln2s, ln2b, DP, qkv, o, x2, \
                               y2, R, N, C, heads, opts, mask_block, scale, eps, stream)

extern "C" {

// Each entry: opts, mask_block as in the file header (0, 0: production).
// K1: x (R, N, C); wqkv (C, 3C); qkv scratch (R, N, 3C). fp32 (every
// whole form): wqkv and wp are their hi and lo planes, (2, 3C, C) and (2,
// C, C); K8's wqkv (h, 2, 3d, C) (stage.cuh).
int d3dp_attention_stage_bf16(D3DP_STAGE_ARGS, D3DP_STAGE_TAIL) {
  return D3DP_STAGE_CALL(d3dp::bf16, false, nullptr);
}

int d3dp_attention_stage_f32(D3DP_STAGE_ARGS, D3DP_STAGE_TAIL) {
  return D3DP_STAGE_CALL(float, false, nullptr);
}

// K1 with DropPath: dp (R,) fp32.
int d3dp_attention_stage_dp_bf16(D3DP_STAGE_ARGS, const void* dp, D3DP_STAGE_TAIL) {
  return D3DP_STAGE_CALL(d3dp::bf16, false, dp);
}

int d3dp_attention_stage_dp_f32(D3DP_STAGE_ARGS, const void* dp, D3DP_STAGE_TAIL) {
  return D3DP_STAGE_CALL(float, false, dp);
}

// K8: wqkv (h, C, 3d), bqkv (h, 1, 3d); qkv scratch (h, R*N, 3d).
int d3dp_attention_stage_hm_bf16(D3DP_STAGE_ARGS, D3DP_STAGE_TAIL) {
  return D3DP_STAGE_CALL(d3dp::bf16, true, nullptr);
}

int d3dp_attention_stage_hm_f32(D3DP_STAGE_ARGS, D3DP_STAGE_TAIL) {
  return D3DP_STAGE_CALL(float, true, nullptr);
}

// K1-tp: a rank's `heads` heads; part (R, N, C) fp32 (the partial form above).
// fp32: wqkv and wp are their hi and lo planes, (2, 3 * heads * 64, C) and
// (2, C, heads * 64); K8-tp's wqkv (heads, 2, 3d, C).
#define D3DP_PARTIAL_ARGS                                                                       \
  const void *x, const void *wqkv, const void *bqkv, const void *ln1s, const void *ln1b,       \
      const void *wp, void *qkv, void *o, void *part, int R, int N, int C, int heads, int opts, \
      int mask_block, float scale, float eps, void *stream
#define D3DP_PARTIAL_CALL(T, HM)                                                                \
  d3dp::attention_stage_partial<T, HM>(x, wqkv, bqkv, ln1s, ln1b, wp, qkv, o, part, R, N, C,    \
                                       heads, opts, mask_block, scale, eps, stream)

int d3dp_attention_stage_partial_bf16(D3DP_PARTIAL_ARGS) {
  return D3DP_PARTIAL_CALL(d3dp::bf16, false);
}

int d3dp_attention_stage_partial_f32(D3DP_PARTIAL_ARGS) { return D3DP_PARTIAL_CALL(float, false); }

// K8-tp: the head-major form of K1-tp; wqkv (heads, C, 3d), bqkv (heads, 3d).
int d3dp_attention_stage_hm_partial_bf16(D3DP_PARTIAL_ARGS) {
  return D3DP_PARTIAL_CALL(d3dp::bf16, true);
}

int d3dp_attention_stage_hm_partial_f32(D3DP_PARTIAL_ARGS) {
  return D3DP_PARTIAL_CALL(float, true);
}

}  // extern "C"
