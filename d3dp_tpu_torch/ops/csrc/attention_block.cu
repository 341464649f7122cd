// MixSTE attention block from a precomputed qkv projection, for Hopper
// (sm_90a):
//   o = softmax(q k^T * scale) v per head;  x2 = res + (o @ Wp + bp);
//   y2 = LN2(x2).     qkv: (R, N, 3C), res: (R, N, C). Writes x2 and y2.
//
// Replaces the TPU kernel d3dp_tpu/ops/attention.py `_attn_block_kernel`
// (launcher `_attention_block_fwd`, API `attention_block_p`), used at fuse
// levels 2 and 3, where LN1 and the qkv projection stay plain ops.
//
// What bounds it on the H100: 6*T*C activation elements move (qkv in, res
// in, x2 and y2 out), 1.015 GB in bf16 at the eval shapes (0.303 ms at 3.35
// TB/s), against 4*T*N*C + 2*T*C*C FLOPs (0.093 ms spatial, 0.171 ms
// temporal at 989 TFLOP/s): bytes set the bound.
//
// Design: the attention stage (attention_stage.cu) without its first launch.
//   1. attend:   `launch_attend` (common.cuh) on the packed qkv, p divided
//                by l BEFORE the cast to the compute type, as the TPU kernel
//                does (`:244`; the stage folds 1/l in after P.V instead);
//                the attention output is rounded to the compute type into
//                a scratch buffer (the TPU kernel's `acc_ref`).
//   2. proj_ln2: `launch_proj_ln2` (stage.cuh), the stage's third launch:
//                in bf16 a persistent grid of 64-row wgmma tiles with Wp
//                streamed by TMA, the residual add and LN2 from the
//                fragments, x2 and y2 out by TMA stores.
// The split writes o and reads it back (2*T*C elements); one fused pass
// per (sequence, query block) is later work.
//
// Tensor-parallel partial form (`d3dp_attention_block_partial_*`, levels
// 2-3 on a rank holding `heads` of the h heads): attend on the rank's qkv
// (R, N, 3 * C_l), C_l = heads * 64, then its rows of the projection, (C_l,
// C), written raw in fp32 (R, N, C): no bias, residual or LN2, which follow
// the all-reduce over the ranks (residual_ln.cu). The projection is the
// walk's `kPartial` epilogue (`launch_proj_partial`, stage.cuh) in either
// type (fp32: the rank's Wp as its TF32 planes, (2, C, C_l)), shared with
// the stage's partial form.
#include "stage.cuh"

namespace d3dp {

template <typename T>
int attention_block(const void* qkv, const void* res, const void* wp, const void* bp,
                    const void* lns, const void* lnb, void* o, void* x2, void* y2, int R, int N,
                    int C, int heads, float scale, float eps, void* stream_) {
  if (R < 1 || N < 1 || N > kMaxKeys || !stage_shape_ok<T>(C) || heads * kHeadDim != C ||
      R > 0x7fffffff / N || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t e = launch_attend_packed<T>((const T*)qkv, (T*)o, R, N, C, heads, scale,
                                          norm_first_opts(), stream);
  if (e != cudaSuccess) return (int)e;
  return launch_proj_ln2<T>((const T*)o, (const T*)res, (const T*)wp, (const float*)bp,
                            (const float*)lns, (const float*)lnb, (T*)x2, (T*)y2, R * N, C, eps,
                            stream);
}

template <typename T>
int attention_block_partial(const void* qkv, const void* wp, void* o, void* part, int R, int N,
                            int C, int heads, float scale, void* stream_) {
  const int Cl = heads * kHeadDim;
  if (R < 1 || N < 1 || N > kMaxKeys || !stage_shape_ok<T>(C) || heads < 1 || Cl > C ||
      R > 0x7fffffff / N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t e = launch_attend_packed<T>((const T*)qkv, (T*)o, R, N, Cl, heads, scale,
                                          norm_first_opts(), stream);
  if (e != cudaSuccess) return (int)e;
  return launch_proj_partial<T>((const T*)o, (const T*)wp, (float*)part, R * N, Cl, C, stream);
}

}  // namespace d3dp

extern "C" {

int d3dp_attention_block_bf16(const void* qkv, const void* res, const void* wp, const void* bp,
                              const void* lns, const void* lnb, void* o, void* x2, void* y2,
                              int R, int N, int C, int heads, float scale, float eps,
                              void* stream) {
  return d3dp::attention_block<d3dp::bf16>(qkv, res, wp, bp, lns, lnb, o, x2, y2, R, N, C, heads,
                                           scale, eps, stream);
}

// fp32: wp is its hi and lo planes, (2, C, C) (stage.cuh).
int d3dp_attention_block_f32(const void* qkv, const void* res, const void* wp, const void* bp,
                             const void* lns, const void* lnb, void* o, void* x2, void* y2, int R,
                             int N, int C, int heads, float scale, float eps, void* stream) {
  return d3dp::attention_block<float>(qkv, res, wp, bp, lns, lnb, o, x2, y2, R, N, C, heads,
                                      scale, eps, stream);
}

// K6-tp: qkv (R, N, 3 * heads * 64), wp (heads * 64, C) (fp32: its planes,
// (2, C, heads * 64)), o scratch (R, N, heads * 64), part (R, N, C) fp32.
int d3dp_attention_block_partial_bf16(const void* qkv, const void* wp, void* o, void* part, int R,
                                      int N, int C, int heads, float scale, void* stream) {
  return d3dp::attention_block_partial<d3dp::bf16>(qkv, wp, o, part, R, N, C, heads, scale,
                                                   stream);
}

int d3dp_attention_block_partial_f32(const void* qkv, const void* wp, void* o, void* part, int R,
                                     int N, int C, int heads, float scale, void* stream) {
  return d3dp::attention_block_partial<float>(qkv, wp, o, part, R, N, C, heads, scale, stream);
}

}  // extern "C"
