// MixSTE pre-LN attention stage for Hopper (sm_90a):
//   y1 = LN1(x); qkv = y1 @ Wqkv + bqkv; o = softmax(q k^T * scale) v per head;
//   x2 = x + (o @ Wp + bp); y2 = LN2(x2).     Writes x2 and y2.
//
// Replaces the TPU kernel d3dp_tpu/ops/attention.py `_attn_stage_kernel`
// (launcher `_attention_stage_fwd`), the production per-head math; its lab
// schedules (batched, pipelined, phasesplit, bf16exp, noy2, grouped spatial)
// are not ported.
//
// What bounds it on the H100: the two projections (2*T*C*3C + 2*T*C*C FLOPs
// over T tokens) dominate; attention adds 4*T*N*C. At the MixSTE shapes
// (C=512, N=17 or 243) the stage is compute-bound in bf16 (about 2,000
// FLOPs per byte of activations), so the tensor cores set the bound.
//
// Design. A temporal sequence (243 x 512) is 249 KB in bf16 and its qkv
// 746 KB, more than a block's 227 KB of shared memory, so the TPU design
// (one whole sequence tile in VMEM) cannot carry over. This first version
// runs the stage as three launches behind one C entry point:
//   1. ln_qkv:   32-token row blocks: LN1 into shared memory, then the qkv
//                projection in 64-column steps on the tensor cores; qkv is
//                rounded to the compute type after its bias (as the TPU
//                kernel does) and written to a scratch buffer.
//   2. attend:   one block per (sequence, head, block of <=64 queries); all
//                keys of the sequence (<=256, tail masked) sit in shared
//                memory with the fp32 logits, so the softmax is exact over
//                the whole row with no online rescaling (`attend_kernel` in
//                common.cuh, shared with attention_qkv.cu).
//                fp32: p is divided by l before P.V; bf16: P.V runs on the
//                unnormalised bf16 p and 1/l is folded into the output,
//                which is rounded to bf16 before the projection.
//   3. proj_ln2: 32-token row blocks: o @ Wp into an fp32 row buffer, then
//                the residual add and LN2 per row (`proj_ln2_kernel` in
//                common.cuh, shared with attention_block.cu).
// The split costs extra device-memory traffic (qkv and o written and read
// back, x read twice); fusing the stage into one pass is later work.
#include "common.cuh"

namespace d3dp {

// ---------------------------------------------------------------- 1. LN1 + qkv
// `ln_qkv_tile` (common.cuh, shared with resident.cu), one row block a block.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
              const float* __restrict__ bqkv, const float* __restrict__ ln1s,
              const float* __restrict__ ln1b, T* __restrict__ qkv, int M, int C, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_qkv_tile<T>(x, wqkv, bqkv, ln1s, ln1b, qkv, M, C, eps, smem, blockIdx.x);
}

// ---------------------------------------------------------------- host entry
template <typename T>
int attention_stage(const void* x, const void* wqkv, const void* bqkv, const void* wp,
                    const void* bp, const void* ln1s, const void* ln1b, const void* ln2s,
                    const void* ln2b, void* qkv, void* o, void* x2, void* y2, int R, int N,
                    int C, int heads, float scale, float eps, void* stream_) {
  if (R < 1 || N < 1 || N > kMaxKeys || C % 64 != 0 || C > 1024 || heads * kHeadDim != C ||
      R > 0x7fffffff / N || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  const int M = R * N;
  constexpr int BM = Cfg<T>::BM;
  cudaError_t e;

  const size_t s1 = ln_qkv_smem<T>(C);
  if ((e = cudaFuncSetAttribute(ln_qkv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)s1)) != cudaSuccess)
    return (int)e;
  ln_qkv_kernel<T><<<cdiv(M, BM), kThreads, s1, stream>>>(
      (const T*)x, (const T*)wqkv, (const float*)bqkv, (const float*)ln1s, (const float*)ln1b,
      (T*)qkv, M, C, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  if ((e = launch_attend_packed<T, false>((const T*)qkv, (T*)o, R, N, C, heads, scale,
                                          stream)) != cudaSuccess)
    return (int)e;
  return (int)launch_proj_ln2<T>((const T*)o, (const T*)x, (const T*)wp, (const float*)bp,
                                 (const float*)ln2s, (const float*)ln2b, (T*)x2, (T*)y2, M, C,
                                 eps, stream);
}

}  // namespace d3dp

extern "C" {

int d3dp_attention_stage_bf16(const void* x, const void* wqkv, const void* bqkv, const void* wp,
                              const void* bp, const void* ln1s, const void* ln1b,
                              const void* ln2s, const void* ln2b, void* qkv, void* o, void* x2,
                              void* y2, int R, int N, int C, int heads, float scale, float eps,
                              void* stream) {
  return d3dp::attention_stage<d3dp::bf16>(x, wqkv, bqkv, wp, bp, ln1s, ln1b, ln2s, ln2b, qkv,
                                           o, x2, y2, R, N, C, heads, scale, eps, stream);
}

int d3dp_attention_stage_f32(const void* x, const void* wqkv, const void* bqkv, const void* wp,
                             const void* bp, const void* ln1s, const void* ln1b,
                             const void* ln2s, const void* ln2b, void* qkv, void* o, void* x2,
                             void* y2, int R, int N, int C, int heads, float scale, float eps,
                             void* stream) {
  return d3dp::attention_stage<float>(x, wqkv, bqkv, wp, bp, ln1s, ln1b, ln2s, ln2b, qkv, o,
                                      x2, y2, R, N, C, heads, scale, eps, stream);
}

}  // extern "C"
