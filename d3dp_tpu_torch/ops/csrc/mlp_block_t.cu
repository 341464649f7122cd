// MixSTE MLP half-block, for Hopper (sm_90a):
//   y = LN(res + (GELU(x @ W1 + b1) @ W2 + b2))
// in two forms, one kernel with a template flag for the output layout:
//   transposing (K2): x, res (B, D1, D2, C), y written as (B, D2, D1, C);
//   rows (K5):        x, res (R, C), y written row for row as (R, C).
//
// Replaces the TPU kernels d3dp_tpu/ops/mlp.py `_mlp_block_t_kernel`
// (launcher `_mlp_block_t_fwd`) and `_mlp_block_kernel` (launcher
// `_mlp_block_fwd`, API `mlp_block_p`, fuse levels 1 and 2), with their
// DropPath input (`has_dp`, APIs `mlp_block_t_dp_p` and `mlp_block_dp_p`):
// a per-row fp32 scale of the branch, fc2's bias included, before the
// residual add (the `*_dp_*` entry points). The GELU uses CUDA's erff where
// the TPU kernels evaluate the A&S 7.1.26 polynomial (<=1.5e-7 abs). Their
// lab switch D3DP_MLP_VARIANT arrives as each entry point's `gelu` (kGelu*
// in mlp.cuh): bf16gelu (bf16 only) evaluates that polynomial op by op in
// bf16, as the TPU kernel does; nogelu puts the identity in its place.
//
// What bounds both on the H100: 4*T*C*H FLOPs for T tokens against 3*T*C
// activation elements moved (x, res in; y out) -- about 680 FLOPs per byte
// in bf16 at C=512, H=1024, so the tensor cores set the bound.
//
// Design. The LayerNorm needs all C outputs of a row, so one block owns
// whole rows: 32 tokens (bf16; 16 in fp32). Its x rows, the whole hidden
// activation h (32 x 1024, rounded to the compute type as the TPU kernel
// does) and the fp32 output rows stay in shared memory, so h never touches
// device memory. W1 and W2 stream through a 64 x 64 staging tile. Each token
// row (b, i, j) is written whole to output row (b, j, i): a C-wide
// contiguous store, so the relayout costs no extra pass (the rows form
// writes it to row t). Tokens are taken in flat order, so the 243-frame axis
// simply ends in a partial last block. The body is `mlp_tile` (mlp.cuh,
// shared with resident.cu), one row block a block.
#include "mlp.cuh"

namespace d3dp {

template <typename T, bool kTranspose>
__global__ void __launch_bounds__(kThreads)
mlp_block_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ lns,
                   const float* __restrict__ lnb, T* __restrict__ out, int D1, int D2, int M,
                   int C, int H, float eps, MlpLayout<T> L, const float* __restrict__ dp,
                   int gelu_mode) {
  extern __shared__ __align__(128) unsigned char smem[];
  mlp_tile<T, kTranspose>(x, res, w1, b1, w2, b2, lns, lnb, out, D1, D2, M, C, H, eps, L, smem,
                          blockIdx.x, dp, gelu_mode);
}

// dp: nullptr, or B * D1 fp32 branch scales (the rows form passes D1 = R,
// D2 = 1: one scale per row); gelu: a kGelu* activation
template <typename T, bool kTranspose>
int mlp_block_any(const void* x, const void* res, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* lns, const void* lnb,
                  const void* dp, void* out, int B, int D1, int D2, int C, int H, int gelu,
                  float eps, void* stream_) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (B < 1 || D1 < 1 || D2 < 1 || C % 64 != 0 || C > 1024 || H % 64 != 0 ||
      (long long)B * D1 * D2 > 0x7fffffffLL || gelu < kGeluErf || gelu > kGeluNone ||
      (f32 && gelu == kGeluBf16))
    return (int)cudaErrorInvalidValue;
  const int M = B * D1 * D2;
  const MlpLayout<T> L(C, H);
  cudaError_t e = cudaFuncSetAttribute(mlp_block_kernel<T, kTranspose>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  mlp_block_kernel<T, kTranspose><<<cdiv(M, Cfg<T>::BM), kThreads, L.total,
                                      static_cast<cudaStream_t>(stream_)>>>(
      (const T*)x, (const T*)res, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)lns, (const float*)lnb, (T*)out, D1, D2, M, C, H, eps, L,
      (const float*)dp, gelu);
  return (int)cudaGetLastError();
}

}  // namespace d3dp

#define D3DP_MLP_ARGS                                                                           \
  const void *x, const void *res, const void *w1, const void *b1, const void *w2,               \
      const void *b2, const void *lns, const void *lnb
#define D3DP_MLP_CALL(T, TR, DP, B, D1, D2)                                                     \
  d3dp::mlp_block_any<T, TR>(x, res, w1, b1, w2, b2, lns, lnb, DP, out, B, D1, D2, C, H, gelu, \
                             eps, stream)

extern "C" {

// Each entry: gelu one of d3dp::kGelu* (mlp.cuh).
// K2: x, res (B, D1, D2, C); out (B, D2, D1, C).
int d3dp_mlp_block_t_bf16(D3DP_MLP_ARGS, void* out, int B, int D1, int D2, int C, int H,
                          int gelu, float eps, void* stream) {
  return D3DP_MLP_CALL(d3dp::bf16, true, nullptr, B, D1, D2);
}

int d3dp_mlp_block_t_f32(D3DP_MLP_ARGS, void* out, int B, int D1, int D2, int C, int H, int gelu,
                         float eps, void* stream) {
  return D3DP_MLP_CALL(float, true, nullptr, B, D1, D2);
}

// K2 with DropPath: dp (B, D1) fp32.
int d3dp_mlp_block_t_dp_bf16(D3DP_MLP_ARGS, const void* dp, void* out, int B, int D1, int D2,
                             int C, int H, int gelu, float eps, void* stream) {
  return D3DP_MLP_CALL(d3dp::bf16, true, dp, B, D1, D2);
}

int d3dp_mlp_block_t_dp_f32(D3DP_MLP_ARGS, const void* dp, void* out, int B, int D1, int D2,
                            int C, int H, int gelu, float eps, void* stream) {
  return D3DP_MLP_CALL(float, true, dp, B, D1, D2);
}

// K5: (R, C) rows in, (R, C) rows out.
int d3dp_mlp_block_bf16(D3DP_MLP_ARGS, void* out, int R, int C, int H, int gelu, float eps,
                        void* stream) {
  return D3DP_MLP_CALL(d3dp::bf16, false, nullptr, 1, R, 1);
}

int d3dp_mlp_block_f32(D3DP_MLP_ARGS, void* out, int R, int C, int H, int gelu, float eps,
                       void* stream) {
  return D3DP_MLP_CALL(float, false, nullptr, 1, R, 1);
}

// K5 with DropPath: dp (R,) fp32.
int d3dp_mlp_block_dp_bf16(D3DP_MLP_ARGS, const void* dp, void* out, int R, int C, int H,
                           int gelu, float eps, void* stream) {
  return D3DP_MLP_CALL(d3dp::bf16, false, dp, 1, R, 1);
}

int d3dp_mlp_block_dp_f32(D3DP_MLP_ARGS, const void* dp, void* out, int R, int C, int H,
                          int gelu, float eps, void* stream) {
  return D3DP_MLP_CALL(float, false, dp, 1, R, 1);
}

}  // extern "C"
