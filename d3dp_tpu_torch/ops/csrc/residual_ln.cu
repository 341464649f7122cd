// The residual-LayerNorm epilogue of a tensor-parallel block half, for Hopper
// (sm_90a):
//   x2 = res + (part + bias);  y = LN(x2)
// or, with DropPath scales dp, x2 = res + dp[row / dp_div] * (part + bias),
// over token rows, part the fp32 sum of the ranks' partial products (the
// all-reduce of K1-tp's, K6-tp's or K2/K5-tp's outputs). Writes x2 (unless
// given no buffer: the MLP half needs only y) and y in the compute type; y
// row for row, or with the MLP's relayout: row t = (b, i, j) of (B, D1, D2)
// to row (b, j, i), K2's (B, D1, D2, C) -> (B, D2, D1, C).
//
// It completes what the un-split kernels do in their epilogues (the
// `proj_ln2` walk of stage.cuh, the MLP walk of mlp.cuh) after the sum over
// the ranks: the bias is added once, after the sum; the sum rounds as theirs
// do, res + (product + bias) in fp32, and the statistics are two-pass fp32
// (`warp_layernorm`). The TPU package has no such kernel: under its tp mesh
// XLA inserts the all-reduce and runs the stage and MLP kernels on gathered
// operands.
//
// DropPath (training under tp with `D3DP_TRAIN_FUSED=1`): the branch, its
// bias included, is scaled by one fp32 value a group of dp_div rows before
// the residual add, as the DropPath forms of the stage and MLP kernels scale
// theirs (K1-dp `proj_ln2`: one a sequence of N tokens; K2-dp / K5-dp: one
// a (b, i) of (B, D1), D2 rows). dp == nullptr leaves the arithmetic as it is.
//
// What bounds it on the H100: bytes. Each row reads C fp32 partials and C
// residual values and writes one or two C-wide rows: at the eval shape
// (165,240 rows, C = 512, bf16) 0.68 GB for the attention half, 0.51 GB for
// the MLP's, 0.20 / 0.15 ms at 3.35 TB/s, against 10 FLOPs a value.
//
// Design: one warp a row (lane l holds channels l, l + 32, ..., so each of
// its C / 32 loads and stores is one coalesced warp-wide access), 8 rows a
// block of 256 threads, the row in registers between the sum and the
// normalisation. A transposed row is written whole to its output row, as K2
// writes it.
#include "mlp.cuh"

namespace d3dp {

template <typename T, bool kTranspose>
__global__ void __launch_bounds__(kThreads)
residual_ln_kernel(const T* __restrict__ res, const float* __restrict__ part,
                   const float* __restrict__ bias, const float* __restrict__ lns,
                   const float* __restrict__ lnb, const float* __restrict__ dp, int dp_div,
                   T* __restrict__ x2, T* __restrict__ y, int D1, int D2, int M, int C,
                   float eps) {
  const int lane = threadIdx.x % 32;
  const int t = blockIdx.x * kWarps + threadIdx.x / 32;
  if (t >= M) return;
  const T* rr = res + (size_t)t * C;
  const float* pr = part + (size_t)t * C;
  const float s = dp ? dp[t / dp_div] : 1.f;
  float v[32];
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < C / 32) {
      const int c = 32 * k + lane;
      v[k] = to_f(rr[c]) + __fmul_rn(s, pr[c] + bias[c]);
      if (x2) x2[(size_t)t * C + c] = from_f<T>(v[k]);
    }
  warp_layernorm(v, C, lns, lnb, eps, lane);
  T* yr = y + mlp_out_row(t, D1, D2, kTranspose) * C;
#pragma unroll
  for (int k = 0; k < 32; ++k)
    if (k < C / 32) yr[32 * k + lane] = from_f<T>(v[k]);
}

// res, part (B, D1, D2, C) as rows (res in T, part fp32); bias, lns, lnb
// (C,) fp32; dp nullptr, or the fp32 scales of groups of dp_div rows; x2
// (rows, in T) or nullptr; y (B, D1, D2, C), or (B, D2, D1, C) with
// transpose.
template <typename T>
int residual_ln(const void* res, const void* part, const void* bias, const void* lns,
                const void* lnb, const void* dp, int dp_div, void* x2, void* y, int B, int D1,
                int D2, int C, int transpose, float eps, void* stream_) {
  if (B < 1 || D1 < 1 || D2 < 1 || C < 32 || C > 1024 || C % 32 || dp_div < 1 ||
      (long long)B * D1 * D2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int M = B * D1 * D2;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  auto kernel = transpose ? &residual_ln_kernel<T, true> : &residual_ln_kernel<T, false>;
  kernel<<<cdiv(M, kWarps), kThreads, 0, stream>>>(
      (const T*)res, (const float*)part, (const float*)bias, (const float*)lns,
      (const float*)lnb, (const float*)dp, dp_div, (T*)x2, (T*)y, D1, D2, M, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace d3dp

extern "C" {

// dp: nullptr (no DropPath) or the scales of groups of dp_div rows.
int d3dp_residual_ln_bf16(const void* res, const void* part, const void* bias, const void* lns,
                          const void* lnb, const void* dp, int dp_div, void* x2, void* y, int B,
                          int D1, int D2, int C, int transpose, float eps, void* stream) {
  return d3dp::residual_ln<d3dp::bf16>(res, part, bias, lns, lnb, dp, dp_div, x2, y, B, D1, D2,
                                       C, transpose, eps, stream);
}

int d3dp_residual_ln_f32(const void* res, const void* part, const void* bias, const void* lns,
                         const void* lnb, const void* dp, int dp_div, void* x2, void* y, int B,
                         int D1, int D2, int C, int transpose, float eps, void* stream) {
  return d3dp::residual_ln<float>(res, part, bias, lns, lnb, dp, dp_div, x2, y, B, D1, D2, C,
                                  transpose, eps, stream);
}

}  // extern "C"
