// The MLP half-block as a tile function, shared by the MLP-block kernels
// (mlp_block_t.cu, whose header describes the design) and the
// depth-resident kernel (resident.cu):
//   y = LN(res + (GELU(x @ W1 + b1) @ W2 + b2)) over one block of BM
// token rows, each written whole to its output row.
#pragma once

#include "common.cuh"

namespace d3dp {

// The activation, per launch: D3DP_MLP_VARIANT of the TPU MLP kernels
// (`_gelu_inkernel`, d3dp_tpu/ops/mlp.py).
constexpr int kGeluErf = 0;   // production: 0.5 v (1 + erf(v / sqrt 2)), fp32
constexpr int kGeluBf16 = 1;  // bf16gelu (bf16 only): the A&S 7.1.26 erf in bf16
constexpr int kGeluNone = 2;  // nogelu: the identity

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// bf16gelu as the JAX kernel spells it: z = v / sqrt 2 in fp32, |z| rounded
// to bf16 and sign(z), then t = 1 / (1 + p |z|), the polynomial in t, erf =
// sign * (1 - poly * exp(-|z|^2)) and 0.5 * bf16(v) * (1 + erf) with every
// constant and every operation rounded to bf16 (JAX's weak-typed constants
// take the bf16 operand's type).
__device__ __forceinline__ float gelu_bf16(float v) {
  const float z = v * 0.70710678118654752f;
  const float a = bf16_round(fabsf(z));
  const float sgn = (float)((z > 0.f) - (z < 0.f));
  const float t = bf16_round(1.f / bf16_round(1.f + bf16_round(bf16_round(0.3275911f) * a)));
  float p = bf16_round(t * bf16_round(1.061405429f));
  p = bf16_round(t * bf16_round(bf16_round(-1.453152027f) + p));
  p = bf16_round(t * bf16_round(bf16_round(1.421413741f) + p));
  p = bf16_round(t * bf16_round(bf16_round(-0.284496736f) + p));
  p = bf16_round(t * bf16_round(bf16_round(0.254829592f) + p));
  const float e = bf16_round(expf(bf16_round(-a * a)));
  const float erf = bf16_round(sgn * bf16_round(1.f - bf16_round(p * e)));
  return bf16_round(bf16_round(0.5f * bf16_round(v)) * bf16_round(1.f + erf));
}

__device__ __forceinline__ float activation(float v, int mode) {
  return mode == kGeluNone ? v : mode == kGeluBf16 ? gelu_bf16(v) : gelu_erf(v);
}

template <typename T>
struct MlpLayout {
  int lda, ldh, lds;
  size_t a, h, s, c, b, total;
  MlpLayout() = default;
  explicit MlpLayout(int C, int H) {
    constexpr int BM = Cfg<T>::BM;
    lda = C + Cfg<T>::PAD;
    ldh = H + Cfg<T>::PAD;
    lds = C + 4;
    size_t off = 0;
    a = off; off += align128(sizeof(T) * BM * lda);
    h = off; off += align128(sizeof(T) * BM * ldh);
    s = off; off += align128(sizeof(float) * BM * lds);
    c = off; off += align128(sizeof(float) * BM * (kBN + 4));
    b = off; off += bs_bytes<T>();
    total = off;
  }
};

// One tile: the row block `tile` (BM token rows from BM * tile).
// kTranspose: token row t = (b, i, j) of (B, D1, D2) goes to output row
// (b, j, i); otherwise to row t (D1, D2 unused). Pointers carry no
// __restrict__ (see attend_tile in common.cuh).
// DropPath: with dp, the branch (fc2 and its bias) of token row t is scaled
// by dp[t / D2] in fp32 before the residual add: one scale per (b, i) of the
// transposing form's (B, D1) and, with D2 = 1, one per row of the rows
// form; dp == nullptr leaves the arithmetic as it is without.
// gelu_mode: one of the kGelu* activations (kGeluBf16 only in bf16).
template <typename T, bool kTranspose>
__device__ __forceinline__ void mlp_tile(const T* x, const T* res, const T* w1, const float* b1,
                                         const T* w2, const float* b2, const float* lns,
                                         const float* lnb, T* out, int D1, int D2, int M, int C,
                                         int H, float eps, const MlpLayout<T>& L,
                                         unsigned char* smem, int tile,
                                         const float* dp = nullptr, int gelu_mode = kGeluErf) {
  constexpr int BM = Cfg<T>::BM;
  constexpr int ldc = kBN + 4;
  T* As = reinterpret_cast<T*>(smem + L.a);
  T* Hs = reinterpret_cast<T*>(smem + L.h);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Cs = reinterpret_cast<float*>(smem + L.c);
  T* Bs = reinterpret_cast<T*>(smem + L.b);

  const int row0 = tile * BM;
  load_rows(As, L.lda, x + (size_t)row0 * C, C, BM, M - row0, C);
  __syncthreads();

  // h = GELU(x @ W1 + b1), 64 hidden columns at a time
  for (int n0 = 0; n0 < H; n0 += kBN) {
    gemm_rowblock(As, L.lda, w1 + n0, H, C, Bs, Cs, ldc);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      Hs[r * L.ldh + n0 + c] = from_f<T>(activation(Cs[r * ldc + c] + b1[n0 + c], gelu_mode));
    }
  }
  __syncthreads();
  // h @ W2 into the fp32 row buffer
  for (int n0 = 0; n0 < C; n0 += kBN) gemm_rowblock(Hs, L.ldh, w2 + n0, C, H, Bs, Ss + n0, L.lds);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int t = row0 + r;
    if (t >= M) continue;
    size_t orow_idx = t;
    if constexpr (kTranspose) {
      const int plane = D1 * D2;
      const int b = t / plane, rem = t % plane;
      const int i = rem / D2, j = rem % D2;
      orow_idx = (size_t)(b * D2 + j) * D1 + i;
    }
    const T* rr = res + (size_t)t * C;
    const float keep = dp ? dp[t / D2] : 1.f;
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) {
        const int c = 32 * k + lane;
        const float branch = Ss[r * L.lds + c] + b2[c];
        // res + (out + b2), or res + dp * (out + b2) rounded apart (no FMA)
        v[k] = dp ? to_f(rr[c]) + __fmul_rn(branch, keep) : to_f(rr[c]) + branch;
      }
    warp_layernorm(v, C, lns, lnb, eps, lane);
    T* orow = out + orow_idx * C;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) orow[32 * k + lane] = from_f<T>(v[k]);
  }
}

}  // namespace d3dp
