// MixSTE MLP half-block, for Hopper (sm_90a):
//   y = LN(res + (GELU_erf(x @ W1 + b1) @ W2 + b2))
// in two forms, one kernel with a template flag for the output layout:
//   transposing (K2): x, res (B, D1, D2, C), y written as (B, D2, D1, C);
//   rows (K5):        x, res (R, C), y written row for row as (R, C).
//
// Replaces the TPU kernels d3dp_tpu/ops/mlp.py `_mlp_block_t_kernel`
// (launcher `_mlp_block_t_fwd`) and `_mlp_block_kernel` (launcher
// `_mlp_block_fwd`, API `mlp_block_p`, fuse levels 1 and 2); their lab
// switches (bf16gelu, nogelu) and the training-only DropPath input are not
// ported. The GELU uses CUDA's erff where the TPU kernels evaluate the A&S
// 7.1.26 polynomial (<=1.5e-7 abs).
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
// simply ends in a partial last block.
#include "common.cuh"

namespace d3dp {

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

template <typename T>
struct MlpLayout {
  int lda, ldh, lds;
  size_t a, h, s, c, b, total;
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

// kTranspose: token row t = (b, i, j) of (B, D1, D2) goes to output row
// (b, j, i); otherwise to row t (D1, D2 unused).
template <typename T, bool kTranspose>
__global__ void __launch_bounds__(kThreads)
mlp_block_kernel(const T* __restrict__ x, const T* __restrict__ res, const T* __restrict__ w1,
                   const float* __restrict__ b1, const T* __restrict__ w2,
                   const float* __restrict__ b2, const float* __restrict__ lns,
                   const float* __restrict__ lnb, T* __restrict__ out, int D1, int D2, int M,
                   int C, int H, float eps, MlpLayout<T> L) {
  constexpr int BM = Cfg<T>::BM;
  constexpr int ldc = kBN + 4;
  extern __shared__ __align__(128) unsigned char smem[];
  T* As = reinterpret_cast<T*>(smem + L.a);
  T* Hs = reinterpret_cast<T*>(smem + L.h);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* Cs = reinterpret_cast<float*>(smem + L.c);
  T* Bs = reinterpret_cast<T*>(smem + L.b);

  const int row0 = blockIdx.x * BM;
  load_rows(As, L.lda, x + (size_t)row0 * C, C, BM, M - row0, C);
  __syncthreads();

  // h = GELU(x @ W1 + b1), 64 hidden columns at a time
  for (int n0 = 0; n0 < H; n0 += kBN) {
    gemm_rowblock(As, L.lda, w1 + n0, H, C, Bs, Cs, ldc);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      Hs[r * L.ldh + n0 + c] = from_f<T>(gelu_erf(Cs[r * ldc + c] + b1[n0 + c]));
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
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) {
        const int c = 32 * k + lane;
        v[k] = to_f(rr[c]) + (Ss[r * L.lds + c] + b2[c]);  // res + (out + b2)
      }
    warp_layernorm(v, C, lns, lnb, eps, lane);
    T* orow = out + orow_idx * C;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) orow[32 * k + lane] = from_f<T>(v[k]);
  }
}

template <typename T, bool kTranspose>
int mlp_block_any(const void* x, const void* res, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* lns, const void* lnb, void* out,
                  int B, int D1, int D2, int C, int H, float eps, void* stream_) {
  if (B < 1 || D1 < 1 || D2 < 1 || C % 64 != 0 || C > 1024 || H % 64 != 0 ||
      (long long)B * D1 * D2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int M = B * D1 * D2;
  const MlpLayout<T> L(C, H);
  cudaError_t e = cudaFuncSetAttribute(mlp_block_kernel<T, kTranspose>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  mlp_block_kernel<T, kTranspose><<<cdiv(M, Cfg<T>::BM), kThreads, L.total,
                                      static_cast<cudaStream_t>(stream_)>>>(
      (const T*)x, (const T*)res, (const T*)w1, (const float*)b1, (const T*)w2,
      (const float*)b2, (const float*)lns, (const float*)lnb, (T*)out, D1, D2, M, C, H, eps, L);
  return (int)cudaGetLastError();
}

}  // namespace d3dp

extern "C" {

int d3dp_mlp_block_t_bf16(const void* x, const void* res, const void* w1, const void* b1,
                          const void* w2, const void* b2, const void* lns, const void* lnb,
                          void* out, int B, int D1, int D2, int C, int H, float eps,
                          void* stream) {
  return d3dp::mlp_block_any<d3dp::bf16, true>(x, res, w1, b1, w2, b2, lns, lnb, out, B, D1, D2,
                                               C, H, eps, stream);
}

int d3dp_mlp_block_t_f32(const void* x, const void* res, const void* w1, const void* b1,
                         const void* w2, const void* b2, const void* lns, const void* lnb,
                         void* out, int B, int D1, int D2, int C, int H, float eps,
                         void* stream) {
  return d3dp::mlp_block_any<float, true>(x, res, w1, b1, w2, b2, lns, lnb, out, B, D1, D2, C, H,
                                          eps, stream);
}

// K5: (R, C) rows in, (R, C) rows out.
int d3dp_mlp_block_bf16(const void* x, const void* res, const void* w1, const void* b1,
                        const void* w2, const void* b2, const void* lns, const void* lnb,
                        void* out, int R, int C, int H, float eps, void* stream) {
  return d3dp::mlp_block_any<d3dp::bf16, false>(x, res, w1, b1, w2, b2, lns, lnb, out, 1, R, 1,
                                                C, H, eps, stream);
}

int d3dp_mlp_block_f32(const void* x, const void* res, const void* w1, const void* b1,
                       const void* w2, const void* b2, const void* lns, const void* lnb,
                       void* out, int R, int C, int H, float eps, void* stream) {
  return d3dp::mlp_block_any<float, false>(x, res, w1, b1, w2, b2, lns, lnb, out, 1, R, 1, C, H,
                                           eps, stream);
}

}  // extern "C"
