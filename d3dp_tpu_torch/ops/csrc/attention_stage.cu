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
//                the whole row with no online rescaling.
//                fp32: p is divided by l before P.V; bf16: P.V runs on the
//                unnormalised bf16 p and 1/l is folded into the output,
//                which is rounded to bf16 before the projection.
//   3. proj_ln2: 32-token row blocks: o @ Wp into an fp32 row buffer, then
//                the residual add and LN2 per row.
// The split costs extra device-memory traffic (qkv and o written and read
// back, x read twice); fusing the stage into one pass is later work.
#include "common.cuh"

namespace d3dp {

constexpr int kHeadDim = 64;
constexpr int kMaxKeys = 256;

// ---------------------------------------------------------------- 1. LN1 + qkv
template <typename T>
__global__ void __launch_bounds__(kThreads)
ln_qkv_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
              const float* __restrict__ bqkv, const float* __restrict__ ln1s,
              const float* __restrict__ ln1b, T* __restrict__ qkv, int M, int C, float eps) {
  constexpr int BM = Cfg<T>::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + Cfg<T>::PAD;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + align128(sizeof(T) * BM * lda));
  float* Cs = reinterpret_cast<float*>(smem + align128(sizeof(T) * BM * lda) + bs_bytes<T>());
  constexpr int ldc = kBN + 4;

  const int row0 = blockIdx.x * BM;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    if (row < M) {
      float v[32];
      const T* xr = x + (size_t)row * C;
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < C / 32) v[k] = to_f(xr[32 * k + lane]);
      warp_layernorm(v, C, ln1s, ln1b, eps, lane);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < C / 32) As[r * lda + 32 * k + lane] = from_f<T>(v[k]);
    } else {
      for (int c = lane; c < C; c += 32) As[r * lda + c] = from_f<T>(0.f);
    }
  }
  __syncthreads();

  const int N3 = 3 * C;
  for (int n0 = 0; n0 < N3; n0 += kBN) {
    gemm_rowblock(As, lda, wqkv + n0, N3, C, Bs, Cs, ldc);
    __syncthreads();
    for (int i = threadIdx.x; i < BM * kBN; i += kThreads) {
      const int r = i / kBN, c = i % kBN;
      if (row0 + r < M)
        qkv[(size_t)(row0 + r) * N3 + n0 + c] = from_f<T>(Cs[r * ldc + c] + bqkv[n0 + c]);
    }
  }
}

template <typename T>
size_t ln_qkv_smem(int C) {
  return align128(sizeof(T) * Cfg<T>::BM * (C + Cfg<T>::PAD)) + bs_bytes<T>() +
         align128(sizeof(float) * Cfg<T>::BM * (kBN + 4));
}

// ---------------------------------------------------------------- 2. attention
struct AttnLayout {
  int QB, NK, ldq, ldk, ldv, lds, ldp;
  size_t q, k, v, s, p, linv, total;
};

template <typename T>
AttnLayout attn_layout(int N) {
  constexpr bool f32 = std::is_same<T, float>::value;
  AttnLayout L;
  L.NK = cdiv(N, 16) * 16;
  L.QB = L.NK < 64 ? L.NK : 64;
  // fp32 reads K transposed (thread j walks row j): an odd row stride keeps
  // those reads on distinct banks. bf16 rows keep wmma's 16-byte multiple.
  L.ldq = f32 ? kHeadDim + 1 : kHeadDim + 8;
  L.ldk = f32 ? kHeadDim + 1 : kHeadDim + 8;
  L.ldv = f32 ? kHeadDim : kHeadDim + 8;
  L.lds = L.NK + 4;
  L.ldp = L.NK + 8;
  size_t off = 0;
  L.q = off; off += align128(sizeof(T) * L.QB * L.ldq);
  L.k = off; off += align128(sizeof(T) * L.NK * L.ldk);
  L.v = off; off += align128(sizeof(T) * L.NK * L.ldv);
  // the logits buffer doubles as the bf16 path's fp32 P.V output
  L.s = off; off += align128(sizeof(float) * L.QB * (L.lds > kHeadDim + 4 ? L.lds : kHeadDim + 4));
  L.p = off; off += f32 ? 0 : align128(sizeof(bf16) * L.QB * L.ldp);
  L.linv = off; off += align128(sizeof(float) * L.QB);
  L.total = off;
  return L;
}

// grid (sequence, head, query block). qkv: (R, N, 3C); out: (R, N, C).
template <typename T>
__global__ void __launch_bounds__(kThreads)
attend_kernel(const T* __restrict__ qkv, T* __restrict__ out, int N, int C, float scale,
              AttnLayout L) {
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem + L.q);
  T* Ks = reinterpret_cast<T*>(smem + L.k);
  T* Vs = reinterpret_cast<T*>(smem + L.v);
  float* Ss = reinterpret_cast<float*>(smem + L.s);
  float* linv = reinterpret_cast<float*>(smem + L.linv);

  const int seq = blockIdx.x, h = blockIdx.y, q0 = blockIdx.z * L.QB;
  const int QB = L.QB, NK = L.NK;
  const size_t ld3 = 3 * (size_t)C;
  const T* base = qkv + (size_t)seq * N * ld3 + h * kHeadDim;
  load_rows(Qs, L.ldq, base + (size_t)q0 * ld3, (int)ld3, QB, N - q0, kHeadDim);
  load_rows(Ks, L.ldk, base + C, (int)ld3, NK, N, kHeadDim);
  load_rows(Vs, L.ldv, base + 2 * C, (int)ld3, NK, N, kHeadDim);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // S = Q K^T (unscaled), fp32
  if constexpr (f32) {
    for (int i = threadIdx.x; i < QB * NK; i += kThreads) {
      const int qi = i / NK, kj = i % NK;
      const float* a = Qs + qi * L.ldq;
      const float* b = Ks + kj * L.ldk;
      float acc = 0.f;
#pragma unroll 16
      for (int d = 0; d < kHeadDim; ++d) acc = fmaf(a[d], b[d], acc);
      Ss[qi * L.lds + kj] = acc;
    }
  } else {
    using namespace nvcuda;
    const int nfj = NK / 16;
    for (int f = warp; f < (QB / 16) * nfj; f += kWarps) {
      const int fi = f / nfj, fj = f % nfj;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kHeadDim; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> b;
        wmma::load_matrix_sync(a, Qs + fi * 16 * L.ldq + kk, L.ldq);
        wmma::load_matrix_sync(b, Ks + fj * 16 * L.ldk + kk, L.ldk);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Ss + fi * 16 * L.lds + fj * 16, acc, L.lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // exact softmax over the N valid keys of each row: s = dot * scale,
  // m = max(s), p = exp(s - m), l = sum(p)
  for (int r = warp; r < QB; r += kWarps) {
    float* srow = Ss + r * L.lds;
    float m = -INFINITY;
    for (int j = lane; j < N; j += 32) {
      const float s = srow[j] * scale;
      srow[j] = s;
      m = fmaxf(m, s);
    }
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < NK; j += 32) {
      const float p = j < N ? expf(srow[j] - m) : 0.f;
      srow[j] = p;
      l += p;
    }
    l = warp_sum(l);
    if constexpr (f32) {
      for (int j = lane; j < N; j += 32) srow[j] = srow[j] / l;
    } else {
      bf16* prow = reinterpret_cast<bf16*>(smem + L.p) + r * L.ldp;
      for (int j = lane; j < NK; j += 32) prow[j] = __float2bfloat16(srow[j]);
      if (lane == 0) linv[r] = 1.0f / l;
    }
  }
  __syncthreads();

  T* orow0 = out + ((size_t)seq * N + q0) * C + h * kHeadDim;
  const int nq = min(QB, N - q0);
  if constexpr (f32) {
    // O = (P / l) V, written straight out
    for (int i = threadIdx.x; i < nq * kHeadDim; i += kThreads) {
      const int qi = i / kHeadDim, d = i % kHeadDim;
      const float* p = Ss + qi * L.lds;
      float acc = 0.f;
      for (int j = 0; j < N; ++j) acc = fmaf(p[j], Vs[j * L.ldv + d], acc);
      orow0[(size_t)qi * C + d] = acc;
    }
  } else {
    // O = P V on the tensor cores into the (now free) logits buffer, then
    // scaled by 1/l and rounded to bf16 on the way out
    using namespace nvcuda;
    const bf16* Ps = reinterpret_cast<const bf16*>(smem + L.p);
    float* Os = Ss;
    constexpr int ldo = kHeadDim + 4;
    for (int f = warp; f < (QB / 16) * (kHeadDim / 16); f += kWarps) {
      const int fi = f / (kHeadDim / 16), fj = f % (kHeadDim / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < NK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, Ps + fi * 16 * L.ldp + kk, L.ldp);
        wmma::load_matrix_sync(b, Vs + kk * L.ldv + fj * 16, L.ldv);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(Os + fi * 16 * ldo + fj * 16, acc, ldo, wmma::mem_row_major);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < nq * kHeadDim; i += kThreads) {
      const int qi = i / kHeadDim, d = i % kHeadDim;
      orow0[(size_t)qi * C + d] = __float2bfloat16(Os[qi * ldo + d] * linv[qi]);
    }
  }
}

// ---------------------------------------------------------------- 3. proj + LN2
template <typename T>
__global__ void __launch_bounds__(kThreads)
proj_ln2_kernel(const T* __restrict__ o, const T* __restrict__ x, const T* __restrict__ wp,
                const float* __restrict__ bp, const float* __restrict__ ln2s,
                const float* __restrict__ ln2b, T* __restrict__ x2, T* __restrict__ y2, int M,
                int C, float eps) {
  constexpr int BM = Cfg<T>::BM;
  extern __shared__ __align__(128) unsigned char smem[];
  const int lda = C + Cfg<T>::PAD;
  const int ldx = C + 4;
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = reinterpret_cast<T*>(smem + align128(sizeof(T) * BM * lda));
  float* Xs = reinterpret_cast<float*>(smem + align128(sizeof(T) * BM * lda) + bs_bytes<T>());

  const int row0 = blockIdx.x * BM;
  load_rows(As, lda, o + (size_t)row0 * C, C, BM, M - row0, C);
  __syncthreads();
  for (int n0 = 0; n0 < C; n0 += kBN) gemm_rowblock(As, lda, wp + n0, C, C, Bs, Xs + n0, ldx);
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < BM; r += kWarps) {
    const int row = row0 + r;
    if (row >= M) continue;
    const T* xr = x + (size_t)row * C;
    T* x2r = x2 + (size_t)row * C;
    float v[32];
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) {
        const int c = 32 * k + lane;
        v[k] = to_f(xr[c]) + (Xs[r * ldx + c] + bp[c]);  // x + (proj + bp)
        x2r[c] = from_f<T>(v[k]);
      }
    warp_layernorm(v, C, ln2s, ln2b, eps, lane);
    T* y2r = y2 + (size_t)row * C;
#pragma unroll
    for (int k = 0; k < 32; ++k)
      if (k < C / 32) y2r[32 * k + lane] = from_f<T>(v[k]);
  }
}

template <typename T>
size_t proj_ln2_smem(int C) {
  return align128(sizeof(T) * Cfg<T>::BM * (C + Cfg<T>::PAD)) + bs_bytes<T>() +
         align128(sizeof(float) * Cfg<T>::BM * (C + 4));
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

  const AttnLayout L = attn_layout<T>(N);
  if ((e = cudaFuncSetAttribute(attend_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)L.total)) != cudaSuccess)
    return (int)e;
  dim3 grid(R, heads, cdiv(N, L.QB));
  attend_kernel<T><<<grid, kThreads, L.total, stream>>>((const T*)qkv, (T*)o, N, C, scale, L);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  const size_t s3 = proj_ln2_smem<T>(C);
  if ((e = cudaFuncSetAttribute(proj_ln2_kernel<T>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)s3)) !=
      cudaSuccess)
    return (int)e;
  proj_ln2_kernel<T><<<cdiv(M, BM), kThreads, s3, stream>>>(
      (const T*)o, (const T*)x, (const T*)wp, (const float*)bp, (const float*)ln2s,
      (const float*)ln2b, (T*)x2, (T*)y2, M, C, eps);
  return (int)cudaGetLastError();
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
