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
// residual add (the `*_dp_*` entry points). The GELU's erf is the TPU
// kernels' own A&S 7.1.26 polynomial (<=1.5e-7 abs) in bf16 and CUDA's erff
// in fp32. Their lab switch D3DP_MLP_VARIANT arrives as each entry point's
// `gelu` (kGelu* in mlp.cuh): bf16gelu (bf16 only) evaluates that polynomial
// op by op in bf16, as the TPU kernel does; nogelu puts the identity in its
// place.
//
// What bounds both on the H100: operations (4*T*C*H FLOPs for T tokens,
// about 680 FLOPs per byte moved in bf16 at C=512, H=1024), and short of
// that the 2 MiB of weights every tile streams from L2 and the registers
// that hold the tile's output while h passes through. fp32 (the default
// dtype of every entry point) runs each product in three TF32 passes, so
// its bound is 3 x 4*T*C*H FLOPs at 495 TFLOP/s (2.10 ms at the eval
// shape), and each 64-row tile streams the weights' hi and lo planes, 8 MiB,
// from L2: 48 FLOPs a byte of that stream, more than the L2 feeds at the
// tensor cores' rate.
//
// Design. The body is `mlp_walk` (mlp.cuh, shared with resident.cu, whose
// header describes the tile): 64 token rows a tile on wgmma, the weights
// through a TMA-fed ring of shared-memory slabs, h a 128-column chunk at a
// time in shared memory; bf16 with bf16 operands, fp32 in tf32x3 (three
// TF32 passes from the weights' hi and lo planes, `mlp_walk_f32`). The
// LayerNorm needs all C outputs of a row, so a tile owns whole rows, and
// each token row (b, i, j) is written whole to output row (b, j, i): a
// C-wide store, so the relayout costs no extra pass (the rows form writes
// it to row t). Tokens are taken in flat order, so the 243-frame axis simply
// ends in a partial last tile. One block fills an SM, so the launch is a
// persistent grid of one block an SM walking the tiles; bf16 at C = 512
// takes the m64n256k16 fc2 (`mlp_wide`), other widths four-wide blocks of
// m64n64k16; fp32 runs m64n64k8 throughout. The weight maps are encoded on
// the host at every launch (a few microseconds), from the pointers the
// launch is given. The tensor-parallel partial form runs the same walk in
// either type, with its `kPartial` epilogue.
#include "mlp.cuh"

namespace d3dp {

template <typename T>
struct MlpParams {
  CUtensorMap tw1, tw2;  // the weights' TMA maps (fp32: over their hi and lo planes)
  MlpArgs<T> a;
  MlpLayout<T> L;
  int n_tiles;
};

// kWide: bf16 at C = 512 (mlp_wide); kPartial: the tensor-parallel partial
template <typename T, bool kTranspose, bool kWide, bool kPartial = false>
__global__ void __launch_bounds__(kThreads) mlp_block_kernel(const __grid_constant__ MlpParams<T> p) {
  extern __shared__ __align__(128) unsigned char smem[];
  mlp_walk<T, kTranspose, kWide, kPartial>(p.a, &p.tw1, &p.tw2, p.L, smem, p.n_tiles);
}

template <typename T, bool kTranspose, bool kWide, bool kPartial = false>
cudaError_t launch_mlp(const MlpParams<T>& p, cudaStream_t stream) {
  auto kernel = mlp_block_kernel<T, kTranspose, kWide, kPartial>;
  const int smem = (int)p.L.total;
  int blocks = 0;
  const cudaError_t e = persistent_grid(kernel, smem, p.n_tiles, &blocks);
  if (e != cudaSuccess) return e;
  kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// dp: nullptr, or B * D1 fp32 branch scales (the rows form passes D1 = R,
// D2 = 1: one scale per row); gelu: a kGelu* activation
template <typename T, bool kTranspose>
int mlp_block_any(const void* x, const void* res, const void* w1, const void* b1,
                  const void* w2, const void* b2, const void* lns, const void* lnb,
                  const void* dp, void* out, int B, int D1, int D2, int C, int H, int gelu,
                  float eps, void* stream_) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (B < 1 || D1 < 1 || D2 < 1 || !mlp_shape_ok<T>(C, H) ||
      (long long)B * D1 * D2 > 0x7fffffffLL || gelu < kGeluErf || gelu > kGeluNone ||
      (f32 && gelu == kGeluBf16))
    return (int)cudaErrorInvalidValue;
  MlpParams<T> p{};
  const int e = f32 ? encode_mlp_plane_maps(&p.tw1, &p.tw2, w1, w2, 1, C, H)
                    : encode_mlp_maps(&p.tw1, &p.tw2, w1, w2, 1, C, H);
  if (e) return e;
  const int M = B * D1 * D2;
  p.a = MlpArgs<T>{(const T*)x, (const T*)res, (const T*)w1, (const float*)b1, (const T*)w2,
                   (const float*)b2, (const float*)lns, (const float*)lnb, (T*)out,
                   (const float*)dp, 0, D1, D2, M, C, H, gelu, eps};
  p.L = MlpLayout<T>(C, H);
  p.n_tiles = cdiv(M, MlpLayout<T>::kRows);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if constexpr (!f32)
    if (mlp_wide(C)) return (int)launch_mlp<T, kTranspose, true>(p, stream);
  return (int)launch_mlp<T, kTranspose, false>(p, stream);
}

// The tensor-parallel partial form (K2/K5-tp): part = act(x @ W1 + b1) @ W2
// over R token rows, raw in fp32 (R, C), with W1 (C, H) and b1 (H,) the
// rank's H = H_model / tp hidden columns and W2 (H, C) their rows: no b2,
// residual or LayerNorm, and no transpose; the caller all-reduces the ranks'
// partials and runs residual_ln.cu, which writes the rows or the other
// stage's layout. One form serves K2 and K5. The walk is theirs with the
// `kPartial` epilogue; it bounds as theirs at the rank's share of the FLOPs,
// plus C fp32 partials a row out.
template <typename T>
int mlp_block_partial(const void* x, const void* w1, const void* b1, const void* w2, void* part,
                      int R, int C, int H, int gelu, void* stream_) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (R < 1 || !mlp_shape_ok<T>(C, H) || gelu < kGeluErf || gelu > kGeluNone ||
      (f32 && gelu == kGeluBf16))
    return (int)cudaErrorInvalidValue;
  MlpParams<T> p{};
  const int e = f32 ? encode_mlp_plane_maps(&p.tw1, &p.tw2, w1, w2, 1, C, H)
                    : encode_mlp_maps(&p.tw1, &p.tw2, w1, w2, 1, C, H);
  if (e) return e;
  p.a = MlpArgs<T>{(const T*)x, nullptr, (const T*)w1, (const float*)b1, (const T*)w2, nullptr,
                   nullptr, nullptr, nullptr, nullptr, 0, R, 1, R, C, H, gelu, 0.f,
                   (float*)part};
  p.L = MlpLayout<T>(C, H);
  p.n_tiles = cdiv(R, MlpLayout<T>::kRows);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  if constexpr (!f32)
    if (mlp_wide(C)) return (int)launch_mlp<T, false, true, true>(p, stream);
  return (int)launch_mlp<T, false, false, true>(p, stream);
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
// K2: x, res (B, D1, D2, C); out (B, D2, D1, C). w1 (C, H) and w2 (H, C) in
// bf16; in fp32 their hi and lo planes, (2, H, C) and (2, C, H) (mlp.cuh).
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

// K2/K5-tp: x (R, C); w1 (C, H), b1 (H,), w2 (H, C) a rank's share (fp32:
// their hi and lo planes, (2, H, C) and (2, C, H)); part (R, C) fp32.
int d3dp_mlp_block_partial_bf16(const void* x, const void* w1, const void* b1, const void* w2,
                                void* part, int R, int C, int H, int gelu, void* stream) {
  return d3dp::mlp_block_partial<d3dp::bf16>(x, w1, b1, w2, part, R, C, H, gelu, stream);
}

int d3dp_mlp_block_partial_f32(const void* x, const void* w1, const void* b1, const void* w2,
                               void* part, int R, int C, int H, int gelu, void* stream) {
  return d3dp::mlp_block_partial<float>(x, w1, b1, w2, part, R, C, H, gelu, stream);
}

}  // extern "C"
