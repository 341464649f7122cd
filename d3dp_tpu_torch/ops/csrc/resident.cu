// Depth-resident MixSTE trunk for Hopper (sm_90a): all 2 x depth blocks of
// the eval forward in ONE launch (fuse level 5).
//   for d in 0..D-1:
//     spatial block d on (B*F, J, C), written as (B, J, F, C);
//     at d == 0: + the temporal position embedding;
//     temporal block d on (B*J, F, C), written back as (B, F, J, C).
// Each block is the level-4 pair: the attention stage (LN1 -> qkv ->
// attention -> proj -> residual -> LN2) and the MLP half with the shared
// spatial/temporal norm, whose output write carries the relayout.
//
// Replaces the TPU kernel d3dp_tpu/ops/resident.py `_resident_kernel`
// (launcher `resident_block_stack`). Its lab switches arrive per launch as
// the stage's `opts` (kOptNormFirst for D3DP_SOFTMAX_FOLD != 1 and
// kOptBf16Exp for the global D3DP_ATTN_VARIANT=bf16exp, both bf16 only) and
// the MLP's `gelu` (D3DP_MLP_VARIANT, kGelu* in mlp.cuh), and reach the same
// tile functions as at level 4. Its tile knobs (D3DP_RES_SP_TOKENS,
// D3DP_RES_TP_SEQS, D3DP_RES_UNROLL) size Mosaic VMEM chunks and are not
// ported.
//
// What bounds it on the H100: operations. At the eval shape (40 rows of
// 243 x 17 tokens, C=512, H=1024, depth 8) one launch does
// 8 x (2 x (2TC*3C + 2TC*C + 4TCH) + 4TC(17+243)) = 11.79 TFLOP over
// T = 165,240 tokens: 11.9 ms at 989 TFLOP/s, against 0.12 ms for the
// stream in and out (0.34 GB) and the weights (0.07 GB).
//
// Design. The TPU kernel walks one row's (F, J, C) stream through every
// depth in VMEM: 4.2 MB in bf16, plus its scratch. A Hopper block has 227 KB
// of shared memory, so the stream cannot stay in one block, and blocks
// cannot hand a row from one depth to the next in order. Here the whole
// grid works on one group of rows at a time and the residual stream stays
// in device memory, small enough to stay in the 50 MB L2:
//   * one cooperative launch (`cudaLaunchCooperativeKernel`) of as many
//     256-thread blocks as can be co-resident, one dynamic shared-memory
//     size, the largest any phase needs (one block per SM);
//   * per row group and depth, nine phases, each walking its tiles
//     grid-stride, with a grid barrier (`this_grid().sync()`) after each:
//     ln_qkv, attend, proj_ln2 and the MLP for the spatial block, the tpos
//     add (depth 0 only), then the same four for the temporal block. Every
//     block reaches every barrier: no block returns early;
//   * the tile bodies are the level-4 kernels' own device functions
//     (`ln_qkv_tile`, `attend_tile`, `proj_ln2_tile`, the MLP's `mlp_walk`)
//     with the same options, in the same order with the same roundings, so
//     level 5 computes what level 4 computes, bit for bit. The attend phase
//     walks (sequence, head) tiles: at F > 32 frames `attend_tile` picks the
//     tensor-core tile of the level-4 launch (its key-fragment count from
//     the layout), whose rows' arithmetic does not depend on the walk. The
//     MLP phase runs the standalone launch's walk (64-row wgmma tiles in
//     bf16, its TMA ring set up and torn down inside the phase, the weight
//     maps over each kind's depth stack, read at depth d), called as a
//     function of its own (`mlp_walk_bf16_call`: inlined among K9's other
//     phases it spilled) and storing from registers; a row's result does
//     not depend on which block takes its tile;
//   * rows go in groups of G, chosen by the caller so that the group's
//     stream and scratch (stream, qkv, o, x2, y2 and the relayout buffer:
//     8 x F*J*C elements a row) fit in L2; the caller allocates the scratch
//     for G rows, and the kernel allocates nothing.
// Each grid barrier costs microseconds; at the eval shape a launch passes
// 40 groups x 65 of them.
#include <cooperative_groups.h>

#include <algorithm>

#include "mlp.cuh"

namespace cg = cooperative_groups;

namespace d3dp {

constexpr int kNoCooperativeLaunch = -1;
constexpr int kNoOccupancy = -2;

// One kind's depth-stacked weights, in the layouts of resident_block_stack.
template <typename T>
struct KindWeights {
  const T* wqkv;      // (D, C, 3C)
  const float* bqkv;  // (D, 3C)
  const T* wp;        // (D, C, C)
  const T* w1;        // (D, C, H)
  const float* b1;    // (D, H)
  const T* w2;        // (D, H, C)
  const float* vec;   // (D, 6, C): bp, ln1s, ln1b, ln2s, ln2b, b2
  CUtensorMap tw1, tw2;  // bf16: TMA maps over w1 and w2 (encode_mlp_maps)
};

template <typename T>
struct ResidentArgs {
  const T* x;            // (B, F, J, C) embedded stream
  const T* tpos;         // (F, C)
  const float* shared;   // (4, C): spatial norm s, b; temporal norm s, b
  KindWeights<T> sp, tp;
  T* out;                // (B, F, J, C): the stream after each depth, the result
  T* qkv;                // scratch for G rows: (G*F*J, 3C)
  T* o, *x2, *y2, *tbuf; // scratch for G rows: (G*F*J, C) each
  int B, F, J, C, H, D, heads, G;
  float scale, eps;
  AttnLayout Ls, Lt;     // attention layouts for N = J and N = F
  AttnOpts ao;           // the attention's lab switches (no mask)
  int gelu;              // the MLP's activation, kGelu*
  MlpLayout<T> Lm;
};

// One block of the trunk at depth d on the group's G*D1 sequences of N
// tokens, h: the attention stage into x2 and y2, then the MLP with the
// shared norm (lns, lnb), written relayouted to dst as (G, N, D1, C).
// Four grid barriers.
template <typename T>
__device__ __forceinline__ void block_phases(const ResidentArgs<T>& a, const KindWeights<T>& w,
                                             int d, const T* h, int G, int D1, int N,
                                             const AttnLayout& L, const float* lns,
                                             const float* lnb, T* dst, unsigned char* smem,
                                             cg::grid_group& grid) {
  constexpr int BM = Cfg<T>::BM;
  const int C = a.C, C3 = 3 * C, H = a.H;
  const int R = G * D1, M = R * N, n_rows = cdiv(M, BM);
  const float* vec = w.vec + (size_t)d * 6 * C;
  for (int t = blockIdx.x; t < n_rows; t += gridDim.x) {
    ln_qkv_tile<T>(h, w.wqkv + (size_t)d * C * C3, w.bqkv + (size_t)d * C3, vec + C, vec + 2 * C,
                   a.qkv, M, C, a.eps, smem, t);
    __syncthreads();  // the next tile overwrites shared memory
  }
  grid.sync();
  const int nqb = cdiv(N, L.QB), n_att = R * a.heads * nqb;
  for (int t = blockIdx.x; t < n_att; t += gridDim.x) {
    attend_tile<T>(a.qkv, a.qkv + C, a.qkv + 2 * C, C3, a.o, N, C, a.scale, L, a.ao, smem,
                   t % R, (t / R) % a.heads, t / (R * a.heads));
    __syncthreads();
  }
  grid.sync();
  for (int t = blockIdx.x; t < n_rows; t += gridDim.x) {
    proj_ln2_tile<T>(a.o, h, w.wp + (size_t)d * C * C, vec, vec + 3 * C, vec + 4 * C, a.x2, a.y2,
                     M, C, a.eps, smem, t);
    __syncthreads();
  }
  grid.sync();
  const MlpArgs<T> m{a.y2, a.x2, w.w1 + (size_t)d * C * H, w.b1 + (size_t)d * H,
                     w.w2 + (size_t)d * H * C, vec + 5 * C, lns, lnb, dst, nullptr, d, D1,
                     N, M, C, H, a.gelu, a.eps};
  mlp_walk<T, true, true>(m, &w.tw1, &w.tw2, a.Lm, smem, cdiv(M, MlpLayout<T>::kRows));
  grid.sync();
}

template <typename T>
__global__ void __launch_bounds__(kThreads) resident_kernel(const __grid_constant__ ResidentArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const size_t row = (size_t)a.F * a.J * a.C;
  for (int r0 = 0; r0 < a.B; r0 += a.G) {
    const int G = min(a.G, a.B - r0);
    T* stream = a.out + r0 * row;
    for (int d = 0; d < a.D; ++d) {
      // spatial: (G*F, J, C) in, (G, J, F, C) out to the relayout buffer
      block_phases(a, a.sp, d, d == 0 ? a.x + r0 * row : stream, G, a.F, a.J, a.Ls, a.shared,
                   a.shared + a.C, a.tbuf, smem, grid);
      if (d == 0) {
        // + tpos on the rounded MLP output, rounded again: the level-4
        // flow's add of two compute-type tensors
        const size_t n = (size_t)G * row;
        for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
             i += (size_t)gridDim.x * kThreads) {
          const size_t c = i % a.C, f = (i / a.C) % a.F;
          a.tbuf[i] = from_f<T>(to_f(a.tbuf[i]) + to_f(a.tpos[f * a.C + c]));
        }
        grid.sync();
      }
      // temporal: (G*J, F, C) in, (G, F, J, C) out to the stream
      block_phases(a, a.tp, d, a.tbuf, G, a.J, a.F, a.Lt, a.shared + 2 * a.C,
                   a.shared + 3 * a.C, stream, smem, grid);
    }
  }
}

// The grid of the cooperative launch: as many blocks as can be co-resident
// at the largest shared-memory size any phase needs.
template <typename T>
int resident_grid(int C, int H, int F, int J, int* blocks, size_t* smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)e;
  if (!coop) return kNoCooperativeLaunch;
  *smem = std::max({ln_qkv_smem<T>(C), proj_ln2_smem<T>(C), MlpLayout<T>(C, H).total,
                    attn_layout<T>(J).total, attn_layout<T>(F).total});
  if ((e = cudaFuncSetAttribute(resident_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resident_kernel<T>, kThreads,
                                                         *smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return kNoOccupancy;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

template <typename T>
bool shape_ok(int B, int F, int J, int C, int H, int D, int heads, int G) {
  return B >= 1 && F >= 1 && J >= 1 && F <= kMaxKeys && J <= kMaxKeys && C % 64 == 0 &&
         C <= 1024 && heads * kHeadDim == C && mlp_shape_ok<T>(C, H) && D >= 1 && G >= 1 &&
         G <= B && (long long)G * F * J * 3 * C <= 0x7fffffffLL;
}

template <typename T>
int resident(const void* const* ptrs, int B, int F, int J, int C, int H, int D, int heads, int G,
             int opts, int gelu, float scale, float eps, void* stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (!shape_ok<T>(B, F, J, C, H, D, heads, G) || (opts & kOptNoY2) || gelu < kGeluErf ||
      gelu > kGeluNone || (f32 && gelu == kGeluBf16))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  size_t smem = 0;
  const int err = resident_grid<T>(C, H, F, J, &blocks, &smem);
  if (err != 0) return err;
  auto kind = [&](int i) {
    return KindWeights<T>{(const T*)ptrs[i], (const float*)ptrs[i + 1], (const T*)ptrs[i + 2],
                          (const T*)ptrs[i + 3], (const float*)ptrs[i + 4],
                          (const T*)ptrs[i + 5], (const float*)ptrs[i + 6]};
  };
  ResidentArgs<T> a{};
  a.x = (const T*)ptrs[0];
  a.tpos = (const T*)ptrs[1];
  a.sp = kind(2);
  a.tp = kind(9);
  if constexpr (!f32) {
    int e = encode_mlp_maps(&a.sp.tw1, &a.sp.tw2, ptrs[5], ptrs[7], D, C, H);
    if (!e) e = encode_mlp_maps(&a.tp.tw1, &a.tp.tw2, ptrs[12], ptrs[14], D, C, H);
    if (e) return e;
  }
  a.shared = (const float*)ptrs[16];
  a.out = (T*)ptrs[17];
  a.qkv = (T*)ptrs[18];
  a.o = (T*)ptrs[19];
  a.x2 = (T*)ptrs[20];
  a.y2 = (T*)ptrs[21];
  a.tbuf = (T*)ptrs[22];
  a.B = B; a.F = F; a.J = J; a.C = C; a.H = H; a.D = D; a.heads = heads; a.G = G;
  a.scale = scale;
  a.eps = eps;
  a.Ls = attn_layout<T>(J);
  a.Lt = attn_layout<T>(F);
  a.ao = attn_opts(opts, 0);
  a.gelu = gelu;
  a.Lm = MlpLayout<T>(C, H);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)resident_kernel<T>, dim3(blocks),
                                              dim3(kThreads), args, smem,
                                              static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace d3dp

extern "C" {

// ptrs: x, tpos, the spatial kind's seven (wqkv, bqkv, wp, w1, b1, w2, vec),
// the temporal kind's seven, shared, out, then the scratch qkv, o, x2, y2
// and the relayout buffer, each sized for G rows. opts: kOptNormFirst |
// kOptBf16Exp (common.cuh); gelu: a kGelu* activation (mlp.cuh). Returns 0,
// a cudaError_t, or -1 (no cooperative launch on this device) / -2 (the
// kernel's shared memory fits no block on an SM).
int d3dp_resident_bf16(const void* const* ptrs, int B, int F, int J, int C, int H, int D,
                       int heads, int G, int opts, int gelu, float scale, float eps,
                       void* stream) {
  return d3dp::resident<d3dp::bf16>(ptrs, B, F, J, C, H, D, heads, G, opts, gelu, scale, eps,
                                    stream);
}

int d3dp_resident_f32(const void* const* ptrs, int B, int F, int J, int C, int H, int D,
                      int heads, int G, int opts, int gelu, float scale, float eps,
                      void* stream) {
  return d3dp::resident<float>(ptrs, B, F, J, C, H, D, heads, G, opts, gelu, scale, eps, stream);
}

}  // extern "C"
