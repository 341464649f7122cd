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
// grid works on one group of rows at a time, the residual stream and the
// scratch in device memory:
//   * one cooperative launch (`cudaLaunchCooperativeKernel`) of as many
//     256-thread blocks as can be co-resident, one dynamic shared-memory
//     size, the largest any phase needs (one block per SM);
//   * per row group and depth, nine phases, each walking its tiles
//     grid-stride, with a grid barrier (`this_grid().sync()`) after each:
//     ln_qkv, attend, proj_ln2 and the MLP for the spatial block, the tpos
//     add (depth 0 only), then the same four for the temporal block. Every
//     block reaches every barrier: no block returns early;
//   * the tile bodies are the level-4 kernels' own device functions with
//     the same options, in the same order with the same roundings, so level
//     5 computes what level 4 computes, bit for bit. The GEMM phases run
//     the standalone launches' walks (stage.cuh: ln_qkv, proj_ln2; mlp.cuh:
//     the MLP): wgmma tiles with the weights streamed by TMA (the maps over
//     each kind's depth stacks, read at depth d; in fp32 over their hi and
//     lo TF32 planes, the walks' tf32x3) and the outputs written by TMA or
//     bulk stores (fp32: plain stores), complete and fenced before the
//     barrier.
//     They are inlined: as functions of their own they ran slower a tile on
//     the H100, their saved registers and operands in local memory beside an
//     L1 the shared memory leaves small. The attend phase at F > 32 frames
//     runs the level-4 launch's double-buffered tensor-core walk with S in
//     parts; at 32 or fewer (spatial), the level-4 launch's short tile walk,
//     its ring of bulk copies as deep as the kernel's shared memory holds
//     (four stages of a 17-token sequence's 52 KB at C = 512; the launch
//     takes two a block, two blocks an SM). fp32 runs the launch's tf32x3
//     tensor-core tile (`attend_f32_walk`, common.cuh) at both. A row's
//     arithmetic does not depend on which block or warp takes its tile;
//   * rows go in groups of G, chosen by the caller so that every GEMM phase
//     has several waves of 64-row tiles on the SMs (`group_rows`): a group
//     of one row gives each phase at most one tile a block, half the SMs
//     idle in the MLP, and a grid barrier for every tile's latency. The
//     group's stream and scratch
//     then exceed L2 and go through device memory (about 2.5 GB a stage at
//     the eval shape, 12 ms a forward at 3.35 TB/s, below the products'
//     time). The caller allocates the scratch for G rows; the kernel
//     allocates nothing.
// Each grid barrier costs microseconds; at the eval shape a launch passes 2
// groups x 65 of them, together about 3% of the launch (the waits measured
// by a build with -DD3DP_PHASE_CLOCKS, which sums, per phase, the cycles
// each block spends in its tiles and waiting at the barrier after them:
// `d3dp_resident_phase_clocks`), so the phases keep their barriers.
#include <cooperative_groups.h>

#include <algorithm>

#include "stage.cuh"

namespace cg = cooperative_groups;

namespace d3dp {

constexpr int kNoCooperativeLaunch = -1;
constexpr int kNoOccupancy = -2;

// One kind's depth-stacked weights, in the layouts of resident_block_stack.
// fp32 takes the four matrices' hi and lo planes instead (mlp.cuh, "fp32:
// tf32x3"): wqkv (D, 2, 3C, C), wp (D, 2, C, C), w1 (D, 2, H, C), w2 (D, 2,
// C, H).
template <typename T>
struct KindWeights {
  const T* wqkv;      // (D, C, 3C)
  const float* bqkv;  // (D, 3C)
  const T* wp;        // (D, C, C)
  const T* w1;        // (D, C, H)
  const float* b1;    // (D, H)
  const T* w2;        // (D, H, C)
  const float* vec;   // (D, 6, C): bp, ln1s, ln1b, ln2s, ln2b, b2
  // TMA maps over wqkv, wp (bf16 `encode_weight_map`, fp32
  // `encode_plane_map`), w1 and w2 (`encode_mlp_maps`, `encode_mlp_plane_maps`)
  CUtensorMap twqkv, twp, tw1, tw2;
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
  AttnLayout Ls, Lt;     // bf16: attention layouts for N = J and N = F
  ShortLayout Ss, St;    // the short tile's, where N <= 32 (attend_short_ok)
  F32AttnLayout Fs, Ft;  // fp32: the tensor-core walk's (f32_attn_layout)
  AttnOpts ao;           // the attention's lab switches (no mask)
  int gelu;              // the MLP's activation, kGelu*
  MlpLayout<T> Lm;
  QkvLayout Lq;          // bf16: the stage walks' layouts
  ProjLayout Lp;
  F32Layout Lf;          // fp32: the stage walks' layout (`f32_stage_layout`)
  CUtensorMap tq, tx2, ty2;  // bf16: TMA maps over the qkv, x2 and y2 scratch
};

// Per-phase clocks (a build with -DD3DP_PHASE_CLOCKS): for each phase
// (spatial ln_qkv, attend, proj_ln2, MLP; the tpos add; the temporal four),
// the SM cycles thread 0 of each block spends in its own tiles and waiting
// at the grid barrier after them, summed over blocks, groups and depths.
constexpr int kPhases = 9;
#ifdef D3DP_PHASE_CLOCKS
__device__ unsigned long long g_phase_clocks[kPhases][2];
#endif

// The grid barrier closing phase `phase`; t: the clock at the phase's start,
// advanced to the next one's.
__device__ __forceinline__ void phase_end(cg::grid_group& grid, int phase, long long& t) {
#ifdef D3DP_PHASE_CLOCKS
  const long long t1 = clock64();
  grid.sync();
  const long long t2 = clock64();
  if (threadIdx.x == 0) {
    atomicAdd(&g_phase_clocks[phase][0], (unsigned long long)(t1 - t));
    atomicAdd(&g_phase_clocks[phase][1], (unsigned long long)(t2 - t1));
  }
  t = t2;
#else
  (void)phase;
  (void)t;
  grid.sync();
#endif
}

// One block of the trunk at depth d on the group's G*D1 sequences of N
// tokens, h: the attention stage into x2 and y2, then the MLP with the
// shared norm (lns, lnb), written relayouted to dst as (G, N, D1, C).
// Four grid barriers, phases p0 .. p0 + 3. kWide: bf16 at C = 512
// (`mlp_wide`), the walks' m64n256k16 form.
template <typename T, bool kWide>
__device__ __forceinline__ void block_phases(const ResidentArgs<T>& a, const KindWeights<T>& w,
                                             int d, const T* h, int G, int D1, int N,
                                             const AttnLayout& L, const ShortLayout& S,
                                             const F32AttnLayout& FL, const float* lns,
                                             const float* lnb, T* dst, unsigned char* smem,
                                             cg::grid_group& grid, int p0, long long& t) {
  constexpr bool f32 = std::is_same<T, float>::value;
  const int C = a.C, C3 = 3 * C, H = a.H;
  const int R = G * D1, M = R * N;
  const float* vec = w.vec + (size_t)d * 6 * C;
  if constexpr (f32) {
    const QkvArgsF32 q{h, a.qkv, w.bqkv + (size_t)d * C3, vec + C, vec + 2 * C, d, M, C, a.eps,
                       a.heads};
    ln_qkv_walk_f32<false>(q, &w.twqkv, a.Lf, smem, cdiv(M, kF32Tile));
  } else {
    const QkvArgs q{h, w.bqkv + (size_t)d * C3, vec + C, vec + 2 * C, d, M, C, a.eps, a.heads};
    ln_qkv_walk_bf16<false>(q, &w.twqkv, &a.tq, a.Lq, smem, cdiv(M, kQkvRows));
  }
  phase_end(grid, p0, t);
  const T* q = a.qkv;
  if (attend_short_ok(N, 0)) {
    // the level-4 launch's short tile, its ring as deep as the kernel's
    // shared memory holds (S.stages)
    attend_short_walk<T>(S, ShortArgsT<T>{q, q + C, q + 2 * C, a.o, R, a.scale, a.ao}, smem);
  } else if constexpr (f32) {
    // the launches' fp32 tensor-core walk (launch_attend)
    if (FL.rb == 1)
      attend_f32_walk<1>(q, q + C, q + 2 * C, 0, C3, a.o, R, N, C, a.heads, a.scale, FL, smem);
    else
      attend_f32_walk<2>(q, q + C, q + 2 * C, 0, C3, a.o, R, N, C, a.heads, a.scale, FL, smem);
  } else if (L.nkf == 4) {
    attend_mma_walk<4, kResidentFrags>(q, q + C, q + 2 * C, 0, C3, a.o, R, N, C, a.heads,
                                       a.scale, L, a.ao, smem);
  } else if (L.nkf == 8) {
    attend_mma_walk<8, kResidentFrags>(q, q + C, q + 2 * C, 0, C3, a.o, R, N, C, a.heads,
                                       a.scale, L, a.ao, smem);
  } else {
    attend_mma_walk<16, kResidentFrags>(q, q + C, q + 2 * C, 0, C3, a.o, R, N, C, a.heads,
                                        a.scale, L, a.ao, smem);
  }
  phase_end(grid, p0 + 1, t);
  if constexpr (f32) {
    const ProjArgsF32 p{a.o, h, a.x2, a.y2, vec, vec + 3 * C, vec + 4 * C, nullptr, 1, d, M, C,
                        a.eps, true, C, nullptr};
    proj_ln2_walk_f32(p, &w.twp, a.Lf, smem, cdiv(M, kF32Tile));
  } else {
    const ProjArgs p{a.o, h, vec, vec + 3 * C, vec + 4 * C, nullptr, 1, d, M, C, a.eps, true,
                     C, nullptr};
    proj_ln2_walk_bf16<kWide>(p, &w.twp, &a.tx2, &a.ty2, a.Lp, smem, cdiv(M, kStageRows));
  }
  phase_end(grid, p0 + 2, t);
  const MlpArgs<T> m{a.y2, a.x2, w.w1 + (size_t)d * C * H, w.b1 + (size_t)d * H,
                     w.w2 + (size_t)d * H * C, vec + 5 * C, lns, lnb, dst, nullptr, d, D1,
                     N, M, C, H, a.gelu, a.eps};
  mlp_walk<T, true, kWide>(m, &w.tw1, &w.tw2, a.Lm, smem, cdiv(M, MlpLayout<T>::kRows));
  phase_end(grid, p0 + 3, t);
}

template <typename T, bool kWide>
__global__ void __launch_bounds__(kThreads) resident_kernel(const __grid_constant__ ResidentArgs<T> a) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::grid_group grid = cg::this_grid();
  const size_t row = (size_t)a.F * a.J * a.C;
  long long t = 0;
#ifdef D3DP_PHASE_CLOCKS
  t = clock64();
#endif
  for (int r0 = 0; r0 < a.B; r0 += a.G) {
    const int G = min(a.G, a.B - r0);
    T* stream = a.out + r0 * row;
    for (int d = 0; d < a.D; ++d) {
      // spatial: (G*F, J, C) in, (G, J, F, C) out to the relayout buffer
      block_phases<T, kWide>(a, a.sp, d, d == 0 ? a.x + r0 * row : stream, G, a.F, a.J, a.Ls,
                             a.Ss, a.Fs, a.shared, a.shared + a.C, a.tbuf, smem, grid, 0, t);
      if (d == 0) {
        // + tpos on the rounded MLP output, rounded again: the level-4
        // flow's add of two compute-type tensors, 16 bytes a thread
        constexpr int kVec = 16 / sizeof(T);
        const size_t n = (size_t)G * row / kVec;
        for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < n;
             i += (size_t)gridDim.x * kThreads) {
          const size_t c = i * kVec % a.C, f = (i * kVec / a.C) % a.F;
          uint4 u = reinterpret_cast<const uint4*>(a.tbuf)[i];
          const uint4 p = *reinterpret_cast<const uint4*>(a.tpos + f * a.C + c);
          T* v = reinterpret_cast<T*>(&u);
          const T* pv = reinterpret_cast<const T*>(&p);
#pragma unroll
          for (int e = 0; e < kVec; ++e) v[e] = from_f<T>(to_f(v[e]) + to_f(pv[e]));
          reinterpret_cast<uint4*>(a.tbuf)[i] = u;
        }
        phase_end(grid, 4, t);
      }
      // temporal: (G*J, F, C) in, (G, F, J, C) out to the stream
      block_phases<T, kWide>(a, a.tp, d, a.tbuf, G, a.J, a.F, a.Lt, a.St, a.Ft,
                             a.shared + 2 * a.C, a.shared + 3 * a.C, stream, smem, grid, 5, t);
    }
  }
}

// The grid of the cooperative launch of `kernel`: as many blocks as can be
// co-resident at the largest shared-memory size any phase needs.
template <typename T, typename Kernel>
int resident_grid(Kernel kernel, int C, int H, int F, int J, int* blocks, size_t* smem) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess)
    return (int)e;
  if (!coop) return kNoCooperativeLaunch;
  constexpr bool f32 = std::is_same<T, float>::value;
  // the attend phases: the short tile's ring (at least one stage; it takes
  // as many as the largest phase leaves room for) or the tensor-core walk
  // (bf16: double-buffered tiles; fp32: the queries and two key groups)
  const int heads = C / kHeadDim;
  auto attend = [&](int N) -> size_t {
    ShortLayout S;
    if (attend_short_ok(N, 0)) {
      short_layout<T>(S, kShortPacked, N, C, heads, 3 * C, 0, (size_t)1 << 30, 1);
      return S.total;
    }
    return f32 ? f32_attn_layout(N).total : 2 * attn_layout_mma(N, 0).total;
  };
  *smem = std::max({f32 ? f32_stage_layout(C).total : QkvLayout(C).total,
                    f32 ? f32_stage_layout(C).total : ProjLayout(C).total,
                    MlpLayout<T>(C, H).total, attend(J), attend(F)});
  if ((e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)*smem)) != cudaSuccess)
    return (int)e;
  if ((e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, *smem)) !=
      cudaSuccess)
    return (int)e;
  if (per_sm < 1) return kNoOccupancy;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

template <typename T>
bool shape_ok(int B, int F, int J, int C, int H, int D, int heads, int G) {
  return B >= 1 && F >= 1 && J >= 1 && F <= kMaxKeys && J <= kMaxKeys && stage_shape_ok<T>(C) &&
         heads * kHeadDim == C && mlp_shape_ok<T>(C, H) && D >= 1 && G >= 1 &&
         G <= B && (long long)G * F * J * 3 * C <= 0x7fffffffLL;
}

template <typename T>
int resident(const void* const* ptrs, int B, int F, int J, int C, int H, int D, int heads, int G,
             int opts, int gelu, float scale, float eps, void* stream) {
  constexpr bool f32 = std::is_same<T, float>::value;
  if (!shape_ok<T>(B, F, J, C, H, D, heads, G) || (opts & kOptNoY2) || gelu < kGeluErf ||
      gelu > kGeluNone || (f32 && gelu == kGeluBf16))
    return (int)cudaErrorInvalidValue;
  // bf16 at C = 512 runs the walks' m64n256k16 form
  auto kernel = &resident_kernel<T, false>;
  if constexpr (!f32)
    if (mlp_wide(C)) kernel = &resident_kernel<T, true>;
  int blocks = 0;
  size_t smem = 0;
  const int err = resident_grid<T>(kernel, C, H, F, J, &blocks, &smem);
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
  for (int i : {2, 9}) {
    KindWeights<T>& k = i == 2 ? a.sp : a.tp;
    int e = 0;
    if constexpr (f32) {
      e = encode_plane_map(&k.twqkv, ptrs[i], 2 * D, 3 * C, C);
      if (!e) e = encode_plane_map(&k.twp, ptrs[i + 2], 2 * D, C, C);
      if (!e) e = encode_mlp_plane_maps(&k.tw1, &k.tw2, ptrs[i + 3], ptrs[i + 5], D, C, H);
    } else {
      e = encode_weight_map(&k.twqkv, ptrs[i], D, C, 3 * C, kQkvSlabRows);
      if (!e) e = encode_weight_map(&k.twp, ptrs[i + 2], D, C, C, kProjSlabRows);
      if (!e) e = encode_mlp_maps(&k.tw1, &k.tw2, ptrs[i + 3], ptrs[i + 5], D, C, H);
    }
    if (e) return e;
  }
  if constexpr (f32) {
    a.Lf = f32_stage_layout(C);
  } else {
    a.Lq = QkvLayout(C);
    a.Lp = ProjLayout(C);
    const int rows = G * F * J;  // the scratch's token rows
    int e = encode_weight_map(&a.tq, ptrs[18], 1, rows, 3 * C, kStageRows);
    if (!e) e = encode_weight_map(&a.tx2, ptrs[20], 1, rows, C, kStageRows);
    if (!e) e = encode_weight_map(&a.ty2, ptrs[21], 1, rows, C, kStageRows);
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
  if constexpr (f32) {
    a.Fs = f32_attn_layout(J);
    a.Ft = f32_attn_layout(F);
  } else {
    a.Ls = attn_layout_mma(J, 0);
    a.Lt = attn_layout_mma(F, 0);
  }
  // the short tile's ring in the kernel's shared memory (resident_grid
  // sized it for one stage at least)
  for (int i : {0, 1}) {
    ShortLayout& S = i == 0 ? a.Ss : a.St;
    const int N = i == 0 ? J : F;
    if (attend_short_ok(N, 0) &&
        !short_layout<T>(S, kShortPacked, N, C, heads, 3 * C, 0, smem, kShortMaxStages))
      return (int)cudaErrorInvalidValue;
  }
  a.ao = attn_opts(opts, 0);
  a.gelu = gelu;
  a.Lm = MlpLayout<T>(C, H);
  void* args[] = {&a};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
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

#ifdef D3DP_PHASE_CLOCKS
// The per-phase sums since the last call, d3dp::kPhases x {in the tiles, at
// the barrier} cycles, into out; the sums restart from 0.
int d3dp_resident_phase_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, d3dp::g_phase_clocks, sizeof(d3dp::g_phase_clocks));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zero[d3dp::kPhases][2] = {};
  return (int)cudaMemcpyToSymbol(d3dp::g_phase_clocks, zero, sizeof(zero));
}
#endif

}  // extern "C"
