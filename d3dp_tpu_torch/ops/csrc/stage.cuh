// The attention stage's two GEMM steps, shared by the stage kernels (K1, its
// DropPath form and the head-major K8: attention_stage.cu), the attention
// block (K6: attention_block.cu) and the depth-resident kernel (resident.cu):
//   ln_qkv:   qkv = bf16(bf16(LN1(x)) @ Wqkv + bqkv), packed (M, 3C) or
//             head-major (h, M, 3d);
//   proj_ln2: v = x + (o @ Wp + bp), or x + dp[row / dp_div] * (o @ Wp + bp)
//             rounded apart (no FMA); x2 = bf16(v); y2 = bf16(LN2(v)) from
//             the fp32 v (unless with_y2 is false).
// They replace the GEMM phases of the TPU kernels `_attn_stage_kernel`,
// `_attn_stage_kernel_hm`, `_attn_block_kernel` (d3dp_tpu/ops/attention.py)
// and of `_resident_kernel` (d3dp_tpu/ops/resident.py).
//
// What bounds them on the H100 at the eval shape (M = 165,240 token rows,
// C = 512): ln_qkv does 2*M*C*3C = 260 GFLOP against 0.68 GB of x and qkv,
// so the tensor cores bound it (0.263 ms); proj_ln2 does 86.6 GFLOP against
// 0.68 GB of o, x, x2 and y2, so bytes bound it (0.202 ms). Short of those:
// every row tile reads all of Wqkv (1.5 MiB) or Wp (0.5 MiB) from L2, 64
// FLOPs a byte of that stream at 64 rows, which the L2 cannot feed at the
// tensor cores' rate; and each tile's LayerNorm and stores leave the tensor
// cores idle.
//
// bf16 (`ln_qkv_walk_bf16`, `proj_ln2_walk_bf16`): the MLP walk's machinery
// (mlp.cuh), one block of two warpgroups an SM.
//   * The A operand (LN1(x), or o) sits in shared memory in the 128-byte
//     swizzled layout the wgmma descriptors read, loaded by cp.async, rows
//     past M zero-filled. ln_qkv normalises its rows in place (warp w takes
//     rows 8w..8w+7 of each 64-row half) before the products.
//   * The weights reach shared memory through a `WeightRing` of TMA slabs
//     on mbarriers, in their own row-major layout (an MN-major B): Wqkv in
//     64-row slabs of one 128-column chunk (two 64-column boxes, 16 KB), Wp
//     in 32-row slabs of all C columns (32 KB). The ring runs on across
//     tiles.
//   * ln_qkv: 128 token rows a tile, warpgroup w owning rows 64w..64w + 63,
//     so both read each Wqkv slab and the weight stream a row halves against
//     64-row tiles; 3C output columns in chunks of 128, each warpgroup with
//     wgmma m64n128k16 (64 fp32 registers); epilogue: + bqkv, bf16. A
//     64-column box of packed qkv (column 64b) is head b % h's q, k or v
//     third (b / h) in the head-major layout, so K8 loads each box from the
//     (h, C, 3d) stack to the same place in the slab that K1 loads it from
//     (C, 3C): the same operands, instructions and k order, so the same bits.
//   * proj_ln2: 64 token rows a tile; each warpgroup holds its C / 2 output
//     columns over all of K = C (m64n256k16 at C = 512, else C / 128
//     m64n64k16 blocks); x is loaded beside o while the products run; the
//     epilogue is the MLP's: + bp, the DropPath scale, + x, x2, then LN2
//     across both warpgroups.
//   * Each output box is staged in the swizzled layout and written with a
//     TMA store, which clips the rows past the map's; the stores complete
//     under the next chunk's or tile's products, and are waited for and
//     fenced at the walk's end. The launches (`ln_qkv_walk_kernel`,
//     `proj_ln2_walk_kernel`) are persistent grids of one block an SM; the
//     depth-resident kernel inlines the walks between its grid barriers.
// Shared memory at C = 512: ln_qkv 128 KB of rows, 32 KB of staging, a
// 4-slab ring of 16 KB; proj_ln2 64 KB of o (then x2), 64 KB of x (then y2),
// a 3-slab ring of 32 KB.
//
// fp32 (the default dtype of every entry point; `ln_qkv_walk_f32`,
// `proj_ln2_walk_f32`, below): the same walks in tf32x3 (mlp.cuh), 64 rows
// a tile. Three TF32 passes make fp32's bound 3 x the products at 495
// TFLOP/s: ln_qkv 1.58 ms, proj_ln2 0.53 ms at the eval shape; each tile
// streams the weights' hi and lo planes (6 MiB of Wqkv, 2 MiB of Wp) from
// L2, 48 FLOPs a byte of that stream.
#pragma once

#include "mlp.cuh"

namespace d3dp {

constexpr int kStageRows = kMlpRows;  // token rows a proj_ln2 tile: one wgmma M
constexpr int kBoxBytes = kStageRows * 128;  // a 64 x 64 bf16 box, swizzled
constexpr int kQkvRows = 2 * kStageRows;     // token rows an ln_qkv tile: 64 a warpgroup
constexpr int kQkvChunk = 128;        // qkv output columns a chunk: two boxes
constexpr int kQkvSlabRows = 64;      // a Wqkv slab: 64 rows of a chunk's two boxes
constexpr int kQkvSlabBytes = 2 * kBoxBytes;
constexpr int kQkvRing = 4;
constexpr int kProjSlabRows = 32;     // a Wp slab: 32 rows x C (C / 64 boxes)
constexpr int kProjRing = 3;

// byte offset of element (r, c) in a swizzled 64-row tile of 64-column boxes
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 6) * kBoxBytes + r * 128 + ((((c & 63) >> 3) ^ (r & 7)) << 4) + (c & 7) * 2;
}

// TMA store of the box at shared address src to (c0, c1, c2) of a 3-D map,
// in this thread's bulk group
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// LayerNorm of the 64 rows of a swizzled tile, in place: fp32 two-pass
// statistics (the mean, then the mean of squared deviations), (v - mu) *
// rsqrt(var + eps) * s + b, rounded to bf16. Warp w takes rows 8w..8w+7,
// lane l a row's 16-byte groups l and l + 32 (C <= 512).
__device__ __forceinline__ void layernorm_tile(unsigned char* ts, int C, const float* s,
                                               const float* b, float eps, int warp, int lane) {
  const int ng = C / 8;
  for (int r = 8 * warp; r < 8 * warp + 8; ++r) {
    float v[2][8];
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int g = lane + 32 * k;
      if (g >= ng) continue;
      const uint4 u = *reinterpret_cast<const uint4*>(ts + swz(r, 8 * g));
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        v[k][2 * e] = f.x;
        v[k][2 * e + 1] = f.y;
        acc += f.x + f.y;
      }
    }
    const float mu = warp_sum(acc) / C;
    acc = 0.f;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (lane + 32 * k < ng)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += (v[k][e] - mu) * (v[k][e] - mu);
    const float rs = rsqrtf(warp_sum(acc) / C + eps);
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      const int g = lane + 32 * k;
      if (g >= ng) continue;
      uint4 u;
      uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * g + 2 * e;
        w[e] = pack_bf16((v[k][2 * e] - mu) * rs * s[c] + b[c],
                         (v[k][2 * e + 1] - mu) * rs * s[c + 1] + b[c + 1]);
      }
      *reinterpret_cast<uint4*>(ts + swz(r, 8 * g)) = u;
    }
  }
}

// ------------------------------------------------------------------ ln_qkv
struct QkvArgs {
  const bf16* x;       // (M, C)
  const float* bqkv;   // packed (3C,); head-major (h, 3d)
  const float* ln1s;   // (C,)
  const float* ln1b;
  int depth;           // the depth the packed Wqkv map is read at
  int M, C;
  float eps;
  int heads;           // qkv's heads: C / kHeadDim, or a tensor-parallel rank's share
};

struct QkvLayout {
  // byte offsets from the 1024-aligned base (`mlp_base`)
  size_t a, out, ring, bars, total;
  QkvLayout() = default;
  explicit QkvLayout(int C) {
    a = 0;                                                     // 2 x (64 x C) rows
    out = a + (size_t)kQkvRows * C * sizeof(bf16);             // a chunk's four output boxes
    ring = out + (size_t)kQkvRows * kQkvChunk * sizeof(bf16);
    bars = ring + (size_t)kQkvRing * kQkvSlabBytes;
    total = bars + 2 * kQkvRing * sizeof(uint64_t) + kAtom;
  }
};

// Where packed box b (qkv columns 64b..64b + 63) lies: its column and depth
// (packed: 64b of `depth`), or its third's column and head (head-major: the
// (h, ., 3d) stacks of Wqkv and of qkv).
template <bool kHeadMajor>
__device__ __forceinline__ int2 qkv_box(int b, int heads, int depth) {
  if constexpr (kHeadMajor) return make_int2(kHeadDim * (b / heads), b % heads);
  return make_int2(64 * b, depth);
}

// Walk the kQkvRows-row tiles blockIdx.x, + gridDim.x, ... below n_tiles.
// Every thread of the block calls it; smem: QkvLayout(C).total bytes, free
// on entry and on return. Needs C % 128 == 0, C <= 512 (3 * a.heads *
// kHeadDim output columns in 128-column chunks; a.heads is C / kHeadDim but
// for a tensor-parallel rank's share, down to one head). kOdd: a.heads is
// odd, and the last chunk holds one 64-column box (the walk loads the box
// before it as its second box, multiplies it again and stores it not);
// the even form's code is the walk without it. Warpgroup w owns
// the tile's rows 64w..64w + 63; both read each weight slab. tw: the TMA map
// over Wqkv, packed (D, C, 3C) or head-major (h, C, 3d), 64-row boxes. The
// output boxes go out by TMA stores through tq, the map over qkv (packed
// (1, M', 3C), head-major (h, M', 3d), M' >= M rows); on return they are
// complete and ordered before the caller's later accesses.
template <bool kHeadMajor, bool kOdd = false>
__device__ __forceinline__ void ln_qkv_walk_bf16(const QkvArgs& a, const CUtensorMap* tw,
                                                 const CUtensorMap* tq, const QkvLayout& L,
                                                 unsigned char* smem_raw, int n_tiles) {
  const int first = blockIdx.x;
  if (first >= n_tiles) return;
  const int C = a.C, M = a.M, heads = a.heads;
  const int nbox = 3 * heads;  // 64-column boxes of qkv
  const int nchunk = kOdd ? cdiv(nbox, 2) : nbox / 2;
  const int per_chunk = C / kQkvSlabRows;
  const int per_tile = nchunk * per_chunk;
  const int mine = (n_tiles - 1 - first) / gridDim.x + 1;
  const size_t half = (size_t)kStageRows * C * sizeof(bf16);  // a 64-row half of the rows

  unsigned char* base = mlp_base(smem_raw);
  unsigned char* as = base + L.a;
  unsigned char* os = base + L.out;
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const uint32_t as_at = smem_addr(as) + wg * half, os_at = smem_addr(os);
  const int r0 = 16 * (tid % 128 / 32) + lane / 4;  // this thread's rows r0, r0 + 8 of its half
  const int cq = 2 * (lane % 4);                    // and column pair in each 8

  // box b, or (kOdd) past the last one the box before it
  auto held = [&](int b) { return kOdd && b == nbox ? b - 1 : b; };
  // slab l: rows 64 s.. of chunk j's two boxes
  auto issue = [&](uint32_t l, uint32_t dst, uint32_t bar) {
    const int q = (int)(l % per_tile), j = q / per_chunk, s = q % per_chunk;
    mbar_expect_tx(bar, kQkvSlabBytes);
    for (int bx = 0; bx < 2; ++bx) {
      const int2 c = qkv_box<kHeadMajor>(held(2 * j + bx), heads, a.depth);
      tma_load_3d(dst + bx * kBoxBytes, tw, bar, c.x, kQkvSlabRows * s, c.y);
    }
  };
  auto load = [&](int tile) {
    mlp_load_rows(as, a.x, 2 * tile, M, C);
    mlp_load_rows(as + half, a.x, 2 * tile + 1, M, C);
  };
  WeightRing<kQkvRing, kQkvSlabBytes> ring;
  ring.start(base + L.bars, base + L.ring, (uint32_t)mine * per_tile, issue);
  load(first);

  uint32_t next = 0;  // the next slab to consume
  for (int i = 0; i < mine; ++i) {
    const int tile = first + i * gridDim.x, row0 = tile * kQkvRows;
    cp_async_wait<0>();
    __syncthreads();  // the tile's rows landed (zeros past M)
    layernorm_tile(as, C, a.ln1s, a.ln1b, a.eps, warp, lane);
    layernorm_tile(as + half, C, a.ln1s, a.ln1b, a.eps, warp, lane);
    fence_proxy_async();  // the normalised rows before the wgmmas read them
    __syncthreads();

    for (int j = 0; j < nchunk; ++j) {
      float acc[64];
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[q] = 0.f;
      for (int s = 0; s < per_chunk; ++s, ++next) {
        ring.acquire(next);
        const uint32_t w = ring.slab(next);
        fence_acc(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kQkvSlabRows / 16; ++kk) {
          const int k = kQkvSlabRows * s + 16 * kk;
          wgmma_n128(acc, wgmma_desc(as_at + (k >> 6) * kBoxBytes + (k & 63) * 2),
                     wgmma_desc(w + kk * 16 * 128, kBoxBytes), s > 0 || kk > 0);
        }
        wgmma_commit();
        fence_acc(acc);
        wgmma_wait<1>();
        ring.release_upto(next, issue);
      }
      wgmma_wait<0>();
      fence_acc(acc);
      ring.release_upto(next, issue);
      if (j == nchunk - 1 && i + 1 < mine) {
        __syncthreads();  // both warpgroups' products have read the rows
        load(tile + gridDim.x);
      }

      // + bqkv, bf16, into this warpgroup's half of the chunk's boxes
      if (tid == 0) bulk_wait_read();
      __syncthreads();  // the previous chunk's stores have read the staging
      unsigned char* ob = os + wg * (2 * kBoxBytes);
      const float* bias[2];  // the chunk's two boxes of bqkv
#pragma unroll
      for (int bx = 0; bx < 2; ++bx) {
        const int b = held(2 * j + bx);
        bias[bx] = a.bqkv + (kHeadMajor ? (b % heads) * 3 * kHeadDim + (b / heads) * kHeadDim
                                        : 64 * b);
      }
#pragma unroll
      for (int jj = 0; jj < 16; ++jj) {
        const int cc = 8 * jj + cq;  // box jj / 8, column cc % 64 of it
        const float2 bb = *reinterpret_cast<const float2*>(bias[jj / 8] + (cc & 63));
        const float* f = acc + 4 * jj;
        *reinterpret_cast<uint32_t*>(ob + swz(r0, cc)) = pack_bf16(f[0] + bb.x, f[1] + bb.y);
        *reinterpret_cast<uint32_t*>(ob + swz(r0 + 8, cc)) = pack_bf16(f[2] + bb.x, f[3] + bb.y);
      }
      fence_proxy_async();
      __syncthreads();  // the chunk's boxes are staged
      if (tid == 0) {
        for (int h = 0; h < 2; ++h)
          for (int bx = 0; bx < (kOdd && 2 * j + 1 == nbox ? 1 : 2); ++bx) {
            const int2 c = qkv_box<kHeadMajor>(2 * j + bx, heads, 0);
            tma_store_3d(tq, os_at + (2 * h + bx) * kBoxBytes, c.x, row0 + kStageRows * h, c.y);
          }
        bulk_commit();
      }
    }
  }
  if (tid == 0) {
    bulk_wait();
    fence_proxy_async_global();
  }
  ring.stop();  // the caller may reuse the memory
}

// ---------------------------------------------------------------- proj_ln2
struct ProjArgs {
  const bf16* o;       // (M, C) the attention output
  const bf16* x;       // (M, C) the residual
  const float* bp;     // (C,)
  const float* ln2s;   // (C,)
  const float* ln2b;
  const float* dp;     // nullptr, or the branch scale of row t at dp[t / dp_div]
  int dp_div;
  int depth;           // the depth the Wp map is read at
  int M, C;
  float eps;
  bool with_y2;
  int K;               // o's columns and Wp's rows: C, or a tensor-parallel rank's C / tp
  float* part;         // kPartial: the raw fp32 product (M, C)
};

struct ProjLayout {
  // byte offsets from the 1024-aligned base (`mlp_base`)
  size_t a, r, ring, stats, bars, total;
  ProjLayout() = default;
  explicit ProjLayout(int C) {
    a = 0;                                            // 64 x C of o, then of x2
    r = a + (size_t)kStageRows * C * sizeof(bf16);    // 64 x C of x, then of y2
    ring = r + (size_t)kStageRows * C * sizeof(bf16);
    stats = ring + (size_t)kProjRing * kSlabBytes;    // [pass][warpgroup][row] fp32
    bars = stats + 2 * 2 * kStageRows * sizeof(float);
    total = bars + 2 * kProjRing * sizeof(uint64_t) + kAtom;
  }
};

// Walk the tiles blockIdx.x, + gridDim.x, ... below n_tiles, as
// ln_qkv_walk_bf16. tw: the TMA map over the depth-stacked (D, K, C) Wp,
// 32-row boxes (K = C but in the partial form). kWide (C == 512,
// `mlp_wide`): m64n256k16, else m64n64k16 blocks (one instruction form a
// kernel). x2 and y2 go out by TMA stores through tx2 and ty2 (maps over
// (1, M', C), M' >= M rows). kPartial (a tensor-parallel rank's share: o
// (M, K) its K = C / tp attention channels, Wp its K rows): the fp32
// product goes raw to a.part (M, C) straight from the fragments, with no
// bias, residual, x2 or LN2 (those follow the all-reduce over the ranks);
// x is not read and tx2, ty2 are unused.
template <bool kWide, bool kPartial = false>
__device__ __forceinline__ void proj_ln2_walk_bf16(const ProjArgs& a, const CUtensorMap* tw,
                                                   const CUtensorMap* tx2, const CUtensorMap* ty2,
                                                   const ProjLayout& L, unsigned char* smem_raw,
                                                   int n_tiles) {
  const int first = blockIdx.x;
  if (first >= n_tiles) return;
  const int C = a.C, M = a.M, K = a.K;
  const int nq = C / 128;  // 64-column output blocks a warpgroup
  const int per_tile = K / kProjSlabRows;
  const int mine = (n_tiles - 1 - first) / gridDim.x + 1;

  unsigned char* base = mlp_base(smem_raw);
  unsigned char* as = base + L.a;
  unsigned char* rs = base + L.r;
  float* stats = reinterpret_cast<float*>(base + L.stats);
  const uint32_t as_at = smem_addr(as), rs_at = smem_addr(rs);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int r0 = 16 * (tid % 128 / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                    // and column pair in each 8

  // slab l: rows 32 s.., all C columns
  auto issue = [&](uint32_t l, uint32_t dst, uint32_t bar) {
    const int s = (int)(l % per_tile);
    mbar_expect_tx(bar, kProjSlabRows * C * sizeof(bf16));
    for (int b = 0; b < C / 64; ++b)
      tma_load_3d(dst + b * (kProjSlabRows * 128), tw, bar, 64 * b, kProjSlabRows * s, a.depth);
  };
  WeightRing<kProjRing> ring;
  ring.start(base + L.bars, base + L.ring, (uint32_t)mine * per_tile, issue);
  mlp_load_rows(as, a.o, first, M, K);
  if constexpr (!kPartial) mlp_load_rows(rs, a.x, first, M, C);

  uint32_t next = 0;
  float acc[128];
#pragma unroll
  for (int q = 0; q < 128; ++q) acc[q] = 0.f;  // no value live into the walk
  for (int i = 0; i < mine; ++i) {
    const int tile = first + i * gridDim.x, row0 = tile * kStageRows;
    cp_async_wait<kPartial ? 0 : 1>();
    fence_proxy_async();
    __syncthreads();  // o landed for every thread (x may still be in flight)

    for (int s = 0; s < per_tile; ++s, ++next) {
      ring.acquire(next);
      const uint32_t w = ring.slab(next) + wg * nq * (kProjSlabRows * 128);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kProjSlabRows / 16; ++kk) {
        const int k = kProjSlabRows * s + 16 * kk;
        const uint64_t da = wgmma_desc(as_at + (k >> 6) * kBoxBytes + (k & 63) * 2);
        const int first_k = s == 0 && kk == 0;
        if constexpr (kWide) {
          wgmma_n256(acc, da, wgmma_desc(w + kk * 16 * 128, kProjSlabRows * 128), !first_k);
        } else {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            if (q < nq)
              wgmma_n64(*reinterpret_cast<float(*)[32]>(acc + 32 * q), da,
                        wgmma_desc(w + q * (kProjSlabRows * 128) + kk * 16 * 128), !first_k);
        }
      }
      wgmma_commit();
      fence_acc(acc);
      wgmma_wait<1>();
      ring.release_upto(next, issue);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    ring.release_upto(next, issue);

    if constexpr (kPartial) {
      // the raw fp32 product, rows past M dropped
      const int ta = row0 + r0, tb = ta + 8;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nq) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float* d = acc + 32 * q + 4 * jj;
            const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
            if (ta < M)
              *reinterpret_cast<float2*>(a.part + (size_t)ta * C + c) = make_float2(d[0], d[1]);
            if (tb < M)
              *reinterpret_cast<float2*>(a.part + (size_t)tb * C + c) = make_float2(d[2], d[3]);
          }
        }
      if (i + 1 < mine) {
        __syncthreads();  // both warpgroups' products have read o
        mlp_load_rows(as, a.o, tile + gridDim.x, M, K);
      }
      continue;
    }

    // epilogue: + bp, DropPath, + x, x2; LN2 over the C columns of a row
    // (this warpgroup holds C / 2 of them); y2
    const int ta = row0 + r0, tb = ta + 8;
    const bool va = ta < M, vb = tb < M;
    const float ka = a.dp && va ? a.dp[ta / a.dp_div] : 1.f;
    const float kb = a.dp && vb ? a.dp[tb / a.dp_div] : 1.f;
    cp_async_wait<0>();
    __syncthreads();  // x landed; both warpgroups' products have read o
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float* d = acc + 32 * q + 4 * jj;
          const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
          const float2 bb = *reinterpret_cast<const float2*>(a.bp + c);
          const float2 xa =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rs + swz(r0, c)));
          const float2 xb =
              __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(rs + swz(r0 + 8, c)));
          // x + (proj + bp), or x + dp * (proj + bp) rounded apart (no FMA)
          if (a.dp) {
            d[0] = xa.x + __fmul_rn(d[0] + bb.x, ka);
            d[1] = xa.y + __fmul_rn(d[1] + bb.y, ka);
            d[2] = xb.x + __fmul_rn(d[2] + bb.x, kb);
            d[3] = xb.y + __fmul_rn(d[3] + bb.y, kb);
          } else {
            d[0] = xa.x + (d[0] + bb.x);
            d[1] = xa.y + (d[1] + bb.y);
            d[2] = xb.x + (d[2] + bb.x);
            d[3] = xb.y + (d[3] + bb.y);
          }
          sa += d[0] + d[1];
          sb += d[2] + d[3];
          *reinterpret_cast<uint32_t*>(as + swz(r0, c)) = pack_bf16(d[0], d[1]);
          *reinterpret_cast<uint32_t*>(as + swz(r0 + 8, c)) = pack_bf16(d[2], d[3]);
        }
      }
    if (a.with_y2) {
      wg_row_sums(sa, sb, stats, wg, r0, lane);  // every read of x is done
      const float mua = sa / C, mub = sb / C;
      sa = sb = 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nq) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float* d = acc + 32 * q + 4 * jj;
            sa += (d[0] - mua) * (d[0] - mua) + (d[1] - mua) * (d[1] - mua);
            sb += (d[2] - mub) * (d[2] - mub) + (d[3] - mub) * (d[3] - mub);
          }
        }
      wg_row_sums(sa, sb, stats + 2 * kStageRows, wg, r0, lane);
      const float rsa = rsqrtf(sa / C + a.eps), rsb = rsqrtf(sb / C + a.eps);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nq) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float* d = acc + 32 * q + 4 * jj;
            const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
            const float2 s = *reinterpret_cast<const float2*>(a.ln2s + c);
            const float2 b = *reinterpret_cast<const float2*>(a.ln2b + c);
            *reinterpret_cast<uint32_t*>(rs + swz(r0, c)) =
                pack_bf16((d[0] - mua) * rsa * s.x + b.x, (d[1] - mua) * rsa * s.y + b.y);
            *reinterpret_cast<uint32_t*>(rs + swz(r0 + 8, c)) =
                pack_bf16((d[2] - mub) * rsb * s.x + b.x, (d[3] - mub) * rsb * s.y + b.y);
          }
        }
    }
    fence_proxy_async();
    __syncthreads();  // the tile's x2 (and y2) boxes are staged
    if (tid == 0) {
      for (int b = 0; b < C / 64; ++b) {
        tma_store_3d(tx2, as_at + b * kBoxBytes, 64 * b, row0, 0);
        if (a.with_y2) tma_store_3d(ty2, rs_at + b * kBoxBytes, 64 * b, row0, 0);
      }
      bulk_commit();
    }
    if (i + 1 < mine) {
      if (tid == 0) bulk_wait_read();
      __syncthreads();  // every read of the tile's shared rows is done
      mlp_load_rows(as, a.o, tile + gridDim.x, M, C);
      mlp_load_rows(rs, a.x, tile + gridDim.x, M, C);
    }
  }
  if (tid == 0) {
    bulk_wait();
    fence_proxy_async_global();
  }
  ring.stop();  // the caller may reuse the memory
}

// -------------------------------------------------------------------- fp32
// The fp32 walks: the bf16 walks' skeleton in tf32x3 (mlp.cuh, "fp32:
// tf32x3"), 64 token rows a tile, both warpgroups on the tile's rows, each
// with half of the output columns. The A tile (LN1(x), or o) is fp32 in
// shared memory; the weights' hi and lo planes stream through a ring of
// three 32 KB stages. Outputs go from the fragments to device memory as
// 8-byte stores (a warp's quad covers 32 contiguous bytes of a row).
//   * ln_qkv: LN1 in place on the loaded x rows (`warp_layernorm`, as
//     residual_ln.cu: warp w takes rows 8w..8w + 7); 3C output columns in
//     chunks of 128, warpgroup w columns 64w.. of each, a stage per 32 k.
//     A 64-row box of the planes is one packed box of qkv (columns 64b..):
//     K8 loads it from the head-major (h, 3d, C) planes (head b % h, rows
//     64 (b / h)..) to the stage place K1 loads it from the packed (3C, C),
//     so the two compute the same bits.
//     An odd head count (a tensor-parallel rank's share, down to one head)
//     ends in a 64-column chunk: warpgroup 1 multiplies a copy of its box
//     there and stores nothing.
//   * proj_ln2: warpgroup w owns output columns w C / 2.. (C / 128 blocks
//     of 64) over all of K = C, a stage per 32 k and block, each stage's
//     products promoted (`tf32x3_stage<true>`, as ln_qkv's); the epilogue is
//     the bf16 walk's (+ bp, DropPath, + x read from device memory, x2, LN2
//     across both warpgroups, y2). The partial form (kPartial) takes K = C /
//     tp and writes the raw product.
// The next tile's rows load once both warpgroups' fragments have read the
// current ones (under the epilogue). Shared memory at C = 512: ring 96 KB,
// A 128 KB, row sums 1 KB.
constexpr int kF32StageRing = 3;

struct QkvArgsF32 {
  const float* x;      // (M, C)
  float* qkv;          // packed (M, 3 heads d); head-major (h, M, 3d)
  const float* bqkv;   // packed (3 heads d,); head-major (h, 3d)
  const float* ln1s;   // (C,)
  const float* ln1b;
  int depth;           // the depth the packed planes' map is read at
  int M, C;
  float eps;
  int heads;
};

inline F32Layout f32_stage_layout(int C) { return F32Layout(kF32StageRing, C, 0); }

// Walk the 64-row tiles blockIdx.x, + gridDim.x, ... below n_tiles, as
// ln_qkv_walk_bf16 (needs C % 128 == 0, C <= 512; kOdd as there). tw: the
// TMA map over the Wqkv planes, packed (2D, 3 heads d, C) or head-major
// (2h, 3d, C). On return qkv is written.
template <bool kHeadMajor, bool kOdd = false>
__device__ __forceinline__ void ln_qkv_walk_f32(const QkvArgsF32& a, const CUtensorMap* tw,
                                                const F32Layout& L, unsigned char* smem_raw,
                                                int n_tiles) {
  const int first = blockIdx.x;
  if (first >= n_tiles) return;
  const int C = a.C, M = a.M, heads = a.heads;
  const int n3 = 3 * heads * kHeadDim, nbox = 3 * heads;
  const int nchunk = kOdd ? cdiv(nbox, 2) : nbox / 2;
  const int per_chunk = C / kF32K, per_tile = nchunk * per_chunk;
  const int mine = (n_tiles - 1 - first) / gridDim.x + 1;

  unsigned char* base = mlp_base(smem_raw);
  float* as = reinterpret_cast<float*>(base + L.a);
  const int tid = threadIdx.x, wg = tid / 128, warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * (tid % 128 / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                    // and column pair in each 8

  // stage l: chunk j's two boxes (packed boxes 2j, 2j + 1, one a
  // warpgroup; past the last box, in the tail chunk of an odd head count,
  // box 2j again, multiplied and never stored), k 32 s..
  auto issue = [&](uint32_t l, uint32_t dst, uint32_t bar) {
    const int q = (int)(l % per_tile), j = q / per_chunk, s = q % per_chunk;
    auto box = [&](int b) {
      return kHeadMajor ? make_int2(kHeadDim * (b / heads), 2 * (b % heads))
                        : make_int2(64 * b, 2 * a.depth);
    };
    f32_issue_stage(dst, tw, bar, kF32K * s, box(2 * j),
                    box(kOdd && 2 * j + 1 == nbox ? 2 * j : 2 * j + 1));
  };
  WeightRing<kF32StageRing, kF32Stage> ring;
  ring.start(base + L.bars, base + L.ring, (uint32_t)mine * per_tile, issue);
  f32_load_rows(as, a.x, first * kF32Tile, M, C);

  uint32_t next = 0;  // the next slab to consume
  for (int i = 0; i < mine; ++i) {
    const int tile = first + i * gridDim.x, row0 = tile * kF32Tile;
    cp_async_wait<0>();
    __syncthreads();  // the tile's rows landed (zeros past M)
    for (int r = 8 * warp; r < 8 * warp + 8; ++r) {
      if (row0 + r >= M) continue;
      float v[32];
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < C / 32) v[k] = as[f32_at(r, 32 * k + lane, C)];
      warp_layernorm(v, C, a.ln1s, a.ln1b, a.eps, lane);
#pragma unroll
      for (int k = 0; k < 32; ++k)
        if (k < C / 32) as[f32_at(r, 32 * k + lane, C)] = v[k];
    }
    __syncthreads();  // the normalised rows

    const int ta = row0 + r0, tb = ta + 8;
    for (int j = 0; j < nchunk; ++j) {
      float acc[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) acc[q] = 0.f;
      for (int s = 0; s < per_chunk; ++s, ++next) {
        ring.acquire(next);
        tf32x3_stage<true>(acc, as, C, kF32K * s, ring.slab(next) + wg * kF32Box);
        ring.release_upto(next + 1, issue);
      }
      if (j == nchunk - 1 && i + 1 < mine) {
        __syncthreads();  // both warpgroups' fragments have read the rows
        f32_load_rows(as, a.x, (tile + gridDim.x) * kF32Tile, M, C);
      }
      if (kOdd && 2 * j + wg == nbox) continue;  // the odd chunk's second box
      // + bqkv, out: packed column c is box c / 64's column c % 64
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = kF32Chunk * j + 64 * wg + 8 * jj + cq;
        const int b = c / 64, cc = c % 64;
        const float* bias = a.bqkv + c;
        float* qa = a.qkv + (size_t)ta * n3 + c;
        float* qb = a.qkv + (size_t)tb * n3 + c;
        if constexpr (kHeadMajor) {
          constexpr int d3 = 3 * kHeadDim;
          const int h = b % heads, third = b / heads;
          bias = a.bqkv + h * d3 + third * kHeadDim + cc;
          qa = a.qkv + ((size_t)h * M + ta) * d3 + third * kHeadDim + cc;
          qb = qa + 8 * d3;
        }
        const float2 bb = *reinterpret_cast<const float2*>(bias);
        const float* f = acc + 4 * jj;
        if (ta < M) *reinterpret_cast<float2*>(qa) = make_float2(f[0] + bb.x, f[1] + bb.y);
        if (tb < M) *reinterpret_cast<float2*>(qb) = make_float2(f[2] + bb.x, f[3] + bb.y);
      }
    }
  }
  ring.stop();  // the caller may reuse the memory
}

struct ProjArgsF32 {
  const float* o;      // (M, C) the attention output
  const float* x;      // (M, C) the residual
  float* x2;           // (M, C)
  float* y2;           // (M, C)
  const float* bp;     // (C,)
  const float* ln2s;   // (C,)
  const float* ln2b;
  const float* dp;     // nullptr, or the branch scale of row t at dp[t / dp_div]
  int dp_div;
  int depth;           // the depth the Wp planes' map is read at
  int M, C;
  float eps;
  bool with_y2;
  int K;               // o's columns and Wp's rows: C, or a tensor-parallel rank's C / tp
  float* part;         // kPartial: the raw fp32 product (M, C)
};

// Walk the 64-row tiles blockIdx.x, + gridDim.x, ... below n_tiles, as
// proj_ln2_walk_bf16 (needs C % 128 == 0, C <= 512, K % 32 == 0). tw: the
// TMA map over the Wp planes (2D, C, K). On return x2 (and y2) are written.
// kPartial: as proj_ln2_walk_bf16's (o (M, K), the raw product to a.part;
// x, x2, y2, bp and the LayerNorm unused).
template <bool kPartial = false>
__device__ __forceinline__ void proj_ln2_walk_f32(const ProjArgsF32& a, const CUtensorMap* tw,
                                                  const F32Layout& L, unsigned char* smem_raw,
                                                  int n_tiles) {
  const int first = blockIdx.x;
  if (first >= n_tiles) return;
  const int C = a.C, M = a.M, K = a.K;
  const int nq = C / 128;  // 64-column output blocks a warpgroup
  const int per_tile = (K / kF32K) * nq;
  const int mine = (n_tiles - 1 - first) / gridDim.x + 1;

  unsigned char* base = mlp_base(smem_raw);
  float* as = reinterpret_cast<float*>(base + L.a);
  float* stats = reinterpret_cast<float*>(base + L.stats);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int r0 = 16 * (tid % 128 / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                    // and column pair in each 8

  // stage l: k 32 (s / nq).., block q = s % nq: rows 64 q.. (warpgroup w:
  // + C / 2 w)
  auto issue = [&](uint32_t l, uint32_t dst, uint32_t bar) {
    const int s = (int)(l % per_tile), kb = s / nq, qb = s % nq;
    f32_issue_stage(dst, tw, bar, kF32K * kb, make_int2(64 * qb, 2 * a.depth),
                    make_int2(C / 2 + 64 * qb, 2 * a.depth));
  };
  WeightRing<kF32StageRing, kF32Stage> ring;
  ring.start(base + L.bars, base + L.ring, (uint32_t)mine * per_tile, issue);
  f32_load_rows(as, a.o, first * kF32Tile, M, K);

  uint32_t next = 0;
  for (int i = 0; i < mine; ++i) {
    const int tile = first + i * gridDim.x, row0 = tile * kF32Tile;
    float acc[128];
#pragma unroll
    for (int q = 0; q < 128; ++q) acc[q] = 0.f;
    cp_async_wait<0>();
    __syncthreads();  // o landed for every thread

    for (int kb = 0; kb < K / kF32K; ++kb)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nq) {
          ring.acquire(next);
          tf32x3_stage<true>(*reinterpret_cast<float(*)[32]>(acc + 32 * q), as, K, kF32K * kb,
                             ring.slab(next) + wg * kF32Box);
          ring.release_upto(++next, issue);
        }
    if (i + 1 < mine) {
      __syncthreads();  // both warpgroups' fragments have read o
      f32_load_rows(as, a.o, (tile + gridDim.x) * kF32Tile, M, K);
    }

    const int ta = row0 + r0, tb = ta + 8;
    if constexpr (kPartial) {
      f32_store_partial(a.part, acc, nq, wg, C, M, ta, cq);
      continue;
    }

    // epilogue: + bp, DropPath, + x, x2; LN2 over the C columns of a row
    // (this warpgroup holds C / 2 of them); y2
    const bool va = ta < M, vb = tb < M;
    const float ka = a.dp && va ? a.dp[ta / a.dp_div] : 1.f;
    const float kb = a.dp && vb ? a.dp[tb / a.dp_div] : 1.f;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float* d = acc + 32 * q + 4 * jj;
          const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
          const float2 bb = *reinterpret_cast<const float2*>(a.bp + c);
          const float2 xa = va ? *reinterpret_cast<const float2*>(a.x + (size_t)ta * C + c)
                               : make_float2(0.f, 0.f);
          const float2 xb = vb ? *reinterpret_cast<const float2*>(a.x + (size_t)tb * C + c)
                               : make_float2(0.f, 0.f);
          // x + (proj + bp), or x + dp * (proj + bp) rounded apart (no FMA)
          if (a.dp) {
            d[0] = xa.x + __fmul_rn(d[0] + bb.x, ka);
            d[1] = xa.y + __fmul_rn(d[1] + bb.y, ka);
            d[2] = xb.x + __fmul_rn(d[2] + bb.x, kb);
            d[3] = xb.y + __fmul_rn(d[3] + bb.y, kb);
          } else {
            d[0] = xa.x + (d[0] + bb.x);
            d[1] = xa.y + (d[1] + bb.y);
            d[2] = xb.x + (d[2] + bb.x);
            d[3] = xb.y + (d[3] + bb.y);
          }
          sa += d[0] + d[1];
          sb += d[2] + d[3];
          if (va) *reinterpret_cast<float2*>(a.x2 + (size_t)ta * C + c) = make_float2(d[0], d[1]);
          if (vb) *reinterpret_cast<float2*>(a.x2 + (size_t)tb * C + c) = make_float2(d[2], d[3]);
        }
      }
    if (!a.with_y2) continue;
    wg_row_sums(sa, sb, stats, wg, r0, lane);
    const float mua = sa / C, mub = sb / C;
    sa = sb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* d = acc + 32 * q + 4 * jj;
          sa += (d[0] - mua) * (d[0] - mua) + (d[1] - mua) * (d[1] - mua);
          sb += (d[2] - mub) * (d[2] - mub) + (d[3] - mub) * (d[3] - mub);
        }
      }
    wg_row_sums(sa, sb, stats + 2 * kF32Tile, wg, r0, lane);
    const float rsa = rsqrtf(sa / C + a.eps), rsb = rsqrtf(sb / C + a.eps);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* d = acc + 32 * q + 4 * jj;
          const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
          const float2 s = *reinterpret_cast<const float2*>(a.ln2s + c);
          const float2 b = *reinterpret_cast<const float2*>(a.ln2b + c);
          if (va)
            *reinterpret_cast<float2*>(a.y2 + (size_t)ta * C + c) =
                make_float2((d[0] - mua) * rsa * s.x + b.x, (d[1] - mua) * rsa * s.y + b.y);
          if (vb)
            *reinterpret_cast<float2*>(a.y2 + (size_t)tb * C + c) =
                make_float2((d[2] - mub) * rsb * s.x + b.x, (d[3] - mub) * rsb * s.y + b.y);
        }
      }
  }
  ring.stop();  // the caller may reuse the memory
}

// --------------------------------------------------------------- launches
struct QkvParams {
  CUtensorMap tw, tq;  // Wqkv, qkv
  QkvArgs a;
  QkvLayout L;
  int n_tiles;
};

struct ProjParams {
  CUtensorMap tw, tx2, ty2;  // Wp, x2, y2
  ProjArgs a;
  ProjLayout L;
  int n_tiles;
};

template <bool kHeadMajor, bool kOdd>
__global__ void __launch_bounds__(kThreads) ln_qkv_walk_kernel(const __grid_constant__ QkvParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_qkv_walk_bf16<kHeadMajor, kOdd>(p.a, &p.tw, &p.tq, p.L, smem, p.n_tiles);
}

template <bool kWide, bool kPartial = false>
__global__ void __launch_bounds__(kThreads) proj_ln2_walk_kernel(const __grid_constant__ ProjParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  proj_ln2_walk_bf16<kWide, kPartial>(p.a, &p.tw, &p.tx2, &p.ty2, p.L, smem, p.n_tiles);
}

struct QkvParamsF32 {
  CUtensorMap tw;  // the Wqkv planes
  QkvArgsF32 a;
  F32Layout L;
  int n_tiles;
};

struct ProjParamsF32 {
  CUtensorMap tw;  // the Wp planes
  ProjArgsF32 a;
  F32Layout L;
  int n_tiles;
};

template <bool kHeadMajor, bool kOdd>
__global__ void __launch_bounds__(kThreads)
ln_qkv_walk_f32_kernel(const __grid_constant__ QkvParamsF32 p) {
  extern __shared__ __align__(128) unsigned char smem[];
  ln_qkv_walk_f32<kHeadMajor, kOdd>(p.a, &p.tw, p.L, smem, p.n_tiles);
}

template <bool kPartial = false>
__global__ void __launch_bounds__(kThreads)
proj_ln2_walk_f32_kernel(const __grid_constant__ ProjParamsF32 p) {
  extern __shared__ __align__(128) unsigned char smem[];
  proj_ln2_walk_f32<kPartial>(p.a, &p.tw, p.L, smem, p.n_tiles);
}

// The shapes the stage's GEMM steps take, the same in both types (the
// walks: C / 2 output columns a warpgroup in 64-column blocks; head_dim 64).
template <typename T>
inline bool stage_shape_ok(int C) {
  return C % 128 == 0 && C <= 512 && C > 0;
}

// qkv = LN1(x) @ Wqkv + bqkv over M token rows, `heads` heads (C /
// kHeadDim, or a tensor-parallel rank's share, any count: Wqkv (C, 3 *
// heads * 64)) (kHeadMajor: Wqkv (h, C, 3d), bqkv (h, 3d), qkv (h, M, 3d)).
// fp32 takes Wqkv's hi and lo planes instead: packed (2, 3 * heads * 64, C),
// head-major (h, 2, 3d, C). Returns 0, a cudaError_t or kNoTensorMap.
template <typename T, bool kHeadMajor>
int launch_ln_qkv(const T* x, const T* wqkv, const float* bqkv, const float* ln1s,
                  const float* ln1b, T* qkv, int M, int C, int heads, float eps,
                  cudaStream_t stream) {
  const int d3 = 3 * kHeadDim, n3 = heads * d3;
  if constexpr (std::is_same<T, bf16>::value) {
    QkvParams p{};
    const int e = kHeadMajor ? encode_weight_map(&p.tw, wqkv, heads, C, d3, kQkvSlabRows)
                             : encode_weight_map(&p.tw, wqkv, 1, C, n3, kQkvSlabRows);
    if (e) return e;
    if (kHeadMajor ? encode_weight_map(&p.tq, qkv, heads, M, d3, kStageRows)
                   : encode_weight_map(&p.tq, qkv, 1, M, n3, kStageRows))
      return kNoTensorMap;
    p.a = QkvArgs{x, bqkv, ln1s, ln1b, 0, M, C, eps, heads};
    p.L = QkvLayout(C);
    p.n_tiles = cdiv(M, kQkvRows);
    auto kernel = heads % 2 ? &ln_qkv_walk_kernel<kHeadMajor, true>
                            : &ln_qkv_walk_kernel<kHeadMajor, false>;
    int blocks = 0;
    const cudaError_t ce = persistent_grid(kernel, (int)p.L.total, p.n_tiles, &blocks);
    if (ce != cudaSuccess) return (int)ce;
    kernel<<<blocks, kThreads, p.L.total, stream>>>(p);
  } else {
    QkvParamsF32 p{};
    const int e = kHeadMajor ? encode_plane_map(&p.tw, wqkv, 2 * heads, d3, C)
                             : encode_plane_map(&p.tw, wqkv, 2, n3, C);
    if (e) return e;
    p.a = QkvArgsF32{x, qkv, bqkv, ln1s, ln1b, 0, M, C, eps, heads};
    p.L = f32_stage_layout(C);
    p.n_tiles = cdiv(M, kF32Tile);
    auto kernel = heads % 2 ? &ln_qkv_walk_f32_kernel<kHeadMajor, true>
                            : &ln_qkv_walk_f32_kernel<kHeadMajor, false>;
    int blocks = 0;
    const cudaError_t ce = persistent_grid(kernel, (int)p.L.total, p.n_tiles, &blocks);
    if (ce != cudaSuccess) return (int)ce;
    kernel<<<blocks, kThreads, p.L.total, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// x2 = x + (o @ Wp + bp) (DropPath: the branch scaled by dp[row / dp_div]),
// y2 = LN2 of it unless !with_y2, over M token rows; fp32 takes Wp's hi and
// lo planes (2, C, C) instead. Returns 0, a cudaError_t or kNoTensorMap.
template <typename T>
int launch_proj_ln2(const T* o, const T* x, const T* wp, const float* bp, const float* ln2s,
                    const float* ln2b, T* x2, T* y2, int M, int C, float eps,
                    cudaStream_t stream, const float* dp = nullptr, int dp_div = 1,
                    bool with_y2 = true) {
  if constexpr (std::is_same<T, bf16>::value) {
    ProjParams p{};
    int e = encode_weight_map(&p.tw, wp, 1, C, C, kProjSlabRows);
    if (!e) e = encode_weight_map(&p.tx2, x2, 1, M, C, kStageRows);
    if (!e) e = encode_weight_map(&p.ty2, y2, 1, M, C, kStageRows);
    if (e) return e;
    p.a = ProjArgs{o, x, bp, ln2s, ln2b, dp, dp_div, 0, M, C, eps, with_y2, C, nullptr};
    p.L = ProjLayout(C);
    p.n_tiles = cdiv(M, kStageRows);
    auto kernel = mlp_wide(C) ? &proj_ln2_walk_kernel<true> : &proj_ln2_walk_kernel<false>;
    int blocks = 0;
    const cudaError_t ce = persistent_grid(kernel, (int)p.L.total, p.n_tiles, &blocks);
    if (ce != cudaSuccess) return (int)ce;
    kernel<<<blocks, kThreads, p.L.total, stream>>>(p);
  } else {
    ProjParamsF32 p{};
    const int e = encode_plane_map(&p.tw, wp, 2, C, C);
    if (e) return e;
    p.a = ProjArgsF32{o, x, x2, y2, bp, ln2s, ln2b, dp, dp_div, 0, M, C, eps, with_y2, C,
                      nullptr};
    p.L = f32_stage_layout(C);
    p.n_tiles = cdiv(M, kF32Tile);
    int blocks = 0;
    const cudaError_t ce =
        persistent_grid(proj_ln2_walk_f32_kernel<false>, (int)p.L.total, p.n_tiles, &blocks);
    if (ce != cudaSuccess) return (int)ce;
    proj_ln2_walk_f32_kernel<false><<<blocks, kThreads, p.L.total, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// part = o @ Wp over M token rows, raw in fp32 (M, C): a tensor-parallel
// rank's share of the projection, o (M, K) its K = C / tp attention channels
// and Wp (K, C) its rows (fp32: their hi and lo planes, (2, C, K)). Returns
// 0, a cudaError_t or kNoTensorMap.
template <typename T>
int launch_proj_partial(const T* o, const T* wp, float* part, int M, int K, int C,
                        cudaStream_t stream) {
  if constexpr (std::is_same<T, bf16>::value) {
    ProjParams p{};
    const int e = encode_weight_map(&p.tw, wp, 1, K, C, kProjSlabRows);
    if (e) return e;
    p.a = ProjArgs{o, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 0, M, C, 0.f, false, K,
                   part};
    p.L = ProjLayout(C);
    p.n_tiles = cdiv(M, kStageRows);
    auto kernel =
        mlp_wide(C) ? &proj_ln2_walk_kernel<true, true> : &proj_ln2_walk_kernel<false, true>;
    int blocks = 0;
    const cudaError_t ce = persistent_grid(kernel, (int)p.L.total, p.n_tiles, &blocks);
    if (ce != cudaSuccess) return (int)ce;
    kernel<<<blocks, kThreads, p.L.total, stream>>>(p);
  } else {
    ProjParamsF32 p{};
    const int e = encode_plane_map(&p.tw, wp, 2, C, K);
    if (e) return e;
    p.a = ProjArgsF32{o, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, 1, 0, M,
                      C, 0.f, false, K, part};
    p.L = f32_stage_layout(C);
    p.n_tiles = cdiv(M, kF32Tile);
    int blocks = 0;
    const cudaError_t ce =
        persistent_grid(proj_ln2_walk_f32_kernel<true>, (int)p.L.total, p.n_tiles, &blocks);
    if (ce != cudaSuccess) return (int)ce;
    proj_ln2_walk_f32_kernel<true><<<blocks, kThreads, p.L.total, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace d3dp
