// The MLP half-block as tile walks, shared by the MLP-block kernels
// (mlp_block_t.cu) and the depth-resident kernel (resident.cu):
//   y = LN(res + (act(x @ W1 + b1) @ W2 + b2)) over tiles of token rows,
// each row written whole to its output row.
//
// What bounds it on the H100: operations. 4*T*C*H FLOPs for T tokens against
// 3*T*C activation elements moved (x, res in; y out): about 680 FLOPs a byte
// in bf16 at C=512, H=1024, above the card's 295, provided the hidden
// activation h (T x H) never reaches device memory. Short of that bound:
// every tile reads all of W1 and W2 (2 MiB in bf16) from L2, so the weight
// stream an SM needs falls as the tile's rows grow; and the tile has to
// keep its 64 x C fp32 output in registers while h passes through.
//
// bf16 (`mlp_walk_bf16`): a tile is 64 token rows, one wgmma M; one block
// of two warpgroups fills an SM (227 KB of shared memory, 255 registers).
//   * x (64 x C) sits in shared memory in the 128-byte swizzled layout the
//     wgmma descriptors read, loaded with cp.async, rows past M zero-filled.
//   * The hidden dimension goes in chunks of 128. fc1: warpgroup w computes
//     h's columns 64w..64w+63 of the chunk with wgmma.mma_async m64n64k16
//     (fp32 in 32 registers), adds b1, applies the activation (a template
//     argument, one mode a code path), rounds to bf16 and writes them to a
//     swizzled 64 x 128 buffer (two buffers, alternating). fc2: both
//     warpgroups add h_chunk @ W2[chunk, :] into their half of the 64 x C
//     output, warpgroup w owning columns w*C/2.. (m64n256k16 at C=512, 128
//     fp32 registers a thread kept across all chunks). h exists a chunk at a
//     time and never leaves the SM.
//   * W1 and W2 reach shared memory through a ring of kRing 32 KB slabs
//     (128 x 128 of W1, 32 x C of W2, in the weights' own row-major layout,
//     which wgmma reads as an MN-major B), copied by the tensor memory
//     accelerator (TMA, thread 0 issuing) and completing on an mbarrier a
//     stage. Thread 0 refills a stage once both warpgroups' wgmmas that read
//     it have retired, so warpgroup 0 waits on warpgroup 1's products there:
//     the two share the SM's tensor cores, and a non-blocking refill
//     measured slower.
//   * The epilogue works on the accumulator fragments: + b2, the DropPath
//     scale, + res (read from shared memory, where cp.async put it while the
//     last chunk's fc2 ran), the LayerNorm's two passes (quad shuffles inside
//     a warp, a 2 x 64 exchange between the warpgroups), then each row to its
//     output row.
//   * A block walks tiles blockIdx.x, + gridDim.x, ...: the ring
//     (`WeightRing`, shared with the stage walks of stage.cuh) runs on
//     across tile boundaries (the slab sequence repeats every tile), the
//     next tile's x loads after the epilogue, and the output rows are staged
//     in shared memory and written with bulk copies that complete under the
//     next tile's products.
// Shared memory: x 64 KB, h 2 x 16 KB, ring 4 x 32 KB, at C = 512.
//
// fp32 (`mlp_walk_f32`; the default dtype of every entry point): the same
// walk in tf32x3, three TF32 passes from the weights' hi and lo planes
// (section "fp32: tf32x3" below), x, h and the ring in shared memory (x
// 128 KB, h 32 KB, ring 2 x 32 KB at C = 512).
#pragma once

#include <cuda.h>

#include "common.cuh"

namespace d3dp {

// The activation, per launch: D3DP_MLP_VARIANT of the TPU MLP kernels
// (`_gelu_inkernel`, d3dp_tpu/ops/mlp.py).
constexpr int kGeluErf = 0;   // production: 0.5 v (1 + erf(v / sqrt 2)), fp32
constexpr int kGeluBf16 = 1;  // bf16gelu (bf16 only): the A&S 7.1.26 erf in bf16
constexpr int kGeluNone = 2;  // nogelu: the identity

// Returned by the launchers when cuTensorMapEncodeTiled cannot be reached or
// refuses a weight map.
constexpr int kNoTensorMap = -3;

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

// The production GELU of the bf16 tile: erf by A&S 7.1.26 (|error| <= 1.5e-7,
// the TPU kernels' own `_erf32`), branch-free with the fast exponential and
// reciprocal, where erff's branches diverge inside a warp; h is rounded to
// bf16 right after.
__device__ __forceinline__ float gelu_poly(float v) {
  const float z = v * 0.70710678118654752f;
  const float a = fabsf(z);
  const float t = __fdividef(1.f, fmaf(0.3275911f, a, 1.f));
  const float p =
      t * fmaf(t, fmaf(t, fmaf(t, fmaf(t, 1.061405429f, -1.453152027f), 1.421413741f),
                       -0.284496736f),
               0.254829592f);
  const float erf = copysignf(1.f - p * __expf(-a * a), z);
  return 0.5f * v * (1.f + erf);
}

template <int kMode>
__device__ __forceinline__ float activation_bf16(float v) {
  return kMode == kGeluNone ? v : kMode == kGeluBf16 ? gelu_bf16(v) : gelu_poly(v);
}

// One walk's operands. Token row t = (b, i, j) of (B, D1, D2) goes to output
// row (b, j, i) under kTranspose, else to row t. DropPath: with dp, the
// branch (fc2 and its bias) of row t is scaled by dp[t / D2] in fp32 before
// the residual add (one scale per (b, i); the rows form passes D2 = 1);
// dp == nullptr leaves the arithmetic as it is without. gelu: a kGelu*
// activation (kGeluBf16 only in bf16). Pointers carry no __restrict__: in
// resident.cu a buffer a walk reads was written by other blocks earlier in
// the same launch.
template <typename T>
struct MlpArgs {
  const T* x;
  const T* res;
  const T* w1;        // (C, H); unused by the walks, which read W1 through a TMA map
  const float* b1;    // (H,)
  const T* w2;        // (H, C); unused by the walks, which read W2 through a TMA map
  const float* b2;    // (C,)
  const float* lns;   // (C,) the closing LayerNorm's scale
  const float* lnb;   // (C,) and bias
  T* out;
  const float* dp;
  int depth;  // the depth the TMA maps of the weight stacks are read at
  int D1, D2, M, C, H, gelu;
  float eps;
  float* part;  // the partial form: (M, C) fp32 out; res, b2, lns, lnb, out, dp unused
};

__device__ __forceinline__ size_t mlp_out_row(int t, int D1, int D2, bool transpose) {
  if (!transpose) return (size_t)t;
  const int plane = D1 * D2;
  const int b = t / plane, rem = t % plane;
  return (size_t)(b * D2 + rem % D2) * D1 + rem / D2;
}

template <typename T> struct MlpLayout;

// ------------------------------------------------------ Hopper primitives
// (the mbarrier and bulk-copy helpers are in common.cuh)
// TMA: the box at (c0, c1, c2) of a 3-D map to shared address dst,
// completing on bar
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// A wgmma shared-memory operand at shared address `at` in the 128-byte
// swizzled layout: rows of 128 bytes, 8-row atoms of 1024 bytes (1024-byte
// aligned) stacked along the operand's strided dimension; lbo: the bytes
// between its 64-element columns of atoms (an MN-major operand wider than 64,
// else unused).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t at, uint32_t lbo = 0) {
  return (uint64_t)((at >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across a
// wgmma issue or wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (+)= A @ B on one warpgroup, bf16 operands from shared memory (A K-major,
// B MN-major: the weights' row-major (K, N) as they are), fp32 D in the
// m64nNk16 fragment layout: d[i] is row 16 * warp + lane / 4 + 8 * (i / 2 % 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2. scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d));
}


constexpr int kSlabBytes = 32768;  // a weight slab
constexpr int kAtom = 1024;        // an 8-row swizzle atom of 128-byte rows

// A ring of kSlabs weight slabs of kBytes in shared memory, fed by the
// tensor memory accelerator and read by both warpgroups' wgmmas. Slab l of
// a walk (l = 0, 1, ... below `total`) lands in stage l % kSlabs and
// completes on that stage's full barrier; each warpgroup arrives on its
// empty barrier once its wgmmas reading the slab have retired, and thread 0
// then refills the stage with slab l + kSlabs, so warpgroup 0 waits on
// warpgroup 1's products there (the two share the SM's tensor cores, and a
// non-blocking refill measured slower). `issue(l, dst, bar)` starts slab l's
// copies into shared address dst, completing on bar; it runs on thread 0.
template <int kSlabs, int kBytes = kSlabBytes>
struct WeightRing {
  uint32_t full;      // full[s] at full + 8 s, empty[s] at full + 8 (kSlabs + s)
  uint32_t slabs;     // stage s at slabs + s * kBytes
  uint32_t total;     // slabs in the walk
  uint32_t released;  // slabs before this one are released by this thread

  __device__ __forceinline__ uint32_t slab(uint32_t l) const {
    return slabs + (l % kSlabs) * kBytes;
  }
  // Every thread of the block: barriers at bars (2 kSlabs x 8 bytes), the
  // stages at ring; thread 0 starts the first kSlabs slabs.
  template <typename Issue>
  __device__ __forceinline__ void start(unsigned char* bars, unsigned char* ring, uint32_t n,
                                        Issue&& issue) {
    full = smem_addr(bars);
    slabs = smem_addr(ring);
    total = n;
    released = 0;
    fence_proxy_async();  // earlier generic writes to this memory before the TMA's
    if (threadIdx.x == 0) {
      for (int s = 0; s < kSlabs; ++s) {
        mbar_init(full + 8 * s, 1);
        mbar_init(full + 8 * (kSlabs + s), 2);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x == 0)
      for (uint32_t l = 0; l < kSlabs && l < total; ++l) issue(l, slab(l), full + 8 * (l % kSlabs));
    __syncwarp();
  }
  // wait for slab l
  __device__ __forceinline__ void acquire(uint32_t l) const {
    mbar_wait(full + 8 * (l % kSlabs), (l / kSlabs) & 1);
    __syncwarp();  // the wgmma instructions that follow are warp-aligned
  }
  // Slabs before l have retired on this warpgroup: one arrival from each;
  // thread 0 then refills each freed stage with the slab kSlabs further on,
  // once both warpgroups have arrived.
  template <typename Issue>
  __device__ __forceinline__ void release_upto(uint32_t l, Issue&& issue) {
    for (; released < l; ++released) {
      const uint32_t e = full + 8 * (kSlabs + released % kSlabs);
      if (threadIdx.x % 128 == 0) mbar_arrive(e);
      if (threadIdx.x == 0 && released + kSlabs < total) {
        mbar_wait(e, (released / kSlabs) & 1);
        const uint32_t n = released + kSlabs;
        issue(n, slab(n), full + 8 * (n % kSlabs));
      }
    }
    __syncwarp();
  }
  // Every thread, once every wait on the ring is done: the barriers are
  // invalidated and the memory is free for the caller on return.
  __device__ __forceinline__ void stop() const {
    __syncthreads();
    if (threadIdx.x == 0)
      for (int s = 0; s < 2 * kSlabs; ++s) mbar_inval(full + 8 * s);
    __syncthreads();
  }
};

// A row's two partial sums x, y (rows r0 and r0 + 8 of a 64-row wgmma
// fragment, over this warpgroup's columns) summed over the quad, then over
// both warpgroups through st (2 x 64 floats): the full-row sums, on every
// thread. One block barrier.
__device__ __forceinline__ void wg_row_sums(float& x, float& y, float* st, int wg, int r0,
                                            int lane) {
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    x += __shfl_xor_sync(0xffffffffu, x, o);
    y += __shfl_xor_sync(0xffffffffu, y, o);
  }
  if (lane % 4 == 0) {
    st[wg * 64 + r0] = x;
    st[wg * 64 + r0 + 8] = y;
  }
  __syncthreads();
  x = st[r0] + st[64 + r0];
  y = st[r0 + 8] + st[64 + r0 + 8];
}

// ------------------------------------------------------- fp32: tf32x3
// Every fp32 walk (`mlp_walk_f32` below, `ln_qkv_walk_f32` and
// `proj_ln2_walk_f32` in stage.cuh) multiplies on wgmma in TF32, three
// passes into an fp32 accumulator (qkv, o @ Wp and fc2 a fresh one each
// 32-k stage, `tf32x3_stage<true>`): each operand v splits into hi =
// tf32(v) and lo = tf32(v - hi) (cvt.rna: to nearest, ties away from zero;
// v - hi is exact), and each k-step adds lo(A) hi(B), hi(A) lo(B), then
// hi(A) hi(B), the small terms first. The dropped lo(A) lo(B) is about
// 2^-22 of a product: the Hopper form of the TPU kernels' fp32 products at
// Precision.HIGHEST (a multi-pass product on the matrix unit).
//   * tf32 wgmma reads both operands K-major from shared memory, or A from
//     registers. The activations are row-major, K-major already; A goes as
//     the register operand, each thread splitting its fragment (rows r,
//     r + 8, columns t, t + 4 of each k-step of 8) from an fp32 tile of 64
//     rows in shared memory (`f32_at`: rows of K floats, 4-float groups
//     XOR-swizzled by the row, so that a warp's fragment reads and the
//     16-byte loads fall on distinct banks). The tile is the LayerNorm's,
//     the residual's or h's fp32 value, never a pre-split copy: its hi and
//     lo planes together would need 256 KB at C = 512.
//   * B (the weights) arrives as hi and lo planes made once per weight
//     version on the host (`ops.tf32.planes`), in nn.Linear's own (out, in)
//     layout, K-major: (Z, N, K) stacks, Z = 2 x depth (hi at 2d, lo at
//     2d + 1) or 2 x heads (the head-major qkv). A ring stage (32 KB) holds
//     one box a warpgroup of each plane: 64 weight rows (the warpgroup's 64
//     output columns) x 32 k, 128-byte rows in the 128-byte swizzle, as the
//     bf16 walks' slabs. A tile's stages run over k in steps of 32 and over
//     the warpgroups' 64-column blocks.
//   * One instruction form, m64n64k8 with A from registers
//     (`wgmma_tf32`); `tf32x3_stage` runs one stage's four k-steps on a
//     warpgroup and waits for them, so that the next stage's fragments may
//     take the registers. (Splitting each k-step's fragments under the
//     previous k-step's wgmmas measured no faster: PERF.md.)
// What bounds them: the three passes make the tensor-core bound 3 x FLOPs
// at 495 TFLOP/s. Short of it, each 64-row tile streams the weights' hi
// and lo planes (8 bytes a weight) from L2, and on the H100 how TMA fetches
// them sets the pace: 128-byte box rows beat 32- and 64-byte ones (the
// latter even at twice the ring's depth), and a 2-CTA cluster multicasting
// each stage to both SMs measured slower (PERF.md).
constexpr int kF32Tile = 64;         // token rows a tile: one wgmma M
constexpr int kF32Box = 8192;        // a plane box: 64 weight rows x 32 k
constexpr int kF32Plane = 2 * kF32Box;
constexpr int kF32Stage = 2 * kF32Plane;  // a ring stage: both warpgroups' boxes of both planes
constexpr int kF32K = 32;            // k columns a stage
constexpr int kF32Chunk = 128;       // output columns of a qkv or fc1 chunk: 64 a warpgroup

// element (r, k) of a 64-row fp32 tile of rows of K floats (K % 32 == 0)
__device__ __forceinline__ int f32_at(int r, int k, int K) { return r * K + (k ^ ((r & 7) << 2)); }

// Rows row0.. of src (M x K fp32) into the tile at xs with cp.async (one
// commit group); rows at or past M zero-filled.
__device__ __forceinline__ void f32_load_rows(float* xs, const float* src, int row0, int M,
                                              int K) {
  const int gpr = K / 4;  // 16-byte groups a row
  for (int v = threadIdx.x; v < kF32Tile * gpr; v += kThreads) {
    const int r = v / gpr, g = v % gpr;
    const bool ok = row0 + r < M;
    cp_async16_zfill(xs + f32_at(r, 4 * g, K), src + (size_t)(ok ? row0 + r : 0) * K + 4 * g, ok);
  }
  cp_async_commit();
}

// D += A @ B on one warpgroup, TF32: A (64 x 8) this thread's fragment in
// registers (a[0] row r col t, a[1] row r + 8 col t, a[2] row r col t + 4,
// a[3] row r + 8 col t + 4; r = 16 * warp + lane / 4, t = lane % 4), B (8 x
// 64) K-major in shared memory (`wgmma_desc`); D in the m64nNk16 fragment
// layout of wgmma_n64. scale_d == 0 overwrites D.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                           int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D += A[:, k0 : k0 + 32] @ B in tf32x3 on this warpgroup over one ring
// stage: A the 64-row fp32 tile at `as` (rows of K, `f32_at`), B this
// warpgroup's hi box at shared address `box` (its lo box kF32Plane on).
// Each k-step adds lo(A) hi(B), hi(A) lo(B), hi(A) hi(B). Every fragment
// is split before the first wgmma; on return the wgmmas are complete (the
// stage is read, the fragments' registers free).
// kPromote: the stage's twelve products go into a fresh accumulator, added
// to D with fp32 adds (round to nearest) once they are complete. The
// tensor cores add each product into their accumulator with truncation, so
// that over K the error grows with the number of adds into D, a bias where
// every add rounds toward zero; promoting a stage at a time cuts those adds
// twelvefold, for 32 more registers. The qkv walk takes it: its error
// passes through the softmax, which magnifies it by the logits' scale. So
// do the projection walk and fc2 (chip_smoke.py, phase fp32_truth, on an
// H100): with one accumulator, o @ Wp over K = 512 sat 9.4e-5 from float64
// at the card tests' inputs (7.0e-6 promoted), and without fc2's promotion
// fp32 `sample` missed its float64 truth by more than twice the plain fp32
// composition. fc1 keeps one (2.3e-5 there): with fc2 promoted `sample`
// meets that rule without it, and promoting fc1 too cost K9 13% (32 more
// registers live beside fc2's 128-register accumulator).
// tests/test_torch_tf32x3.py models the accumulation on the CPU.
template <bool kPromote = false>
__device__ __forceinline__ void tf32x3_stage(float (&d)[32], const float* as, int K, int k0,
                                             uint32_t box) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x % 128 / 32) + lane / 4, t = lane % 4;
  uint32_t hi[kF32K / 8][4], lo[kF32K / 8][4];
#pragma unroll
  for (int kk = 0; kk < kF32K / 8; ++kk) {
    const int k = k0 + 8 * kk + t;
    tf32_split(as[f32_at(r, k, K)], hi[kk][0], lo[kk][0]);
    tf32_split(as[f32_at(r + 8, k, K)], hi[kk][1], lo[kk][1]);
    tf32_split(as[f32_at(r, k + 4, K)], hi[kk][2], lo[kk][2]);
    tf32_split(as[f32_at(r + 8, k + 4, K)], hi[kk][3], lo[kk][3]);
  }
  // the first product overwrites a promoted stage's fresh accumulator
  auto products = [&](float(&acc)[32]) {
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kF32K / 8; ++kk) {
      const uint64_t bh = wgmma_desc(box + kk * 32), bl = wgmma_desc(box + kF32Plane + kk * 32);
      wgmma_tf32(acc, lo[kk], bh, !kPromote || kk > 0);
      wgmma_tf32(acc, hi[kk], bl);
      wgmma_tf32(acc, hi[kk], bh);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
  };
  if constexpr (kPromote) {
    float sum[32];
    products(sum);
#pragma unroll
    for (int i = 0; i < 32; ++i) d[i] += sum[i];
  } else {
    products(d);
  }
}

// The fp32 walks' partial epilogue: a warpgroup's raw accumulators (nq of
// its 64-column blocks of the C / 2 columns at wg * C / 2, the m64nNk16
// fragment layout; this thread's rows ta and ta + 8, column pair cq in
// each 8) stored to part (M, C), rows at or past M dropped.
__device__ __forceinline__ void f32_store_partial(float* part, const float (&acc)[128], int nq,
                                                  int wg, int C, int M, int ta, int cq) {
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (q < nq) {
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float* d = acc + 32 * q + 4 * jj;
        const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
        if (ta < M)
          *reinterpret_cast<float2*>(part + (size_t)ta * C + c) = make_float2(d[0], d[1]);
        if (ta + 8 < M)
          *reinterpret_cast<float2*>(part + (size_t)(ta + 8) * C + c) = make_float2(d[2], d[3]);
      }
    }
}

// Start one stage into shared address dst, completing on bar: k columns
// k0..k0 + 32 of both planes for each warpgroup w, the 64 weight rows
// rz[w].x.. of plane pair rz[w].y (map coordinates (k, row, z + plane)).
__device__ __forceinline__ void f32_issue_stage(uint32_t dst, const CUtensorMap* map,
                                                uint32_t bar, int k0, int2 rz0, int2 rz1) {
  mbar_expect_tx(bar, kF32Stage);
  for (int p = 0; p < 2; ++p) {
    tma_load_3d(dst + p * kF32Plane, map, bar, k0, rz0.x, rz0.y + p);
    tma_load_3d(dst + p * kF32Plane + kF32Box, map, bar, k0, rz1.x, rz1.y + p);
  }
}

// The fp32 walks' shared memory, byte offsets from the 1024-aligned base
// (`mlp_base`): the ring, the 64 x C fp32 A tile, h (the MLP's 64 x kHid
// chunk), the LayerNorm row sums ([pass][warpgroup][row]) and the ring's
// barriers.
struct F32Layout {
  size_t ring, a, h, stats, bars, total;
  F32Layout() = default;
  F32Layout(int stages, int C, int hid) {
    ring = 0;
    a = ring + (size_t)stages * kF32Stage;
    h = a + (size_t)kF32Tile * C * sizeof(float);
    stats = h + (size_t)kF32Tile * hid * sizeof(float);
    bars = stats + 2 * 2 * kF32Tile * sizeof(float);
    total = bars + 2 * (size_t)stages * sizeof(uint64_t) + 1024;  // + the base's alignment
  }
};

// ------------------------------------------------------------------ bf16
constexpr int kMlpRows = 64;    // token rows a tile: one wgmma M
constexpr int kHid = 128;       // hidden columns a chunk: 64 a warpgroup
constexpr int kW1Rows = 128;    // a W1 slab: 128 x 128 (two 64-column TMA boxes)
constexpr int kW2Rows = 32;     // a W2 slab: 32 x C (C / 64 TMA boxes)
constexpr int kRing = 4;        // slabs in the ring

template <>
struct MlpLayout<bf16> {
  static constexpr int kRows = kMlpRows;
  // byte offsets from the 1024-aligned base (`mlp_base`)
  size_t x, h, ring, stats, bars, total;
  MlpLayout() = default;
  MlpLayout(int C, int) {
    x = 0;                                            // 64 x C: C / 64 blocks of 8 KB
    h = x + (size_t)kMlpRows * C * sizeof(bf16);      // 2 x (64 x 128): two blocks each
    ring = h + 2 * kMlpRows * kHid * sizeof(bf16);
    stats = ring + (size_t)kRing * kSlabBytes;        // [pass][warpgroup][row] fp32
    bars = stats + 2 * 2 * kMlpRows * sizeof(float);  // kRing full, then kRing empty
    total = bars + 2 * kRing * sizeof(uint64_t) + kAtom;  // + the base's alignment
  }
};

// smem rounded up to a 1024-byte boundary, by pointer arithmetic so that
// the compiler keeps the shared address space (plain LDS/STS)
__device__ __forceinline__ unsigned char* mlp_base(unsigned char* smem) {
  return smem + ((kAtom - (smem_addr(smem) & (kAtom - 1))) & (kAtom - 1));
}

// Rows of tile `tile` of src (M x C) into the swizzled 64 x C buffer at dst
// with cp.async (one commit group); rows at or past M zero-filled.
__device__ __forceinline__ void mlp_load_rows(unsigned char* xs, const bf16* x, int tile, int M,
                                              int C) {
  const int gpr = C / 8, row0 = tile * kMlpRows;  // 16-byte groups a row
  for (int v = threadIdx.x; v < kMlpRows * gpr; v += kThreads) {
    const int r = v / gpr, g = v % gpr;
    const bool ok = row0 + r < M;
    cp_async16_zfill(xs + (g >> 3) * (kMlpRows * 128) + r * 128 + (((g & 7) ^ (r & 7)) << 4),
                     x + (size_t)(ok ? row0 + r : 0) * C + 8 * g, ok);
  }
  cp_async_commit();
}

// h = act(acc1 + b1) in bf16 into the swizzled 64-column block hb, from the
// m64n64 fragments of acc1 (rows r0, r0 + 8; columns 8 jj + cq, + 1). The
// activation is a template argument: a select per element would evaluate
// every mode's arithmetic.
template <int kMode>
__device__ __forceinline__ void mlp_store_h(const float (&acc1)[32], const float* b1,
                                            unsigned char* hb, int r0, int cq) {
#pragma unroll
  for (int jj = 0; jj < 8; ++jj) {
    const float2 bb = *reinterpret_cast<const float2*>(b1 + 8 * jj + cq);
    const int sw = ((jj ^ (r0 & 7)) << 4) + 2 * cq;
    *reinterpret_cast<__nv_bfloat162*>(hb + r0 * 128 + sw) =
        __floats2bfloat162_rn(activation_bf16<kMode>(acc1[4 * jj] + bb.x),
                              activation_bf16<kMode>(acc1[4 * jj + 1] + bb.y));
    *reinterpret_cast<__nv_bfloat162*>(hb + (r0 + 8) * 128 + sw) =
        __floats2bfloat162_rn(activation_bf16<kMode>(acc1[4 * jj + 2] + bb.x),
                              activation_bf16<kMode>(acc1[4 * jj + 3] + bb.y));
  }
}

// Walk the tiles blockIdx.x, blockIdx.x + gridDim.x, ... below n_tiles.
// Every thread of the block calls it; smem is the dynamic shared memory,
// MlpLayout<bf16>(C, H).total bytes, free on entry and on return.
// Needs C % 128 == 0, C <= 512, H % 128 == 0.
// tw1, tw2: TMA maps over the depth-stacked (D, C, H) W1 and (D, H, C) W2
// in kernel parameter space (`encode_mlp_maps`). kWide (C == 512): fc2 as
// one m64n256k16 a step over the warpgroup's 256 columns, reading h once;
// else C / 128 m64n64k16 (one instruction form a kernel: ptxas serializes
// the wgmma pipeline when one accumulator meets two). The output rows are
// staged in shared memory and written by bulk copies that complete under the
// next tile's products; on return they are complete and ordered before the
// caller's later accesses (the depth-resident kernel's next phase reads them
// from other blocks after a grid barrier). kPartial (a tensor-parallel rank's
// share: W1's H / tp columns and W2's H / tp rows in a.H): the fp32 fc2
// product goes raw to a.part (M, C) in rows from the fragments, with no b2,
// residual or LayerNorm (those follow the all-reduce over the ranks, with
// the transposed write); the next tile's x loads under the last chunk's fc2.
template <bool kTranspose, bool kWide, bool kPartial = false>
__device__ __forceinline__ void mlp_walk_bf16(const MlpArgs<bf16>& a, const CUtensorMap* tw1,
                                              const CUtensorMap* tw2, const MlpLayout<bf16>& L,
                                              unsigned char* smem_raw, int n_tiles) {
  const int first = blockIdx.x;
  if (first >= n_tiles) return;
  const int C = a.C, M = a.M;
  const int mine = (n_tiles - 1 - first) / gridDim.x + 1;
  const int nq = C / 128;             // 64-column output blocks a warpgroup
  const int nw1 = C / kW1Rows;        // W1 slabs a chunk
  const int per_chunk = nw1 + kHid / kW2Rows;
  const int per_tile = (a.H / kHid) * per_chunk;
  const uint32_t total = (uint32_t)mine * per_tile;

  unsigned char* base = mlp_base(smem_raw);
  unsigned char* xs = base + L.x;
  unsigned char* hs = base + L.h;
  float* stats = reinterpret_cast<float*>(base + L.stats);
  // shared-space addresses of the wgmma operands
  const uint32_t xs_at = smem_addr(xs), hs_at = smem_addr(hs);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int r0 = 16 * (tid % 128 / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                    // and column pair in each 8

  // slab l of the walk: chunk j = l % per_tile / per_chunk; the first nw1 of
  // a chunk are W1's rows 128 s.., columns 128 j..; the rest W2's rows
  // 128 j + 32 s.., all columns
  auto issue = [&](uint32_t l, uint32_t dst, uint32_t bar) {
    const int q = (int)(l % per_tile), j = q / per_chunk, s = q % per_chunk;
    if (s < nw1) {
      mbar_expect_tx(bar, kW1Rows * kHid * sizeof(bf16));
      tma_load_3d(dst, tw1, bar, kHid * j, kW1Rows * s, a.depth);
      tma_load_3d(dst + kW1Rows * 128, tw1, bar, kHid * j + 64, kW1Rows * s, a.depth);
    } else {
      mbar_expect_tx(bar, kW2Rows * C * sizeof(bf16));
      for (int b = 0; b < C / 64; ++b)
        tma_load_3d(dst + b * (kW2Rows * 128), tw2, bar, 64 * b,
                    kHid * j + kW2Rows * (s - nw1), a.depth);
    }
  };
  WeightRing<kRing> ring;
  ring.start(base + L.bars, base + L.ring, total, issue);
  mlp_load_rows(xs, a.x, first, M, C);

  uint32_t next = 0;  // the next slab to consume
  float acc2[128];
#pragma unroll
  for (int q = 0; q < 128; ++q) acc2[q] = 0.f;  // no value live into the walk
  for (int i = 0; i < mine; ++i) {
    const int tile = first + i * gridDim.x;
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();  // x landed for every thread

    for (int j = 0; j < a.H / kHid; ++j) {
      // fc1: this warpgroup's 64 hidden columns of the chunk
      float acc1[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) acc1[q] = 0.f;
      for (int s = 0; s < nw1; ++s, ++next) {
        ring.acquire(next);
        const uint32_t w = ring.slab(next) + wg * (kW1Rows * 128);
        fence_acc(acc1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kW1Rows / 16; ++kk) {
          const int k = kW1Rows * s + 16 * kk;
          wgmma_n64(acc1, wgmma_desc(xs_at + (k >> 6) * (kMlpRows * 128) + (k & 63) * 2),
                    wgmma_desc(w + kk * 16 * 128), s > 0 || kk > 0);
        }
        wgmma_commit();
        fence_acc(acc1);
        wgmma_wait<1>();
        ring.release_upto(next, issue);
      }
      wgmma_wait<0>();
      fence_acc(acc1);
      ring.release_upto(next, issue);
      // + b1, the activation, bf16, into this warpgroup's 64 columns of h
      unsigned char* hb = hs + (j & 1) * (kMlpRows * kHid * 2) + wg * (kMlpRows * 128);
      const float* b1 = a.b1 + kHid * j + 64 * wg;
      if (a.gelu == kGeluErf)
        mlp_store_h<kGeluErf>(acc1, b1, hb, r0, cq);
      else if (a.gelu == kGeluBf16)
        mlp_store_h<kGeluBf16>(acc1, b1, hb, r0, cq);
      else
        mlp_store_h<kGeluNone>(acc1, b1, hb, r0, cq);
      fence_proxy_async();
      __syncthreads();  // both halves of the chunk written; the last chunk: x is free
      if (j == a.H / kHid - 1) {
        if constexpr (kPartial) {
          if (i + 1 < mine) mlp_load_rows(xs, a.x, tile + gridDim.x, M, C);
        } else {
          mlp_load_rows(xs, a.res, tile, M, C);  // for the epilogue
        }
      }

      // fc2: this warpgroup's columns of out += h_chunk @ W2[chunk, :]
      const uint32_t hc = hs_at + (j & 1) * (kMlpRows * kHid * 2);
      for (int s = 0; s < kHid / kW2Rows; ++s, ++next) {
        ring.acquire(next);
        const uint32_t w = ring.slab(next) + wg * nq * (kW2Rows * 128);
        fence_acc(acc2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kW2Rows / 16; ++kk) {
          const int k = kW2Rows * s + 16 * kk;
          const uint64_t da = wgmma_desc(hc + (k >> 6) * (kMlpRows * 128) + (k & 63) * 2);
          const int first_k = j == 0 && s == 0 && kk == 0;
          if constexpr (kWide) {
            wgmma_n256(acc2, da, wgmma_desc(w + kk * 16 * 128, kW2Rows * 128), !first_k);
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              if (q < nq)
                wgmma_n64(*reinterpret_cast<float(*)[32]>(acc2 + 32 * q), da,
                          wgmma_desc(w + q * (kW2Rows * 128) + kk * 16 * 128), !first_k);
          }
        }
        wgmma_commit();
        fence_acc(acc2);
        wgmma_wait<1>();
        ring.release_upto(next, issue);
      }
    }
    wgmma_wait<0>();
    fence_acc(acc2);
    ring.release_upto(next, issue);

    if constexpr (kPartial) {
      const int ta = tile * kMlpRows + r0, tb = ta + 8;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (q < nq) {
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float* d = acc2 + 32 * q + 4 * jj;
            const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
            if (ta < M)
              *reinterpret_cast<float2*>(a.part + (size_t)ta * C + c) = make_float2(d[0], d[1]);
            if (tb < M)
              *reinterpret_cast<float2*>(a.part + (size_t)tb * C + c) = make_float2(d[2], d[3]);
          }
        }
      continue;
    }

    // epilogue: + b2, DropPath, + res; LayerNorm over the C columns of a row
    // (this warpgroup holds C / 2 of them); the store
    const int ta = tile * kMlpRows + r0, tb = ta + 8;
    const bool va = ta < M, vb = tb < M;
    const float ka = a.dp && va ? a.dp[ta / a.D2] : 1.f;
    const float kb = a.dp && vb ? a.dp[tb / a.D2] : 1.f;
    cp_async_wait<0>();
    __syncthreads();  // the tile's res rows landed in the x buffer (zeros past M)
    const unsigned char* resa = xs + r0 * 128 + 2 * cq;
    const unsigned char* resb = resa + 8 * 128;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float* d = acc2 + 32 * q + 4 * jj;
          const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
          const float2 bb = *reinterpret_cast<const float2*>(a.b2 + c);
          const int at = (wg * nq + q) * (kMlpRows * 128) + ((jj ^ (r0 & 7)) << 4);
          const float2 ra = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resa + at));
          const float2 rb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(resb + at));
          // res + (out + b2), or res + dp * (out + b2) rounded apart (no FMA)
          if (a.dp) {
            d[0] = ra.x + __fmul_rn(d[0] + bb.x, ka);
            d[1] = ra.y + __fmul_rn(d[1] + bb.y, ka);
            d[2] = rb.x + __fmul_rn(d[2] + bb.x, kb);
            d[3] = rb.y + __fmul_rn(d[3] + bb.y, kb);
          } else {
            d[0] = ra.x + (d[0] + bb.x);
            d[1] = ra.y + (d[1] + bb.y);
            d[2] = rb.x + (d[2] + bb.x);
            d[3] = rb.y + (d[3] + bb.y);
          }
          sa += d[0] + d[1];
          sb += d[2] + d[3];
        }
      }
    wg_row_sums(sa, sb, stats, wg, r0, lane);
    const float mua = sa / C, mub = sb / C;
    sa = sb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* d = acc2 + 32 * q + 4 * jj;
          sa += (d[0] - mua) * (d[0] - mua) + (d[1] - mua) * (d[1] - mua);
          sb += (d[2] - mub) * (d[2] - mub) + (d[3] - mub) * (d[3] - mub);
        }
      }
    wg_row_sums(sa, sb, stats + 2 * kMlpRows, wg, r0, lane);
    const float rsa = rsqrtf(sa / C + a.eps), rsb = rsqrtf(sb / C + a.eps);
    // the staged rows: pitch 2C + 16 bytes spreads a warp's 8 rows over the
    // banks; the last rows reach into h's first buffer, free here
    const int pitch = 2 * C + 16;
    bf16* outa = reinterpret_cast<bf16*>(xs + r0 * pitch);
    bf16* outb = reinterpret_cast<bf16*>(xs + (r0 + 8) * pitch);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* d = acc2 + 32 * q + 4 * jj;
          const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
          const float2 s = *reinterpret_cast<const float2*>(a.lns + c);
          const float2 b = *reinterpret_cast<const float2*>(a.lnb + c);
          *reinterpret_cast<__nv_bfloat162*>(outa + c) =
              __floats2bfloat162_rn((d[0] - mua) * rsa * s.x + b.x, (d[1] - mua) * rsa * s.y + b.y);
          *reinterpret_cast<__nv_bfloat162*>(outb + c) =
                __floats2bfloat162_rn((d[2] - mub) * rsb * s.x + b.x, (d[3] - mub) * rsb * s.y + b.y);
        }
      }
    fence_proxy_async();
    __syncthreads();  // the tile's rows are staged
    const int t = tile * kMlpRows + tid;
    if (tid < kMlpRows && t < M)
      bulk_store(a.out + mlp_out_row(t, a.D1, a.D2, kTranspose) * C, xs_at + tid * pitch, 2 * C);
    if (i + 1 < mine) {
      if (tid < kMlpRows) bulk_wait_read();
      __syncthreads();  // every read of res and of the staged rows is done
      mlp_load_rows(xs, a.x, tile + gridDim.x, M, C);
    }
  }
  if (tid < kMlpRows) {
    bulk_wait();
    fence_proxy_async_global();
  }
  ring.stop();  // the caller may reuse the memory
}

// ------------------------------------------------------------------ fp32
// `mlp_walk_f32`: the bf16 walk's skeleton in tf32x3 (see "fp32: tf32x3"
// above). A tile is 64 token rows; x (64 x C fp32, the fc1 operand) stays in
// shared memory for the tile. The hidden dimension goes in chunks of kHid:
// fc1, warpgroup w computes h's columns 64w.. of the chunk, + b1, the
// activation, into the fp32 h buffer; fc2, both warpgroups add h_chunk @
// W2[chunk, :] into their C / 2 output columns (C / 128 blocks of 64, 128
// registers a thread at C = 512), kept across all chunks, each 32-k stage
// promoted (fc1's 32-k stages go into one accumulator). The ring carries
// W1 stages (the chunk's 128 rows x 32 k) and W2 stages (the warpgroups'
// 64-column blocks x 32 k of the chunk). The next tile's x loads
// under the last chunk's fc2; the epilogue (+ b2, DropPath, + res read from
// device memory, the LayerNorm's two passes across both warpgroups) writes
// each row's C outputs from the fragments.
// Shared memory at C = 512: ring 2 x 32 KB, x 128 KB, h 32 KB.
template <>
struct MlpLayout<float> : F32Layout {
  static constexpr int kRows = kF32Tile;
  static constexpr int kStages = 2;
  MlpLayout() = default;
  MlpLayout(int C, int) : F32Layout(kStages, C, kHid) {}
};

// Walk the tiles blockIdx.x, + gridDim.x, ... below n_tiles, as
// mlp_walk_bf16 (its contract: every thread calls it, the memory free on
// entry and return, C % 128 == 0, C <= 512, H % 128 == 0; on return the
// output rows are written). tw1, tw2: TMA maps over the planes of the
// depth-stacked W1 (2D, H, C) and W2 (2D, C, H), read at depth a.depth.
// kPartial: mlp_walk_bf16's (a tensor-parallel rank's H / tp hidden units
// in a.H; the raw fc2 product to a.part from the fragments).
template <bool kTranspose, bool kPartial = false>
__device__ __forceinline__ void mlp_walk_f32(const MlpArgs<float>& a, const CUtensorMap* tw1,
                                             const CUtensorMap* tw2, const MlpLayout<float>& L,
                                             unsigned char* smem_raw, int n_tiles) {
  const int first = blockIdx.x;
  if (first >= n_tiles) return;
  const int C = a.C, M = a.M;
  const int mine = (n_tiles - 1 - first) / gridDim.x + 1;
  const int nq = C / 128;  // 64-column output blocks a warpgroup
  const int n1 = C / kF32K, per_chunk = n1 + (kHid / kF32K) * nq;
  const int per_tile = (a.H / kHid) * per_chunk;

  unsigned char* base = mlp_base(smem_raw);
  float* xs = reinterpret_cast<float*>(base + L.a);
  float* hs = reinterpret_cast<float*>(base + L.h);
  float* stats = reinterpret_cast<float*>(base + L.stats);
  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int r0 = 16 * (tid % 128 / 32) + lane / 4;  // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);                    // and column pair in each 8

  // stage l: chunk j = l % per_tile / per_chunk; the first n1 W1's rows
  // kHid j.. (warpgroup w: + 64 w), k 32 s..; then, for each 32 k of the
  // chunk and each block q, W2's rows 64 q.. (warpgroup w: + C / 2 w)
  auto issue = [&](uint32_t l, uint32_t dst, uint32_t bar) {
    const int q = (int)(l % per_tile), j = q / per_chunk, s = q % per_chunk;
    const int z = 2 * a.depth;
    if (s < n1) {
      f32_issue_stage(dst, tw1, bar, kF32K * s, make_int2(kHid * j, z),
                      make_int2(kHid * j + 64, z));
    } else {
      const int kb = (s - n1) / nq, qb = (s - n1) % nq;
      f32_issue_stage(dst, tw2, bar, kHid * j + kF32K * kb, make_int2(64 * qb, z),
                      make_int2(C / 2 + 64 * qb, z));
    }
  };
  WeightRing<MlpLayout<float>::kStages, kF32Stage> ring;
  ring.start(base + L.bars, base + L.ring, (uint32_t)mine * per_tile, issue);
  f32_load_rows(xs, a.x, first * kF32Tile, M, C);

  uint32_t next = 0;  // the next slab to consume
  for (int i = 0; i < mine; ++i) {
    const int tile = first + i * gridDim.x;
    float acc2[128];
#pragma unroll
    for (int q = 0; q < 128; ++q) acc2[q] = 0.f;
    cp_async_wait<0>();
    __syncthreads();  // x landed for every thread

    for (int j = 0; j < a.H / kHid; ++j) {
      float acc1[32];
#pragma unroll
      for (int q = 0; q < 32; ++q) acc1[q] = 0.f;
      for (int s = 0; s < n1; ++s, ++next) {
        ring.acquire(next);
        tf32x3_stage(acc1, xs, C, kF32K * s, ring.slab(next) + wg * kF32Box);
        ring.release_upto(next + 1, issue);
      }
      __syncthreads();  // every fragment of the previous chunk's h is read
      // + b1, the activation, into this warpgroup's 64 columns of h
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int c = 64 * wg + 8 * jj + cq;
        const float2 bb = *reinterpret_cast<const float2*>(a.b1 + kHid * j + c);
        *reinterpret_cast<float2*>(hs + f32_at(r0, c, kHid)) =
            make_float2(activation(acc1[4 * jj] + bb.x, a.gelu),
                        activation(acc1[4 * jj + 1] + bb.y, a.gelu));
        *reinterpret_cast<float2*>(hs + f32_at(r0 + 8, c, kHid)) =
            make_float2(activation(acc1[4 * jj + 2] + bb.x, a.gelu),
                        activation(acc1[4 * jj + 3] + bb.y, a.gelu));
      }
      __syncthreads();  // the chunk's h is written; the last chunk: x is free
      if (j == a.H / kHid - 1 && i + 1 < mine)
        f32_load_rows(xs, a.x, (tile + gridDim.x) * kF32Tile, M, C);

      for (int kb = 0; kb < kHid / kF32K; ++kb)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (q < nq) {
            ring.acquire(next);
            tf32x3_stage<true>(*reinterpret_cast<float(*)[32]>(acc2 + 32 * q), hs, kHid,
                               kF32K * kb, ring.slab(next) + wg * kF32Box);
            ring.release_upto(++next, issue);
          }
    }

    const int ta = tile * kF32Tile + r0, tb = ta + 8;
    if constexpr (kPartial) {
      f32_store_partial(a.part, acc2, nq, wg, C, M, ta, cq);
      continue;
    }

    // epilogue: + b2, DropPath, + res; LayerNorm over the C columns of a row
    // (this warpgroup holds C / 2 of them); the rows out
    const bool va = ta < M, vb = tb < M;
    const float ka = a.dp && va ? a.dp[ta / a.D2] : 1.f;
    const float kb = a.dp && vb ? a.dp[tb / a.D2] : 1.f;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          float* d = acc2 + 32 * q + 4 * jj;
          const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
          const float2 bb = *reinterpret_cast<const float2*>(a.b2 + c);
          const float2 ra = va ? *reinterpret_cast<const float2*>(a.res + (size_t)ta * C + c)
                               : make_float2(0.f, 0.f);
          const float2 rb = vb ? *reinterpret_cast<const float2*>(a.res + (size_t)tb * C + c)
                               : make_float2(0.f, 0.f);
          // res + (out + b2), or res + dp * (out + b2) rounded apart (no FMA)
          if (a.dp) {
            d[0] = ra.x + __fmul_rn(d[0] + bb.x, ka);
            d[1] = ra.y + __fmul_rn(d[1] + bb.y, ka);
            d[2] = rb.x + __fmul_rn(d[2] + bb.x, kb);
            d[3] = rb.y + __fmul_rn(d[3] + bb.y, kb);
          } else {
            d[0] = ra.x + (d[0] + bb.x);
            d[1] = ra.y + (d[1] + bb.y);
            d[2] = rb.x + (d[2] + bb.x);
            d[3] = rb.y + (d[3] + bb.y);
          }
          sa += d[0] + d[1];
          sb += d[2] + d[3];
        }
      }
    wg_row_sums(sa, sb, stats, wg, r0, lane);
    const float mua = sa / C, mub = sb / C;
    sa = sb = 0.f;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* d = acc2 + 32 * q + 4 * jj;
          sa += (d[0] - mua) * (d[0] - mua) + (d[1] - mua) * (d[1] - mua);
          sb += (d[2] - mub) * (d[2] - mub) + (d[3] - mub) * (d[3] - mub);
        }
      }
    wg_row_sums(sa, sb, stats + 2 * kF32Tile, wg, r0, lane);
    const float rsa = rsqrtf(sa / C + a.eps), rsb = rsqrtf(sb / C + a.eps);
    float* outa = a.out + (va ? mlp_out_row(ta, a.D1, a.D2, kTranspose) * C : 0);
    float* outb = a.out + (vb ? mlp_out_row(tb, a.D1, a.D2, kTranspose) * C : 0);
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < nq) {
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const float* d = acc2 + 32 * q + 4 * jj;
          const int c = wg * (C / 2) + 64 * q + 8 * jj + cq;
          const float2 s = *reinterpret_cast<const float2*>(a.lns + c);
          const float2 b = *reinterpret_cast<const float2*>(a.lnb + c);
          if (va)
            *reinterpret_cast<float2*>(outa + c) =
                make_float2((d[0] - mua) * rsa * s.x + b.x, (d[1] - mua) * rsa * s.y + b.y);
          if (vb)
            *reinterpret_cast<float2*>(outb + c) =
                make_float2((d[2] - mub) * rsb * s.x + b.x, (d[3] - mub) * rsb * s.y + b.y);
        }
      }
  }
  ring.stop();  // the caller may reuse the memory
}

// Whether the bf16 walk takes its kWide form at C channels.
__host__ __device__ constexpr bool mlp_wide(int C) { return C == 512; }

// The walk of either type: bf16 as above (kWide as given, which the caller
// matches to mlp_wide(C)), fp32 `mlp_walk_f32` (kWide unused).
template <typename T, bool kTranspose, bool kWide = false, bool kPartial = false>
__device__ __forceinline__ void mlp_walk(const MlpArgs<T>& a, const CUtensorMap* tw1,
                                         const CUtensorMap* tw2, const MlpLayout<T>& L,
                                         unsigned char* smem, int n_tiles) {
  if constexpr (std::is_same<T, bf16>::value) {
    mlp_walk_bf16<kTranspose, kWide, kPartial>(a, tw1, tw2, L, smem, n_tiles);
  } else {
    mlp_walk_f32<kTranspose, kPartial>(a, tw1, tw2, L, smem, n_tiles);
  }
}

// ------------------------------------------------------------------ host
// A TMA map over D stacked row-major (rows, cols) bf16 matrices at base:
// boxes of 64 columns (128 bytes, 128-byte swizzle) x box_rows rows of one
// matrix. cuTensorMapEncodeTiled comes from the driver through the runtime
// (cudaGetDriverEntryPoint), so the libraries need no -lcuda. Returns 0 or
// kNoTensorMap.
inline int encode_map(CUtensorMap* map, CUtensorMapDataType type, size_t elem, const void* base,
                      int D, int rows, int cols, int box_cols, int box_rows,
                      CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return kNoTensorMap;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) !=
            cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return kNoTensorMap;
#endif
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows, (cuuint64_t)D};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * elem, (cuuint64_t)rows * cols * elem};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t step[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? 0
             : kNoTensorMap;
}

inline int encode_weight_map(CUtensorMap* map, const void* base, int D, int rows, int cols,
                             int box_rows) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, sizeof(bf16), base, D, rows, cols, 64,
                    box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// A TMA map over Z stacked row-major (rows, cols) fp32 planes (the fp32
// walks' K-major weight planes: rows the output columns, cols the k; Z = 2 x
// depth or 2 x heads, hi then lo): boxes of 32 columns (128 bytes, 128-byte
// swizzle) x 64 rows of one plane. Returns 0 or kNoTensorMap.
inline int encode_plane_map(CUtensorMap* map, const void* base, int Z, int rows, int cols) {
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), base, Z, rows, cols,
                    kF32K, 64, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The maps of D stacked (C, H) W1 and (H, C) W2 the bf16 walk reads.
inline int encode_mlp_maps(CUtensorMap* tw1, CUtensorMap* tw2, const void* w1, const void* w2,
                           int D, int C, int H) {
  const int e = encode_weight_map(tw1, w1, D, C, H, kW1Rows);
  return e ? e : encode_weight_map(tw2, w2, D, H, C, kW2Rows);
}

// The maps of D stacked W1 and W2 planes (2D, H, C) and (2D, C, H) the fp32
// walk reads.
inline int encode_mlp_plane_maps(CUtensorMap* tw1, CUtensorMap* tw2, const void* w1,
                                 const void* w2, int D, int C, int H) {
  const int e = encode_plane_map(tw1, w1, 2 * D, H, C);
  return e ? e : encode_plane_map(tw2, w2, 2 * D, C, H);
}

// The shapes the walk of T takes, the same in both types: C / 2 output
// columns a warpgroup in 64-column blocks, 128-column hidden chunks.
template <typename T>
inline bool mlp_shape_ok(int C, int H) {
  return C % 128 == 0 && C <= 512 && H % kHid == 0 && H > 0;
}

}  // namespace d3dp
