// fp32 linear layers on the tensor cores, for Hopper (sm_90a):
//   Y[M, N] = A[M, K] @ B[N, K]^T (+ bias)
// in three TF32 passes (tf32x3, mlp.cuh "fp32: tf32x3"), with the TF32 hi
// and lo planes of B made by a split kernel of its own.
//
// Replaces no TPU kernel. The JAX package leaves its composed blocks'
// Dense layers to XLA at Precision.HIGHEST (d3dp_tpu/models/mixste.py
// `Attention`, `Mlp`: a multi-pass product on the matrix unit); the port's
// composed training path (`models/mixste.py` `Attention`, `Mlp`) ran them
// through `F.linear`, which in fp32 with TF32 off goes to cuBLAS's fp32
// kernels on the CUDA cores (FFMA, 67 TFLOP/s). `ops.linear` sends the
// block's four linears here in fp32 (qkv, proj, fc1, fc2: the forward
// on B = W, the input gradient dY @ W on B = W^T), so that they run on the
// tensor cores at fp32 accuracy.
//
// What bounds it on the H100: operations. Three TF32 passes make the bound
// 3 x 2MNK FLOPs at 495 TFLOP/s; the token rows are many (16,524 a train
// step) and K and N a few hundred, so the bytes (A once, Y once, B's planes
// from L2 per tile) are far below the operations' time at the card's 3.35
// TB/s. Short of the bound: the L2 stream of B's planes (8 bytes a
// weight, which set the pace of the eval walks' 64-row tiles), the split of
// A into hi and lo in registers, and the fp32 adds that promote each 32-k
// stage.
//
// Design.
//   * A tile is 128 token rows x 128 output columns: two consumer
//     warpgroups of 64 rows share every B stage, so each stage fetched from
//     L2 serves 128 rows, twice the eval walks' 64; a warpgroup's 64 x 128
//     fp32 output (64 registers a thread) is one m64n128k8 wgmma's.
//   * One producer thread keeps a ring of kLinStages stages in flight: a
//     stage is k columns 32s..32s + 31 of A's 128 rows (16 KB) and of B's hi
//     and lo planes' 128 rows (16 KB each), each a TMA box of 128-byte rows
//     in the 128-byte swizzle; rows of A past M arrive zero-filled. Its
//     warpgroup keeps 40 registers a thread and gives the rest to the two
//     consumer warpgroups (setmaxnreg: 232 each), which hold a tile's sum,
//     a stage's fresh accumulator and two stages' split fragments: at the
//     launch's 168 they spilled and ran 1.3x slower than without the
//     promotion's accumulator (PERF.md).
//   * A's box is, element for element, the `f32_at` layout of a 32-column
//     fp32 tile, so each consumer thread reads its fragment from it and
//     splits it into hi and lo in registers (cvt.rna), as `tf32x3_stage`
//     does; B's boxes are the K-major operands of the wgmma descriptors.
//   * Each 32-k stage's twelve products (lo(A) hi(B), hi(A) lo(B), hi(A)
//     hi(B) at each k-step of 8, nothing dropped beyond lo(A) lo(B)) go
//     into a fresh accumulator, added to the tile's sum in fp32 once they
//     are complete (`tf32x3_stage<true>`'s promotion): one truncating
//     accumulator over K >= 512 leaves 1e-4-level errors (PERF.md). While
//     a stage's products run, the warpgroup splits the next stage's
//     fragments; it releases the stage to the producer once its wgmmas are
//     done. The two warpgroups share the SM's tensor cores, so one's adds
//     run under the other's products.
//   * Persistent blocks, one an SM, walk the tiles blockIdx.x, + gridDim.x,
//     ..., the column tiles of a row block next to each other (A's rows from
//     device memory once, then from L2). The epilogue (+ bias, rows past M
//     dropped) stores from the accumulator fragments while the producer
//     already fills the ring with the next tile's stages.
// Shared memory: the ring, 4 x 48 KB.
//
// The split (`tf32_planes_kernel`): the hi and lo planes of W (N, K), and in
// the same launch, where asked, those of W^T (K, N), through a 32 x 32 tile
// in shared memory so that both writes are coalesced: one launch a weight a
// step. Bytes bound it: 4 read and 8 or 16 written a weight.
#include "mlp.cuh"

namespace d3dp {

constexpr int kLinRows = 128;                  // token rows a tile: two warpgroups of 64
constexpr int kLinCols = 128;                  // output columns a tile
constexpr int kLinK = 32;                      // k a stage: one 128-byte row of fp32
constexpr int kLinStages = 4;                  // stages in the ring
constexpr int kLinA = kLinRows * kLinK * 4;    // A's box, 16 KB
constexpr int kLinB = kLinCols * kLinK * 4;    // a plane's box, 16 KB
constexpr int kLinStage = kLinA + 2 * kLinB;   // 48 KB
constexpr int kLinConsumerWarps = 8;
constexpr int kLinThreads = 32 * kLinConsumerWarps + 128;  // + the producer warpgroup
// registers a thread: 168 at launch (384 threads); the producer's warpgroup
// gives all but 40 to the two consumer warpgroups (setmaxnreg)
constexpr int kLinProducerRegs = 40, kLinConsumerRegs = 232;
constexpr size_t kLinSmem = (size_t)kLinStages * kLinStage + 2 * kLinStages * 8 + 1024;

// D (+)= A @ B on one warpgroup, TF32, N = 128: A (64 x 8) this thread's
// fragment in registers (as `wgmma_tf32`), B (8 x 128) K-major in shared
// memory; D in the m64nNk16 fragment layout of wgmma_n128. scale_d == 0
// overwrites D.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// This thread's A fragments of one stage, split: the warpgroup's 64 rows
// at `as` (rows of 32 floats, `f32_at`), for each k-step of 8 rows r, r +
// 8 and columns t, t + 4 (as `wgmma_tf32` takes them), hi = tf32(v) and lo
// = tf32(v - hi).
__device__ __forceinline__ void linear_split(uint32_t (&hi)[kLinK / 8][4],
                                             uint32_t (&lo)[kLinK / 8][4], const float* as) {
  const int lane = threadIdx.x % 32;
  const int r = 16 * (threadIdx.x % 128 / 32) + lane / 4, t = lane % 4;
#pragma unroll
  for (int kk = 0; kk < kLinK / 8; ++kk) {
    const int k = 8 * kk + t;
    tf32_split(as[f32_at(r, k, kLinK)], hi[kk][0], lo[kk][0]);
    tf32_split(as[f32_at(r + 8, k, kLinK)], hi[kk][1], lo[kk][1]);
    tf32_split(as[f32_at(r, k + 4, kLinK)], hi[kk][2], lo[kk][2]);
    tf32_split(as[f32_at(r + 8, k + 4, kLinK)], hi[kk][3], lo[kk][3]);
  }
}

// Start one stage's twelve products on this warpgroup into the fresh
// accumulator sum (the first overwrites it): at each k-step of 8, lo(A)
// hi(B), hi(A) lo(B), hi(A) hi(B), B's hi box at shared address bh (its lo
// box kLinB on), 128 rows of 32 k. Committed, not waited for.
__device__ __forceinline__ void linear_products(float (&sum)[64],
                                                const uint32_t (&hi)[kLinK / 8][4],
                                                const uint32_t (&lo)[kLinK / 8][4], uint32_t bh) {
  fence_acc(sum);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kLinK / 8; ++kk) {
    const uint64_t dh = wgmma_desc(bh + kk * 32), dl = wgmma_desc(bh + kLinB + kk * 32);
    wgmma_tf32_n128(sum, lo[kk], dh, kk > 0);
    wgmma_tf32_n128(sum, hi[kk], dl, 1);
    wgmma_tf32_n128(sum, hi[kk], dh, 1);
  }
  wgmma_commit();
}

// keep the fragments' registers live up to here: the wgmmas read them
// asynchronously, until their wait
__device__ __forceinline__ void keep_frag(uint32_t (&f)[kLinK / 8][4]) {
#pragma unroll
  for (int i = 0; i < kLinK / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(f[i][j])::"memory");
}

struct LinearParams {
  CUtensorMap ta;     // A (M, K) fp32: boxes of 32 k x 128 rows
  CUtensorMap tb;     // B's planes (2, N, K) fp32, hi then lo: boxes of 32 k x 128 rows
  const float* bias;  // (N,) or nullptr
  float* y;           // (M, N)
  int M, N, K, col_tiles, n_tiles;
};

__global__ void __launch_bounds__(kLinThreads, 1)
    linear_tf32x3_kernel(const __grid_constant__ LinearParams p) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base = mlp_base(smem_raw);
  const uint32_t ring = smem_addr(base);
  // full[s] at bars + 8 s (the producer's expect_tx, TMA's bytes), empty[s]
  // at bars + 8 (kLinStages + s) (one arrival from each consumer warp)
  const uint32_t bars = ring + kLinStages * kLinStage;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int n_k = p.K / kLinK;
  if (tid == 0) {
    for (int s = 0; s < kLinStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (kLinStages + s), kLinConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kLinConsumerWarps) {  // the producer's warpgroup: one thread issues
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLinProducerRegs));
    if (tid == 32 * kLinConsumerWarps) {
      uint32_t it = 0;
      for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
        const int row0 = tile / p.col_tiles * kLinRows, col0 = tile % p.col_tiles * kLinCols;
        for (int ks = 0; ks < n_k; ++ks, ++it) {
          const uint32_t s = it % kLinStages, dst = ring + s * kLinStage, full = bars + 8 * s;
          if (it >= kLinStages)  // the stage's previous use released
            mbar_wait(bars + 8 * (kLinStages + s), ((it / kLinStages) & 1) ^ 1);
          mbar_expect_tx(full, kLinStage);
          tma_load_3d(dst, &p.ta, full, kLinK * ks, row0, 0);
          tma_load_3d(dst + kLinA, &p.tb, full, kLinK * ks, col0, 0);
          tma_load_3d(dst + kLinA + kLinB, &p.tb, full, kLinK * ks, col0, 1);
        }
      }
    }
  } else {  // the consumers: warpgroup wg computes rows 64 wg.. of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kLinConsumerRegs));
    const int wg = warp / 4;
    const int r0 = wg * 64 + 16 * (warp % 4) + lane / 4;  // this thread's rows r0, r0 + 8
    const int cq = 2 * (lane % 4);                        // and column pair in each 8
    const float* a_rows = reinterpret_cast<const float*>(base) + wg * 64 * kLinK;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
      const int row0 = tile / p.col_tiles * kLinRows, col0 = tile % p.col_tiles * kLinCols;
      float d[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) d[i] = 0.f;
      uint32_t hi[kLinK / 8][4], lo[kLinK / 8][4];
      mbar_wait(bars + 8 * (it % kLinStages), (it / kLinStages) & 1);
      linear_split(hi, lo, a_rows + (it % kLinStages) * (kLinStage / 4));
      // each stage: its products start, the next stage's fragments split
      // under them, then its sum is added to d and the stage released
      for (int ks = 0; ks < n_k; ++ks, ++it) {
        const uint32_t s = it % kLinStages;
        float sum[64];
        linear_products(sum, hi, lo, ring + s * kLinStage + kLinA);
        uint32_t nhi[kLinK / 8][4], nlo[kLinK / 8][4];
        if (ks + 1 < n_k) {
          const uint32_t s1 = (it + 1) % kLinStages;
          mbar_wait(bars + 8 * s1, ((it + 1) / kLinStages) & 1);
          linear_split(nhi, nlo, a_rows + s1 * (kLinStage / 4));
        }
        wgmma_wait<0>();
        fence_acc(sum);
        keep_frag(hi);
        keep_frag(lo);
        __syncwarp();
        if (lane == 0) mbar_arrive(bars + 8 * (kLinStages + s));
#pragma unroll
        for (int i = 0; i < 64; ++i) d[i] += sum[i];
#pragma unroll
        for (int i = 0; i < kLinK / 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            hi[i][j] = nhi[i][j];
            lo[i][j] = nlo[i][j];
          }
      }
      const int ra = row0 + r0, rb = ra + 8;
#pragma unroll
      for (int j = 0; j < kLinCols / 8; ++j) {
        const int c = col0 + 8 * j + cq;
        const float2 b =
            p.bias ? *reinterpret_cast<const float2*>(p.bias + c) : make_float2(0.f, 0.f);
        if (ra < p.M)
          *reinterpret_cast<float2*>(p.y + (size_t)ra * p.N + c) =
              make_float2(d[4 * j] + b.x, d[4 * j + 1] + b.y);
        if (rb < p.M)
          *reinterpret_cast<float2*>(p.y + (size_t)rb * p.N + c) =
              make_float2(d[4 * j + 2] + b.x, d[4 * j + 3] + b.y);
      }
    }
  }
}

// The hi and lo planes of w (N, K) into p (2, N, K) and, where pt is not
// nullptr, those of w^T into pt (2, K, N): hi = tf32(v), lo = tf32(v - hi)
// (`tf32_split`, as `ops.tf32.planes` rounds). A block a 32 x 32 tile.
__global__ void __launch_bounds__(256) tf32_planes_kernel(const float* __restrict__ w,
                                                          float* __restrict__ p,
                                                          float* __restrict__ pt, int N, int K) {
  __shared__ float hs[32][33], ls[32][33];
  const int n0 = blockIdx.y * 32, k0 = blockIdx.x * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const size_t plane = (size_t)N * K;
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i, k = k0 + tx;
    if (n < N && k < K) {
      uint32_t h, l;
      tf32_split(w[(size_t)n * K + k], h, l);
      p[(size_t)n * K + k] = __uint_as_float(h);
      p[plane + (size_t)n * K + k] = __uint_as_float(l);
      hs[i][tx] = __uint_as_float(h);
      ls[i][tx] = __uint_as_float(l);
    }
  }
  if (pt == nullptr) return;
  __syncthreads();
  for (int i = ty; i < 32; i += 8) {
    const int k = k0 + i, n = n0 + tx;
    if (k < K && n < N) {
      pt[(size_t)k * N + n] = hs[tx][i];
      pt[plane + (size_t)k * N + n] = ls[tx][i];
    }
  }
}

inline bool linear_shape_ok(int M, int N, int K) {
  return M > 0 && N > 0 && K > 0 && N % kLinCols == 0 && K % kLinK == 0;
}

}  // namespace d3dp

extern "C" {

// y (M, N) = a (M, K) @ B^T (+ bias) in tf32x3, B given as its hi and lo
// planes (2, N, K); bias (N,) or null. Needs N % 128 == 0, K % 32 == 0.
int d3dp_linear_tf32x3(const void* a, const void* planes, const void* bias, void* y, int M,
                       int N, int K, void* stream) {
  using namespace d3dp;
  if (!linear_shape_ok(M, N, K)) return (int)cudaErrorInvalidValue;
  LinearParams p{};
  int e = encode_map(&p.ta, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), a, 1, M, K, kLinK,
                     kLinRows, CU_TENSOR_MAP_SWIZZLE_128B);
  if (!e)
    e = encode_map(&p.tb, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, sizeof(float), planes, 2, N, K, kLinK,
                   kLinCols, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e) return e;
  p.bias = static_cast<const float*>(bias);
  p.y = static_cast<float*>(y);
  p.M = M;
  p.N = N;
  p.K = K;
  p.col_tiles = N / kLinCols;
  p.n_tiles = cdiv(M, kLinRows) * p.col_tiles;
  // the shared-memory opt-in and the SM count, once a device
  static int sms[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaFuncSetAttribute(linear_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)kLinSmem);
    int n = 0;
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms[dev] = n;
  }
  linear_tf32x3_kernel<<<std::min(p.n_tiles, sms[dev]), kLinThreads, kLinSmem,
                         static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// p (2, N, K): the hi and lo planes of w (N, K); pt (2, K, N) those of w^T,
// or null for none.
int d3dp_tf32_planes(const void* w, void* p, void* pt, int N, int K, void* stream) {
  using namespace d3dp;
  if (N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid(cdiv(K, 32), cdiv(N, 32));
  tf32_planes_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(w), static_cast<float*>(p), static_cast<float*>(pt), N, K);
  return (int)cudaGetLastError();
}

}  // extern "C"
