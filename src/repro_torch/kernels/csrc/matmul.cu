// K2: out = a @ b in IEEE fp32, with an optional ReLU epilogue.
//
// Replaces the TPU kernel matmul_pallas (src/repro/kernels/matmul/kernel.py
// :111; bodies _matmul_kernel :34 and _matmul_stream_kernel :53).  Every
// shape the port feeds it is skinny — M is a handful of rows — so the work
// is ~1 FLOP per byte of b and the kernel is bound by device memory
// (3.35 TB/s on an H100), never by arithmetic: the design's aim is enough
// 16-byte loads of b in flight on every SM.  Two kernels cover the two
// regimes; the choice and the split count are the plan of
// kernels/matmul/kernel.py::matmul_plan, passed in as `splits`:
//
// * column kernel (splits == 0): the coded transition's decode GEMM
//   d (Q, Q) @ rows (Q, F), ReLU fused into the store, and its re-encode
//   m_next^T (L, k_a') @ parts (k_a', F').  K is 2-16 and F runs to
//   millions of columns, so one thread per output column, with all BM
//   accumulators in registers and the small A tile broadcast from shared
//   memory, gives ceil(F/256) blocks — enough to fill the card — and reads
//   each element of b once.
// * split kernel (splits >= 1): the coded LM worker GEMMs, x (B <= 16,
//   d_in) @ W (d_in, N): SmolLM-135M's N = 288-1,536 over K = 576-1,536,
//   Qwen3-4B's N = 1,280-9,728 over K = 2,560-9,728.  The column kernel
//   would launch 2-38 blocks and walk K serially in each thread: latency
//   bound, a few bytes in flight (Qwen3-4B's down projection, K = 9,728
//   over N = 1,280, would run as 5 blocks on 132 SMs).  Here a
//   block owns a strip of 16 columns (4 threads, a float4 each) and one
//   slice of K; its 32 thread rows take every 32nd row of b in that
//   slice, so each thread has several 16-byte loads in flight.  The block
//   stages its rows of a for the slice in shared memory in chunks of
//   SK_CHUNK rows, the next chunk while the current round of b rows is in
//   flight, so a slice may be any length and shared memory stays a few KB.
//   The `splits` slices of one strip form a thread-block cluster: each
//   block sums its 32 row-partials in shared memory in a fixed order,
//   then block rank r of the cluster sums its share of the strip's outputs
//   over the cluster's blocks in rank order, reading their shared memory
//   directly (distributed shared memory), and writes `out` with the ReLU.
//   No float atomics and no scratch: two launches on the same inputs give
//   the same bits.  Where N % 4 != 0 or b is not 16-byte aligned, the
//   loads fall back to scalars inside the kernel.
//
// Rows beyond M and rows of K beyond K are masked; any shape is accepted.
// No TF32 anywhere: the CRME decode multiplies rounding error by the
// recovery matrix's condition number.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

// -- column kernel ----------------------------------------------------------
constexpr int THREADS = 256;
constexpr int BK = 32;

template <int BM>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int M, int64_t N, int K, int relu) {
  __shared__ float As[BM][BK];
  const int64_t n = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  const int m0 = blockIdx.y * BM;
  float acc[BM];
#pragma unroll
  for (int i = 0; i < BM; ++i) acc[i] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int i = e / BK;
      const int kk = e - i * BK;
      const int m = m0 + i;
      const int k = k0 + kk;
      As[i][kk] = (m < M && k < K) ? a[(int64_t)m * K + k] : 0.f;
    }
    __syncthreads();
    if (n < N) {
      const int kend = min(BK, K - k0);
      for (int kk = 0; kk < kend; ++kk) {
        const float bv = b[(int64_t)(k0 + kk) * N + n];
#pragma unroll
        for (int i = 0; i < BM; ++i) acc[i] = fmaf(As[i][kk], bv, acc[i]);
      }
    }
    __syncthreads();
  }
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < BM; ++i) {
    const int m = m0 + i;
    if (m < M) {
      const float v = acc[i];
      // v < 0 (not fmaxf) so a NaN propagates like torch's clamp_min
      out[(int64_t)m * N + n] = (relu && v < 0.f) ? 0.f : v;
    }
  }
}

template <int BM>
int launch_column(const float* a, const float* b, float* out, long long M,
                  long long N, long long K, int relu, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + THREADS - 1) / THREADS),
                  (unsigned)((M + BM - 1) / BM));
  matmul_kernel<BM><<<grid, THREADS, 0, stream>>>(a, b, out, (int)M,
                                                  (int64_t)N, (int)K, relu);
  return (int)cudaGetLastError();
}

// -- split kernel -----------------------------------------------------------
constexpr int SK_COLS = 4;                  // threads across a strip
constexpr int SK_ROWS = 32;                 // thread rows down K
constexpr int SK_THREADS = SK_COLS * SK_ROWS;
constexpr int SK_STRIP = 4 * SK_COLS;       // columns a block owns
constexpr int SK_UNROLL = 4;                // b rows in flight per thread
constexpr int SK_MAX_M = 16;
constexpr int SK_CHUNK = 1024;  // rows of a a block stages at a time
static_assert(SK_CHUNK % (SK_ROWS * SK_UNROLL) == 0,
              "a chunk holds whole rounds of the b stream");

__host__ __device__ constexpr int a_floats(int bm, int span) {
  return (bm * span + 3) / 4 * 4;
}

template <int BM>
__global__ void __launch_bounds__(SK_THREADS)
matmul_split_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int M, int N, int K, int slice,
                    int relu, int vec) {
  // a's rows of one chunk of this slice (padded to 16 bytes), then the 32
  // row-partials, then the block's sum
  extern __shared__ __align__(16) float smem[];
  const int span = min(slice, SK_CHUNK);                 // a's columns staged
  float* As = smem;                                      // [BM][span]
  float* part = As + a_floats(BM, span);                 // [SK_ROWS][BM][16]
  float* sum = part + SK_ROWS * BM * SK_STRIP;           // [BM][16]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.y;     // == cluster.block_rank(): cluster (1, splits)
  const int nsplit = gridDim.y;
  const int k_lo = split * slice;
  const int k_hi = min(K, k_lo + slice);
  const int tid = threadIdx.x;
  const int tc = tid % SK_COLS;
  const int tr = tid / SK_COLS;
  const int n = blockIdx.x * SK_STRIP + tc * 4;

  auto load = [&](int k) -> float4 {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (k >= k_hi) return v;
    const float* row = b + (int64_t)k * N;
    if (vec) {
      if (n < N) v = __ldg(reinterpret_cast<const float4*>(row + n));
    } else {
      if (n < N) v.x = __ldg(row + n);
      if (n + 1 < N) v.y = __ldg(row + n + 1);
      if (n + 2 < N) v.z = __ldg(row + n + 2);
      if (n + 3 < N) v.w = __ldg(row + n + 3);
    }
    return v;
  };
  // a's columns c0 .. c0 + span - 1 of this slice (zeros past it)
  auto stage = [&](int c0) {
    for (int e = tid; e < BM * span; e += SK_THREADS) {
      const int i = e / span;
      const int k = c0 + (e - i * span);
      As[e] = (i < M && k < k_hi) ? a[(int64_t)i * K + k] : 0.f;
    }
  };

  // this thread's first rows of b are in flight while a is staged
  float4 bv[SK_UNROLL];
#pragma unroll
  for (int u = 0; u < SK_UNROLL; ++u) bv[u] = load(k_lo + tr + u * SK_ROWS);
  stage(k_lo);
  __syncthreads();

  float acc[BM][4];
#pragma unroll
  for (int i = 0; i < BM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // rounds of SK_ROWS * SK_UNROLL rows of b, the same for every thread; a
  // new chunk of a is staged at every SK_CHUNK rows while the round's b
  // rows are in flight
  for (int r0 = 0; r0 < k_hi - k_lo; r0 += SK_ROWS * SK_UNROLL) {
    if (r0 > 0 && r0 % SK_CHUNK == 0) {
      __syncthreads();  // every thread is done with the previous chunk
      stage(k_lo + r0);
      __syncthreads();
    }
    const int k = k_lo + r0 + tr;
    float4 next[SK_UNROLL];
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u)
      next[u] = load(k + (SK_UNROLL + u) * SK_ROWS);
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u) {
      const int kk = r0 % SK_CHUNK + tr + u * SK_ROWS;
      if (kk >= span) break;  // rows past the slice hold zeros of b anyway
#pragma unroll
      for (int i = 0; i < BM; ++i) {
        const float av = As[i * span + kk];
        acc[i][0] = fmaf(av, bv[u].x, acc[i][0]);
        acc[i][1] = fmaf(av, bv[u].y, acc[i][1]);
        acc[i][2] = fmaf(av, bv[u].z, acc[i][2]);
        acc[i][3] = fmaf(av, bv[u].w, acc[i][3]);
      }
    }
#pragma unroll
    for (int u = 0; u < SK_UNROLL; ++u) bv[u] = next[u];
  }

  // the 32 row-partials of the block, summed in row order
#pragma unroll
  for (int i = 0; i < BM; ++i)
    *reinterpret_cast<float4*>(&part[(tr * BM + i) * SK_STRIP + tc * 4]) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  __syncthreads();
  for (int e = tid; e < BM * SK_STRIP; e += SK_THREADS) {
    float s = 0.f;
    for (int r = 0; r < SK_ROWS; ++r) s += part[r * BM * SK_STRIP + e];
    sum[e] = s;
  }
  // the cluster's blocks' sums, in rank order; block `split` writes its
  // share of the strip's BM*16 outputs
  cluster.sync();
  const int per = (BM * SK_STRIP + nsplit - 1) / nsplit;
  const int lo = split * per;
  const int hi = min(BM * SK_STRIP, lo + per);
  for (int e = lo + tid; e < hi; e += SK_THREADS) {
    float v = 0.f;
    for (int q = 0; q < nsplit; ++q) v += cluster.map_shared_rank(sum, q)[e];
    const int i = e / SK_STRIP;
    const int col = blockIdx.x * SK_STRIP + (e - i * SK_STRIP);
    if (i < M && col < N)
      out[(int64_t)i * N + col] = (relu && v < 0.f) ? 0.f : v;
  }
  cluster.sync();  // no block leaves while another still reads its sum
}

template <int BM>
int launch_split(const float* a, const float* b, float* out, long long M,
                 long long N, long long K, int relu, int splits,
                 cudaStream_t stream) {
  const int slice = (int)((K + splits - 1) / splits);
  const int span = slice < SK_CHUNK ? slice : SK_CHUNK;
  const size_t smem = sizeof(float) * ((size_t)a_floats(BM, span) +
                                       (size_t)(SK_ROWS + 1) * BM * SK_STRIP);
  static const cudaError_t attr = cudaFuncSetAttribute(
      matmul_split_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)(sizeof(float) * ((size_t)a_floats(BM, SK_CHUNK) +
                             (size_t)(SK_ROWS + 1) * BM * SK_STRIP)));
  if (attr != cudaSuccess) return (int)attr;
  const int vec = (N % 4 == 0) && ((uintptr_t)b % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((N + SK_STRIP - 1) / SK_STRIP), (unsigned)splits);
  cfg.blockDim = dim3(SK_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = (unsigned)splits;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, matmul_split_kernel<BM>, a, b,
                                           out, (int)M, (int)N, (int)K, slice,
                                           relu, vec);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// a: (M, K), b: (K, N), out: (M, N); fp32, row-major, contiguous.
// splits == 0 launches the column kernel; splits in {1, 2, 4, 8} the split
// kernel with that many K slices per cluster (M <= 16, a slice of any
// length).  Returns the launch's cudaError_t.
extern "C" int matmul_f32(const void* a, const void* b, void* out,
                          long long M, long long N, long long K,
                          long long relu, long long splits, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* po = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (splits == 0) {
    if (M <= 8) return launch_column<8>(pa, pb, po, M, N, K, (int)relu, s);
    return launch_column<16>(pa, pb, po, M, N, K, (int)relu, s);
  }
  if ((splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      M > SK_MAX_M || K < 1 || K > 0x7fffffffLL || N > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int sp = (int)splits;
  if (M == 1) return launch_split<1>(pa, pb, po, M, N, K, (int)relu, sp, s);
  if (M == 2) return launch_split<2>(pa, pb, po, M, N, K, (int)relu, sp, s);
  if (M <= 4) return launch_split<4>(pa, pb, po, M, N, K, (int)relu, sp, s);
  if (M <= 8) return launch_split<8>(pa, pb, po, M, N, K, (int)relu, sp, s);
  return launch_split<16>(pa, pb, po, M, N, K, (int)relu, sp, s);
}
