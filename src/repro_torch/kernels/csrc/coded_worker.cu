// K1: one FCDCC worker's coded subtask as one implicit-GEMM convolution.
//
// Replaces the TPU kernel coded_worker_pallas / _fused_worker_gemm
// (src/repro/kernels/conv2d/kernel.py:291, :190; bodies
// _worker_im2col_kernel :72 and _worker_im2col_stream_kernel :129).  The
// reference splits the work into a VMEM-resident, a K-streamed and a
// two-step variant only because of the TPU's VMEM limit; here one kernel
// covers all geometries.
//
// Computes, for coded shares x (G = ell_a*B, C, H, W) and coded filters
// w (N = ell_b*NB, K = C*KH*KW) (the (ell_b, NB, C, KH, KW) filters viewed
// row-major), the strided VALID convolution as a GEMM with
//   rows    m = (g, oh, ow)   M = G*HO*WO
//   columns n = (b2, o)       N = EB*NB
//   depth   k = (c, dh, dw)   in the (C, KH, KW) order of the filters,
// written straight into the reference's layout out[(slot, b, o, oh, ow)],
// slot = EB*a + b2, where g = a*B + b.  All offsets into x and out are
// 64-bit (VGG-16 at 224 and bucket 8 gives M = 401,408).
//
// Two kernels compute it; kernels/conv2d/kernel.py::worker_plan picks one
// a shape (its `route`).
//
// The tensor-core kernel (route "tc", coded_worker_tc_f32).  Bound on an
// H100 by three TF32 products a multiply-add on the tensor cores: 2*M*N*K
// FLOPs at 495/3 TFLOP/s, or, at K = 27 (VGG-16's first layer), by the
// bytes of its output; the plan sends K <= 32 to the FFMA kernel.
//
// * Precision.  Plain TF32 keeps 10 mantissa bits, about 2^-11 relative a
//   product, which the CRME decode multiplies by the recovery matrix's
//   condition number (1.2-5.7 over the 28 survivor pairs of n = 8,
//   (k_a, k_b) = (2, 4)).  So each fp32 operand is split, a = hi + lo,
//   hi = cvt.rna.tf32(a), lo = cvt.rna.tf32(a - hi) (a - hi is exact in
//   fp32), and each k8 step runs lo*hi, hi*lo and hi*hi: the dropped lo*lo
//   and lo's rounding cost about 2^-22 relative (3xTF32).  No operand
//   reaches the tensor cores as raw fp32 bits.  The tensor cores' own
//   fp32 accumulation loses more than IEEE rounding: a chain of wgmmas
//   over all of K = 4,608 drifted to 10x the fp32 path's error against
//   float64 on an H100.  So a chain runs over two stages (64 taps) into a
//   partial accumulator, which is then added to the tile's in fp32
//   (promotion); the error is then below cuBLAS fp32's.
// * Filters.  split_filters, launched before the kernel on the same stream,
//   writes the filters' hi and lo parts in the kernel's tile order: one
//   [BN][32] block each a (N-tile, K stage), K-major with the 128-byte
//   swizzle, zero past N and K.  So a stage's B is one contiguous bulk copy
//   (cp.async.bulk on an mbarrier's transaction count) and the wgmma
//   descriptors read it as it lies.  It is redone every launch: a layer's
//   filters are read once and written twice (a few MB at VGG-16's deepest
//   layers, against a convolution of billions of FLOPs), and the public
//   coded_worker(xe, ke, stride) keeps no state between calls.
// * Patches.  A producer warpgroup gathers the im2col tile, one output
//   pixel a thread, with 4-byte cp.async (zero-filled past M and K; the
//   patch rows have no 16-byte alignment in general); lane l of each warp
//   decodes tap k0 + l once a stage and the warp shares the offsets by
//   shuffle.  Each thread's copies arrive on the stage's full barrier
//   (cp.async.mbarrier.arrive.noinc).  A stage is [32][BM + 8], with rows
//   m and m + 8 side by side (apos), so a consumer thread loads both rows
//   of its fragment with one 8-byte load, conflict-free.
// * Consumers.  Two warpgroups own 64 rows each: a thread splits its A
//   fragment in registers (the saturation and inf cases only where a warp
//   holds a value at the top of the float range) and issues
//   wgmma.mma_async m64nBNk8 .tf32 with A from registers and B from the
//   swizzled stage.  A ring of 4 stages of 32 k each; the consumers
//   release a stage on its empty barrier once their wgmmas on it are done.
// * Tiles.  128 x BN, BN = 32, 64 or 128: the layer's N up to 128 (a
//   256-wide tile with its hi and lo blocks leaves room for two stages
//   only).  The accumulators are 2 x BN/2 fp32 registers a thread.
// * Split-K and epilogue as the FFMA kernel's below: the tile is staged in
//   shared memory and stored along the output's pixels; where the last
//   wave of tiles would leave most SMs idle the plan cuts K into 2, 4 or
//   8 slices, one per block of a thread-block cluster, and block r sums
//   its share of the tile's columns over the cluster's blocks in rank
//   order through distributed shared memory.  No float atomics: two
//   launches give the same bits.
//
// The FFMA kernel (route "ffma", coded_worker_f32).  Bound by fp32 FMA
// throughput outside the tensor cores (67 TFLOP/s).  A block owns a
// 128 x BN output tile (BN = 32, 64 or 128), each thread an 8 x TN
// register micro-tile (TN = 8 at BN >= 64, else 4) read from shared memory
// as float4; a ring of 3 stages of depth 16 filled with 4-byte cp.async
// through a per-block k -> offset table; IEEE fp32 FFMA accumulation; the
// same epilogue and split-K.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, bulk copies, wgmma descriptors and fences

namespace cg = cooperative_groups;

namespace {

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem,
                                          bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int bytes = pred ? 4 : 0;  // 0: fill the slot with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}


// ---------------------------------------------------------------------------
// The FFMA kernel
// ---------------------------------------------------------------------------
namespace ffma {


constexpr int BM = 128;
constexpr int BK = 16;
constexpr int STAGES = 3;
constexpr int TM = 8;  // two runs of 4 rows, BM/2 apart
constexpr int MAX_K = 16384;  // offset table entries (64 KB)

template <int BN>
struct Cfg {
  static constexpr int TN = BN >= 64 ? 8 : 4;
  static constexpr int TX = BN / TN;            // threads across the tile
  static constexpr int THREADS = (BM / TM) * TX;
  static constexpr int LDB = BN + 4;            // padded B rows
  static constexpr int A_STAGE = BK * BM;
  static constexpr int B_STAGE = BK * LDB;
  static constexpr int A_PER_THREAD = A_STAGE / THREADS;
  static constexpr int B_PER_THREAD = BK * BN / THREADS;
  static constexpr int LDR = BM + 4;            // padded rows of the partial tile
  static_assert(THREADS % BM == 0, "a thread owns one A row");
  static_assert(BM / TM == 16 && TX % 8 == 0, "warps of 4 x 8 threads");
};

template <int BN>
size_t smem_bytes(int K) {
  using C = Cfg<BN>;
  const size_t kpad = (size_t)((K + BK - 1) / BK) * BK;
  const size_t ring = sizeof(float) * STAGES * (C::A_STAGE + C::B_STAGE) +
                      sizeof(int) * kpad;
  const size_t red = sizeof(float) * (size_t)BN * C::LDR;
  return ring > red ? ring : red;
}

template <int BN>
__global__ void __launch_bounds__(Cfg<BN>::THREADS, 2)
coded_worker_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int C, int H, int W, int KH,
                    int KW, int stride, int HO, int WO, int64_t M, int N,
                    int K, int B, int EB, int NB, int chunks_per_split) {
  using Cf = Cfg<BN>;
  constexpr int THREADS = Cf::THREADS;
  constexpr int TN = Cf::TN;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                                  // [STAGES][BK][BM]
  float* Bs = As + STAGES * Cf::A_STAGE;             // [STAGES][BK][LDB]
  int* tab = reinterpret_cast<int*>(Bs + STAGES * Cf::B_STAGE);

  const int tid = threadIdx.x;
  // a warp computes 4 x 8 threads' micro-tiles, so each of its float4
  // fragment reads spans 64 (A) or 128 (B) bytes: one shared-memory
  // wavefront.  Thread (tm, tn) owns rows tm*4 + i and BM/2 + tm*4 + i and
  // columns tn*4 + j (and BN/2 + tn*4 + j when TN = 8).
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int tm = (warp % 4) * 4 + lane % 4;
  const int tn = (warp / 4) * 8 + lane / 4;
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int nsplit = gridDim.z;
  const int nchunks = (K + BK - 1) / BK;
  const int c_lo = blockIdx.z * chunks_per_split;
  const int c_hi = min(nchunks, c_lo + chunks_per_split);
  const int64_t hw_out = (int64_t)HO * WO;

  // the k -> offset table of this block's K range
  const int khw = KH * KW;
  for (int k = c_lo * BK + tid; k < c_hi * BK; k += THREADS) {
    int off = 0;
    if (k < K) {
      const int c = k / khw;
      const int r = k - c * khw;
      const int dh = r / KW;
      off = c * H * W + dh * W + (r - dh * KW);
    }
    tab[k - c_lo * BK] = off;
  }

  // A loader: this thread's output pixel row and the k's it copies
  const int a_m = tid % BM;
  const int a_k = tid / BM;
  constexpr int A_KSTEP = THREADS / BM;
  const int64_t gm = m0 + a_m;
  const bool a_row_ok = gm < M;
  const float* a_src = x;
  if (a_row_ok) {
    const int64_t g = gm / hw_out;
    const int p = (int)(gm - g * hw_out);
    const int oh = p / WO;
    const int ow = p - oh * WO;
    a_src = x + g * C * (int64_t)H * W + (int64_t)(oh * stride) * W + ow * stride;
  }
  __syncthreads();  // the table is complete

  auto load_stage = [&](int slot, int chunk) {
    const int k0 = chunk * BK;
    float* as = As + slot * Cf::A_STAGE;
    float* bs = Bs + slot * Cf::B_STAGE;
#pragma unroll
    for (int i = 0; i < Cf::A_PER_THREAD; ++i) {
      const int kk = a_k + i * A_KSTEP;
      const bool ok = a_row_ok && k0 + kk < K;
      cp_async4(&as[kk * BM + a_m],
                ok ? a_src + tab[k0 + kk - c_lo * BK] : x, ok);
    }
#pragma unroll
    for (int i = 0; i < Cf::B_PER_THREAD; ++i) {
      const int e = tid + i * THREADS;
      const int kk = e % BK;
      const int nn = e / BK;
      const bool ok = n0 + nn < N && k0 + kk < K;
      cp_async4(&bs[kk * Cf::LDB + nn],
                ok ? w + (int64_t)(n0 + nn) * K + k0 + kk : w, ok);
    }
  };

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (c_lo + s < c_hi) load_stage(s, c_lo + s);
    cp_async_commit();
  }
  for (int c = c_lo; c < c_hi; ++c) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of chunk c landed
    __syncthreads();  // everyone's landed; everyone is done with chunk c-1
    const int next = c + STAGES - 1;
    if (next < c_hi) load_stage((next - c_lo) % STAGES, next);
    cp_async_commit();
    const float* as = As + ((c - c_lo) % STAGES) * Cf::A_STAGE;
    const float* bs = Bs + ((c - c_lo) % STAGES) * Cf::B_STAGE;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[TM], bv[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk * BM + tm * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&as[kk * BM + BM / 2 + tm * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      const float4 b0 =
          *reinterpret_cast<const float4*>(&bs[kk * Cf::LDB + tn * 4]);
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      if constexpr (TN == 8) {
        const float4 b1 = *reinterpret_cast<const float4*>(
            &bs[kk * Cf::LDB + BN / 2 + tn * 4]);
        bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  // Epilogue: the tile goes to shared memory column-major ([BN][LDR], over
  // the ring, which no copy touches any more), so the stores below run
  // along m, i.e. along the output's pixels.  With split-K the cluster's
  // blocks each hold a partial tile; block r then sums columns
  // [r*BN/nsplit, (r+1)*BN/nsplit) over ranks 0..nsplit-1 in rank order.
  cp_async_wait<0>();
  __syncthreads();
  float* red = smem;
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = (j < 4 ? 0 : BN / 2 - 4) + tn * 4 + j;
    *reinterpret_cast<float4*>(&red[col * Cf::LDR + tm * 4]) =
        make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    *reinterpret_cast<float4*>(&red[col * Cf::LDR + BM / 2 + tm * 4]) =
        make_float4(acc[4][j], acc[5][j], acc[6][j], acc[7][j]);
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // a plain barrier when nsplit == 1
  // out[R(m) + Cn(n)]: R(m) = (a*EB*B*NB + b*NB)*hw_out + p and
  // Cn(n) = (b2*B*NB + o)*hw_out, with g = a*B + b, p the pixel, n = b2*NB + o.
  // A thread's four rows stay the same for every column it stores.
  const int row = (tid % (BM / 4)) * 4;
  int64_t rb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + row + i;
    const int64_t g = m / hw_out;
    const int64_t a = g / B;
    rb[i] = m < M ? (a * EB * B * NB + (g - a * B) * NB) * hw_out + (m - g * hw_out)
                  : -1;
  }
  const int rank = blockIdx.z;  // == cluster.block_rank(): cluster (1, 1, nsplit)
  const int ncols = BN / nsplit;
  for (int cc = tid / (BM / 4); cc < ncols; cc += THREADS / (BM / 4)) {
    const int col = rank * ncols + cc;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < nsplit; ++q) {
      const float4 t = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, q) + col * Cf::LDR + row);
      v.x += t.x; v.y += t.y; v.z += t.z; v.w += t.w;
    }
    const int n = n0 + col;
    if (n >= N) continue;
    const int b2 = n / NB;
    const int64_t cb = ((int64_t)b2 * B * NB + (n - b2 * NB)) * hw_out;
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (rb[i] >= 0) out[rb[i] + cb] = vs[i];
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

template <int BN>
int launch(const float* x, const float* w, float* out, int C, int H, int W,
           int KH, int KW, int stride, int HO, int WO, int64_t M, int N, int K,
           int B, int EB, int NB, int splits, cudaStream_t stream) {
  using Cf = Cfg<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      coded_worker_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_bytes<BN>(MAX_K));
  if (attr != cudaSuccess) return (int)attr;
  const int nchunks = (K + BK - 1) / BK;
  const int per = (nchunks + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN),
                     (unsigned)splits);
  cfg.blockDim = dim3(Cf::THREADS);
  cfg.dynamicSmemBytes = smem_bytes<BN>(per * BK);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = (unsigned)splits;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, coded_worker_kernel<BN>, x, w, out, C, H, W, KH, KW, stride, HO,
      WO, M, N, K, B, EB, NB, per);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace ffma

// ---------------------------------------------------------------------------
// The tensor-core kernel (3xTF32 on wgmma)
// ---------------------------------------------------------------------------
namespace tc {

// Stage timing, compiled only with -DK1_TRACE (scripts/torch_k1_trace.py):
// thread 0 of each warpgroup of one block writes clock64() stamps of each
// stage's steps to trace[(role * 1024 + stage) * 8 + step], role 0-1 the
// consumers, 2 the producer, 3 the block's start and end a warpgroup.
#ifdef K1_TRACE
__device__ long long* trace_buf = nullptr;
__device__ int trace_block = -1;
#define K1_STAMP(role, i, j)                                              \
  do {                                                                    \
    if (trace && (i) < 1024) trace[((role) * 1024 + (i)) * 8 + (j)] = clock64(); \
  } while (0)
#else
#define K1_STAMP(role, i, j) \
  do {                       \
  } while (0)
#endif

constexpr int BM = 128;      // two consumer warpgroups of 64 rows
constexpr int BK = 32;       // one 128-byte swizzle row of tf32 a stage
constexpr int STAGES = 4;
constexpr int PROMOTE = 2;   // stages a tensor-core accumulation chain runs
constexpr int LDA = BM + 8;  // A stage [BK][LDA]: a half-warp's loads hit 32 banks
constexpr int THREADS = 384; // warpgroups 0-1 consume, warpgroup 2 copies
constexpr int LDR = BM + 4;  // padded rows of the staged output tile

template <int BN>
struct Cfg {
  static constexpr int B_STAGE = 2 * BN * BK;  // floats: hi block, lo block
  static constexpr int A_STAGE = BK * LDA;
  static constexpr uint32_t B_BYTES = sizeof(float) * B_STAGE;
  static constexpr size_t RING =
      sizeof(float) * (size_t)STAGES * (B_STAGE + A_STAGE);
  static constexpr size_t RED = sizeof(float) * (size_t)BN * LDR;
  static constexpr size_t BODY = RING > RED ? RING : RED;
  // 1024 bytes of slack to align the ring to the swizzle's 1024-byte
  // period, then the full and empty barriers
  static constexpr size_t BYTES = 1024 + BODY + 2 * STAGES * sizeof(uint64_t);
  static_assert(B_BYTES % 1024 == 0, "B stages keep the 1024-byte alignment");
};

// where pixel m of the tile sits in an A stage's row: m and m + 8 side by
// side, so a consumer thread loads its two rows with one 8-byte load
__device__ __forceinline__ int apos(int m) {
  return (m & ~15) | ((m & 7) << 1) | ((m >> 3) & 1);
}

// the barrier counts one arrival once this thread's earlier cp.asyncs land
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// The filters' hi and lo parts in the tensor-core kernel's tile order:
// ws[t][s][part][nn][k] for N-tile t, K stage s, part 0 = hi, 1 = lo, each
// [BN][BK] block with the 128-byte swizzle (16-byte chunk q of row nn at
// chunk q ^ (nn % 8)), zero past N and K.  One thread a 16-byte chunk.
__global__ void split_filters(const float* __restrict__ w, float* __restrict__ ws,
                              int N, int K, int bn, int kstages,
                              int64_t chunks) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= chunks) return;
  const int q = (int)(i % (BK / 4));
  const int nn = (int)((i / (BK / 4)) % bn);
  const int64_t ts = i / ((BK / 4) * bn);  // t * kstages + s
  const int s = (int)(ts % kstages);
  const int n = (int)(ts / kstages) * bn + nn;
  const int k0 = s * BK + q * 4;
  uint32_t hi[4], lo[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float v = (n < N && k0 + j < K) ? w[(int64_t)n * K + k0 + j] : 0.f;
    split(v, hi[j], lo[j]);
  }
  float* blk = ws + ts * (2 * (int64_t)bn * BK);
  const int off = nn * BK + ((q ^ (nn & 7)) * 4);
  *reinterpret_cast<uint4*>(blk + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
  *reinterpret_cast<uint4*>(blk + (int64_t)bn * BK + off) =
      make_uint4(lo[0], lo[1], lo[2], lo[3]);
}

template <int BN>
__global__ void __launch_bounds__(THREADS, BN == 32 ? 2 : 1)
coded_worker_tc_kernel(const float* __restrict__ x, const float* __restrict__ ws,
                       float* __restrict__ out, int C, int H, int W, int KH,
                       int KW, int stride, int HO, int WO, int64_t M, int N,
                       int K, int B, int EB, int NB, int stages_per_split) {
  using Cf = Cfg<BN>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the ring from the first 1024-byte boundary: B stages (hi, lo), then
  // A stages, then the barriers past the larger of ring and output tile
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  float* Bs = reinterpret_cast<float*>(base);
  float* As = Bs + STAGES * Cf::B_STAGE;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + Cf::BODY);
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x;
  const int wg = tid / 128;
#ifdef K1_TRACE
  long long* trace = (blockIdx.x == trace_block && blockIdx.y == 0 &&
                      blockIdx.z == 0 && tid % 128 == 0)
                         ? trace_buf
                         : nullptr;
#endif
  K1_STAMP(3, wg, 0);
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int nsplit = gridDim.z;
  const int kstages = (K + BK - 1) / BK;
  const int s_lo = blockIdx.z * stages_per_split;
  const int s_hi = min(kstages, s_lo + stages_per_split);
  const int nst = s_hi - s_lo;
  const int64_t hw_out = (int64_t)HO * WO;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 128 + 1);  // 128 copying threads + the B bulk copy
      mbar_init(&empty[s], 256);     // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

  if (wg == 2) {
    // -- producer: thread p gathers row p of the A tile (one output pixel)
    // with 4-byte cp.async (the patch gather has no 16-byte alignment);
    // thread 0 also brings the stage's hi and lo filter block in one bulk
    // copy
    const int p = tid - 256;
    const int lane = tid % 32;
    const int64_t gm = m0 + p;
    const bool row_ok = gm < M;
    const float* a_src = x;
    if (row_ok) {
      const int64_t g = gm / hw_out;
      const int pix = (int)(gm - g * hw_out);
      const int oh = pix / WO;
      const int ow = pix - oh * WO;
      a_src = x + g * C * (int64_t)H * W + (int64_t)(oh * stride) * W +
              ow * stride;
    }
    const int khw = KH * KW;
    const float* b_src = ws + ((int64_t)blockIdx.y * kstages) * Cf::B_STAGE;
    for (int i = 0; i < nst; ++i) {
      const int slot = i % STAGES;
      K1_STAMP(2, i, 0);
      if (i >= STAGES) mbar_wait(&empty[slot], ((i / STAGES) - 1) & 1);
      K1_STAMP(2, i, 1);
      const int st = s_lo + i;
      if (p == 0) {
        mbar_expect_tx(&full[slot], Cf::B_BYTES);
        bulk_copy(Bs + slot * Cf::B_STAGE, b_src + (int64_t)st * Cf::B_STAGE,
                  Cf::B_BYTES, &full[slot]);
      }
      // lane l finds the input offset of tap k0 + l (-1 past K); the warp
      // shares them
      const int k = st * BK + lane;
      const int ci = k / khw;
      const int r = k - ci * khw;
      const int dh = r / KW;
      const int off_l = k < K ? ci * H * W + dh * W + (r - dh * KW) : -1;
      float* as = As + slot * Cf::A_STAGE + apos(p);
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const int off = __shfl_sync(0xffffffffu, off_l, kk);
        const bool ok = row_ok && off >= 0;
        cp_async4(as + kk * LDA, a_src + (ok ? off : 0), ok);
      }
      cp_async_arrive(&full[slot]);
      K1_STAMP(2, i, 2);
    }
  } else {
    // -- consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of the
    // tile.  The products of PROMOTE stages go into `part` (the first
    // wgmma of the run overwrites it), which is then added to `acc` in
    // fp32: the tensor cores' own accumulation loses more than fp32
    // rounding over a long K, so no chain of them is longer than 64 taps.
    const int lane = tid % 32;
    const int g = lane / 4;
    const int t = lane % 4;
    const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + g;  // rows r0, r0 + 8
    const int c0 = apos(r0);  // r0 at c0, r0 + 8 at c0 + 1
    float part[BN / 2];
    for (int i = 0; i < nst; ++i) {
      const int slot = i % STAGES;
      K1_STAMP(wg, i, 0);
      mbar_wait(&full[slot], (i / STAGES) & 1);
      __syncwarp();  // converged for the .aligned wgmma instructions
      K1_STAMP(wg, i, 1);
      const float* as = As + slot * Cf::A_STAGE + c0;
      // A fragments of the stage's four k8 steps, split in registers:
      // a[0] (r0, t), a[1] (r0 + 8, t), a[2] (r0, t + 4), a[3] (r0 + 8, t + 4)
      float a[BK / 8][4];
      float big = 0.f;
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        const float2 u = *reinterpret_cast<const float2*>(as + (s * 8 + t) * LDA);
        const float2 v =
            *reinterpret_cast<const float2*>(as + (s * 8 + t + 4) * LDA);
        a[s][0] = u.x;
        a[s][1] = u.y;
        a[s][2] = v.x;
        a[s][3] = v.y;
#pragma unroll
        for (int j = 0; j < 4; ++j) big = fmaxf(big, fabsf(a[s][j]));
      }
      // the saturation and inf cases of split() only where a value of
      // the warp's fragments needs them (|x| at the top of the float
      // range), so the common path is two conversions and a subtraction
      uint32_t ah[BK / 8][4], al[BK / 8][4];
      if (__any_sync(0xffffffffu, big >= __uint_as_float(TF32_OVERFLOW))) {
#pragma unroll
        for (int s = 0; s < BK / 8; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) split(a[s][j], ah[s][j], al[s][j]);
      } else {
#pragma unroll
        for (int s = 0; s < BK / 8; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            ah[s][j] = cvt_tf32(a[s][j]);
            al[s][j] = cvt_tf32(a[s][j] - __uint_as_float(ah[s][j]));
          }
      }
      K1_STAMP(wg, i, 2);
      const uint32_t bh = smem_u32(Bs + slot * Cf::B_STAGE);
      const uint32_t bl = bh + Cf::B_BYTES / 2;
      fence_regs(part);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        // the two small products first, then hi * hi; k8 step s starts 32
        // bytes into the swizzled rows
        wgmma_tf32(part, al[s], desc_sw128(bh + 32 * s),
                   (s == 0 && i % PROMOTE == 0) ? 0 : 1);
        wgmma_tf32(part, ah[s], desc_sw128(bl + 32 * s), 1);
        wgmma_tf32(part, ah[s], desc_sw128(bh + 32 * s), 1);
      }
      wgmma_commit();
      K1_STAMP(wg, i, 3);
      wgmma_wait_all();
      fence_regs(part);
      K1_STAMP(wg, i, 4);
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        fence_regs(ah[s]);
        fence_regs(al[s]);
      }
      mbar_arrive(&empty[slot]);
      if (i % PROMOTE == PROMOTE - 1 || i == nst - 1) {
#pragma unroll
        for (int q = 0; q < BN / 2; ++q) acc[q] += part[q];
      }
      K1_STAMP(wg, i, 5);
    }
  }

  // Epilogue, as the FFMA kernel's: the tile goes to shared memory
  // column-major ([BN][LDR], over the ring, which nothing reads any more),
  // then block r of the cluster sums its share of the columns over the
  // cluster's blocks in rank order and stores along the output's pixels.
  __syncthreads();
  float* red = Bs;
  if (wg < 2) {
    const int lane = tid % 32;
    const int r0 = wg * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = 8 * j + 2 * (lane % 4);
      red[col * LDR + r0] = acc[4 * j];
      red[(col + 1) * LDR + r0] = acc[4 * j + 1];
      red[col * LDR + r0 + 8] = acc[4 * j + 2];
      red[(col + 1) * LDR + r0 + 8] = acc[4 * j + 3];
    }
  }
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // a plain barrier when nsplit == 1
  const int row = (tid % (BM / 4)) * 4;
  int64_t rb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + row + i;
    const int64_t g = m / hw_out;
    const int64_t a = g / B;
    rb[i] = m < M ? (a * EB * B * NB + (g - a * B) * NB) * hw_out + (m - g * hw_out)
                  : -1;
  }
  const int rank = blockIdx.z;  // == cluster.block_rank(): cluster (1, 1, nsplit)
  const int ncols = BN / nsplit;
  const int n0 = blockIdx.y * BN;
  for (int cc = tid / (BM / 4); cc < ncols; cc += THREADS / (BM / 4)) {
    const int col = rank * ncols + cc;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < nsplit; ++q) {
      const float4 u = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(red, q) + col * LDR + row);
      v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
    }
    const int n = n0 + col;
    if (n >= N) continue;
    const int b2 = n / NB;
    const int64_t cb = ((int64_t)b2 * B * NB + (n - b2 * NB)) * hw_out;
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
      if (rb[i] >= 0) out[rb[i] + cb] = vs[i];
  }
  cluster.sync();  // no block leaves while another still reads its tile
  K1_STAMP(3, wg, 1);
}

template <int BN>
int launch(const float* x, const float* w, float* ws, float* out, int C, int H,
           int W, int KH, int KW, int stride, int HO, int WO, int64_t M, int N,
           int K, int B, int EB, int NB, int splits, cudaStream_t stream) {
  using Cf = Cfg<BN>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      coded_worker_tc_kernel<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cf::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const int kstages = (K + BK - 1) / BK;
  const int ntiles = (N + BN - 1) / BN;
  const int64_t chunks = (int64_t)ntiles * kstages * BN * (BK / 4);
  split_filters<<<(unsigned)((chunks + 255) / 256), 256, 0, stream>>>(
      w, ws, N, K, BN, kstages, chunks);
  const cudaError_t e0 = cudaGetLastError();
  if (e0 != cudaSuccess) return (int)e0;
  const int per = (kstages + splits - 1) / splits;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((M + BM - 1) / BM), (unsigned)ntiles,
                     (unsigned)splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = Cf::BYTES;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = 1;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = (unsigned)splits;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, coded_worker_tc_kernel<BN>, x, (const float*)ws, out, C, H, W, KH,
      KW, stride, HO, WO, M, N, K, B, EB, NB, per);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// x: (G, C, H, W) fp32, w: (EB*NB, C*KH*KW) fp32, out: (G/B*EB, B, NB, HO, WO)
// fp32, all contiguous, G = ell_a * B.  bn in {32, 64, 128} is the N-tile
// and splits in {1, 2, 4, 8} the K slices per cluster (worker_plan); K at
// most 16,384 and C*H*W below 2^31.  Returns the launch's cudaError_t.
extern "C" int coded_worker_f32(const void* x, const void* w, void* out,
                                long long C, long long H, long long W,
                                long long KH, long long KW, long long stride,
                                long long G, long long B, long long EB,
                                long long NB, long long bn, long long splits,
                                void* stream) {
  const long long HO = (H - KH) / stride + 1;
  const long long WO = (W - KW) / stride + 1;
  const long long M = G * HO * WO;
  const long long N = EB * NB;
  const long long K = C * KH * KW;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K < 1 || K > ffma::MAX_K || C * H * W >= (1LL << 31) ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      (bn != 32 && bn != 64 && bn != 128))
    return (int)cudaErrorInvalidValue;
  const float* px = (const float*)x;
  const float* pw = (const float*)w;
  float* po = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define K1_ARGS px, pw, po, (int)C, (int)H, (int)W, (int)KH, (int)KW, \
    (int)stride, (int)HO, (int)WO, (int64_t)M, (int)N, (int)K, (int)B, \
    (int)EB, (int)NB, (int)splits, s
  if (bn == 32) return ffma::launch<32>(K1_ARGS);
  if (bn == 64) return ffma::launch<64>(K1_ARGS);
  return ffma::launch<128>(K1_ARGS);
#undef K1_ARGS
}

// The tensor-core kernel on the same operands; ws: the filters' split
// scratch, ceil(N/bn) * ceil(K/32) * 2 * bn * 32 fp32, 16-byte aligned.
// Launches split_filters, then the kernel.  C*H*W below 2^31.
extern "C" int coded_worker_tc_f32(const void* x, const void* w, void* ws,
                                   void* out, long long C, long long H,
                                   long long W, long long KH, long long KW,
                                   long long stride, long long G, long long B,
                                   long long EB, long long NB, long long bn,
                                   long long splits, void* stream) {
  const long long HO = (H - KH) / stride + 1;
  const long long WO = (W - KW) / stride + 1;
  const long long M = G * HO * WO;
  const long long N = EB * NB;
  const long long K = C * KH * KW;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  if (K < 1 || C * H * W >= (1LL << 31) || N * K >= (1LL << 40) ||
      (splits != 1 && splits != 2 && splits != 4 && splits != 8) ||
      (bn != 32 && bn != 64 && bn != 128) || ((uintptr_t)ws & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const float* px = (const float*)x;
  const float* pw = (const float*)w;
  float* pws = (float*)ws;
  float* po = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
#define K1_ARGS px, pw, pws, po, (int)C, (int)H, (int)W, (int)KH, (int)KW, \
    (int)stride, (int)HO, (int)WO, (int64_t)M, (int)N, (int)K, (int)B, \
    (int)EB, (int)NB, (int)splits, s
  if (bn == 32) return tc::launch<32>(K1_ARGS);
  if (bn == 64) return tc::launch<64>(K1_ARGS);
  return tc::launch<128>(K1_ARGS);
#undef K1_ARGS
}

#ifdef K1_TRACE
// where the traced kernel writes its stamps (a device buffer of 4 * 1024
// * 8 int64) and which block along M it traces; a null buffer stops it
extern "C" int coded_worker_tc_trace(void* buf, long long block) {
  long long* p = (long long*)buf;
  const int b = (int)block;
  cudaMemcpyToSymbol(tc::trace_buf, &p, sizeof(p));
  cudaMemcpyToSymbol(tc::trace_block, &b, sizeof(b));
  return (int)cudaGetLastError();
}
#endif
