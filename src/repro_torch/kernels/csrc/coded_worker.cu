// K1: one FCDCC worker's coded subtask as one implicit-GEMM convolution.
//
// Replaces the TPU kernel coded_worker_pallas / _fused_worker_gemm
// (src/repro/kernels/conv2d/kernel.py:190, :291; bodies
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
//   depth   k = (c, dh, dw)   in the (C, KH, KW) order of the filters.
//
// Bound on an H100: at the serving shapes the work is 2*M*N*K fp32 FLOPs
// against a few hundred MB, far above the card's fp32 ridge point, so the
// kernel is bound by fp32 FMA throughput (67 TFLOP/s outside the tensor
// cores).  The design keeps the FMA pipes fed:
//
// * Tiles.  A block owns a 128 x BN output tile, BN = 32, 64 or 128 to
//   match the layer's N (the plan of kernels/conv2d/kernel.py::
//   worker_plan).  Each thread holds an 8 x TN register micro-tile (TN = 8
//   at BN >= 64, else 4; 128 threads, 256 at BN = 128) and reads its A and
//   B fragments from shared memory as float4: 2 + TN/4 loads of 16 bytes
//   for 8*TN FMAs.  A warp's threads
//   form a 4 x 8 grid, so each of those loads is one shared-memory
//   wavefront and the FMA pipes, not shared memory, set the pace.
// * Copies.  A ring of STAGES tiles of depth BK in dynamic shared memory is
//   filled with 4-byte cp.async (the patch gather has no 16-byte
//   alignment), zero-filled where a row, column or k is out of range, with
//   one barrier per stage: the copy of chunk c+STAGES-1 is issued right
//   after the barrier that ends chunk c-1's reads of its slot.
// * Loader.  Each block builds, once, a table of k -> c*H*W + dh*W + dw in
//   shared memory; a thread owns one output pixel row of the A tile, so a
//   patch element is its pixel's base offset plus one table entry — no
//   integer division in the loop.
// * Epilogue and split-K.  The finished tile is staged in shared memory
//   so the stores run along the output's pixels.  Where the tiles are
//   fewer than the SMs (VGG-16's last six layers at bucket 8), the plan
//   cuts K into 2, 4 or 8 slices, one per block of a thread-block cluster;
//   each block stages its partial tile, and block r of the cluster sums its
//   share of the tile's columns over the cluster's blocks in rank order,
//   reading their shared memory directly, and writes the output.  No float
//   atomics and no scratch: two launches give the same bits.
//
// Accumulation is IEEE fp32 FFMA (no TF32: the CRME decode multiplies
// rounding error by the recovery matrix's condition number).  The epilogue
// writes the reference's layout directly, with no permute:
// out[(slot, b, o, oh, ow)], slot = EB*a + b2, where g = a*B + b.  All
// offsets into x and out are 64-bit (VGG-16 at 224 and bucket 8 gives
// M = 401,408).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int BM = 128;
constexpr int BK = 16;
constexpr int STAGES = 3;
constexpr int TM = 8;  // two runs of 4 rows, BM/2 apart
constexpr int MAX_K = 16384;  // offset table entries (64 KB)

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
  if (K < 1 || K > MAX_K || C * H * W >= (1LL << 31) ||
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
  if (bn == 32) return launch<32>(K1_ARGS);
  if (bn == 64) return launch<64>(K1_ARGS);
  return launch<128>(K1_ARGS);
#undef K1_ARGS
}
