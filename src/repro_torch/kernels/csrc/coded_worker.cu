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
// Each block owns a BM x BN output tile and walks K in BK chunks: every
// chunk of the patch matrix is gathered straight from x into shared
// memory (the patch matrix never reaches device memory), the filter chunk
// comes from w, and the next chunk's loads are issued into registers while
// the current one is multiplied.  Accumulation is IEEE fp32 FFMA in
// registers (no TF32: the CRME decode multiplies rounding error by the
// recovery matrix's condition number).  Ragged M, N and K edges are
// masked in the kernel; no operand is padded in memory.
//
// The epilogue writes the reference's layout directly, with no permute:
// out[(slot, b, o, oh, ow)], slot = EB*a + b2, where g = a*B + b.  All
// offsets are 64-bit (VGG-16 at 224 and bucket 8 gives M = 401,408).
//
// Bound on an H100: at the serving shapes the work is 2*M*N*K fp32 FLOPs
// against a few hundred MB, far above the card's fp32 ridge point, so the
// kernel is bound by fp32 FMA throughput (67 TFLOP/s outside the tensor
// cores).  This first version is a plain 64x64x16 SIMT tile with a 4x4
// register micro-tile per thread; wgmma/TMA and 3xTF32 are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;
constexpr int A_PER_THREAD = BM * BK / THREADS;  // 4
constexpr int B_PER_THREAD = BN * BK / THREADS;  // 4

__global__ void __launch_bounds__(THREADS)
coded_worker_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    float* __restrict__ out, int C, int H, int W, int KH,
                    int KW, int stride, int HO, int WO, int64_t M, int N,
                    int K, int B, int EB, int NB) {
  __shared__ float As[BK][BM];
  __shared__ float Bs[BK][BN + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // micro-tile rows tx + 16*i
  const int ty = tid / 16;  // micro-tile cols ty + 16*j
  const int64_t m0 = (int64_t)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int khw = KH * KW;
  const int64_t hw_in = (int64_t)H * W;
  const int64_t hw_out = (int64_t)HO * WO;

  // A (patch) loader: each thread owns one output pixel row of the tile,
  // so its base offset into x is computed once.
  const int a_m = tid % BM;
  const int a_k = tid / BM;  // loads k = a_k + 4*i of each chunk
  const int64_t gm = m0 + a_m;
  const bool a_row_ok = gm < M;
  int64_t a_base = 0;
  if (a_row_ok) {
    const int64_t g = gm / hw_out;
    const int p = (int)(gm - g * hw_out);
    const int oh = p / WO;
    const int ow = p - oh * WO;
    a_base = g * C * hw_in + (int64_t)(oh * stride) * W + ow * stride;
  }
  // B (filter) loader: consecutive threads read consecutive k of a row.
  const int b_k = tid % BK;
  const int b_n = tid / BK;  // loads n = b_n + 16*i

  float a_reg[A_PER_THREAD];
  float b_reg[B_PER_THREAD];
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  auto load_chunk = [&](int k0) {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) {
      const int k = k0 + a_k + 4 * i;
      float v = 0.f;
      if (a_row_ok && k < K) {
        const int c = k / khw;
        const int r = k - c * khw;
        const int dh = r / KW;
        const int dw = r - dh * KW;
        v = x[a_base + (int64_t)c * hw_in + (int64_t)dh * W + dw];
      }
      a_reg[i] = v;
    }
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) {
      const int k = k0 + b_k;
      const int n = n0 + b_n + 16 * i;
      b_reg[i] = (k < K && n < N) ? w[(int64_t)n * K + k] : 0.f;
    }
  };

  load_chunk(0);
  for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
    for (int i = 0; i < A_PER_THREAD; ++i) As[a_k + 4 * i][a_m] = a_reg[i];
#pragma unroll
    for (int i = 0; i < B_PER_THREAD; ++i) Bs[b_k][b_n + 16 * i] = b_reg[i];
    __syncthreads();
    if (k0 + BK < K) load_chunk(k0 + BK);  // in flight during the FMAs
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[kk][tx + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[kk][ty + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

  // Epilogue: scatter into (EA*EB, B, NB, HO, WO); neighbouring threads
  // hold neighbouring output pixels, so stores coalesce along ow.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t m = m0 + tx + 16 * i;
    if (m >= M) continue;
    const int64_t g = m / hw_out;
    const int64_t p = m - g * hw_out;
    const int64_t a = g / B;
    const int64_t b = g - a * B;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + ty + 16 * j;
      if (n >= N) continue;
      const int b2 = n / NB;
      const int o = n - b2 * NB;
      const int64_t slot = a * EB + b2;
      out[((slot * B + b) * NB + o) * hw_out + p] = acc[i][j];
    }
  }
}

}  // namespace

// x: (G, C, H, W) fp32, w: (EB*NB, C*KH*KW) fp32, out: (G/B*EB, B, NB, HO, WO)
// fp32, all contiguous, G = ell_a * B.  Returns the launch's cudaError_t.
extern "C" int coded_worker_f32(const void* x, const void* w, void* out,
                                long long C, long long H, long long W,
                                long long KH, long long KW, long long stride,
                                long long G, long long B, long long EB,
                                long long NB, void* stream) {
  const long long HO = (H - KH) / stride + 1;
  const long long WO = (W - KW) / stride + 1;
  const long long M = G * HO * WO;
  const long long N = EB * NB;
  const long long K = C * KH * KW;
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const dim3 grid((unsigned)((M + BM - 1) / BM), (unsigned)((N + BN - 1) / BN));
  coded_worker_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)w, (float*)out, (int)C, (int)H, (int)W,
      (int)KH, (int)KW, (int)stride, (int)HO, (int)WO, (int64_t)M, (int)N,
      (int)K, (int)B, (int)EB, (int)NB);
  return (int)cudaGetLastError();
}
