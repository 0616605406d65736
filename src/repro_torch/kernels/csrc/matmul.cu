// K2: out = a @ b in IEEE fp32, with an optional ReLU epilogue.
//
// Replaces the TPU kernel matmul_pallas (src/repro/kernels/matmul/kernel.py
// :111; bodies _matmul_kernel :34 and _matmul_stream_kernel :53) where the
// coded transition uses it: the decode GEMM d (Q, Q) @ rows (Q, F) with
// the ReLU fused into the store, and the re-encode GEMM
// m_next^T (L, k_a') @ parts (k_a', F').  Both are skinny — M and K are a
// handful (Q = 8, L = 16, k_a' = 2 for VGG-16 on n = 8 workers) while F
// runs to millions — so the work is 2*M*K/(4*(K+M)) ~ 1 FLOP per byte
// moved: the kernel is bound by device memory (3.35 TB/s on an H100), not
// by arithmetic.  The design follows from that: every thread owns one
// output column and keeps BM accumulators in registers, the small A tile
// sits in shared memory (read as broadcasts), and each element of b is
// read from device memory exactly once per BM-row block of the output
// (once in total for M <= BM, which is every shape of the serving path),
// each output element written once.  Loads and stores are coalesced along
// the column axis.  Any M, N, K is accepted (K = 2 for the re-encode);
// rows beyond M and chunks beyond K are masked.  No TF32 anywhere: the CRME
// decode multiplies rounding error by the recovery matrix's condition
// number.  A general square GEMM would want a register-tiled kernel; none
// is on this path.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
int launch(const float* a, const float* b, float* out, long long M,
           long long N, long long K, int relu, cudaStream_t stream) {
  const dim3 grid((unsigned)((N + THREADS - 1) / THREADS),
                  (unsigned)((M + BM - 1) / BM));
  matmul_kernel<BM><<<grid, THREADS, 0, stream>>>(a, b, out, (int)M,
                                                  (int64_t)N, (int)K, relu);
  return (int)cudaGetLastError();
}

}  // namespace

// a: (M, K), b: (K, N), out: (M, N); fp32, row-major, contiguous.
// Returns the launch's cudaError_t.
extern "C" int matmul_f32(const void* a, const void* b, void* out,
                          long long M, long long N, long long K,
                          long long relu, void* stream) {
  if (M <= 0 || N <= 0) return (int)cudaSuccess;
  const float* pa = (const float*)a;
  const float* pb = (const float*)b;
  float* po = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  if (M <= 8) return launch<8>(pa, pb, po, M, N, K, (int)relu, s);
  return launch<16>(pa, pb, po, M, N, K, (int)relu, s);
}
