// K3: the CRME coded GEMM, out = code @ feats in IEEE fp32.
//
// Replaces the TPU kernels coded_gemm_pallas_legacy
// (src/repro/kernels/coded_gemm/kernel.py:57, body _coded_kernel) and
// coded_gemm_pallas (:27, which delegates to matmul_pallas); the reference
// proves the two bit-equal, so one kernel is the counterpart of both.
// Both NSCTC phases are this product: the encode
// matrix^T (ell*n, k) @ parts (k, F) and the decode
// inv(E^T) (Q, Q) @ coded rows (Q, F).
//
// code is tiny (R_out, R_in <= 16) and feats is wide (F up to millions
// at build time, 144-3072 a decode round on the SmolLM-135M path), so the
// work is 2*R_out*R_in*F FLOPs against 4*(R_in + R_out)*F bytes: about
// one FLOP a byte, far below the card's ridge point.  The kernel is bound
// by device memory (3.35 TB/s on an H100) at build-time widths and by
// launch latency at decode widths.  The design follows: the whole code
// matrix sits in shared memory and is read as broadcasts, each thread owns
// VEC consecutive feature columns (a float4 when F and the pointers
// allow), keeps all R_out accumulators in registers and sums over R_in in
// order with fmaf, so every element of feats is read from device memory
// exactly once and every output element written once, coalesced along F.
// No TF32: the decode multiplies rounding error by cond(E).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int R_MAX = 16;

template <int RO, int VEC>
__global__ void __launch_bounds__(THREADS)
coded_gemm_kernel(const float* __restrict__ code,
                  const float* __restrict__ feats, float* __restrict__ out,
                  int R_out, int R_in, int64_t F) {
  __shared__ float cs[R_MAX][R_MAX];
  for (int e = threadIdx.x; e < R_out * R_in; e += THREADS) {
    cs[e / R_in][e % R_in] = code[e];
  }
  __syncthreads();
  const int64_t col = ((int64_t)blockIdx.x * THREADS + threadIdx.x) * VEC;
  if (col >= F) return;

  float acc[RO][VEC];
#pragma unroll
  for (int o = 0; o < RO; ++o)
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[o][v] = 0.f;

  for (int c = 0; c < R_in; ++c) {
    float x[VEC];
    const float* row = feats + (int64_t)c * F + col;
    if constexpr (VEC == 4) {
      const float4 t = *reinterpret_cast<const float4*>(row);
      x[0] = t.x; x[1] = t.y; x[2] = t.z; x[3] = t.w;
    } else {
#pragma unroll
      for (int v = 0; v < VEC; ++v) x[v] = row[v];
    }
#pragma unroll
    for (int o = 0; o < RO; ++o) {
      if (o < R_out) {
        const float w = cs[o][c];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[o][v] = fmaf(w, x[v], acc[o][v]);
      }
    }
  }
#pragma unroll
  for (int o = 0; o < RO; ++o) {
    if (o < R_out) {
      float* dst = out + (int64_t)o * F + col;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[o][0], acc[o][1], acc[o][2], acc[o][3]);
      } else {
#pragma unroll
        for (int v = 0; v < VEC; ++v) dst[v] = acc[o][v];
      }
    }
  }
}

template <int RO>
int launch(const float* code, const float* feats, float* out, int R_out,
           int R_in, int64_t F, bool vec4, cudaStream_t stream) {
  if (vec4) {
    const int64_t blocks = (F / 4 + THREADS - 1) / THREADS;
    coded_gemm_kernel<RO, 4><<<(unsigned)blocks, THREADS, 0, stream>>>(
        code, feats, out, R_out, R_in, F);
  } else {
    const int64_t blocks = (F + THREADS - 1) / THREADS;
    coded_gemm_kernel<RO, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(
        code, feats, out, R_out, R_in, F);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// code: (R_out, R_in), feats: (R_in, F), out: (R_out, F); fp32, row-major,
// contiguous; 1 <= R_out, R_in <= 16.  Returns the launch's cudaError_t
// (cudaErrorInvalidValue for sizes the kernel does not take).
extern "C" int coded_gemm_f32(const void* code, const void* feats, void* out,
                              long long R_out, long long R_in, long long F,
                              void* stream) {
  if (R_out < 1 || R_in < 1 || R_out > R_MAX || R_in > R_MAX || F < 0)
    return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  const float* pc = (const float*)code;
  const float* pf = (const float*)feats;
  float* po = (float*)out;
  const bool vec4 = F % 4 == 0 && ((uintptr_t)pf % 16) == 0 &&
                    ((uintptr_t)po % 16) == 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int ro = (int)R_out, ri = (int)R_in;
  if (R_out <= 4) return launch<4>(pc, pf, po, ro, ri, F, vec4, s);
  if (R_out <= 8) return launch<8>(pc, pf, po, ro, ri, F, vec4, s);
  return launch<16>(pc, pf, po, ro, ri, F, vec4, s);
}
