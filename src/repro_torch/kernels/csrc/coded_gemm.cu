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
// at build time, 576-3072 a decode round on the SmolLM-135M path), so the
// work is 2*R_out*R_in*F FLOPs against 4*(R_in + R_out)*F bytes: about
// one FLOP a byte, far below the card's ridge point.  The kernel is bound
// by device memory (3.35 TB/s on an H100) at build-time widths and by
// latency at decode widths, where a launch moves a few tens of KB.  The
// design follows:
//
//   * the code matrix is born on the host and travels to the kernel by
//     value, as a __grid_constant__ parameter of RO x RI floats (R_out and
//     R_in rounded up to 4, 8 or 16: 64 bytes at the 4 x 4 decode, 1 KB at
//     most, so the launch copies little): every thread reads it from the
//     constant bank, so there is no load of it from device memory, no
//     shared-memory staging and no barrier;
//   * each thread owns VEC consecutive feature columns (VEC = 4, one
//     float4 a row, at build-time widths; VEC = 1 at decode widths, so
//     a launch spreads over tens of blocks) and issues all R_in loads of
//     its columns before its first FMA: one memory latency a thread;
//   * each output row sums over R_in in order with fmaf, so every element
//     of feats is read from device memory once and every output element
//     written once, coalesced along F, the same bits every launch.
//
// `coded_gemm_plan` (kernels/coded_gemm/kernel.py) picks VEC and the
// threads a block.  No TF32: the decode multiplies rounding error by
// cond(E).
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int R_MAX = 16;

template <int RO, int RI>
struct CodeMatrix {
  float c[RO][RI];  // row o, column c; zero outside (R_out, R_in)
};

template <int RO, int RI, int VEC>
__global__ void coded_gemm_kernel(const __grid_constant__ CodeMatrix<RO, RI> code,
                                  const float* __restrict__ feats,
                                  float* __restrict__ out, int R_out,
                                  int R_in, int64_t F) {
  const int64_t col = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if (col >= F) return;
  float x[RI][VEC];
#pragma unroll
  for (int c = 0; c < RI; ++c) {  // every load in flight before any FMA
    if (c < R_in) {
      const float* row = feats + (int64_t)c * F + col;
      if constexpr (VEC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(row);
        x[c][0] = t.x; x[c][1] = t.y; x[c][2] = t.z; x[c][3] = t.w;
      } else {
        x[c][0] = row[0];
      }
    }
  }
#pragma unroll
  for (int o = 0; o < RO; ++o) {  // unrolled: code.c is read at fixed offsets
    if (o >= R_out) break;
    float acc[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[t] = 0.f;
#pragma unroll
    for (int c = 0; c < RI; ++c) {
      if (c < R_in) {
        const float w = code.c[o][c];
#pragma unroll
        for (int t = 0; t < VEC; ++t) acc[t] = fmaf(w, x[c][t], acc[t]);
      }
    }
    float* dst = out + (int64_t)o * F + col;
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
    } else {
      dst[0] = acc[0];
    }
  }
}

template <int RO, int RI>
int launch(const float* host, const float* feats, float* out, int R_out,
           int R_in, int64_t F, int vec, int threads, cudaStream_t stream) {
  CodeMatrix<RO, RI> code;
  memset(&code, 0, sizeof(code));
  for (int o = 0; o < R_out; ++o)
    for (int c = 0; c < R_in; ++c) code.c[o][c] = host[o * R_in + c];
  const int64_t cols = (F + vec - 1) / vec;
  const dim3 grid((unsigned)((cols + threads - 1) / threads));
  if (vec == 4)
    coded_gemm_kernel<RO, RI, 4><<<grid, threads, 0, stream>>>(code, feats, out, R_out, R_in, F);
  else
    coded_gemm_kernel<RO, RI, 1><<<grid, threads, 0, stream>>>(code, feats, out, R_out, R_in, F);
  return (int)cudaGetLastError();
}

template <int RO>
int launch_ri(const float* host, const float* feats, float* out, int R_out,
              int R_in, int64_t F, int vec, int threads, cudaStream_t s) {
  if (R_in <= 4) return launch<RO, 4>(host, feats, out, R_out, R_in, F, vec, threads, s);
  if (R_in <= 8) return launch<RO, 8>(host, feats, out, R_out, R_in, F, vec, threads, s);
  return launch<RO, 16>(host, feats, out, R_out, R_in, F, vec, threads, s);
}

}  // namespace

// code: (R_out, R_in) fp32 row-major in HOST memory, copied into the
// launch's parameters before this returns; feats: (R_in, F) and out:
// (R_out, F) fp32 row-major contiguous on the device; 1 <= R_out, R_in
// <= 16.  vec (1, or 4 with F % 4 == 0 and both device pointers 16-byte
// aligned) and threads (32, 64, 128 or 256) are coded_gemm_plan's.
// Returns the launch's cudaError_t (cudaErrorInvalidValue for what the
// kernel does not take).
extern "C" int coded_gemm_f32(const void* code, const void* feats, void* out,
                              long long R_out, long long R_in, long long F,
                              long long vec, long long threads, void* stream) {
  if (R_out < 1 || R_in < 1 || R_out > R_MAX || R_in > R_MAX || F < 0 ||
      code == nullptr)
    return (int)cudaErrorInvalidValue;
  if (threads != 32 && threads != 64 && threads != 128 && threads != 256)
    return (int)cudaErrorInvalidValue;
  if (vec != 1 && !(vec == 4 && F % 4 == 0 &&
                    (((uintptr_t)feats | (uintptr_t)out) % 16) == 0))
    return (int)cudaErrorInvalidValue;
  if ((F + vec - 1) / vec / threads >= (1LL << 31))  // grid.x
    return (int)cudaErrorInvalidValue;
  if (F == 0) return (int)cudaSuccess;
  const float* host = (const float*)code;
  const float* pf = (const float*)feats;
  float* po = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int ro = (int)R_out, ri = (int)R_in, v = (int)vec, t = (int)threads;
  if (R_out <= 4) return launch_ri<4>(host, pf, po, ro, ri, F, v, t, s);
  if (R_out <= 8) return launch_ri<8>(host, pf, po, ro, ri, F, v, t, s);
  return launch_ri<16>(host, pf, po, ro, ri, F, v, t, s);
}
