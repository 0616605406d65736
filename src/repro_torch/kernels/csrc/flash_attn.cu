// K4: attention with an online softmax, causal or not, fp32 throughout.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/kernel.py:69, body _flash_kernel :24).
// The TPU kernel walks a (bh, q-block, kv-block) grid in order and carries
// the softmax state (m, l, acc) in VMEM scratch from one kv step to the
// next.  Blocks of a CUDA grid run in no order, so here the kv walk is a
// loop inside the block and the state lives in registers:
//
//   * one block per (bh, 64-query tile), one thread per query row; the
//     row's q (D floats) and its accumulator (D floats) stay in registers;
//   * K and V tiles of BK x D are staged in shared memory and read as
//     broadcasts (every thread reads the same key at the same time);
//   * each tile's scores go to a shared (BK, 64) scratch so the tile max
//     is taken before any exponential, then one rescale per tile;
//   * keys at index >= Sk, and with `causal` keys after the query's own
//     index, are masked (p = 0); a causal block stops at its last row;
//   * the output row is written once, as acc / max(l, 1e-30).
//
// GQA: query row bh reads K/V row bh / rep (rep query heads per KV head,
// heads ordered h = g*rep + r as in the reference), so the caller never
// materialises repeated K/V.  expf (not __expf) and fmaf only; no TF32.
//
// Bound on an H100: at the prefill shapes of the serving path (BH = 36,
// S <= 16, D = 64) the work is a few MFLOP over a few hundred KB, so a
// launch costs more than either; the kernel is latency-bound.  D = 128
// keeps 256 floats of state a thread and spills to local memory; it is
// accepted but not on this path.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;  // query rows a block = threads a block
constexpr int BK = 32;  // keys a shared-memory tile

template <int D>
__global__ void __launch_bounds__(BQ)
flash_attn_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int rep, float scale, int causal) {
  __shared__ float ks[BK][D];
  __shared__ float vs[BK][D];
  __shared__ float ss[BK][BQ];

  const int tid = threadIdx.x;
  const int64_t bh = blockIdx.y;
  const int64_t kvh = bh / rep;
  const int q0 = blockIdx.x * BQ;
  const int i = q0 + tid;  // this thread's query row
  const bool live = i < Sq;

  float qr[D];
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[(bh * Sq + i) * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = -INFINITY;
  float l = 0.f;

  // causal: no key after the block's last query row is ever unmasked
  const int k_end = causal ? min(Sk, q0 + BQ) : Sk;
  const float* kb = k + kvh * (int64_t)Sk * D;
  const float* vb = v + kvh * (int64_t)Sk * D;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    for (int e = tid; e < BK * D; e += BQ) {
      const int j = e / D;
      const bool ok = k0 + j < Sk;
      ks[j][e % D] = ok ? kb[(int64_t)k0 * D + e] : 0.f;
      vs[j][e % D] = ok ? vb[(int64_t)k0 * D + e] : 0.f;
    }
    __syncthreads();
    float tile_max = -INFINITY;
    for (int j = 0; j < BK; ++j) {
      const int kj = k0 + j;
      float s = -INFINITY;
      if (live && kj < Sk && (!causal || kj <= i)) {
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D; ++d) dot = fmaf(qr[d], ks[j][d], dot);
        s = dot * scale;
        tile_max = fmaxf(tile_max, s);
      }
      ss[j][tid] = s;
    }
    const float m_new = fmaxf(m, tile_max);
    if (m_new != -INFINITY) {  // at least one live key so far
      const float corr = expf(m - m_new);  // 0 on the first live tile
      l *= corr;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] *= corr;
      for (int j = 0; j < BK; ++j) {
        const float p = expf(ss[j][tid] - m_new);  // masked: expf(-inf) = 0
        l += p;
#pragma unroll
        for (int d = 0; d < D; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
      }
      m = m_new;
    }
    __syncthreads();
  }
  if (!live) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
  float* o = out + (bh * Sq + i) * D;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = acc[d] * inv;
}

template <int D>
int launch(const float* q, const float* k, const float* v, float* out,
           long long BH, long long Sq, long long Sk, long long rep,
           float scale, int causal, cudaStream_t stream) {
  const dim3 grid((unsigned)((Sq + BQ - 1) / BQ), (unsigned)BH);
  flash_attn_kernel<D><<<grid, BQ, 0, stream>>>(
      q, k, v, out, (int)Sq, (int)Sk, (int)rep, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// q: (BH, Sq, D), k/v: (BH / rep, Sk, D), out: (BH, Sq, D); fp32,
// row-major, contiguous; D in {16, 32, 64, 128}.  Returns the launch's
// cudaError_t (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int flash_attn_f32(const void* q, const void* k, const void* v,
                              void* out, long long BH, long long Sq,
                              long long Sk, long long D, long long rep,
                              float scale, long long causal, void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || rep < 1 || BH > 65535)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return (int)cudaSuccess;
  const float* pq = (const float*)q;
  const float* pk = (const float*)k;
  const float* pv = (const float*)v;
  float* po = (float*)out;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16: return launch<16>(pq, pk, pv, po, BH, Sq, Sk, rep, scale, c, s);
    case 32: return launch<32>(pq, pk, pv, po, BH, Sq, Sk, rep, scale, c, s);
    case 64: return launch<64>(pq, pk, pv, po, BH, Sq, Sk, rep, scale, c, s);
    case 128: return launch<128>(pq, pk, pv, po, BH, Sq, Sk, rep, scale, c, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
