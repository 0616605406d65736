// K4: attention with an online softmax, causal or not, for fp32 and bf16
// operands.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/kernel.py:69, body _flash_kernel :24).
// The TPU kernel walks a (bh, q-block, kv-block) grid in order and carries
// the softmax state (m, l, acc) in VMEM scratch from one kv step to the
// next.  Blocks of a CUDA grid run in no order, so here the kv walk is a
// loop inside the block and the state lives in registers.
//
// Bound on an H100: at the LM prefill (36 query heads over 12 KV heads,
// S = 16, D = 64) the work is about 1.3 MFLOP over 0.3 MB, under 0.01 ms
// either way, so a launch is bound by latency: how many dependent steps
// one query row takes, and whether the card's SMs all have work.  The
// design follows from that:
//
//   * one block per (KV head, group of its query heads, tile of `rows`
//     query rows); the block stages K and V once in shared memory, in
//     chunks of 32 keys, for all the query heads it serves, with 16-byte
//     loads and no division (D is a template constant);
//   * one warp per (query head, query row) pair at a time (a warp takes
//     at most 4 pairs in turn, its state for each in registers); for the
//     scores lane j takes key j of the chunk (a 4-way fp32 dot product
//     over shared memory, q read as a broadcast, K rows padded so the 32
//     lanes hit 32 banks); warp shuffles give the chunk max and the sum
//     of p; for P.V each lane owns D/32 consecutive output elements and
//     walks the chunk's keys with p broadcast by a shuffle;
//   * every row stops at its causal limit, and a block stages keys only
//     up to its last row's limit;
//   * q is staged coalesced and the output row is written once, each lane
//     its D/32 consecutive elements, as acc / max(l, 1e-30);
//   * `flash_plan` (kernels/flash_attn/kernel.py) picks heads, rows and
//     warps so the prefill runs as hundreds of warps on all SMs; no array
//     of D floats lives in a thread, so D = 128 stays in registers.
//
// Precision: scores, m, l and acc in fp32 (expf, fmaf; no TF32, no fast
// math).  bf16 operands are widened exactly, so a score is the fp32 sum
// of exact products, as the TPU kernel's preferred_element_type=f32 dot;
// p is rounded to bf16 before P.V (the TPU kernel's p.astype(v.dtype))
// while l sums the fp32 p; the output is rounded to bf16 once.  Every sum
// runs in a fixed order (xor-butterfly shuffles give every lane the same
// bits), so a launch repeats bit for bit.
//
// GQA: query head bh reads KV head bh / rep (heads ordered h = g*rep + r
// as in the reference), so the caller never materialises repeated K/V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;           // keys a shared-memory chunk: one a lane
constexpr int MAX_WARPS = 16;       // warps a block
constexpr int PAIRS_A_WARP = 4;     // (head, row) pairs one warp takes in turn
constexpr int MAX_ROWS = 64;        // query rows a block
constexpr unsigned FULL = 0xffffffffu;

// (head, row) pairs a block: q of every pair is staged, and the block's
// shared memory (K chunk, V chunk, q) stays under the 48 KB static limit
constexpr int max_pairs(int d) { return 2048 / d < 64 ? 2048 / d : 64; }

__device__ __forceinline__ void load16(const float* src, float* dst) {
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
}

__device__ __forceinline__ void load16(const __nv_bfloat16* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  reinterpret_cast<float4*>(dst)[0] = make_float4(a.x, a.y, b.x, b.y);
  reinterpret_cast<float4*>(dst)[1] = make_float4(c.x, c.y, d.x, d.y);
}

// p as P.V takes it: fp32 as is, bf16 rounded to nearest even
__device__ __forceinline__ float p_for_pv(float p, float) { return p; }
__device__ __forceinline__ float p_for_pv(float p, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

template <int VEC>
__device__ __forceinline__ void store(float* dst, const float* x) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(x[0], x[1]);
  } else {
    dst[0] = x[0];
  }
}

template <int VEC>
__device__ __forceinline__ void store(__nv_bfloat16* dst, const float* x) {
  if constexpr (VEC == 4) {
    __nv_bfloat162 h[2] = {__floats2bfloat162_rn(x[0], x[1]),
                           __floats2bfloat162_rn(x[2], x[3])};
    *reinterpret_cast<uint2*>(dst) = *reinterpret_cast<const uint2*>(h);
  } else if constexpr (VEC == 2) {
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(x[0], x[1]);
  } else {
    dst[0] = __float2bfloat16_rn(x[0]);
  }
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// grid: (ceil(Sq / rows), BH / rep * groups); block: warps * 32 threads.
// A block serves query heads r0 .. r0 + heads - 1 of KV head kvh, and
// query rows q0 .. q0 + rows - 1 of each; pair p is head p >> rows_log2,
// row p & (rows - 1), and warp w takes pairs w, w + warps, ...
template <int D, typename T>
__global__ void __launch_bounds__(MAX_WARPS * 32, 1)
flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                  const T* __restrict__ v, T* __restrict__ out, int Sq,
                  int Sk, int rep, int heads, int groups, int rows_log2,
                  float scale, int causal) {
  constexpr int KS = D + 4;                // padded K row (floats)
  constexpr int VEC = D >= 32 ? D / 32 : 1;  // output elements a lane
  constexpr int E = 16 / (int)sizeof(T);   // elements a 16-byte load
  constexpr int LOADS = D / E;             // 16-byte loads a row
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // [CHUNK][KS]
  float* vs = ks + CHUNK * KS;                  // [CHUNK][D]
  float* qs = vs + CHUNK * D;                   // [heads * rows][D]

  const int rows = 1 << rows_log2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int kvh = blockIdx.y / groups;  // one division a block
  const int r0 = (blockIdx.y - kvh * groups) * heads;
  const int nheads = min(heads, rep - r0);
  const int q0 = blockIdx.x * rows;
  const int pairs = heads * rows;
  const int64_t bh0 = (int64_t)kvh * rep + r0;

  // stage q: a head's rows are contiguous, so neighbouring threads load
  // neighbouring 16 bytes
  for (int e = threadIdx.x; e < pairs * LOADS; e += blockDim.x) {
    const int p = e / LOADS, c = e % LOADS;
    const int r = p >> rows_log2, i = q0 + (p & (rows - 1));
    float* dst = qs + p * D + c * E;
    if (r < nheads && i < Sq) {
      load16(q + ((bh0 + r) * Sq + i) * D + c * E, dst);
    } else {
#pragma unroll
      for (int t = 0; t < E; ++t) dst[t] = 0.f;
    }
  }

  float m[PAIRS_A_WARP], l[PAIRS_A_WARP], acc[PAIRS_A_WARP][VEC];
#pragma unroll
  for (int pp = 0; pp < PAIRS_A_WARP; ++pp) {
    m[pp] = -INFINITY;
    l[pp] = 0.f;
#pragma unroll
    for (int t = 0; t < VEC; ++t) acc[pp][t] = 0.f;
  }

  // causal: no key after the block's last row is unmasked for any row
  const int k_end = causal ? min(Sk, min(Sq, q0 + rows)) : Sk;
  const T* kb = k + (int64_t)kvh * Sk * D;
  const T* vb = v + (int64_t)kvh * Sk * D;
  for (int k0 = 0; k0 < k_end; k0 += CHUNK) {
    const int nk = min(CHUNK, k_end - k0);
    __syncthreads();  // every warp is done with the previous chunk
    for (int e = threadIdx.x; e < nk * LOADS; e += blockDim.x) {
      const int j = e / LOADS, c = e % LOADS;
      load16(kb + (int64_t)(k0 + j) * D + c * E, ks + j * KS + c * E);
      load16(vb + (int64_t)(k0 + j) * D + c * E, vs + j * D + c * E);
    }
    __syncthreads();
#pragma unroll
    for (int pp = 0; pp < PAIRS_A_WARP; ++pp) {
      const int p = warp + pp * warps;
      const int r = p >> rows_log2, i = q0 + (p & (rows - 1));
      if (p >= pairs || r >= nheads || i >= Sq) continue;  // warp-uniform
      const int lim = causal ? min(i + 1, Sk) : Sk;  // keys row i sees
      const int n = min(nk, lim - k0);                // of this chunk
      if (n <= 0) continue;                           // row i is done
      float s = -INFINITY;
      if (lane < n) {
        const float4* qp = reinterpret_cast<const float4*>(qs + p * D);
        const float4* kp = reinterpret_cast<const float4*>(ks + lane * KS);
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
        for (int c = 0; c < D / 4; ++c) {
          const float4 x = qp[c], y = kp[c];
          a.x = fmaf(x.x, y.x, a.x);
          a.y = fmaf(x.y, y.y, a.y);
          a.z = fmaf(x.z, y.z, a.z);
          a.w = fmaf(x.w, y.w, a.w);
        }
        s = ((a.x + a.y) + (a.z + a.w)) * scale;
      }
      const float m_new = fmaxf(m[pp], warp_max(s));  // finite: key k0 is live
      const float corr = expf(m[pp] - m_new);          // 0 on the first chunk
      const float pr = expf(s - m_new);                // masked: expf(-inf) = 0
      l[pp] = l[pp] * corr + warp_sum(pr);
      const float pv = p_for_pv(pr, T());
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc[pp][t] *= corr;
      const float* vl = vs + lane * VEC;
      const bool owns = lane * VEC < D;
#pragma unroll 8
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(FULL, pv, j);
        if (owns) {
          float x[VEC];
          if constexpr (VEC == 4) {
            const float4 t4 = *reinterpret_cast<const float4*>(vl + j * D);
            x[0] = t4.x; x[1] = t4.y; x[2] = t4.z; x[3] = t4.w;
          } else if constexpr (VEC == 2) {
            const float2 t2 = *reinterpret_cast<const float2*>(vl + j * D);
            x[0] = t2.x; x[1] = t2.y;
          } else {
            x[0] = vl[j * D];
          }
#pragma unroll
          for (int t = 0; t < VEC; ++t) acc[pp][t] = fmaf(pj, x[t], acc[pp][t]);
        }
      }
      m[pp] = m_new;
    }
  }

#pragma unroll
  for (int pp = 0; pp < PAIRS_A_WARP; ++pp) {
    const int p = warp + pp * warps;
    const int r = p >> rows_log2, i = q0 + (p & (rows - 1));
    if (p >= pairs || r >= nheads || i >= Sq || lane * VEC >= D) continue;
    const float den = fmaxf(l[pp], 1e-30f);
    float o[VEC];
#pragma unroll
    for (int t = 0; t < VEC; ++t) o[t] = acc[pp][t] / den;
    store<VEC>(out + ((bh0 + r) * Sq + i) * D + lane * VEC, o);
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* out,
           long long BH, long long Sq, long long Sk, long long rep,
           float scale, int causal, int heads, int rows_log2, int warps,
           cudaStream_t stream) {
  const long long groups = (rep + heads - 1) / heads;
  const long long rows = 1LL << rows_log2;
  const dim3 grid((unsigned)((Sq + rows - 1) / rows),
                  (unsigned)(BH / rep * groups));
  const size_t smem =
      sizeof(float) * (CHUNK * (D + 4) + CHUNK * D + heads * rows * D);
  flash_attn_kernel<D, T><<<grid, warps * 32, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, (int)Sq, (int)Sk,
      (int)rep, heads, (int)groups, rows_log2, scale, causal);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(long long D, const void* q, const void* k, const void* v,
             void* out, long long BH, long long Sq, long long Sk,
             long long rep, float scale, int causal, int heads,
             int rows_log2, int warps, cudaStream_t s) {
  switch (D) {
    case 16: return launch<16, T>(q, k, v, out, BH, Sq, Sk, rep, scale, causal, heads, rows_log2, warps, s);
    case 32: return launch<32, T>(q, k, v, out, BH, Sq, Sk, rep, scale, causal, heads, rows_log2, warps, s);
    case 64: return launch<64, T>(q, k, v, out, BH, Sq, Sk, rep, scale, causal, heads, rows_log2, warps, s);
    case 128: return launch<128, T>(q, k, v, out, BH, Sq, Sk, rep, scale, causal, heads, rows_log2, warps, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q: (BH, Sq, D), k/v: (BH / rep, Sk, D), out: (BH, Sq, D); row-major,
// contiguous, 16-byte aligned; fp32 (bf16 = 0) or bf16 (bf16 = 1);
// D in {16, 32, 64, 128}.  heads, rows and warps are flash_plan's:
// query heads of one KV head a block (1..rep), query rows a block (a
// power of two up to 64) and warps a block (1..16), with heads * rows at
// most 2048 / D (and 64) and at most 4 pairs a warp.  Returns the
// launch's cudaError_t (cudaErrorInvalidValue for what it does not take).
extern "C" int flash_attn(const void* q, const void* k, const void* v,
                          void* out, long long BH, long long Sq, long long Sk,
                          long long D, long long rep, float scale,
                          long long causal, long long bf16, long long heads,
                          long long rows, long long warps, void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || rep < 1 || BH % rep != 0 ||
      Sq > (1LL << 24) || Sk > (1LL << 24))
    return (int)cudaErrorInvalidValue;
  if (D != 16 && D != 32 && D != 64 && D != 128)
    return (int)cudaErrorInvalidValue;
  int rows_log2 = 0;
  while ((1LL << rows_log2) < rows) ++rows_log2;
  if (rows < 1 || rows > MAX_ROWS || (1LL << rows_log2) != rows ||
      heads < 1 || heads > rep || warps < 1 || warps > MAX_WARPS ||
      heads * rows > max_pairs((int)D) || heads * rows > warps * PAIRS_A_WARP)
    return (int)cudaErrorInvalidValue;
  if (BH / rep * ((rep + heads - 1) / heads) > 65535)  // grid.y
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  if (bf16)
    return dispatch<__nv_bfloat16>(D, q, k, v, out, BH, Sq, Sk, rep, scale,
                                   c, (int)heads, rows_log2, (int)warps, s);
  return dispatch<float>(D, q, k, v, out, BH, Sq, Sk, rep, scale, c,
                         (int)heads, rows_log2, (int)warps, s);
}
