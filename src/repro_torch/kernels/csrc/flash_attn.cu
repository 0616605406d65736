// K4: attention with an online softmax, causal or not, for fp32 and bf16
// operands.
//
// Replaces the TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attn/kernel.py:69, body _flash_kernel :24).
// The TPU kernel walks a (bh, q-block, kv-block) grid in order and carries
// the softmax state (m, l, acc) in VMEM scratch from one kv step to the
// next.  Blocks of a CUDA grid run in no order, so here the kv walk is a
// loop inside the block and the state lives in registers.  Two routes
// compute the same function; `flash_plan` (kernels/flash_attn/kernel.py)
// picks one from the number of query rows.
//
// The rows route (entry point flash_attn), for short prompts.  At the LM
// prefill (36 query heads over 12 KV heads, S = 16, D = 64) the work is
// about 1.3 MFLOP over 0.3 MB, under 0.01 ms either way, so a launch is
// bound by latency: how many dependent steps one query row takes, and
// whether the card's SMs all have work.  So:
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
//     its D/32 consecutive elements, as acc / max(l, 1e-30).
//
// The tiled route (entry point flash_attn_tiled), for long sequences.  At
// the Qwen3-4B prefill of 2 x 2,048 tokens (64 query heads over 16 KV
// heads, D = 128) the work is 6.9e10 FLOP over 84 MB: 0.07 ms at the bf16
// tensor-core peak against 0.025 ms of HBM traffic, so the launch is bound
// by operations, and the rows route (every block re-reading every key for
// 16 (head, row) pairs, bf16 widened to FFMA) took 115x its bound.  So:
//
//   * one block per (query head, tile of 64 query rows), 64-key tiles
//     walked in a loop; K and V tiles are double-buffered in (dynamic)
//     shared memory with cp.async, the next tile loading while this one
//     is multiplied; rows are padded by 16 bytes so no load conflicts;
//   * bf16: four warps of 16 query rows each; q stays in registers as
//     mma A fragments (ldmatrix), Q.K^T and P.V run on the tensor cores
//     (mma.sync m16n8k16, fp32 accumulators), K fragments by ldmatrix and
//     V fragments by ldmatrix.trans; the score accumulators are reused in
//     place as P.V's A fragments; row max and sum need only the 4 lanes
//     of a quad;
//   * fp32: eight warps, each thread a 4 x 4 block of scores (4 rows, 4
//     keys 16 apart) and a 4 x D/16 block of the output, IEEE FFMA over
//     float4 reads of shared memory; p goes through shared memory to the
//     threads that own its rows' outputs;
//   * causal: key tiles above a block's last row are never loaded, only
//     tiles that cross a warp's rows are masked, and the grid issues the
//     longest query tiles (the bottom of the triangle) first so the
//     triangle balances over the SMs;
//   * the output is written with 16-byte stores (bf16 through the warp's
//     own q rows in shared memory).
//
// Precision, both routes: scores, m, l and acc in fp32 (fmaf; no TF32, no
// fast math).  p = expf(s - m), except in the tiled bf16 kernel: exp2f(x -
// m) of scores x with log2(e) folded into the scale, one rounding more and
// far inside p's bf16 rounding.  bf16 products are exact in fp32, so a
// score is the fp32 sum of exact products, as the TPU kernel's
// preferred_element_type=f32 dot (the tensor cores add them with fp32
// accumulators); p is rounded to bf16 before P.V (the TPU kernel's
// p.astype(v.dtype)) while l sums the fp32 p; the output is rounded to bf16
// once.  Every sum runs in a fixed order (xor-butterfly shuffles give every
// lane the same bits; no atomics, no split over keys across blocks), so a
// launch repeats bit for bit.
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

// -- tiled route ------------------------------------------------------------
constexpr int TQ = 64;  // query rows a block
constexpr int TK = 64;  // keys a tile
constexpr int TILED_BF16_THREADS = 128;  // four warps of 16 query rows
constexpr int TILED_F32_THREADS = 256;   // 16 x 16 threads of 4 x 4 scores

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, asynchronously; zero-filled where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// c += a (16 x 16, row) . b (16 x 8, col): bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The block's query head and tile: a flat grid of BH * ceil(Sq / TQ)
// blocks, heads fastest; causal, the last (longest) query tiles first.
struct TileCoords {
  int bh, q0;
};

__device__ __forceinline__ TileCoords tile_coords(int BH, int Sq, int causal) {
  const int nq = (Sq + TQ - 1) / TQ;
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  int qt = (int)(blockIdx.x / (unsigned)BH);
  if (causal) qt = nq - 1 - qt;
  return {bh, qt * TQ};
}

// stage rows r0 .. r0 + rows - 1 of a (S, D) operand into a [rows][LD]
// tile, 16 bytes a thread at a time; rows past S are zero-filled
template <int D, int LD, int THREADS, typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int r0, int rows,
                                           int S) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int CH = D / E;  // 16-byte chunks a row
  for (int e = threadIdx.x; e < rows * CH; e += THREADS) {
    const int r = e / CH, c = e - (e / CH) * CH;
    const bool ok = r0 + r < S;
    cp_async16(dst + r * LD + c * E, src + (int64_t)(ok ? r0 + r : 0) * D + c * E,
               ok);
  }
}

// bf16 on the tensor cores.  Warp w owns query rows q0 + 16w .. q0 + 16w +
// 15; in mma's accumulator layout lane (g = lane / 4, t = lane % 4) holds
// rows g and g + 8 and, of each 8-column n-tile, columns 2t and 2t + 1.
template <int D>
__global__ void __launch_bounds__(TILED_BF16_THREADS)
flash_tiled_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ out, int BH, int Sq, int Sk,
                        int rep, float scale, int causal) {
  constexpr int LD = D + 8;  // padded row (bf16): rows 16 bytes apart mod 128
  constexpr int CH = D / 8;  // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [TQ][LD]
  __nv_bfloat16* ks = qs + TQ * LD;                             // [2][TK][LD]
  __nv_bfloat16* vs = ks + 2 * TK * LD;                         // [2][TK][LD]

  const TileCoords tc = tile_coords(BH, Sq, causal);
  const int q0 = tc.q0;
  const int kvh = tc.bh / rep;
  const __nv_bfloat16* qg = q + (int64_t)tc.bh * Sq * D;
  const __nv_bfloat16* kg = k + (int64_t)kvh * Sk * D;
  const __nv_bfloat16* vg = v + (int64_t)kvh * Sk * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wrow = warp * 16;
  const int row0 = q0 + wrow + g, row1 = row0 + 8;

  // causal: no key after the block's last row is unmasked for any row
  const int k_end = causal ? min(Sk, min(Sq, q0 + TQ)) : Sk;
  const int ntiles = (k_end + TK - 1) / TK;
  // scores in units of log2: log2(e) folded into the scale, p = 2^(x - m)
  const float sc = scale * 1.4426950408889634f;

  stage_tile<D, LD, TILED_BF16_THREADS>(qs, qg, q0, TQ, Sq);
  stage_tile<D, LD, TILED_BF16_THREADS>(ks, kg, 0, TK, Sk);
  stage_tile<D, LD, TILED_BF16_THREADS>(vs, vg, 0, TK, Sk);
  cp_async_commit();

  uint32_t qf[D / 16][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {  // the next tile loads while this one is used
      stage_tile<D, LD, TILED_BF16_THREADS>(ks + (buf ^ 1) * TK * LD, kg,
                                            (t + 1) * TK, TK, Sk);
      stage_tile<D, LD, TILED_BF16_THREADS>(vs + (buf ^ 1) * TK * LD, vg,
                                            (t + 1) * TK, TK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], qs + (wrow + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + buf * TK * LD;
    const __nv_bfloat16* vt = vs + buf * TK * LD;

    // S = Q K^T: n-tile j holds keys 8j .. 8j + 7 of the tile
    float s[TK / 8][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < TK / 16; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // scale, mask, online softmax (rows row0 and row1 of this lane)
    const int k0 = t * TK;
    const bool edge = (causal && k0 + TK - 1 > q0 + wrow) || k0 + TK > Sk;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * sc;
        if (edge) {
          const int key = k0 + 8 * j + 2 * t4 + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (key >= Sk || (causal && key > row)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      corr[r] = exp2f(m[r] - mx[r]);  // 0 on the first tile (key 0 is live)
      m[r] = mx[r];
      l[r] *= corr[r];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }
    // p: fp32 into l, bf16 into P.V's A fragments (k-step kk covers keys
    // 16kk .. 16kk + 15: n-tiles 2kk and 2kk + 1)
    uint32_t pf[TK / 16][4];
#pragma unroll
    for (int j = 0; j < TK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - m[0]), p1 = exp2f(s[j][1] - m[0]);
      const float p2 = exp2f(s[j][2] - m[1]), p3 = exp2f(s[j][3] - m[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pf[j >> 1][(j & 1) * 2] = pack_bf16(p0, p1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
    }
    // O += P V
#pragma unroll
    for (int kk = 0; kk < TK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t b[4];
        ldsm_x4_trans(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             dp * 16 + (lane >> 4) * 8);
        mma_bf16(o[2 * dp], pf[kk], b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer
  }

  // l over the quad, then acc / max(l, 1e-30) rounded to bf16 once, staged
  // in the warp's own q rows and written 16 bytes a lane
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(FULL, l[r], 1);
    l[r] += __shfl_xor_sync(FULL, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  __nv_bfloat16* ws = qs + wrow * LD;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<__nv_bfloat162*>(ws + g * LD + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(o[n][0] / den[0], o[n][1] / den[0]);
    *reinterpret_cast<__nv_bfloat162*>(ws + (g + 8) * LD + n * 8 + 2 * t4) =
        __floats2bfloat162_rn(o[n][2] / den[1], o[n][3] / den[1]);
  }
  __syncwarp();
  __nv_bfloat16* og = out + (int64_t)tc.bh * Sq * D;
  for (int e = lane; e < 16 * CH; e += 32) {
    const int r = e / CH, c = e - (e / CH) * CH;
    const int i = q0 + wrow + r;
    if (i < Sq)
      *reinterpret_cast<uint4*>(og + (int64_t)i * D + c * 8) =
          *reinterpret_cast<const uint4*>(ws + r * LD + c * 8);
  }
}

// fp32 with IEEE FFMA.  Thread (ty, tx) = (tid / 16, tid % 16) owns query
// rows 4ty .. 4ty + 3 of the tile; of each key tile it scores keys tx +
// 16c (c < 4), and of the output it owns columns tx * VW + 16 * VW * c.
template <int D>
__global__ void __launch_bounds__(TILED_F32_THREADS, 1)
flash_tiled_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ out,
                       int BH, int Sq, int Sk, int rep, float scale, int causal) {
  constexpr int LD = D + 4;                // padded row (floats)
  constexpr int PL = TQ + 4;               // p's padded row: [key][query row]
  constexpr int VW = D >= 64 ? 4 : D / 16;  // output columns a vector
  constexpr int OV = D / (16 * VW);        // output vectors a thread
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [TQ][LD]
  float* ks = qs + TQ * LD;                     // [2][TK][LD]
  float* vs = ks + 2 * TK * LD;                 // [2][TK][LD]
  float* ps = vs + 2 * TK * LD;                 // [TK][PL]

  const TileCoords tc = tile_coords(BH, Sq, causal);
  const int q0 = tc.q0;
  const int kvh = tc.bh / rep;
  const float* qg = q + (int64_t)tc.bh * Sq * D;
  const float* kg = k + (int64_t)kvh * Sk * D;
  const float* vg = v + (int64_t)kvh * Sk * D;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int rlo = q0 + 4 * ty;  // this thread's first query row

  const int k_end = causal ? min(Sk, min(Sq, q0 + TQ)) : Sk;
  const int ntiles = (k_end + TK - 1) / TK;

  stage_tile<D, LD, TILED_F32_THREADS>(qs, qg, q0, TQ, Sq);
  stage_tile<D, LD, TILED_F32_THREADS>(ks, kg, 0, TK, Sk);
  stage_tile<D, LD, TILED_F32_THREADS>(vs, vg, 0, TK, Sk);
  cp_async_commit();

  float o[4][OV * VW];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < OV * VW; ++c) o[r][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < ntiles) {
      stage_tile<D, LD, TILED_F32_THREADS>(ks + (buf ^ 1) * TK * LD, kg,
                                           (t + 1) * TK, TK, Sk);
      stage_tile<D, LD, TILED_F32_THREADS>(vs + (buf ^ 1) * TK * LD, vg,
                                           (t + 1) * TK, TK, Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* kt = ks + buf * TK * LD;
    const float* vt = vs + buf * TK * LD;

    // 4 x 4 scores, each an fp32 sum over d in order
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qv[r] = *reinterpret_cast<const float4*>(qs + (4 * ty + r) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(kt + (tx + 16 * c) * LD + d);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = s[r][c];
          a = fmaf(qv[r].x, kv[c].x, a);
          a = fmaf(qv[r].y, kv[c].y, a);
          a = fmaf(qv[r].z, kv[c].z, a);
          a = fmaf(qv[r].w, kv[c].w, a);
          s[r][c] = a;
        }
    }

    const int k0 = t * TK;
    const bool edge = (causal && k0 + TK - 1 > rlo) || k0 + TK > Sk;
    float corr[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float mx = m[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[r][c] * scale;
        if (edge) {
          const int key = k0 + tx + 16 * c;
          if (key >= Sk || (causal && key > rlo + r)) x = -INFINITY;
        }
        s[r][c] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)  // the 16 lanes of this ty
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, off));
      corr[r] = expf(m[r] - mx);  // 0 on the first tile (key 0 is live)
      m[r] = mx;
      l[r] *= corr[r];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = expf(s[r][c] - mx);
        l[r] += s[r][c];
      }
#pragma unroll
      for (int c = 0; c < OV * VW; ++c) o[r][c] *= corr[r];
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(ps + (tx + 16 * c) * PL + 4 * ty) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    __syncthreads();

    // O += P V over the tile's keys in order
#pragma unroll 4
    for (int j = 0; j < TK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ps + j * PL + 4 * ty);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < OV; ++c) {
        float x[VW];
        const float* vp = vt + j * LD + (tx + 16 * c) * VW;
        if constexpr (VW == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vp);
          x[0] = t4.x; x[1] = t4.y; x[2] = t4.z; x[3] = t4.w;
        } else if constexpr (VW == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vp);
          x[0] = t2.x; x[1] = t2.y;
        } else {
          x[0] = vp[0];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int w = 0; w < VW; ++w)
            o[r][c * VW + w] = fmaf(pr[r], x[w], o[r][c * VW + w]);
      }
    }
    __syncthreads();  // p and this buffer are free again
  }

  float* og = out + (int64_t)tc.bh * Sq * D;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float lr = l[r];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) lr += __shfl_xor_sync(FULL, lr, off);
    const int i = rlo + r;
    if (i >= Sq) continue;
    const float den = fmaxf(lr, 1e-30f);
#pragma unroll
    for (int c = 0; c < OV; ++c) {
      float x[VW];
#pragma unroll
      for (int w = 0; w < VW; ++w) x[w] = o[r][c * VW + w] / den;
      store<VW>(og + (int64_t)i * D + (tx + 16 * c) * VW, x);
    }
  }
}

template <int D>
int launch_tiled_bf16(const void* q, const void* k, const void* v, void* out,
                      long long BH, long long Sq, long long Sk, long long rep,
                      float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(TQ + 4 * TK) * (D + 8);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tiled_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned blocks = (unsigned)(BH * ((Sq + TQ - 1) / TQ));
  flash_tiled_bf16_kernel<D><<<blocks, TILED_BF16_THREADS, smem, stream>>>(
          (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
          (const __nv_bfloat16*)v, (__nv_bfloat16*)out, (int)BH, (int)Sq,
          (int)Sk, (int)rep, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tiled_f32(const void* q, const void* k, const void* v, void* out,
                     long long BH, long long Sq, long long Sk, long long rep,
                     float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(float) * ((size_t)(TQ + 4 * TK) * (D + 4) +
                                           (size_t)TK * (TQ + 4));
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tiled_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned blocks = (unsigned)(BH * ((Sq + TQ - 1) / TQ));
  flash_tiled_f32_kernel<D><<<blocks, TILED_F32_THREADS, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, (int)BH,
      (int)Sq, (int)Sk, (int)rep, scale, causal);
  return (int)cudaGetLastError();
}

template <int D>
int launch_tiled(const void* q, const void* k, const void* v, void* out,
                 long long BH, long long Sq, long long Sk, long long rep,
                 float scale, int causal, int bf16, cudaStream_t stream) {
  if (bf16)
    return launch_tiled_bf16<D>(q, k, v, out, BH, Sq, Sk, rep, scale, causal,
                                stream);
  return launch_tiled_f32<D>(q, k, v, out, BH, Sq, Sk, rep, scale, causal, stream);
}

}  // namespace

// The rows route: q: (BH, Sq, D), k/v: (BH / rep, Sk, D), out: (BH, Sq,
// D); row-major, contiguous, 16-byte aligned; fp32 (bf16 = 0) or bf16
// (bf16 = 1); D in {16, 32, 64, 128}.  heads, rows and warps are flash_plan's:
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

// The tiled route: the rows route's arguments, of which the launch shape
// is the kernel's own: one block per (query head, 64 query rows), so heads
// = 1 and rows = 64, with warps = 4 for bf16 and 8 for fp32 (flash_plan's
// tiled plan, checked here so that the plan is what launches);
// BH * ceil(Sq / 64) blocks, at most 2^31 - 1.
extern "C" int flash_attn_tiled(const void* q, const void* k, const void* v,
                                void* out, long long BH, long long Sq,
                                long long Sk, long long D, long long rep,
                                float scale, long long causal, long long bf16,
                                long long heads, long long rows, long long warps,
                                void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || rep < 1 || BH % rep != 0 ||
      Sq > (1LL << 24) || Sk > (1LL << 24) || BH > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  if (heads != 1 || rows != TQ ||
      warps * 32 != (bf16 ? TILED_BF16_THREADS : TILED_F32_THREADS))
    return (int)cudaErrorInvalidValue;
  if (BH * ((Sq + TQ - 1) / TQ) > (1LL << 31) - 1)  // grid.x
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal ? 1 : 0, b = bf16 ? 1 : 0;
  switch (D) {
    case 16: return launch_tiled<16>(q, k, v, out, BH, Sq, Sk, rep, scale, c, b, s);
    case 32: return launch_tiled<32>(q, k, v, out, BH, Sq, Sk, rep, scale, c, b, s);
    case 64: return launch_tiled<64>(q, k, v, out, BH, Sq, Sk, rep, scale, c, b, s);
    case 128: return launch_tiled<128>(q, k, v, out, BH, Sq, Sk, rep, scale, c, b, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
