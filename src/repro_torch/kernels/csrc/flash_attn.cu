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
// picks one from the query rows, the keys and the query heads a KV head.
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
// 16 (head, row) pairs, bf16 widened to FFMA) took 115x its bound.  Four
// kernels; the launch shape and the operands' type name one (flash_plan's
// tiled plans).
//
//   * bf16 at D 64 and 128, the wgmma kernel (flash_tiled_bf16_kernel):
//     query tiles of (query head, 128 rows), walked longest first by a
//     persistent grid of one 384-thread block an SM.  Warpgroup 2 gives up
//     its registers (setmaxnreg) and two of its threads issue the TMA
//     copies: a tile's Q once and 128-key K tiles, and V tiles, each into
//     its own ring on full / empty mbarriers; tiles lie in shared memory as
//     TMA's 128-byte swizzle writes them (3-D tensor maps over (heads, S,
//     D), zero past S).  Warpgroups 0 and 1 own 64 rows each and take up
//     to 240 registers: S = Q.K^T by wgmma m64n128k16 with Q and K from
//     shared memory; the S accumulators, packed pairwise to bf16, are
//     P.V's register A operand, and V is read MN-major (the descriptor's
//     transpose), never transposed in memory.  Each loop step issues Q.K^T
//     of tile t and P.V of tile t - 1, then runs the softmax of tile t
//     while P.V(t - 1) runs; named barriers make the two warpgroups take
//     turns issuing, so one's softmax also runs under the other's GEMMs.
//     The output goes through a staging tile to a TMA store, while the
//     producer already loads the block's next tile.
//   * fp32 at D 64 and 128, the 3xTF32 wgmma kernel
//     (flash_tiled_tf32x3_kernel): bound by three TF32 products a
//     multiply-add on the tensor cores (495 / 3 TFLOP/s; 0.417 ms at the
//     Qwen3-4B prefill in fp32, against 1.026 ms at the FFMA peak).  The
//     same persistent grid of 128-row query tiles and three warpgroups,
//     64-key tiles.  A tf32 operand has no transpose bit, so both operands
//     of each GEMM are K-major: a pre-pass (flash_tiled_split_kv, once a
//     launch) writes K's and V^T's TF32 hi and lo parts into a scratch in
//     the swizzled layout the descriptors read, V^T's keys permuted within
//     each 8-key group so that the score accumulators are P.V's tf32 A
//     fragments as they lie; a K or V stage is one bulk copy (one stage of
//     each at D 128, 192 KB with Q, two at D 64).  Q arrives raw by TMA
//     and each k8 fragment is split in registers just before its wgmmas;
//     each warpgroup runs Q.K^T, the softmax and P.V of a key tile in turn
//     while the other's GEMMs keep the tensor cores busy.
//   * bf16, the mma.sync kernel (flash_tiled_bf16_mma_kernel; every D,
//     the route at D 16 and 32): one block per (query head, 64 query
//     rows), 64-key tiles double-buffered with cp.async, four warps of 16
//     query rows each; q stays in registers as mma A fragments (ldmatrix),
//     Q.K^T and P.V on mma.sync m16n8k16 with fp32 accumulators, K by
//     ldmatrix and V by ldmatrix.trans; the score accumulators are reused
//     in place as P.V's A fragments;
//   * fp32, the FFMA kernel (flash_tiled_f32_kernel; every D, the route at
//     D 16 and 32 and below the 3xTF32 kernel's row threshold): one block
//     per (query head, 64 query rows), 64-key tiles double-buffered with
//     cp.async, eight warps, each thread a 4 x 4 block of scores (4 rows, 4
//     keys 16 apart) and a 4 x D/16 block of the output, IEEE FFMA over
//     float4 reads of shared memory; p goes through shared memory to the
//     threads that own its rows' outputs;
//   * in all four, row max and sum need only the lanes that share a row;
//     causal: key tiles above a block's last row are never loaded (the
//     3xTF32 kernel also skips a warpgroup's tiles above its last row),
//     only tiles that cross a warpgroup's (warp's) rows are masked, and the
//     grid issues the longest query tiles (the bottom of the triangle)
//     first so the triangle balances over the SMs.
//
// Precision, both routes: scores, m, l and acc in fp32 (fmaf; no fast
// math).  p = expf(s - m), except in the tiled bf16 kernels: 2^(x -
// m) of scores x with log2(e) folded into the scale, one rounding more
// and far inside p's bf16 rounding, m the running max after each key tile
// (128 keys in the wgmma kernel, 64 in the mma.sync one; the wgmma kernel
// takes 2^x from ex2.approx.ftz, exp2f's result but flushed to 0 below
// 2^-126, the mma.sync one from exp2f).  bf16 products are exact in fp32, so a
// score is the fp32 sum of exact products, as the TPU kernel's
// preferred_element_type=f32 dot (the tensor cores add them with fp32
// accumulators); p is rounded to bf16 before P.V (the TPU kernel's
// p.astype(v.dtype)) while l sums the fp32 p; the output is rounded to bf16
// once.  The 3xTF32 kernel keeps the fp32 path's error: every fp32 operand
// (q, k, v, p) is split as a = hi + lo, hi = cvt.rna.tf32(a), lo =
// cvt.rna.tf32(a - hi) (kernels/tf32.py::split_tf32; hopper.cuh),
// and a product is lo.hi + hi.lo + hi.hi, about 2^-22 relative.  The
// tensor cores' own fp32 accumulation rounds against the running sum, so
// the small products of a chain go first, no chain of large products runs
// over more than 64 taps (Q.K^T at D 128 sums two chains in fp32), and each
// key tile's P.V sums into its own partial, then O = O * corr + partial in
// fp32.  Its error against float64 is held to 4x the fp32 plain version's
// (chip_smoke.K4_FP64_RATIO; PERF.md has the readings).  Every sum runs in
// a fixed order (xor-butterfly shuffles give every lane the same bits; no
// atomics, no split over keys across blocks), so a launch repeats bit for
// bit.
//
// GQA: query head bh reads KV head bh / rep (heads ordered h = g*rep + r
// as in the reference), so the caller never materialises repeated K/V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"  // mbarriers, TMA, wgmma descriptors and fences

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

// 16 bytes global -> shared, asynchronously; zero-filled where !full
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
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
               : "r"(smem_u32(p))
               : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
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
flash_tiled_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int BH, int Sq,
                            int Sk, int rep, float scale, int causal) {
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

// -- the persistent tiled kernels' shared pieces ------------------------------
// The query tile a persistent block takes: tiles of TQ_ rows are numbered
// heads fastest, and causal, the last (longest) query tiles first; ntiles
// counts the TK_-key tiles the query tile walks
struct Tile {
  int bh, q0, ntiles;
};

template <int TQ_, int TK_>
__device__ __forceinline__ Tile tile_at(int i, int BH, int Sq, int Sk, int causal) {
  const int nq = (Sq + TQ_ - 1) / TQ_;
  int qt = i / BH;
  if (causal) qt = nq - 1 - qt;
  const int q0 = qt * TQ_;
  // causal: no key after the tile's last row is unmasked for any row
  const int k_end = causal ? min(Sk, min(Sq, q0 + TQ_)) : Sk;
  return {i % BH, q0, (k_end + TK_ - 1) / TK_};
}

// cuTensorMapEncodeTiled from the driver, looked up once through the
// runtime (no link against libcuda)
typedef CUresult (*TensorMapEncodeTiled)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
    CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

TensorMapEncodeTiled tensor_map_encoder() {
  static const TensorMapEncodeTiled fn = []() -> TensorMapEncodeTiled {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                                  cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? (TensorMapEncodeTiled)f
               : nullptr;
  }();
  return fn;
}

// a (heads, S, D) operand of `width`-byte elements as a 3-D tensor map of
// boxes of 128 bytes of a row x `rows` rows with the 128-byte swizzle:
// rows past S read as zeros and are not written
bool tile_map(CUtensorMap* map, CUtensorMapDataType type, int width,
              const void* base, long long D, long long S, long long heads, int rows) {
  const TensorMapEncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)(D * width), (cuuint64_t)(S * D * width)};
  const cuuint32_t box[3] = {(cuuint32_t)(128 / width), (cuuint32_t)rows, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the card's SMs: a persistent grid's blocks
int num_sms() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// -- tiled route, bf16 on Hopper's wgmma ------------------------------------
// Query tiles of (query head, 128 rows), walked by a persistent grid of one
// block an SM: warpgroups 0 and 1 own 64 rows each and run the GEMMs and
// the softmax; in warpgroup 2 one thread issues the TMA copies of Q and K,
// another those of V.  A tile's Q is loaded once; 128-key K and V tiles
// stream through two rings on full / empty mbarriers, on across the
// block's tiles.  Every tile is held in shared memory as 64-column blocks
// of [rows][64 bf16] with the 128-byte swizzle, as TMA writes it and wgmma
// reads it.  K4_TRACE adds clock64 stamps (scripts/torch_k4_trace.py).
namespace wg {

constexpr int TQ = 128;          // query rows a block
constexpr int TK = 128;          // keys a tile (the TPU kernel's bk)
constexpr int THREADS = 384;     // warpgroups 0-1 consume, 2 loads
constexpr int BLOCK = 128 * 128;  // bytes of a [128 rows][64 bf16] block
constexpr int HALF = 64 * 128;   // a consumer's 64 rows of a Q block
// setmaxnreg: 24 * 128 + 240 * 256 <= 65,536 registers an SM
constexpr int LOAD_REGS = 24, MMA_REGS = 240;
// named barriers (0 is __syncthreads): TURN + w orders warpgroup w's GEMM
// issues against the other's; OWN + w is warpgroup w's own 128 threads
constexpr int TURN = 1, OWN = 3;

template <int D>
struct Cfg {
  static constexpr int CB = D / 64;                   // 64-column blocks a row
  static constexpr uint32_t TILE = CB * BLOCK;        // Q (128 rows) or a K/V tile
  // Q, the output tile, then the K and V rings
  static constexpr int KST = 2;            // K tiles in flight
  static constexpr int VST = 2;            // V tiles in flight
  static constexpr size_t BODY = (size_t)TILE * (2 + KST + VST);
  // 1024 bytes of slack to align the tiles to the swizzle's period, then
  // the barriers: Q's full and empty, and full and empty for each K and V
  // stage
  static constexpr size_t BYTES =
      1024 + BODY + (2 + 2 * KST + 2 * VST) * sizeof(uint64_t);
  static_assert(BYTES <= 232448, "a block's shared memory on an H100");
};

// wgmma descriptor of an MN-major B operand with the 128-byte swizzle (V
// as it lies, [keys][D]): 8-key groups 1024 bytes apart (stride byte
// offset), 64-column blocks BLOCK bytes apart (leading byte offset)
__device__ __forceinline__ uint64_t desc_sw128_mn(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)(BLOCK >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// 2^x by MUFU.EX2 alone: exp2f's result for every normal one (2 ulp), and
// 0 for results below 2^-126, which no bf16 output can tell from p's
// rounding (l >= 1 from the row's max)
__device__ __forceinline__ float exp2_(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void turn_wait(int me) { bar_sync(me, 256); }
__device__ __forceinline__ void turn_pass(int other) { bar_arrive(other, 256); }

// Step timing, compiled only with -DK4_TRACE: thread 0 of each consumer
// warpgroup of block 0 writes clock64() stamps of each step of each key
// tile of the block's first query tile to trace[(w * 256 + t) * 8 + step].
#ifdef K4_TRACE
__device__ long long* trace_buf = nullptr;
#define K4_STAMP(t, step)                                                  \
  do {                                                                     \
    if (trace && (t) < 256) trace[(w * 256 + (t)) * 8 + (step)] = clock64(); \
  } while (0)
#else
#define K4_STAMP(t, step) \
  do {                    \
  } while (0)
#endif

// D (64 x 128, fp32, registers) = A (64 x 16 bf16, K-major in shared memory)
// * B (128 x 16 bf16, K-major in shared memory)^T + (scale_d ? D : 0)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t desc_a,
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 128, fp32, registers) = A (64 x 16 bf16, registers) * B (16 x 128
// bf16, MN-major in shared memory: the descriptor's transpose) + (scale_d ?
// D : 0)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, fp32, registers) = A (64 x 16 bf16, registers) * B (16 x 64
// bf16, MN-major in shared memory: the descriptor's transpose) + (scale_d ?
// D : 0)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// S = Q K^T of the tile at `ka`: D / 16 k-steps of 16 columns, 32 bytes
// apart in a swizzled row, 64-column blocks BLOCK bytes apart
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[TK / 2], uint32_t qa,
                                         uint32_t ka) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * BLOCK + (kk & 3) * 32;
    wgmma_ss(s, desc_sw128(qa + off), desc_sw128(ka + off), kk > 0);
  }
}

// O += P V of the tile at `va` (O: D / 2 registers a thread): k-step kk
// takes keys 16kk .. 16kk + 15, two 8-key groups of 1024 bytes
template <int R>
__device__ __forceinline__ void issue_pv(float (&o)[R], const uint32_t (&p)[TK / 16][4],
                                         uint32_t va) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) wgmma_rs(o, p[kk], desc_sw128_mn(va + kk * 2048), 1);
}

// The online softmax over one tile's scores.  In wgmma's accumulator
// layout s[4j + e] is row row0 + 8 (e >> 1), key k0 + 8j + 2 t4 + (e & 1):
// a row's 128 scores lie in the 4 lanes of a quad.  Scores are scaled into
// units of log2, masked (an instance of its own, for the tiles that cross
// the diagonal or Sk), then replaced by p = 2^(x - m) against the new
// running max; l and corr as the mma.sync kernel's.  The fences at the end
// keep the compiler from sinking the work past the caller's next wgmma
// wait, which would take it out from under P.V.
template <bool EDGE>
__device__ __forceinline__ void online_softmax(float (&s)[TK / 2], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float sc, int k0, int t4, int row0,
                                               int Sk, int causal) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * sc;
      if constexpr (EDGE) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= Sk || (causal && key > row)) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    corr[r] = exp2_(m[r] - mx[r]);  // 0 on the first tile (a key is live)
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
    const float p0 = exp2_(s[4 * j] - m[0]), p1 = exp2_(s[4 * j + 1] - m[0]);
    const float p2 = exp2_(s[4 * j + 2] - m[1]), p3 = exp2_(s[4 * j + 3] - m[1]);
    l[0] += p0 + p1;
    l[1] += p2 + p3;
    s[4 * j] = p0;
    s[4 * j + 1] = p1;
    s[4 * j + 2] = p2;
    s[4 * j + 3] = p3;
  }
  fence_regs(s);
  fence_regs(l);
}

__device__ __forceinline__ void online_softmax(float (&s)[TK / 2], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float sc, bool edge, int k0,
                                               int t4, int row0, int Sk,
                                               int causal) {
  if (edge)
    online_softmax<true>(s, m, l, corr, sc, k0, t4, row0, Sk, causal);
  else
    online_softmax<false>(s, m, l, corr, sc, k0, t4, row0, Sk, causal);
}

// p rounded to bf16 as P.V's A fragments: wgmma's accumulator layout is
// its A layout, so k-step kk is n8 blocks 2kk (keys 2 t4, 2 t4 + 1) and
// 2kk + 1 (keys 8 + 2 t4, 9 + 2 t4), rows row0 and row0 + 8
__device__ __forceinline__ void pack_p(uint32_t (&p)[TK / 16][4],
                                       const float (&s)[TK / 2]) {
#pragma unroll
  for (int kk = 0; kk < TK / 16; ++kk) {
    p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
    p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
    p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
    p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
  }
}

// O *= corr, done before the caller's next fence (not moved in among its
// wgmma issues)
template <int R>
__device__ __forceinline__ void rescale(float (&o)[R], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    o[4 * j] *= corr[0];
    o[4 * j + 1] *= corr[0];
    o[4 * j + 2] *= corr[1];
    o[4 * j + 3] *= corr[1];
  }
  fence_regs(o);
}

// grid: one block an SM (at most BH * ceil(Sq / TQ)); block b takes query
// tiles b, b + gridDim.x, ..., so the longest go first, and loads the next
// tile's Q and K while it finishes the last one
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tiled_bf16_kernel(const __grid_constant__ CUtensorMap qmap,
                        const __grid_constant__ CUtensorMap kmap,
                        const __grid_constant__ CUtensorMap vmap,
                        const __grid_constant__ CUtensorMap omap, int BH, int Sq,
                        int Sk, int rep, float scale, int causal) {
  using Cf = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* qs = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* os = qs + Cf::TILE;  // the output tile, staged for its TMA store
  unsigned char* ks = os + Cf::TILE;
  unsigned char* vs = ks + Cf::KST * Cf::TILE;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(qs + Cf::BODY);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qempty + 1;
  uint64_t* kempty = kfull + Cf::KST;
  uint64_t* vfull = kempty + Cf::KST;
  uint64_t* vempty = vfull + Cf::VST;
  const int tiles = BH * ((Sq + TQ - 1) / TQ);
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qfull, 1);  // the producer's expect_tx, then the bytes
    mbar_init(qempty, 256);  // every consumer thread, past its last Q K^T
    for (int st = 0; st < Cf::KST; ++st) {
      mbar_init(&kfull[st], 1);
      mbar_init(&kempty[st], 256);
    }
    for (int st = 0; st < Cf::VST; ++st) {
      mbar_init(&vfull[st], 1);
      mbar_init(&vempty[st], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // -- producer: gives up registers; one thread issues Q and K copies,
    // another V copies, each waiting only on its own ring's releases.  The
    // rings run on across the block's query tiles (kv counts their tiles)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOAD_REGS));
    if (tid == 256 || tid == 288) {
      const bool is_k = tid == 256;
      const int nst = is_k ? Cf::KST : Cf::VST;
      uint64_t* fulls = is_k ? kfull : vfull;
      uint64_t* empties = is_k ? kempty : vempty;
      unsigned char* ring = is_k ? ks : vs;
      const CUtensorMap* map = is_k ? &kmap : &vmap;
      int kv = 0, n = 0;
      for (int i = blockIdx.x; i < tiles; i += gridDim.x, ++n) {
        const Tile tl = tile_at<TQ, TK>(i, BH, Sq, Sk, causal);
        const int kvh = tl.bh / rep;
        if (is_k) {
          if (n > 0) mbar_wait(qempty, (n - 1) & 1);
          mbar_expect_tx(qfull, Cf::TILE);
          for (int c = 0; c < Cf::CB; ++c)
            for (int h = 0; h < 2; ++h)
              tma_load_3d(qs + c * BLOCK + h * HALF, &qmap, 64 * c, tl.q0 + 64 * h,
                          tl.bh, qfull);
        }
        for (int t = 0; t < tl.ntiles; ++t, ++kv) {
          // the ring's stage, once the tile it held before is released
          const int st = kv % nst;
          if (kv >= nst) mbar_wait(&empties[st], (kv / nst - 1) & 1);
          mbar_expect_tx(&fulls[st], Cf::TILE);
          for (int c = 0; c < Cf::CB; ++c)
            tma_load_3d(ring + st * Cf::TILE + c * BLOCK, map, 64 * c, t * TK, kvh,
                        &fulls[st]);
        }
      }
    }
  } else {
    // -- consumers: warpgroup w owns rows q0 + 64w .. q0 + 64w + 63 of each
    // query tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
    const int w = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int me = TURN + w, other = TURN + (w ^ 1);
#ifdef K4_TRACE
    long long* trace = blockIdx.x == 0 && (tid & 127) == 0 ? trace_buf : nullptr;
#endif
    // scores in units of log2: log2(e) folded into the scale, p = 2^(x - m)
    const float sc = scale * 1.4426950408889634f;
    const uint32_t qa = smem_u32(qs) + w * HALF;
    const uint32_t ka = smem_u32(ks), va = smem_u32(vs);

    float s[TK / 2];           // a tile's scores, then its p in fp32
    float o[D / 2];
    uint32_t p[TK / 16][4];    // p in bf16: P.V's A fragments
    float m[2], l[2], corr[2];

    // The GEMM issues of the two warpgroups alternate (TURN barriers):
    // while one runs its softmax the tensor cores run the other's GEMMs.
    // Warpgroup 0 issues first; each issue slot ends by handing the turn
    // over, except warpgroup 1's last, which nobody waits for.
    if (w == 1) turn_pass(TURN);
    int kv = 0, n = 0;
    for (int i = blockIdx.x; i < tiles; i += gridDim.x, ++n) {
      const Tile tl = tile_at<TQ, TK>(i, BH, Sq, Sk, causal);
      const int ntiles = tl.ntiles;
      const int row0 = tl.q0 + 64 * w + 16 * warp + g;  // and row0 + 8
      const int rmin = tl.q0 + 64 * w;  // this warpgroup's first row
      const bool last_tile = i + (int)gridDim.x >= tiles;
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
      mbar_wait(qfull, n & 1);

      // slot 0: S = Q K^T of key tile 0, then its softmax
      mbar_wait(&kfull[kv % Cf::KST], (kv / Cf::KST) & 1);
      __syncwarp();
      turn_wait(me);
      wgmma_fence();
      issue_qk<D>(s, qa, ka + (kv % Cf::KST) * Cf::TILE);
      wgmma_commit();
      turn_pass(other);  // slot 0 is never the last
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(&kempty[kv % Cf::KST]);
      if (ntiles == 1) mbar_arrive(qempty);
      online_softmax(s, m, l, corr, sc, (causal && TK - 1 > rmin) || TK > Sk, 0,
                     t4, row0, Sk, causal);
      pack_p(p, s);
#ifdef K4_TRACE
      if (n > 0) trace = nullptr;  // the block's first query tile only
#endif

      // slot t: issue Q K^T of key tile t and P V of tile t - 1; the
      // softmax of tile t runs while P V(t - 1) (and the other
      // warpgroup's GEMMs) are on the tensor cores
      for (int t = 1; t < ntiles; ++t) {
        const int kst = (kv + t) % Cf::KST, vst = (kv + t - 1) % Cf::VST;
        K4_STAMP(t, 0);
        mbar_wait(&kfull[kst], ((kv + t) / Cf::KST) & 1);
        mbar_wait(&vfull[vst], ((kv + t - 1) / Cf::VST) & 1);
        K4_STAMP(t, 1);
        rescale(o, corr);  // corr of tile t - 1: O's last P V is done
        __syncwarp();
        turn_wait(me);
        K4_STAMP(t, 2);
        wgmma_fence();
        issue_qk<D>(s, qa, ka + kst * Cf::TILE);
        wgmma_commit();
        issue_pv(o, p, va + vst * Cf::TILE);
        wgmma_commit();
        turn_pass(other);
        K4_STAMP(t, 3);
        wgmma_wait<1>();  // Q K^T(t) is done; P V(t - 1) may still run
        fence_regs(s);
        K4_STAMP(t, 4);
        mbar_arrive(&kempty[kst]);
        if (t == ntiles - 1) mbar_arrive(qempty);  // Q is free for the next tile
        const int k0 = t * TK;
        online_softmax(s, m, l, corr, sc,
                       (causal && k0 + TK - 1 > rmin) || k0 + TK > Sk, k0, t4,
                       row0, Sk, causal);
        K4_STAMP(t, 5);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int kk = 0; kk < TK / 16; ++kk) fence_regs(p[kk]);
        K4_STAMP(t, 6);
        mbar_arrive(&vempty[vst]);
        pack_p(p, s);
        K4_STAMP(t, 7);
      }

      // the last slot: P V of the last key tile
      const int vl = (kv + ntiles - 1) % Cf::VST;
      mbar_wait(&vfull[vl], ((kv + ntiles - 1) / Cf::VST) & 1);
      rescale(o, corr);
      __syncwarp();
      turn_wait(me);
      wgmma_fence();
      issue_pv(o, p, va + vl * Cf::TILE);
      wgmma_commit();
      if (w == 0 || !last_tile) turn_pass(other);
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) fence_regs(p[kk]);
      mbar_arrive(&vempty[vl]);
      kv += ntiles;

      // l over the quad, then acc / max(l, 1e-30) rounded to bf16 once into
      // this warpgroup's rows of the output tile, swizzled as the TMA store
      // reads it; rows past Sq are not stored.  The first barrier waits for
      // the thread that stored the block's previous tile, which waited
      // until its store had read the buffer.
      float den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        den[r] = fmaxf(l[r], 1e-30f);
      }
      unsigned char* ow = os + w * HALF;
      const int r0 = 16 * warp + g;  // rows r0 and r0 + 8, both at swizzle phase g
      bar_sync(OWN + w, 128);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        unsigned char* row = ow + (j >> 3) * BLOCK + r0 * 128 + ((j & 7) ^ g) * 16 + 4 * t4;
        *reinterpret_cast<__nv_bfloat162*>(row) =
            __floats2bfloat162_rn(o[4 * j] / den[0], o[4 * j + 1] / den[0]);
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * 128) =
            __floats2bfloat162_rn(o[4 * j + 2] / den[1], o[4 * j + 3] / den[1]);
      }
      fence_proxy_async();
      bar_sync(OWN + w, 128);
      if ((tid & 127) == 0) {
        for (int c = 0; c < Cf::CB; ++c)
          tma_store_3d(&omap, ow + c * BLOCK, 64 * c, tl.q0 + 64 * w, tl.bh);
        tma_store_wait();
      }
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, long long BH,
           long long Sq, long long Sk, long long rep, float scale, int causal,
           cudaStream_t stream) {
  using Cf = Cfg<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tiled_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cf::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  constexpr CUtensorMapDataType BF16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap qm, km, vm, om;
  if (!tile_map(&qm, BF16, 2, q, D, Sq, BH, 64) ||
      !tile_map(&km, BF16, 2, k, D, Sk, BH / rep, TK) ||
      !tile_map(&vm, BF16, 2, v, D, Sk, BH / rep, TK) ||
      !tile_map(&om, BF16, 2, out, D, Sq, BH, 64))
    return (int)cudaErrorInvalidValue;
  long long blocks = BH * ((Sq + TQ - 1) / TQ);
  if (blocks > num_sms()) blocks = num_sms();
  flash_tiled_bf16_kernel<D><<<(unsigned)blocks, THREADS, Cf::BYTES, stream>>>(
      qm, km, vm, om, (int)BH, (int)Sq, (int)Sk, (int)rep, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

// -- tiled route, fp32 as 3xTF32 on Hopper's wgmma ---------------------------
// Query tiles of (query head, 128 rows), walked by a persistent grid of one
// block an SM, as the bf16 wgmma kernel's: warpgroups 0 and 1 own 64 rows
// each and run the GEMMs and the softmax; warpgroup 2 gives up its
// registers (setmaxnreg) and one of its threads issues the copies of Q, K
// and V in the order they are used.  The consumers take 240 registers:
// at D 128 O, P V's partial sums and p's hi and lo parts alone take 192.
// Every fp32 operand reaches
// the tensor cores split into TF32 parts, x = hi + lo, and each k8 step
// runs lo.hi, hi.lo and hi.hi.  K and V are split once a launch by
// flash_tiled_split_kv, before the main kernel on the same stream, into a
// scratch laid out as the wgmma descriptors read it (see there), so a K or
// V stage is one bulk copy; Q is loaded raw by TMA (a tf32 operand has no
// transpose bit: both operands of each GEMM are K-major) and each k8
// fragment is split in registers just before its three wgmmas.
namespace tf {

constexpr int TQ = 128;         // query rows a block
constexpr int TK = 64;          // keys a tile
constexpr int THREADS = 384;    // warpgroups 0-1 consume, 2 loads
constexpr int QBLK = 64 * 128;  // bytes of a [64 rows][32 floats] block
// k8 steps (64 taps) of a Q K^T chain: its Q fragments (8 registers a
// step) are held until its wgmmas are done
constexpr int QCHAIN = 8;

// setmaxnreg: 24 * 128 + 240 * 256 <= 65,536 registers an SM
constexpr int LOAD_REGS = 24, MMA_REGS = 240;

template <int D>
struct Cfg {
  static constexpr int CB = D / 32;                 // 32-float column blocks a row
  static constexpr uint32_t PART = TK * D * 4;      // bytes of K hi (lo) or V^T hi (lo)
  static constexpr uint32_t QTILE = TQ * D * 4;     // bytes of a query tile
  // K and V stages in flight: one each at D 128 (192 KB with Q), two at D 64
  static constexpr int KST = D == 64 ? 2 : 1;
  static constexpr int VST = KST;
  static constexpr size_t BODY = QTILE + (size_t)2 * PART * (KST + VST);
  // 1024 bytes of slack to align the tiles to the swizzle's period, then
  // Q's full and empty barriers and full and empty for each K and V stage
  static constexpr size_t BYTES =
      1024 + BODY + (2 + 2 * KST + 2 * VST) * sizeof(uint64_t);
  static_assert(BYTES <= 232448, "a block's shared memory on an H100");
};

// The pre-pass: K and V of key tile t of KV head h split into TF32 hi and
// lo parts, written to kv[h][t] as four parts of TK * D floats, K hi, K lo,
// V^T hi, V^T lo, zero past Sk.  A K part is D / 32 blocks of [TK keys][32
// floats] (Q K^T's B, K-major); a V^T part is TK / 32 blocks of [D][32
// keys] (P V's B, K-major: tf32 has no transposed operand).  Every row of
// 128 bytes holds its 16-byte chunk q at q ^ (row % 8), the 128-byte
// swizzle.  Within each 8-key group V^T's slot s holds key 2s (s < 4) or
// key 2(s - 4) + 1: a thread's score accumulators hold keys 2t and 2t + 1
// of each group, and the tf32 A fragment wants k-slots t and t + 4, so
// with the keys so placed the split scores are P V's A fragments as they
// lie.  Block b takes tile (b / 2) % nt of head b / 2 / nt, K if b is even;
// V goes through shared memory to be transposed.
template <int D>
__global__ void __launch_bounds__(256)
flash_tiled_split_kv(const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ kv, int Sk, int nt) {
  constexpr int PART = TK * D;  // floats
  __shared__ float tile[TK][D + 1];
  const int b = (int)(blockIdx.x >> 1);
  const bool is_v = blockIdx.x & 1;
  const int t = b % nt, h = b / nt;
  const int k0 = t * TK, rows = min(TK, Sk - k0);
  const float* src = (is_v ? v : k) + ((int64_t)h * Sk + k0) * D;
  float* dst = kv + ((int64_t)b * 4 + (is_v ? 2 : 0)) * PART;
  if (!is_v) {
    for (int i = threadIdx.x; i < TK * D / 4; i += 256) {
      const int r = i / (D / 4), q = i - r * (D / 4);
      const float4 x = r < rows
                           ? *reinterpret_cast<const float4*>(src + (int64_t)r * D + 4 * q)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
      uint32_t hi[4], lo[4];
      split(x.x, hi[0], lo[0]);
      split(x.y, hi[1], lo[1]);
      split(x.z, hi[2], lo[2]);
      split(x.w, hi[3], lo[3]);
      const int off = (q >> 3) * (TK * 32) + r * 32 + (((q & 7) ^ (r & 7)) * 4);
      *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(dst + PART + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
    return;
  }
  for (int i = threadIdx.x; i < TK * D; i += 256) {
    const int r = i / D, d = i - r * D;
    tile[r][d] = r < rows ? src[(int64_t)r * D + d] : 0.f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TK * D / 4; i += 256) {
    // chunk q of row d of key block c: slots 4 (q & 1) .. 4 (q & 1) + 3 of
    // 8-key group q >> 1, keys j0, j0 + 2, j0 + 4, j0 + 6
    const int c = i / (D * 8), e = i - c * (D * 8);
    const int d = e >> 3, q = e & 7;
    const int j0 = 32 * c + 8 * (q >> 1) + (q & 1);
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) split(tile[j0 + 2 * j][d], hi[j], lo[j]);
    const int off = c * (D * 32) + d * 32 + ((q ^ (d & 7)) * 4);
    *reinterpret_cast<uint4*>(dst + off) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(dst + PART + off) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// S = Q K^T of the K stage at `kb` (hi part, then lo PART bytes on), in
// chains of QCHAIN k8 steps (64 taps), each into accumulators of its own
// (the first wgmma of a chain overwrites them), added in fp32 at the end;
// within a chain the small products (lo.hi, hi.lo) go first, then the
// hi.hi ones.  The tensor cores' accumulation rounds against the running
// sum: so the small products add while it is still small, and no chain of
// large products runs over more than 64 taps (at D 128 one chain over all
// 128 taps doubled the worst error against float64 on an H100).  A chain's
// Q fragments are held until its wgmmas are done.  `qw` points at this
// thread's first element in its warpgroup's Q rows: rows r and r + 8 (r %
// 8 = g), column t4 of every 32-float block, whose 16-byte chunk q lies at
// q ^ g (q_at).  The saturation and inf cases of split() run only where
// `top`: a value of the warp's Q rows needs them (q_top).
__device__ __forceinline__ const float* q_at(const unsigned char* qw, int g, int kk,
                                             int half, int row8) {
  return reinterpret_cast<const float*>(qw + (kk >> 2) * QBLK + row8 * 8 * 128 +
                                        ((2 * (kk & 3) + half) ^ g) * 16);
}

template <int D>
__device__ __forceinline__ bool q_top(const unsigned char* qw, int g) {
  float big = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < D / 8; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) big = fmaxf(big, fabsf(*q_at(qw, g, kk, e >> 1, e & 1)));
  return __any_sync(FULL, big >= __uint_as_float(TF32_OVERFLOW));
}

template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[TK / 2], const unsigned char* qw,
                                         int g, bool top, uint32_t kb) {
  using Cf = Cfg<D>;
  constexpr int CHAINS = D / 8 / QCHAIN;
  float more[CHAINS > 1 ? CHAINS - 1 : 1][TK / 2];
#pragma unroll
  for (int c = 0; c < CHAINS; ++c) {
    float(&acc)[TK / 2] = c == 0 ? s : more[c - 1];
#pragma unroll
    for (int j = 0; j < TK / 2; ++j) acc[j] = 0.f;  // dead until the chain
    // the A fragment of k8 step kk: (r, t4), (r + 8, t4), (r, t4 + 4),
    // (r + 8, t4 + 4) of its 8 columns
    uint32_t qh[QCHAIN][4], ql[QCHAIN][4];
    if (top) {
#pragma unroll
      for (int j = 0; j < QCHAIN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          split(*q_at(qw, g, c * QCHAIN + j, e >> 1, e & 1), qh[j][e], ql[j][e]);
    } else {
#pragma unroll
      for (int j = 0; j < QCHAIN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = *q_at(qw, g, c * QCHAIN + j, e >> 1, e & 1);
          qh[j][e] = cvt_tf32(x);
          ql[j][e] = cvt_tf32(x - __uint_as_float(qh[j][e]));
        }
    }
    fence_regs(acc);
    wgmma_fence();
    // k8 step kk: key block kk / 4, 32 bytes a step into its rows
#pragma unroll
    for (int j = 0; j < QCHAIN; ++j) {
      const int kk = c * QCHAIN + j;
      const uint32_t off = (kk >> 2) * (TK * 128) + (kk & 3) * 32;
      wgmma_tf32(acc, ql[j], desc_sw128(kb + off), j > 0);
      wgmma_tf32(acc, qh[j], desc_sw128(kb + Cf::PART + off), 1);
    }
#pragma unroll
    for (int j = 0; j < QCHAIN; ++j) {
      const int kk = c * QCHAIN + j;
      wgmma_tf32(acc, qh[j], desc_sw128(kb + (kk >> 2) * (TK * 128) + (kk & 3) * 32), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < QCHAIN; ++j) {
      fence_regs(qh[j]);
      fence_regs(ql[j]);
    }
  }
#pragma unroll
  for (int c = 1; c < CHAINS; ++c)
#pragma unroll
    for (int j = 0; j < TK / 2; ++j) s[j] += more[c - 1][j];
}

// part = P V of the V stage at `vb` (V^T hi, then lo PART bytes on), P
// split into ph + pl.  k8 step kk covers keys 8kk .. 8kk + 7, the score
// accumulators 4kk .. 4kk + 3 (keys 2t4, 2t4 + 1 of rows g and g + 8),
// which the permuted V^T takes as k-slots t4 and t4 + 4
template <int D>
__device__ __forceinline__ void issue_pv(float (&part)[D / 2],
                                         const uint32_t (&ph)[TK / 2],
                                         const uint32_t (&pl)[TK / 2], uint32_t vb) {
  using Cf = Cfg<D>;
  fence_regs(part);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < TK / 8; ++kk) {  // the small products first, as issue_qk
    const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1], ph[4 * kk + 3]};
    const uint32_t al[4] = {pl[4 * kk], pl[4 * kk + 2], pl[4 * kk + 1], pl[4 * kk + 3]};
    const uint32_t off = (kk >> 2) * (D * 128) + (kk & 3) * 32;
    wgmma_tf32(part, al, desc_sw128(vb + off), kk > 0);
    wgmma_tf32(part, ah, desc_sw128(vb + Cf::PART + off), 1);
  }
#pragma unroll
  for (int kk = 0; kk < TK / 8; ++kk) {
    const uint32_t ah[4] = {ph[4 * kk], ph[4 * kk + 2], ph[4 * kk + 1], ph[4 * kk + 3]};
    wgmma_tf32(part, ah, desc_sw128(vb + (kk >> 2) * (D * 128) + (kk & 3) * 32), 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(part);
}

// The online softmax over one tile's scores, in fp32 as the FFMA kernel's:
// s[4j + e] is row row0 + 8 (e >> 1), key k0 + 8j + 2 t4 + (e & 1); scaled,
// masked (an instance of its own for the tiles that cross the diagonal or
// Sk), then replaced by p = expf(x - m) against the new running max, l
// rescaled by corr = expf(m_old - m) and summed in this lane's order
template <bool EDGE>
__device__ __forceinline__ void online_softmax(float (&s)[TK / 2], float (&m)[2],
                                               float (&l)[2], float (&corr)[2],
                                               float scale, int k0, int t4, int row0,
                                               int Sk, int causal) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < TK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[4 * j + e] * scale;
      if constexpr (EDGE) {
        const int key = k0 + 8 * j + 2 * t4 + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= Sk || (causal && key > row)) x = -INFINITY;
      }
      s[4 * j + e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    corr[r] = expf(m[r] - mx[r]);  // 0 on the first tile (key 0 is live)
    m[r] = mx[r];
    l[r] *= corr[r];
  }
#pragma unroll
  for (int j = 0; j < TK / 2; ++j) {
    s[j] = expf(s[j] - m[(j >> 1) & 1]);
    l[(j >> 1) & 1] += s[j];
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_tiled_tf32x3_kernel(const __grid_constant__ CUtensorMap qmap,
                          const float* __restrict__ kv, float* __restrict__ out,
                          int BH, int Sq, int Sk, int rep, float scale, int causal) {
  using Cf = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* qs = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  unsigned char* ks = qs + Cf::QTILE;
  unsigned char* vs = ks + 2 * Cf::KST * Cf::PART;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(qs + Cf::BODY);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qempty + 1;
  uint64_t* kempty = kfull + Cf::KST;
  uint64_t* vfull = kempty + Cf::KST;
  uint64_t* vempty = vfull + Cf::VST;
  const int tiles = BH * ((Sq + TQ - 1) / TQ);
  const int nt = (Sk + TK - 1) / TK;  // key tiles of a KV head in the scratch
  const int tid = threadIdx.x;

  if (tid == 0) {
    mbar_init(qfull, 1);     // the producer's expect_tx, then the bytes
    mbar_init(qempty, 256);  // every consumer thread, past its last Q K^T
    for (int st = 0; st < Cf::KST; ++st) {
      mbar_init(&kfull[st], 1);
      mbar_init(&kempty[st], 256);
    }
    for (int st = 0; st < Cf::VST; ++st) {
      mbar_init(&vfull[st], 1);
      mbar_init(&vempty[st], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // -- producer: one thread issues a query tile's Q (TMA), then each key
    // tile's K and V stage (one bulk copy each), in the order the
    // consumers use them; the rings run on across the block's query tiles
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(LOAD_REGS));
    if (tid == 256) {
      const unsigned char* src = reinterpret_cast<const unsigned char*>(kv);
      int n = 0, kvn = 0;
      for (int i = blockIdx.x; i < tiles; i += gridDim.x, ++n) {
        const Tile tl = tile_at<TQ, TK>(i, BH, Sq, Sk, causal);
        const int kvh = tl.bh / rep;
        if (n > 0) mbar_wait(qempty, (n - 1) & 1);
        mbar_expect_tx(qfull, Cf::QTILE);
        for (int h = 0; h < 2; ++h)
          for (int c = 0; c < Cf::CB; ++c)
            tma_load_3d(qs + (h * Cf::CB + c) * QBLK, &qmap, 32 * c, tl.q0 + 64 * h,
                        tl.bh, qfull);
        for (int t = 0; t < tl.ntiles; ++t, ++kvn) {
          const unsigned char* tile = src + ((size_t)kvh * nt + t) * 4 * Cf::PART;
          const int kst = kvn % Cf::KST, vst = kvn % Cf::VST;
          if (kvn >= Cf::KST) mbar_wait(&kempty[kst], (kvn / Cf::KST - 1) & 1);
          mbar_expect_tx(&kfull[kst], 2 * Cf::PART);
          bulk_copy(ks + kst * 2 * Cf::PART, tile, 2 * Cf::PART, &kfull[kst]);
          if (kvn >= Cf::VST) mbar_wait(&vempty[vst], (kvn / Cf::VST - 1) & 1);
          mbar_expect_tx(&vfull[vst], 2 * Cf::PART);
          bulk_copy(vs + vst * 2 * Cf::PART, tile + 2 * Cf::PART, 2 * Cf::PART,
                    &vfull[vst]);
        }
      }
    }
  } else {
    // -- consumers: warpgroup w owns rows q0 + 64w .. q0 + 64w + 63 of each
    // query tile; each key tile runs Q K^T, the softmax and P V in turn,
    // while the other warpgroup's GEMMs keep the tensor cores busy.  P V
    // goes into a partial accumulator (the first wgmma overwrites it), then
    // O = O * corr + part in fp32: no tensor-core accumulation chain spans
    // more than one key tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(MMA_REGS));
    const int w = tid >> 7;
    const int warp = (tid >> 5) & 3, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const unsigned char* qw = qs + w * Cf::CB * QBLK + (16 * warp + g) * 128 + 4 * t4;
    const uint32_t ka = smem_u32(ks), va = smem_u32(vs);
    float s[TK / 2];
    float o[D / 2];
    float m[2], l[2], corr[2];
    int kvn = 0, n = 0;
    for (int i = blockIdx.x; i < tiles; i += gridDim.x, ++n) {
      const Tile tl = tile_at<TQ, TK>(i, BH, Sq, Sk, causal);
      const int rmin = tl.q0 + 64 * w;  // this warpgroup's first row
      const int row0 = rmin + 16 * warp + g;  // and row0 + 8
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = 0.f;
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
      mbar_wait(qfull, n & 1);
      const bool top = q_top<D>(qw, g);
      for (int t = 0; t < tl.ntiles; ++t, ++kvn) {
        const int kst = kvn % Cf::KST, vst = kvn % Cf::VST;
        const int k0 = t * TK;
        // causal: a key tile past this warpgroup's last row is all masked
        const bool live = !causal || k0 <= rmin + 63;
        mbar_wait(&kfull[kst], (kvn / Cf::KST) & 1);
        if (live) {
          __syncwarp();
          issue_qk<D>(s, qw, g, top, ka + kst * 2 * Cf::PART);
        }
        mbar_arrive(&kempty[kst]);
        if (t == tl.ntiles - 1) mbar_arrive(qempty);  // Q is free for the next tile
        uint32_t ph[TK / 2], pl[TK / 2];
        if (live) {
          if ((causal && k0 + TK - 1 > rmin) || k0 + TK > Sk)
            online_softmax<true>(s, m, l, corr, scale, k0, t4, row0, Sk, causal);
          else
            online_softmax<false>(s, m, l, corr, scale, k0, t4, row0, Sk, causal);
#pragma unroll
          for (int j = 0; j < TK / 2; ++j) {  // p in [0, 1]: no saturation
            ph[j] = cvt_tf32(s[j]);
            pl[j] = cvt_tf32(s[j] - __uint_as_float(ph[j]));
          }
        }
        mbar_wait(&vfull[vst], (kvn / Cf::VST) & 1);
        if (live) {
          float part[D / 2];
#pragma unroll
          for (int j = 0; j < D / 2; ++j) part[j] = 0.f;  // dead until here
          __syncwarp();
          issue_pv<D>(part, ph, pl, va + vst * 2 * Cf::PART);
          fence_regs(ph);
          fence_regs(pl);
#pragma unroll
          for (int j = 0; j < D / 2; ++j) o[j] = fmaf(o[j], corr[(j >> 1) & 1], part[j]);
        }
        mbar_arrive(&vempty[vst]);
      }

      // l over the quad, then O / max(l, 1e-30), rows past Sq not stored
      float den[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        l[r] += __shfl_xor_sync(FULL, l[r], 1);
        l[r] += __shfl_xor_sync(FULL, l[r], 2);
        den[r] = fmaxf(l[r], 1e-30f);
      }
      float* og = out + ((int64_t)tl.bh * Sq + row0) * D + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (row0 + 8 * r >= Sq) continue;
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          *reinterpret_cast<float2*>(og + 8 * r * D + 8 * j) =
              make_float2(o[4 * j + 2 * r] / den[r], o[4 * j + 2 * r + 1] / den[r]);
      }
    }
  }
}

// K and V split into the scratch `kv` (BH / rep * ceil(Sk / TK) * 4 * TK *
// D floats), then the main kernel over it
template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* kv,
           long long BH, long long Sq, long long Sk, long long rep, float scale,
           int causal, cudaStream_t stream) {
  using Cf = Cfg<D>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tiled_tf32x3_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)Cf::BYTES);
  if (attr != cudaSuccess) return (int)attr;
  const long long nt = (Sk + TK - 1) / TK;
  if (2 * nt * (BH / rep) > (1LL << 31) - 1) return (int)cudaErrorInvalidValue;
  CUtensorMap qm;
  if (!tile_map(&qm, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, q, D, Sq, BH, 64))
    return (int)cudaErrorInvalidValue;
  flash_tiled_split_kv<D><<<(unsigned)(2 * nt * (BH / rep)), 256, 0, stream>>>(
      (const float*)k, (const float*)v, (float*)kv, (int)Sk, (int)nt);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  long long blocks = BH * ((Sq + TQ - 1) / TQ);
  if (blocks > num_sms()) blocks = num_sms();
  flash_tiled_tf32x3_kernel<D><<<(unsigned)blocks, THREADS, Cf::BYTES, stream>>>(
      qm, (const float*)kv, (float*)out, (int)BH, (int)Sq, (int)Sk, (int)rep, scale,
      causal);
  return (int)cudaGetLastError();
}

}  // namespace tf

template <int D>
int launch_tiled_bf16_mma(const void* q, const void* k, const void* v, void* out,
                          long long BH, long long Sq, long long Sk, long long rep,
                          float scale, int causal, cudaStream_t stream) {
  constexpr size_t smem = sizeof(__nv_bfloat16) * (size_t)(TQ + 4 * TK) * (D + 8);
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tiled_bf16_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (attr != cudaSuccess) return (int)attr;
  const unsigned blocks = (unsigned)(BH * ((Sq + TQ - 1) / TQ));
  flash_tiled_bf16_mma_kernel<D><<<blocks, TILED_BF16_THREADS, smem, stream>>>(
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

// kernel: 0 the fp32 FFMA kernel, 1 the bf16 mma.sync kernel, 2 the bf16
// wgmma kernel, 3 the fp32 3xTF32 wgmma kernel (2 and 3 at D 64 and 128
// only; 3 splits K and V into `kv` first)
template <int D>
int launch_tiled(const void* q, const void* k, const void* v, void* out, void* kv,
                 long long BH, long long Sq, long long Sk, long long rep,
                 float scale, int causal, int kernel, cudaStream_t stream) {
  if (kernel >= 2) {
    if constexpr (D == 64 || D == 128)
      return kernel == 2 ? wg::launch<D>(q, k, v, out, BH, Sq, Sk, rep, scale, causal,
                                         stream)
                         : tf::launch<D>(q, k, v, out, kv, BH, Sq, Sk, rep, scale,
                                         causal, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (kernel == 1)
    return launch_tiled_bf16_mma<D>(q, k, v, out, BH, Sq, Sk, rep, scale, causal,
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

// The tiled route: the rows route's arguments and a scratch `kv`, of which
// the launch shape names the kernel and must be its own (flash_plan's
// tiled plans, checked here so that the plan is what launches): heads = 1
// and
//   fp32: rows 64, warps 8 (the FFMA kernel),
//         or rows 128, warps 12 (the 3xTF32 wgmma kernel; D 64 and 128
//         only; kv holds BH / rep * ceil(Sk / 64) * 4 * 64 * D floats,
//         16-byte aligned);
//   bf16: rows 128, warps 12 (the wgmma kernel; D 64 and 128 only),
//         or rows 64, warps 4 (the mma.sync kernel, every D);
// BH * ceil(Sq / rows) blocks, at most 2^31 - 1.  The other kernels do not
// read kv.
extern "C" int flash_attn_tiled(const void* q, const void* k, const void* v,
                                void* out, void* kv, long long BH, long long Sq,
                                long long Sk, long long D, long long rep,
                                float scale, long long causal, long long bf16,
                                long long heads, long long rows, long long warps,
                                void* stream) {
  if (BH < 0 || Sq < 0 || Sk < 1 || rep < 1 || BH % rep != 0 ||
      Sq > (1LL << 24) || Sk > (1LL << 24) || BH > (1LL << 31) - 1)
    return (int)cudaErrorInvalidValue;
  const bool wide = D == 64 || D == 128;  // the wgmma kernels' instances
  int kernel;
  if (heads != 1) {
    return (int)cudaErrorInvalidValue;
  } else if (!bf16 && rows == TQ && warps * 32 == TILED_F32_THREADS) {
    kernel = 0;
  } else if (bf16 && rows == TQ && warps * 32 == TILED_BF16_THREADS) {
    kernel = 1;
  } else if (bf16 && rows == wg::TQ && warps * 32 == wg::THREADS && wide) {
    kernel = 2;
  } else if (!bf16 && rows == tf::TQ && warps * 32 == tf::THREADS && wide &&
             kv != nullptr && (uintptr_t)kv % 16 == 0) {
    kernel = 3;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (BH * ((Sq + rows - 1) / rows) > (1LL << 31) - 1)  // grid.x
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  if (BH == 0 || Sq == 0) return (int)cudaSuccess;
  cudaStream_t s = (cudaStream_t)stream;
  const int c = causal ? 1 : 0;
  switch (D) {
    case 16: return launch_tiled<16>(q, k, v, out, kv, BH, Sq, Sk, rep, scale, c, kernel, s);
    case 32: return launch_tiled<32>(q, k, v, out, kv, BH, Sq, Sk, rep, scale, c, kernel, s);
    case 64: return launch_tiled<64>(q, k, v, out, kv, BH, Sq, Sk, rep, scale, c, kernel, s);
    case 128: return launch_tiled<128>(q, k, v, out, kv, BH, Sq, Sk, rep, scale, c, kernel, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

#ifdef K4_TRACE
// where the traced wgmma kernel writes its stamps (a device buffer of 2 *
// 256 * 8 int64); a null buffer stops it
extern "C" int flash_attn_tiled_trace(void* buf) {
  long long* p = (long long*)buf;
  cudaMemcpyToSymbol(wg::trace_buf, &p, sizeof(p));
  return (int)cudaGetLastError();
}
#endif
