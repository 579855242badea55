// Per-token attention body (attend_token) of the float32-q paths of both
// kernels: paged_decode_kernel (paged_decode_attention.cu) and
// ragged_paged_kernel (ragged_paged_attention.cu). With q in bf16, the
// dtype serving runs, each kernel has its own tensor-core body instead:
// the ragged kernel's query-tiled one and the decode kernel's split over
// the context with a combine pass. The float32 paths are held to 1e-4,
// which a bf16 tensor-core product cannot meet, so they keep this body.
//
// One thread block attends ONE query token for ONE kv head: the block
// holds that kv head's `group` query heads (GQA) in float32 shared
// memory, walks the token's visible context in tiles of TILE positions
// (each position resolved through the page table to its slot in the
// flat [S, Hk, hd] pool), and keeps a float32 online softmax per query
// head. Its two callers differ only in how a block finds its query row
// and how many positions it may see.
//
// What bounds it on an H100: the bytes of K/V it reads (one decode step
// of llama3.2:1b at 64 sequences of 512 tokens reads 64 MiB of K/V per
// layer against ~1 MFLOP of softmax work per KiB), so the design keeps
// every byte of K/V read once per block and nothing but the output
// written. Positions past a row's frontier are never loaded: the tile
// loop stops there and a partial tile fills its tail with zeros, so
// stale slot data (a reused page, the trash page padding rows write to)
// can never reach the accumulator, not even as 0 * NaN.
//
// Int8 pools (the TPU kernels' quantized=True variants): the payload P is
// int8 and every (slot, kv head) row carries one f32 scale in a [S, Hk]
// plane beside the pool. A tile first stages its positions' scales in
// shared memory (one load per position and pool), then dequantizes each
// element in f32 right after its load, (float)q * scale, the value the
// plain version's kv_gather computes; nothing is rounded to bf16, and the
// tiles stay f32. Scales of positions past the frontier are never loaded.
//
// Kept simple on purpose: plain loads, float32 FMA on CUDA cores, no
// tensor cores, no split over the context.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace paged_attn {

constexpr int TILE = 32;      // context positions per tile (= warp size)
constexpr int THREADS = 128;  // threads per block

enum DType { F32 = 0, BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return (float)x; }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Shared-memory floats one block needs; `quantized` adds the tile's
// staged K and V scales.
__host__ __device__ inline int smem_floats(int group, int hd, bool quantized) {
  return group * hd          // q rows (pre-scaled)
         + TILE * (hd + 1)   // K tile, rows padded against bank conflicts
         + TILE * hd         // V tile
         + group * TILE      // scores, then probabilities
         + group * hd        // accumulators
         + 3 * group         // running max, running sum, rescale factor
         + (quantized ? 2 * TILE : 0);  // K and V scales of the tile
}

// Attend one query token (q_row: [group, hd] of type T, this kv head's
// query heads) over context positions [0, n_visible) of the sequence
// whose page-table row is pt_row; write [group, hd] to out_row in T.
// n_visible must already be clamped to max_pages * page_size. The pools
// hold payload P: T itself, or int8 with f32 scale planes k_scale /
// v_scale [S, Hk] (unread, and may be null, for other payloads).
template <typename T, typename P>
__device__ void attend_token(const T* __restrict__ q_row,
                             const P* __restrict__ k_pool,
                             const P* __restrict__ v_pool,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ pt_row, int n_visible,
                             int kvh, int Hk, int hd, int group, int page_size,
                             T* __restrict__ out_row, float* smem) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  float* qs = smem;
  float* ks = qs + group * hd;
  float* vs = ks + TILE * (hd + 1);
  float* sc = vs + TILE * hd;
  float* acc = sc + group * TILE;
  float* m_run = acc + group * hd;
  float* l_run = m_run + group;
  float* alpha = l_run + group;
  float* k_sc = alpha + group;  // [TILE], int8 pools only
  float* v_sc = k_sc + TILE;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_warps = blockDim.x >> 5;
  const float scale = rsqrtf((float)hd);

  for (int i = tid; i < group * hd; i += blockDim.x) {
    qs[i] = to_f32(q_row[i]) * scale;
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += blockDim.x) {
    m_run[g] = -INFINITY;
    l_run[g] = 0.f;
  }
  __syncthreads();

  for (int base = 0; base < n_visible; base += TILE) {
    const int nt = min(TILE, n_visible - base);
    if constexpr (kQuant) {
      // Stage the tile's scales, one load per position; the previous
      // tile's last barrier guarantees no thread still reads them.
      for (int t = tid; t < TILE; t += blockDim.x) {
        float kscale = 0.f, vscale = 0.f;
        if (t < nt) {
          const int pos = base + t;
          const long slot = (long)pt_row[pos / page_size] * page_size + pos % page_size;
          kscale = k_scale[slot * Hk + kvh];
          vscale = v_scale[slot * Hk + kvh];
        }
        k_sc[t] = kscale;
        v_sc[t] = vscale;
      }
      __syncthreads();
    }
    // Load the tile's K/V rows (dequantized in f32 for int8 pools);
    // positions past the frontier load zeros.
    for (int i = tid; i < TILE * hd; i += blockDim.x) {
      const int t = i / hd, d = i - t * hd;
      float kf = 0.f, vf = 0.f;
      if (t < nt) {
        const int pos = base + t;
        const long slot = (long)pt_row[pos / page_size] * page_size + pos % page_size;
        const long off = (slot * Hk + kvh) * hd + d;
        kf = to_f32(k_pool[off]);
        vf = to_f32(v_pool[off]);
        if constexpr (kQuant) {
          kf *= k_sc[t];
          vf *= v_sc[t];
        }
      }
      ks[t * (hd + 1) + d] = kf;
      vs[t * hd + d] = vf;
    }
    __syncthreads();
    // Scores for every (query head, position) of the tile.
    for (int i = tid; i < group * TILE; i += blockDim.x) {
      const int g = i / TILE, t = i - g * TILE;
      float s = -INFINITY;
      if (t < nt) {
        s = 0.f;
        const float* qg = qs + g * hd;
        const float* kt = ks + t * (hd + 1);
        for (int d = 0; d < hd; ++d) s = fmaf(qg[d], kt[d], s);
      }
      sc[i] = s;
    }
    __syncthreads();
    // Online softmax: one warp per query head, one lane per position.
    for (int g = warp; g < group; g += n_warps) {
      const bool valid = lane < nt;
      const float s = sc[g * TILE + lane];
      const float m_prev = m_run[g];
      const float m_new = fmaxf(m_prev, warp_max(valid ? s : -INFINITY));
      const float p = valid ? expf(s - m_new) : 0.f;
      const float psum = warp_sum(p);
      sc[g * TILE + lane] = p;
      if (lane == 0) {
        const float a = (m_prev == -INFINITY) ? 0.f : expf(m_prev - m_new);
        alpha[g] = a;
        l_run[g] = l_run[g] * a + psum;
        m_run[g] = m_new;
      }
    }
    __syncthreads();
    // Rescale and accumulate P @ V; each thread owns fixed (g, d) entries.
    for (int i = tid; i < group * hd; i += blockDim.x) {
      const int g = i / hd, d = i - g * hd;
      float a = acc[i] * alpha[g];
      const float* pg = sc + g * TILE;
      for (int t = 0; t < nt; ++t) a = fmaf(pg[t], vs[t * hd + d], a);
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < group * hd; i += blockDim.x) {
    const int g = i / hd;
    out_row[i] = from_f32<T>(acc[i] / fmaxf(l_run[g], 1e-20f));
  }
}

// Raise the kernel's dynamic shared-memory ceiling when a shape needs
// more than the default 48 KiB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace paged_attn
