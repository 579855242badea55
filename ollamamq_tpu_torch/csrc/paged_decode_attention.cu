// Paged decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel paged_decode_attention_pallas
// (ollamamq_tpu/ops/pallas/paged_attention.py, body _decode_kernel): one
// query token per sequence, q [B, H, hd], attends positions
// 0..seq_len-1 of its own paged context; the page walk is clamped to
// max_pages, GQA group = H / Hk, scale 1/sqrt(hd), float32 online softmax,
// output [B, H, hd] in q's dtype. A row with seq_len <= 0 writes zeros.
//
// Two entry points: paged_decode_attention (pool in q's dtype) and
// paged_decode_attention_int8 (the quantized=True variant: int8 pool plus
// f32 [S, Hk] scale planes).
//
// Bound on the card: bytes. A decode step reads each sequence's visible
// K/V rows once and does 4 * hd * group FLOPs per position and kv head,
// a few FLOPs per byte against the ~295 the tensor cores could take. So
// the time is the bytes' time, if enough of them are in flight at once:
// a (sequence, kv head) walk of up to max_pages * page_size positions
// done by one block leaves most SMs idle and one block's serial tile
// latency as the kernel's time.
//
// q in bf16 (the serving path): flash-decoding over the paged pool.
//   - Split kernel, grid (n_splits, Hk, B), n_splits = ceil(max_pages *
//     page_size / SPLIT) from shapes alone (no host sync, safe to capture
//     in a CUDA graph). Block (s, kvh, b) attends positions [s * SPLIT,
//     min((s + 1) * SPLIT, n)), n = clamp(seq_len, 0, max_pages *
//     page_size); a block with nothing there exits at once. The launch
//     plan (ops/cuda/paged_attention.py: decode_launch_plan) is checked
//     here against this file's formulas before the launch. SPLIT = 512
//     was the fastest of 64 to 1024 on an H100 (PERF.md): the four warps
//     of a block already keep a context's loads in flight side by side,
//     and a smaller split adds blocks, partials and combine work that
//     cost more than the shorter walks save.
//   - Four warps per block. The block's range goes in tiles of KV_TILE =
//     64 positions, warp w taking positions [16 w, 16 w + 16) of each
//     tile. Each warp streams its own positions into its own two-stage
//     ring in shared memory (a third stage measured no faster and costs
//     occupancy at head dim 128) with 16-byte cp.async (an int8 pool's f32 K
//     and V scales ride in the same stage as their rows), the next tile's
//     loads issued before the current tile's math; warps synchronise
//     only with __syncwarp until the block's merge. Lanes 0-15 read one
//     page-table entry each per tile and pass slots on by shuffle.
//     Positions past the block's range are never loaded; their shared
//     rows are zero-filled, so stale slots, NaN included, never reach an
//     mma.
//   - Math on tensor cores, mma.sync m16n8k16 (bf16 in, f32 accumulate).
//     The block's `group` (<= 8) query heads are padded to one m16 tile,
//     as in the ragged kernel: S = Q K^T leaves each thread the scores of
//     its row for the positions that P needs as the A fragment of
//     O += P V, so P never leaves registers. Swapping the operands (K as
//     M, the group as N = 8) would waste no rows but leave P transposed
//     against V's fragment, a trip through shared memory per tile; the
//     padded rows cost only tensor-core issue, which is idle anyway.
//     Softmax in f32 with the TPU kernel's guards (alpha is 0 while the
//     running max is -inf, p is 0 for a masked position).
//   - int8 pool: dequantized at the fragment load. int8 -> bf16 is exact;
//     the K scale multiplies S's column of each position in f32, the V
//     scale multiplies P's column before P is rounded to bf16. Each lane
//     reads whole 32-bit words of int8 rows: K with the head dim
//     permuted inside each k-step (Q's fragment takes the same
//     permutation, so Q K^T is unchanged), V with the output columns
//     permuted (undone when the warp writes its partial). The bytes
//     become bf16 by byte permutes and one f32 add each rather than by
//     the conversion unit's slower integer-to-float path.
//   - The four warps' (max, sum, unnormalised O) merge in shared memory.
//     A sequence whose n fits in one split gets its output written here;
//     otherwise the block writes its f32 partial to the scratch buffer
//     the wrapper allocated, [B, Hk, n_splits, group, hd + 2] (O, then
//     the max in log2 units and the sum), and the combine kernel
//     (grid (Hk, B)) reduces the ceil(n / SPLIT) partials that had work:
//     M = max m_s, out = sum e^(m_s - M) O_s / max(sum e^(m_s - M) l_s,
//     1e-20). It skips the rows the split kernel wrote, by the same
//     test, and writes exact zeros for n <= 0.
//   - Left for later: TMA and wgmma (the paged gather cuts a tile into
//     page-size runs), a split sized per call from the batch (a lone
//     512-token sequence ran fastest at SPLIT 128), a persistent grid.
//
// q in float32: paged_decode_kernel, one block per (sequence, kv head)
// over attend_token (paged_attention_common.cuh), scalar f32 math; it is
// held to 1e-4, which a bf16 tensor-core product cannot meet.

#include "paged_attention_common.cuh"
#include "paged_attention_tc.cuh"

using namespace paged_attn;

// ---- q in float32: one block per (sequence, kv head) ------------------------

template <typename T, typename P>
__global__ void __launch_bounds__(THREADS)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ seq_lens, T* __restrict__ out, int H,
                    int Hk, int hd, int page_size, int max_pages) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = H / Hk;
  int n = seq_lens[b];
  n = max(0, min(n, max_pages * page_size));
  const long row = ((long)b * H + (long)kvh * group) * hd;
  attend_token<T, P>(q + row, k_pool, v_pool, k_scale, v_scale,
                     page_table + (long)b * max_pages, n, kvh, Hk, hd, group,
                     page_size, out + row, smem);
}

template <typename T, typename P>
static int launch(const void* q, const void* k, const void* v, const float* ks,
                  const float* vs, const int* pt, const int* seq_lens, void* out,
                  int B, int H, int Hk, int hd, int page_size, int max_pages,
                  cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * smem_floats(H / Hk, hd, std::is_same<P, int8_t>::value);
  cudaError_t err = allow_smem(paged_decode_kernel<T, P>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B, Hk);
  paged_decode_kernel<T, P><<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const P*)k, (const P*)v, ks, vs, pt, seq_lens, (T*)out, H, Hk,
      hd, page_size, max_pages);
  return (int)cudaGetLastError();
}

// ---- q in bf16: split over the context, tensor cores, combine pass ----------

namespace split {

constexpr int SPLIT = 512;                 // context positions per block
constexpr int WARPS = 4;                   // warps per block
constexpr int WARP_POS = 16;               // positions per warp and tile
constexpr int KV_TILE = WARPS * WARP_POS;  // positions per block tile
constexpr int THREADS = WARPS * 32;
constexpr int MAX_GROUP = 8;               // query heads per kv head, at most
constexpr int STAGES = 2;                  // ring depth of each warp
constexpr int PAD_BF16 = 8;   // bf16 padding per shared row (ldmatrix banks)
constexpr int PAD_INT8 = 16;  // bytes of padding per shared int8 row (banks)

// One warp's shared memory: its ring, reused for its merge record
// (MAX_GROUP maxima, MAX_GROUP sums, MAX_GROUP x hd partial O, f32).
__host__ __device__ constexpr int stage_bytes(int hd, bool quantized) {
  return quantized ? 2 * WARP_POS * (hd + PAD_INT8) + 2 * WARP_POS * 4
                   : 2 * WARP_POS * (hd + PAD_BF16) * 2;
}
__host__ __device__ constexpr int warp_bytes(int hd, bool quantized) {
  return STAGES * stage_bytes(hd, quantized) > (2 + hd) * MAX_GROUP * 4
             ? STAGES * stage_bytes(hd, quantized)
             : (2 + hd) * MAX_GROUP * 4;
}
// Dynamic shared memory of one block; decode_launch_plan mirrors this.
__host__ __device__ constexpr int smem_bytes(int hd, bool quantized) {
  return WARPS * warp_bytes(hd, quantized);
}

// The four int8 of w as f32, exactly, without the conversion unit: each
// byte, biased to unsigned, becomes the low mantissa byte of 2^23, and
// the bias and 2^23 are subtracted in f32.
__device__ __forceinline__ void int8x4_f32(uint32_t w, float (&f)[4]) {
  const uint32_t u = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - 8388736.f;
}

// Two f32 holding integers of at most 8 significant bits as bf16x2
// (`lo` in the low half): their bf16 is exactly their upper 16 bits.
__device__ __forceinline__ uint32_t pack_exact_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

template <typename P, int HD>
__global__ void __launch_bounds__(THREADS)
paged_decode_split_kernel(const bf16* __restrict__ q, const P* __restrict__ k_pool,
                          const P* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ page_table,
                          const int* __restrict__ seq_lens, bf16* __restrict__ out,
                          float* __restrict__ scratch, int H, int Hk, int page_size,
                          int max_pages, int n_splits) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int KD = HD / 16;          // k-steps of Q K^T
  constexpr int ND = HD / 8;           // n-tiles of O
  constexpr int LD = HD + PAD_BF16;    // bf16 row stride of a shared K/V row
  constexpr int LB = HD + PAD_INT8;    // byte row stride of a shared int8 row
  // int8 V: lane column gid of n-tile dn holds head-dim element
  // (dn / E) * 8E + gid * E + dn % E, so one 32-bit (E = 4) or 16-bit
  // (hd 16: E = 2) read of a row feeds E n-tiles.
  constexpr int E = ND >= 4 ? 4 : ND;
  static_assert(HD % 16 == 0, "head dim");
  extern __shared__ __align__(16) unsigned char smem_raw[];

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int n = max(0, min(seq_lens[b], max_pages * page_size));
  const int lo = s * SPLIT;
  if (lo >= n) return;
  const int hi = min(lo + SPLIT, n);
  const int group = H / Hk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int* pt_row = page_table + (long)b * max_pages;
  unsigned char* wsm = smem_raw + warp * warp_bytes(HD, kQuant);

  // Q as mma A fragments (row gid = query head gid of this kv head; rows
  // past the group and rows 8-15 are zero), straight from global memory.
  uint32_t qf[KD][4];
  {
    const bool real = gid < group;
    const bf16* qrow = q + ((long)b * H + (long)kvh * group + (real ? gid : 0)) * HD;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t a0 = 0u, a2 = 0u;
      if (real) {
        if constexpr (kQuant) {  // k index 2t, 2t+1 | 2t+8, 2t+9 -> d 4t..4t+3
          const uint2 w = *reinterpret_cast<const uint2*>(qrow + kk * 16 + tig * 4);
          a0 = w.x;
          a2 = w.y;
        } else {
          const uint32_t* r = reinterpret_cast<const uint32_t*>(qrow + kk * 16 + tig * 2);
          a0 = r[0];
          a2 = r[4];
        }
      }
      qf[kk][0] = a0;
      qf[kk][1] = 0u;
      qf[kk][2] = a2;
      qf[kk][3] = 0u;
    }
  }

  // The warp's tiles: positions lo + j * KV_TILE + 16 warp + [0, 16).
  const int first = lo + warp * WARP_POS;
  const int n_tiles = first < hi ? (hi - first + KV_TILE - 1) / KV_TILE : 0;

  // Issue the loads of the warp's tile j into ring stage st (the caller
  // commits them as one group).
  auto issue = [&](int j, int st) {
    const int base = first + j * KV_TILE;
    int slot = -1;  // lanes 0-15: the slot of position base + lane
    if (lane < WARP_POS && base + lane < hi) {
      const int pos = base + lane;
      slot = pt_row[pos / page_size] * page_size + pos % page_size;
    }
    unsigned char* stage = wsm + st * stage_bytes(HD, kQuant);
    constexpr int CH = kQuant ? HD / 16 : HD / 8;  // 16-byte chunks per row
    constexpr int ROW = kQuant ? LB : LD * 2;      // bytes per shared row
#pragma unroll
    for (int i = 0; i < (WARP_POS * CH + 31) / 32; ++i) {
      const int idx = i * 32 + lane;
      const int p = (idx / CH) & (WARP_POS - 1);
      const int c = idx % CH;
      const int sl = __shfl_sync(0xffffffffu, slot, p);
      if (idx < WARP_POS * CH) {
        unsigned char* kdst = stage + p * ROW + c * 16;
        unsigned char* vdst = kdst + WARP_POS * ROW;
        if (sl >= 0) {
          const long off = ((long)sl * Hk + kvh) * HD * (long)sizeof(P) + c * 16;
          cp_async16(kdst, reinterpret_cast<const unsigned char*>(k_pool) + off);
          cp_async16(vdst, reinterpret_cast<const unsigned char*>(v_pool) + off);
        } else {
          *reinterpret_cast<uint4*>(kdst) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vdst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    if constexpr (kQuant) {  // the rows' f32 scales, in the same stage
      float* ksd = reinterpret_cast<float*>(stage + 2 * WARP_POS * LB);
      if (lane < WARP_POS) {
        if (slot >= 0) {
          cp_async4(ksd + lane, k_scale + (long)slot * Hk + kvh);
          cp_async4(ksd + WARP_POS + lane, v_scale + (long)slot * Hk + kvh);
        } else {
          ksd[lane] = ksd[WARP_POS + lane] = 0.f;
        }
      }
    }
  };

  float o[ND][4];  // O rows gid (entries 0, 1) and gid + 8 (padding)
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m_run = -INFINITY;  // row gid's running max, log2 units
  float l_run = 0.f;        // this thread's part of row gid's running sum
  const float scale_log2 = rsqrtf((float)HD) * 1.4426950408889634f;

  // STAGES - 1 tiles in flight ahead of the one being multiplied; one
  // commit group per tile slot (empty past the last tile), so tile j has
  // landed once at most STAGES - 1 groups are pending.
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < n_tiles) issue(j, j);
    cp_async_commit();
  }
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % STAGES;
    __syncwarp();  // every lane is done reading the stage issue() refills
    if (j + STAGES - 1 < n_tiles) issue(j + STAGES - 1, (j + STAGES - 1) % STAGES);
    cp_async_commit();
    cp_async_wait_group<STAGES - 1>();
    __syncwarp();  // tile j has landed for every lane of the warp
    const int base = first + j * KV_TILE;
    const unsigned char* stage = wsm + st * stage_bytes(HD, kQuant);

    // S = Q K^T for the warp's 16 positions: n-tiles 0 and 1.
    float sacc[2][4];
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) sacc[jn][0] = sacc[jn][1] = sacc[jn][2] = sacc[jn][3] = 0.f;
    if constexpr (kQuant) {
      const unsigned char* k8 = stage;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
        for (int jn = 0; jn < 2; ++jn) {
          float f[4];
          int8x4_f32(*reinterpret_cast<const uint32_t*>(k8 + (jn * 8 + gid) * LB + kk * 16 +
                                                        tig * 4),
                     f);
          mma_bf16(sacc[jn], qf[kk], pack_exact_bf16(f[0], f[1]), pack_exact_bf16(f[2], f[3]));
        }
      }
      const float* ksc = reinterpret_cast<const float*>(stage + 2 * WARP_POS * LB);
#pragma unroll
      for (int jn = 0; jn < 2; ++jn) {
        sacc[jn][0] *= ksc[jn * 8 + tig * 2];
        sacc[jn][1] *= ksc[jn * 8 + tig * 2 + 1];
      }
    } else {
      const bf16* ks = reinterpret_cast<const bf16*>(stage);
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t bq[4];
        ldsm_x4(bq, ks + ((lane >> 4) * 8 + (lane & 7)) * LD + kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[0], qf[kk], bq[0], bq[1]);
        mma_bf16(sacc[1], qf[kk], bq[2], bq[3]);
      }
    }

    // Online softmax of row gid in f32: mask past the range, rescale.
    float mx = -INFINITY;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pos = base + jn * 8 + tig * 2 + e;
        const float v = pos < hi ? sacc[jn][e] * scale_log2 : -INFINITY;
        sacc[jn][e] = v;
        mx = fmaxf(mx, v);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    const float alpha = m_run == -INFINITY ? 0.f : exp2f(m_run - m_new);
    m_run = m_new;
    float sum = 0.f;
#pragma unroll
    for (int jn = 0; jn < 2; ++jn) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = sacc[jn][e];
        const float p = v == -INFINITY ? 0.f : exp2f(v - m_new);
        sacc[jn][e] = p;
        sum += p;
      }
    }
    l_run = l_run * alpha + sum;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= alpha;
      o[dn][1] *= alpha;
    }

    // O += P V: P (bf16) from the S accumulators as the A fragment.
    if constexpr (kQuant) {
      const unsigned char* v8 = stage + WARP_POS * LB;
      const float* vsc = reinterpret_cast<const float*>(stage + 2 * WARP_POS * LB) + WARP_POS;
      const uint32_t pf[4] = {
          pack_bf16(sacc[0][0] * vsc[tig * 2], sacc[0][1] * vsc[tig * 2 + 1]), 0u,
          pack_bf16(sacc[1][0] * vsc[8 + tig * 2], sacc[1][1] * vsc[8 + tig * 2 + 1]), 0u};
#pragma unroll
      for (int dq = 0; dq < ND / E; ++dq) {
        // Rows (positions) 2t, 2t+1, 2t+8, 2t+9; E bytes of head dim each.
        float f[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const unsigned char* src = v8 + (tig * 2 + (r & 1) + (r >> 1) * 8) * LB +
                                     dq * 8 * E + gid * E;
          if constexpr (E == 4)
            int8x4_f32(*reinterpret_cast<const uint32_t*>(src), f[r]);
          else
            int8x4_f32(*reinterpret_cast<const uint16_t*>(src), f[r]);
        }
#pragma unroll
        for (int e = 0; e < E; ++e)
          mma_bf16(o[dq * E + e], pf, pack_exact_bf16(f[0][e], f[1][e]),
                   pack_exact_bf16(f[2][e], f[3][e]));
      }
    } else {
      const bf16* vs = reinterpret_cast<const bf16*>(stage) + WARP_POS * LD;
      const uint32_t pf[4] = {pack_bf16(sacc[0][0], sacc[0][1]), 0u,
                              pack_bf16(sacc[1][0], sacc[1][1]), 0u};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vs + ((lane & 7) + ((lane >> 3) & 1) * 8) * LD + (dn + (lane >> 4)) * 8);
        mma_bf16(o[dn], pf, bv[0], bv[1]);
        mma_bf16(o[dn + 1], pf, bv[2], bv[3]);
      }
    }
  }

  // The warp's record, over its own ring: max and sum of each row, then
  // its unnormalised O in head-dim order.
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 1);
  l_run += __shfl_xor_sync(0xffffffffu, l_run, 2);
  __syncwarp();
  float* rec = reinterpret_cast<float*>(wsm);
  float* rec_o = rec + 2 * MAX_GROUP;
  if (tig == 0) {
    rec[gid] = m_run;
    rec[MAX_GROUP + gid] = l_run;
  }
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int col = tig * 2 + c;
      const int d = kQuant ? (dn / E) * 8 * E + col * E + dn % E : dn * 8 + col;
      rec_o[gid * HD + d] = o[dn][c];
    }
  }
  __syncthreads();

  // Merge the warps; write the output row, or this split's partial.
  const bool alone = n <= SPLIT;  // the sequence's only split with work
  const long row0 = (long)b * H + (long)kvh * group;
  float* part = scratch + (((long)b * Hk + kvh) * n_splits + s) * group * (HD + 2);
  for (int i = tid; i < group * HD; i += THREADS) {
    const int g = i / HD, d = i - g * HD;
    float mw[WARPS];
    float m_all = -INFINITY;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      mw[w] = reinterpret_cast<const float*>(smem_raw + w * warp_bytes(HD, kQuant))[g];
      m_all = fmaxf(m_all, mw[w]);
    }
    float l_all = 0.f, acc = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const float* r = reinterpret_cast<const float*>(smem_raw + w * warp_bytes(HD, kQuant));
      const float wt = mw[w] == -INFINITY ? 0.f : exp2f(mw[w] - m_all);
      l_all += wt * r[MAX_GROUP + g];
      acc += wt * r[2 * MAX_GROUP + g * HD + d];
    }
    if (alone) {
      out[(row0 + g) * HD + d] = __float2bfloat16(acc / fmaxf(l_all, 1e-20f));
    } else {
      part[g * (HD + 2) + d] = acc;
      if (d == 0) {
        part[g * (HD + 2) + HD] = m_all;
        part[g * (HD + 2) + HD + 1] = l_all;
      }
    }
  }
}

// Reduce the partials of the sequences with more than one split that had
// work; zero the rows of sequences with nothing visible. Grid (Hk, B).
__global__ void __launch_bounds__(THREADS)
paged_decode_combine_kernel(const float* __restrict__ scratch,
                            const int* __restrict__ seq_lens, bf16* __restrict__ out,
                            int H, int Hk, int hd, int page_size, int max_pages,
                            int n_splits) {
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int n = max(0, min(seq_lens[b], max_pages * page_size));
  const int n_work = (n + SPLIT - 1) / SPLIT;  // splits that had work
  if (n_work == 1) return;                     // written by the split kernel
  const int group = H / Hk;
  bf16* rows = out + ((long)b * H + (long)kvh * group) * hd;
  const float* part = scratch + ((long)b * Hk + kvh) * n_splits * group * (hd + 2);
  for (int i = threadIdx.x; i < group * hd; i += blockDim.x) {
    if (n_work == 0) {
      rows[i] = __float2bfloat16(0.f);
      continue;
    }
    const int g = i / hd, d = i - g * hd;
    float m_all = -INFINITY;
    for (int sp = 0; sp < n_work; ++sp)
      m_all = fmaxf(m_all, part[(sp * group + g) * (hd + 2) + hd]);
    float l_all = 0.f, acc = 0.f;
    for (int sp = 0; sp < n_work; ++sp) {
      const float* r = part + (sp * group + g) * (hd + 2);
      const float wt = exp2f(r[hd] - m_all);  // every split with work has a finite max
      l_all += wt * r[hd + 1];
      acc += wt * r[d];
    }
    rows[i] = __float2bfloat16(acc / fmaxf(l_all, 1e-20f));
  }
}

template <typename P, int HD>
static int launch_hd(const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const int* pt, const int* seq_lens, void* out,
                     void* scratch, int B, int H, int Hk, int page_size, int max_pages,
                     int split, int kv_tile, int threads, int smem, int n_splits,
                     cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int group = H / Hk;
  // The plan computed on the host must be the one this kernel was built for.
  if (group < 1 || group > MAX_GROUP || split != SPLIT || kv_tile != KV_TILE ||
      threads != THREADS || smem != smem_bytes(HD, kQuant) ||
      n_splits != (max_pages * page_size + SPLIT - 1) / SPLIT || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(paged_decode_split_kernel<P, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  paged_decode_split_kernel<P, HD><<<dim3(n_splits, Hk, B), THREADS, smem, stream>>>(
      (const bf16*)q, (const P*)k, (const P*)v, ks, vs, pt, seq_lens, (bf16*)out,
      (float*)scratch, H, Hk, page_size, max_pages, n_splits);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  paged_decode_combine_kernel<<<dim3(Hk, B), THREADS, 0, stream>>>(
      (const float*)scratch, seq_lens, (bf16*)out, H, Hk, HD, page_size, max_pages,
      n_splits);
  return (int)cudaGetLastError();
}

template <typename P>
static int launch(const void* q, const void* k, const void* v, const float* ks,
                  const float* vs, const int* pt, const int* seq_lens, void* out,
                  void* scratch, int B, int H, int Hk, int hd, int page_size,
                  int max_pages, int split, int kv_tile, int threads, int smem,
                  int n_splits, cudaStream_t stream) {
#define DECODE_SPLIT_HD(HD)                                                         \
  case HD:                                                                        \
    return launch_hd<P, HD>(q, k, v, ks, vs, pt, seq_lens, out, scratch, B, H, Hk, \
                            page_size, max_pages, split, kv_tile, threads, smem,    \
                            n_splits, stream);
  switch (hd) {
    DECODE_SPLIT_HD(16)
    DECODE_SPLIT_HD(32)
    DECODE_SPLIT_HD(64)
    DECODE_SPLIT_HD(128)
  }
#undef DECODE_SPLIT_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace split

// ---- entry points -----------------------------------------------------------
// The launch plan (split, kv_tile, threads, smem_bytes, n_splits) and the
// f32 scratch buffer [B, Hk, n_splits, group, hd + 2] are read for q in
// bf16 only; the float32 path ignores them.

extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* seq_lens, void* out, void* scratch,
                                      int B, int H, int Hk, int hd, int page_size,
                                      int max_pages, int split, int kv_tile,
                                      int threads, int smem_bytes, int n_splits,
                                      int dtype, void* stream) {
  const int* pt = (const int*)page_table;
  const int* sl = (const int*)seq_lens;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, pt, sl, out,
                                  B, H, Hk, hd, page_size, max_pages, s);
    case BF16:
      return split::launch<__nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr, pt, sl,
                                          out, scratch, B, H, Hk, hd, page_size,
                                          max_pages, split, kv_tile, threads,
                                          smem_bytes, n_splits, s);
  }
  return (int)cudaErrorInvalidValue;
}

// int8 pools: k_pool / v_pool int8 [S, Hk, hd], k_scale / v_scale f32
// [S, Hk]; `dtype` is q's (and out's).
extern "C" int paged_decode_attention_int8(const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scale,
                                           const void* v_scale,
                                           const void* page_table,
                                           const void* seq_lens, void* out,
                                           void* scratch, int B, int H, int Hk, int hd,
                                           int page_size, int max_pages, int split,
                                           int kv_tile, int threads, int smem_bytes,
                                           int n_splits, int dtype, void* stream) {
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* pt = (const int*)page_table;
  const int* sl = (const int*)seq_lens;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch<float, int8_t>(q, k_pool, v_pool, ks, vs, pt, sl, out, B, H,
                                   Hk, hd, page_size, max_pages, s);
    case BF16:
      return split::launch<int8_t>(q, k_pool, v_pool, ks, vs, pt, sl, out, scratch, B,
                                   H, Hk, hd, page_size, max_pages, split, kv_tile,
                                   threads, smem_bytes, n_splits, s);
  }
  return (int)cudaErrorInvalidValue;
}
