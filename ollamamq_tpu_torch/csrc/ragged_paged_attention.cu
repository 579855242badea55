// Ragged mixed-batch paged attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ragged_paged_attention_pallas
// (ollamamq_tpu/ops/pallas/ragged_attention.py, body _ragged_kernel). One
// flattened stream q [T, H, hd] holds any mix of prefill spans and decode
// tokens: sequence s owns rows [q_start[s], q_start[s] + q_len[s]), row i
// of that span sits at kv position kv_len[s] - q_len[s] + i and attends
// positions <= that position (and < kv_len[s]) of s's paged context,
// clamped to max_pages * page_size. Rows that no span covers (stream
// padding) write exact zeros. Spans are contiguous and ascending in
// stream order; padding sequences carry q_len = 0, q_start = T.
//
// Two entry points: ragged_paged_attention (pool in q's dtype) and
// ragged_paged_attention_int8 (the quantized=True variant: int8 pool plus
// f32 [S, Hk] scale planes).
//
// Bound on the card: bytes. Each sequence's visible K/V rows are the
// data; the arithmetic (4 * hd FLOPs per query head and visible
// position) is far below the tensor cores' rate. So the design reads
// each K/V row once per query tile instead of once per query row, and
// keeps the loads in flight while the previous tile is multiplied.
//
// q in bf16 (the serving path), ragged_paged_kernel_tc:
//   - One block per (sequence, query tile of QT consecutive rows of its
//     span, kv head). Its matrix rows are the tile's QT tokens times the
//     kv head's `group` query heads, padded to a multiple of 16; each
//     warp owns 16 of them. The host-side launch plan
//     (ops/cuda/ragged_attention.py: launch_plan) picks QT, the K/V tile
//     length, the threads and the shared-memory bytes; this file checks
//     them against its own formulas before it launches.
//   - Grid (ceil(T / QT) + B, Hk): an upper bound on the work items that
//     depends on shapes only (no host sync, safe to capture in a CUDA
//     graph). A block finds its (sequence, tile) by a warp scan of
//     ceil(q_len / QT) over the sequences; blocks past the last work item
//     write the zeros of the stream rows that no span covers, so every
//     output row is written by the kernel.
//   - The tile walks positions [0, n_tile), n_tile being its last row's
//     frontier, in tiles of KV_TILE positions resolved through the page
//     table. 16-byte cp.async loads fill a two-stage ring in shared
//     memory: tile j+1 is in flight while tile j is multiplied. An int8
//     pool stages its payload and its f32 scales the same way, and a
//     pass dequantizes them, (float)q * scale rounded to bf16, into the
//     tile the tensor cores read. Positions >= n_tile are never loaded
//     (nor their scales): their rows in shared memory are zero-filled,
//     so stale slots, NaN included, never reach an mma.
//   - S = Q K^T and O += P V on tensor cores (mma.sync m16n8k16, bf16 in,
//     f32 accumulate; P rounded to bf16), softmax scale, row max and row
//     sum in f32 registers. Each row masks its own positions past its
//     frontier; the online softmax keeps the TPU kernel's guards (alpha
//     is 0 while the running max is -inf, masked positions add 0), and a
//     row with nothing visible writes exact zeros.
//   - Left for later: wgmma and TMA (the paged gather cuts a K/V tile into
//     page-size runs), deeper rings, splitting a long context over blocks.
//
// q in float32: ragged_paged_kernel, one block per (stream row, kv head)
// over attend_token (paged_attention_common.cuh), scalar f32 math; it is
// held to 1e-4, which a bf16 tensor-core product cannot meet.

#include "paged_attention_common.cuh"
#include "paged_attention_tc.cuh"

using namespace paged_attn;

// ---- q in float32: one block per (stream row, kv head) ----------------------

template <typename T, typename P>
__global__ void __launch_bounds__(THREADS)
ragged_paged_kernel(const T* __restrict__ q, const P* __restrict__ k_pool,
                    const P* __restrict__ v_pool, const float* __restrict__ k_scale,
                    const float* __restrict__ v_scale,
                    const int* __restrict__ page_table,
                    const int* __restrict__ q_start, const int* __restrict__ q_lens,
                    const int* __restrict__ kv_lens, T* __restrict__ out, int B, int H,
                    int Hk, int hd, int page_size, int max_pages) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int kvh = blockIdx.y;
  const int group = H / Hk;
  // First sequence whose span ends past row t.
  int lo = 0, hi = B;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (q_start[mid] + q_lens[mid] <= t) lo = mid + 1; else hi = mid;
  }
  int n = 0;
  int s = lo;
  if (s < B && q_lens[s] > 0 && q_start[s] <= t) {
    const int row_pos = kv_lens[s] - q_lens[s] + (t - q_start[s]);
    n = min(row_pos + 1, kv_lens[s]);
    n = max(0, min(n, max_pages * page_size));
  } else {
    s = 0;  // uncovered row: n = 0 writes zeros, the page table is not read
  }
  const long row = ((long)t * H + (long)kvh * group) * hd;
  attend_token<T, P>(q + row, k_pool, v_pool, k_scale, v_scale,
                     page_table + (long)s * max_pages, n, kvh, Hk, hd, group,
                     page_size, out + row, smem);
}

template <typename T, typename P>
static int launch(const void* q, const void* k, const void* v, const float* ks,
                  const float* vs, const int* pt, const int* qs, const int* ql,
                  const int* kl, void* out, int T_rows, int B, int H, int Hk, int hd,
                  int page_size, int max_pages, cudaStream_t stream) {
  const size_t bytes =
      sizeof(float) * smem_floats(H / Hk, hd, std::is_same<P, int8_t>::value);
  cudaError_t err = allow_smem(ragged_paged_kernel<T, P>, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(T_rows, Hk);
  ragged_paged_kernel<T, P><<<grid, THREADS, bytes, stream>>>(
      (const T*)q, (const P*)k, (const P*)v, ks, vs, pt, qs, ql, kl, (T*)out, B, H,
      Hk, hd, page_size, max_pages);
  return (int)cudaGetLastError();
}

// ---- q in bf16: one block per (query tile, kv head), tensor cores -----------

namespace tc {

constexpr int KV_TILE = 64;   // context positions per K/V tile
constexpr int ROW_PAD = 8;    // bf16 padding per shared row (ldmatrix banks)
constexpr int MAX_ROWS = 128; // matrix rows per block at most (8 warps)

// Dynamic shared memory of one block; launch_plan mirrors this formula.
__host__ __device__ constexpr int smem_bytes(int hd, bool quantized) {
  return quantized
             ? 2 * 2 * KV_TILE * hd                    // int8 K, V ring (2 stages)
                   + 2 * 2 * KV_TILE * 4               // their f32 scales
                   + 2 * KV_TILE * (hd + ROW_PAD) * 2  // dequantized bf16 K, V
             : 2 * 2 * KV_TILE * (hd + ROW_PAD) * 2;   // bf16 K, V ring
}

template <typename P, int HD>
__global__ void __launch_bounds__(MAX_ROWS / 16 * 32)
ragged_paged_kernel_tc(const bf16* __restrict__ q, const P* __restrict__ k_pool,
                       const P* __restrict__ v_pool, const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ q_start, const int* __restrict__ q_lens,
                       const int* __restrict__ kv_lens, bf16* __restrict__ out, int T,
                       int B, int H, int Hk, int page_size, int max_pages, int QT) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  constexpr int KT = KV_TILE;
  constexpr int LD = HD + ROW_PAD;  // bf16 row stride of a shared K/V tile
  constexpr int NT = KT / 8;        // n-tiles of S per warp
  constexpr int KD = HD / 16;       // k-steps of Q K^T
  constexpr int ND = HD / 8;        // n-tiles of O per warp
  static_assert(HD % 16 == 0 && KT % 16 == 0, "tile shapes");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ int work[3];  // sequence (-1: none), query tile, work items

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nthr = blockDim.x;
  const int kvh = blockIdx.y;
  const int group = H / Hk;
  const int w = blockIdx.x;

  // Work item w: the w-th (sequence, query tile) in sequence order.
  if (warp == 0) {
    int carry = 0, found = -1, found_tile = 0;
    for (int base = 0; base < B; base += 32) {
      const int i = base + lane;
      const int n = i < B ? (max(q_lens[i], 0) + QT - 1) / QT : 0;
      int incl = n;
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const int excl = carry + incl - n;
      if (w >= excl && w < excl + n) {
        found = i;
        found_tile = w - excl;
      }
      carry += __shfl_sync(0xffffffffu, incl, 31);
    }
    const unsigned hit = __ballot_sync(0xffffffffu, found >= 0);
    const int src = hit ? __ffs(hit) - 1 : 0;
    found = __shfl_sync(0xffffffffu, found, src);
    found_tile = __shfl_sync(0xffffffffu, found_tile, src);
    if (lane == 0) {
      work[0] = hit ? found : -1;
      work[1] = found_tile;
      work[2] = carry;
    }
  }
  __syncthreads();
  const int s = work[0];

  if (s < 0) {
    // Past the last work item: zero this kv head's slice of every stream
    // row that no span covers, rows strided over the tail blocks.
    const int items = work[2];
    const int n_tail = gridDim.x - items;
    for (int r = (w - items) * nthr + tid; r < T; r += n_tail * nthr) {
      int lo = 0, hi = B;  // first sequence whose span ends past row r
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (q_start[mid] + q_lens[mid] <= r) lo = mid + 1; else hi = mid;
      }
      if (lo < B && q_lens[lo] > 0 && q_start[lo] <= r) continue;
      uint4* dst = reinterpret_cast<uint4*>(out + ((long)r * H + (long)kvh * group) * HD);
      for (int c = 0; c < group * HD / 8; ++c) dst[c] = make_uint4(0u, 0u, 0u, 0u);
    }
    return;
  }

  const int ql = q_lens[s], kvl = kv_lens[s], qs = q_start[s];
  const int cap = max_pages * page_size;
  const int first = work[1] * QT;       // the tile's first token in the span
  const int n_tok = min(QT, ql - first);
  const int pos0 = kvl - ql + first;    // kv position of that token
  // Positions token i of the tile attends: [0, visible(i)).
  auto visible = [&](int i) { return max(0, min(min(pos0 + i + 1, kvl), cap)); };
  const int n_tile = visible(n_tok - 1);  // the deepest frontier
  const int* pt_row = page_table + (long)s * max_pages;

  // This thread's two matrix rows (mma fragment rows gid and gid + 8).
  const int gid = lane >> 2, tig = lane & 3;
  long qoff[2];
  int nvis[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = warp * 16 + gid + 8 * h;
    const int i = m / group;
    qoff[h] = -1;
    nvis[h] = 0;
    if (i < n_tok && qs + first + i < T) {
      qoff[h] = ((long)(qs + first + i) * H + (long)kvh * group + (m - i * group)) * HD;
      nvis[h] = visible(i);
    }
  }
  const int warp_vis = __reduce_max_sync(0xffffffffu, max(nvis[0], nvis[1]));

  // Q as mma A fragments, straight from global memory (padding rows 0).
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      qf[kk][h] = qf[kk][h + 2] = 0u;
      if (qoff[h] >= 0) {  // columns c, c + 1 and c + 8, c + 9
        const uint32_t* row =
            reinterpret_cast<const uint32_t*>(q + qoff[h] + kk * 16 + tig * 2);
        qf[kk][h] = row[0];
        qf[kk][h + 2] = row[4];
      }
    }
  }

  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};  // this thread's partial row sums
  const float scale_log2 = rsqrtf((float)HD) * 1.4426950408889634f;

  bf16* ring = reinterpret_cast<bf16*>(smem_raw);          // bf16 pool
  int8_t* raw = reinterpret_cast<int8_t*>(smem_raw);       // int8 pool
  float* scl = reinterpret_cast<float*>(raw + 4 * KT * HD);
  bf16* deq = reinterpret_cast<bf16*>(scl + 4 * KT);

  // Issue the loads of the tile at t0 into ring stage st.
  auto issue = [&](int t0, int st) {
    if constexpr (!kQuant) {
      constexpr int CH = HD / 8;  // 16-byte chunks per row
      bf16* kd = ring + st * 2 * KT * LD;
      bf16* vd = kd + KT * LD;
      for (int idx = tid; idx < KT * CH; idx += nthr) {
        const int p = idx / CH, c = idx % CH;
        const int pos = t0 + p;
        bf16* kdst = kd + p * LD + c * 8;
        bf16* vdst = vd + p * LD + c * 8;
        if (pos < n_tile) {
          const long slot = (long)pt_row[pos / page_size] * page_size + pos % page_size;
          const long off = (slot * Hk + kvh) * HD + c * 8;
          cp_async16(kdst, k_pool + off);
          cp_async16(vdst, v_pool + off);
        } else {
          *reinterpret_cast<uint4*>(kdst) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vdst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    } else {
      constexpr int CH = HD / 16;  // 16-byte chunks per int8 row
      int8_t* kd = raw + st * 2 * KT * HD;
      int8_t* vd = kd + KT * HD;
      float* ksd = scl + st * 2 * KT;
      float* vsd = ksd + KT;
      for (int idx = tid; idx < KT * CH; idx += nthr) {
        const int p = idx / CH, c = idx % CH;
        const int pos = t0 + p;
        int8_t* kdst = kd + p * HD + c * 16;
        int8_t* vdst = vd + p * HD + c * 16;
        if (pos < n_tile) {
          const long slot = (long)pt_row[pos / page_size] * page_size + pos % page_size;
          const long row = slot * Hk + kvh;
          cp_async16(kdst, k_pool + row * HD + c * 16);
          cp_async16(vdst, v_pool + row * HD + c * 16);
          if (c == 0) {
            cp_async4(ksd + p, k_scale + row);
            cp_async4(vsd + p, v_scale + row);
          }
        } else {
          *reinterpret_cast<uint4*>(kdst) = make_uint4(0u, 0u, 0u, 0u);
          *reinterpret_cast<uint4*>(vdst) = make_uint4(0u, 0u, 0u, 0u);
          if (c == 0) ksd[p] = vsd[p] = 0.f;
        }
      }
    }
    cp_async_commit();
  };

  const int n_kv = (n_tile + KT - 1) / KT;
  if (n_kv > 0) issue(0, 0);
  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1, t0 = j * KT;
    cp_async_wait_all();
    __syncthreads();  // tile j has landed; every warp is done with tile j-1
    if (j + 1 < n_kv) issue(t0 + KT, st ^ 1);

    const bf16* ks;
    const bf16* vs;
    if constexpr (kQuant) {
      // (float)q * scale, rounded to bf16, into the tile the mma reads.
      constexpr int CH = HD / 16;
      for (int idx = tid; idx < 2 * KT * CH; idx += nthr) {
        const int pl = idx / (KT * CH);
        const int rem = idx - pl * KT * CH;
        const int p = rem / CH, c = rem % CH;
        const int4 v = *reinterpret_cast<const int4*>(raw + ((st * 2 + pl) * KT + p) * HD + c * 16);
        const float sc = scl[(st * 2 + pl) * KT + p];
        const uint32_t words[4] = {(uint32_t)v.x, (uint32_t)v.y, (uint32_t)v.z,
                                   (uint32_t)v.w};
        uint32_t packed[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {  // bytes 2e, 2e + 1, sign-extended
          const uint32_t w = words[e / 2];
          const int sh = (e % 2) * 16;
          packed[e] = pack_bf16((float)((int)(w << (24 - sh)) >> 24) * sc,
                                (float)((int)(w << (16 - sh)) >> 24) * sc);
        }
        uint4* dst = reinterpret_cast<uint4*>(deq + (pl * KT + p) * LD + c * 16);
        dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
        dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
      }
      __syncthreads();
      ks = deq;
      vs = deq + KT * LD;
    } else {
      ks = ring + st * 2 * KT * LD;
      vs = ks + KT * LD;
    }
    if (warp_vis <= t0) continue;  // nothing of this tile is visible to the warp

    // S = Q K^T for the warp's 16 rows and the tile's KT positions.
    float sacc[NT][4];
#pragma unroll
    for (int jn = 0; jn < NT; ++jn) sacc[jn][0] = sacc[jn][1] = sacc[jn][2] = sacc[jn][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jn = 0; jn < NT; jn += 2) {
        uint32_t b[4];
        ldsm_x4(b, ks + ((jn + (lane >> 4)) * 8 + (lane & 7)) * LD + kk * 16 +
                       ((lane >> 3) & 1) * 8);
        mma_bf16(sacc[jn], qf[kk], b[0], b[1]);
        mma_bf16(sacc[jn + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax in f32: mask past each row's frontier, rescale.
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int pos = t0 + jn * 8 + tig * 2 + e;
          const float v = pos < nvis[h] ? sacc[jn][2 * h + e] * scale_log2 : -INFINITY;
          sacc[jn][2 * h + e] = v;
          mx = fmaxf(mx, v);
        }
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_run[h], mx);
      alpha[h] = m_run[h] == -INFINITY ? 0.f : exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < NT; ++jn) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = sacc[jn][2 * h + e];
          const float p = v == -INFINITY ? 0.f : exp2f(v - m_new);
          sacc[jn][2 * h + e] = p;
          sum += p;
        }
      }
      l_run[h] = l_run[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V: P (bf16) from the S accumulators as A fragments.
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(sacc[2 * kk][0], sacc[2 * kk][1]),
                              pack_bf16(sacc[2 * kk][2], sacc[2 * kk][3]),
                              pack_bf16(sacc[2 * kk + 1][0], sacc[2 * kk + 1][1]),
                              pack_bf16(sacc[2 * kk + 1][2], sacc[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        uint32_t b[4];
        ldsm_x4_trans(b, vs + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                             (dn + (lane >> 4)) * 8);
        mma_bf16(o[dn], pf, b[0], b[1]);
        mma_bf16(o[dn + 1], pf, b[2], b[3]);
      }
    }
  }

  // Row sums over the quad, then out = O / l (exact zeros when l = 0).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float l = l_run[h];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    if (qoff[h] < 0) continue;
    const float inv = 1.f / fmaxf(l, 1e-20f);
    uint32_t* row = reinterpret_cast<uint32_t*>(out + qoff[h]);
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      row[(dn * 8 + tig * 2) / 2] = pack_bf16(o[dn][2 * h] * inv, o[dn][2 * h + 1] * inv);
  }
}

template <typename P, int HD>
static int launch_hd(const void* q, const void* k, const void* v, const float* ks,
                     const float* vs, const int* pt, const int* qs, const int* ql,
                     const int* kl, void* out, int T_rows, int B, int H, int Hk,
                     int page_size, int max_pages, int q_tile, int kv_tile, int threads,
                     int smem, int blocks, cudaStream_t stream) {
  constexpr bool kQuant = std::is_same<P, int8_t>::value;
  const int rows = (q_tile * (H / Hk) + 15) / 16 * 16;
  // The plan computed on the host must be the one this kernel was built for.
  if (q_tile < 1 || kv_tile != KV_TILE || rows > MAX_ROWS || threads != rows / 16 * 32 ||
      smem != smem_bytes(HD, kQuant) || blocks != (T_rows + q_tile - 1) / q_tile + B)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ragged_paged_kernel_tc<P, HD>, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(blocks, Hk);
  ragged_paged_kernel_tc<P, HD><<<grid, threads, smem, stream>>>(
      (const bf16*)q, (const P*)k, (const P*)v, ks, vs, pt, qs, ql, kl, (bf16*)out,
      T_rows, B, H, Hk, page_size, max_pages, q_tile);
  return (int)cudaGetLastError();
}

template <typename P>
static int launch(const void* q, const void* k, const void* v, const float* ks,
                  const float* vs, const int* pt, const int* qs, const int* ql,
                  const int* kl, void* out, int T_rows, int B, int H, int Hk, int hd,
                  int page_size, int max_pages, int q_tile, int kv_tile, int threads,
                  int smem, int blocks, cudaStream_t stream) {
#define RAGGED_TC_HD(HD)                                                            \
  case HD:                                                                        \
    return launch_hd<P, HD>(q, k, v, ks, vs, pt, qs, ql, kl, out, T_rows, B, H, Hk, \
                            page_size, max_pages, q_tile, kv_tile, threads, smem,   \
                            blocks, stream);
  switch (hd) {
    RAGGED_TC_HD(16)
    RAGGED_TC_HD(32)
    RAGGED_TC_HD(64)
    RAGGED_TC_HD(128)
  }
#undef RAGGED_TC_HD
  return (int)cudaErrorInvalidValue;
}

}  // namespace tc

// ---- entry points -----------------------------------------------------------
// The launch plan (q_tile, kv_tile, threads, smem_bytes, blocks) is read
// for q in bf16 only; the float32 path ignores it.

extern "C" int ragged_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* q_start, const void* q_lens,
                                      const void* kv_lens, void* out, int T_rows, int B,
                                      int H, int Hk, int hd, int page_size,
                                      int max_pages, int q_tile, int kv_tile,
                                      int threads, int smem_bytes, int blocks,
                                      int dtype, void* stream) {
  const int* pt = (const int*)page_table;
  const int* qs = (const int*)q_start;
  const int* ql = (const int*)q_lens;
  const int* kl = (const int*)kv_lens;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, pt, qs, ql,
                                  kl, out, T_rows, B, H, Hk, hd, page_size,
                                  max_pages, s);
    case BF16:
      return tc::launch<__nv_bfloat16>(q, k_pool, v_pool, nullptr, nullptr, pt, qs,
                                       ql, kl, out, T_rows, B, H, Hk, hd, page_size,
                                       max_pages, q_tile, kv_tile, threads,
                                       smem_bytes, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}

// int8 pools: k_pool / v_pool int8 [S, Hk, hd], k_scale / v_scale f32
// [S, Hk]; `dtype` is q's (and out's).
extern "C" int ragged_paged_attention_int8(const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scale,
                                           const void* v_scale,
                                           const void* page_table,
                                           const void* q_start, const void* q_lens,
                                           const void* kv_lens, void* out, int T_rows,
                                           int B, int H, int Hk, int hd,
                                           int page_size, int max_pages, int q_tile,
                                           int kv_tile, int threads, int smem_bytes,
                                           int blocks, int dtype, void* stream) {
  const float* ks = (const float*)k_scale;
  const float* vs = (const float*)v_scale;
  const int* pt = (const int*)page_table;
  const int* qs = (const int*)q_start;
  const int* ql = (const int*)q_lens;
  const int* kl = (const int*)kv_lens;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch<float, int8_t>(q, k_pool, v_pool, ks, vs, pt, qs, ql, kl, out,
                                   T_rows, B, H, Hk, hd, page_size, max_pages, s);
    case BF16:
      return tc::launch<int8_t>(q, k_pool, v_pool, ks, vs, pt, qs, ql, kl, out, T_rows,
                                B, H, Hk, hd, page_size, max_pages, q_tile, kv_tile,
                                threads, smem_bytes, blocks, s);
  }
  return (int)cudaErrorInvalidValue;
}
