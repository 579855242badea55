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
// f32 [S, Hk] scale planes, dequantized in f32 right after each load).
//
// Design: one block per (stream row, kv head). The block finds its own
// sequence by binary search over the span ends (the searchsorted the TPU
// wrapper ran on the host side of the grid) and walks pages up to its
// own causal frontier only. The TPU kernel's 8-row tiles with per-tile
// sequence walks, lane-packed q and DMA ring do not carry over.
//
// Bound on the card: bytes, as for the decode kernel, but this first
// design re-reads a prefill span's shared prefix once per row (mostly out
// of the 50 MB L2); blocks that share K/V loads across a span's rows are
// the next step.

#include "paged_attention_common.cuh"

using namespace paged_attn;

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

extern "C" int ragged_paged_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* q_start, const void* q_lens,
                                      const void* kv_lens, void* out, int T_rows, int B,
                                      int H, int Hk, int hd, int page_size,
                                      int max_pages, int dtype, void* stream) {
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
      return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr,
                                                  nullptr, pt, qs, ql, kl, out,
                                                  T_rows, B, H, Hk, hd, page_size,
                                                  max_pages, s);
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
                                           int page_size, int max_pages, int dtype,
                                           void* stream) {
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
      return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, ks, vs, pt, qs, ql,
                                           kl, out, T_rows, B, H, Hk, hd, page_size,
                                           max_pages, s);
  }
  return (int)cudaErrorInvalidValue;
}
