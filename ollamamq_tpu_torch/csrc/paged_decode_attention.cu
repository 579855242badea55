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
// f32 [S, Hk] scale planes, dequantized in f32 right after each load).
//
// Bound on the card: bytes. Each (sequence, kv head) block reads its
// visible K/V rows once; see paged_attention_common.cuh for the design
// and what it leaves for later. The TPU kernel's cross-program DMA
// prefetch and segment-matrix lane tricks have no counterpart here: blocks
// run concurrently on 132 SMs and each loads its own rows.
//
// Safe to capture in a CUDA graph: no host synchronisation, no
// allocation, the launch shape depends on tensor shapes only.

#include "paged_attention_common.cuh"

using namespace paged_attn;

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

extern "C" int paged_decode_attention(const void* q, const void* k_pool,
                                      const void* v_pool, const void* page_table,
                                      const void* seq_lens, void* out, int B, int H,
                                      int Hk, int hd, int page_size, int max_pages,
                                      int dtype, void* stream) {
  const int* pt = (const int*)page_table;
  const int* sl = (const int*)seq_lens;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case F32:
      return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, pt, sl, out,
                                  B, H, Hk, hd, page_size, max_pages, s);
    case BF16:
      return launch<__nv_bfloat16, __nv_bfloat16>(q, k_pool, v_pool, nullptr,
                                                  nullptr, pt, sl, out, B, H, Hk,
                                                  hd, page_size, max_pages, s);
  }
  return (int)cudaErrorInvalidValue;
}

// int8 pools: k_pool / v_pool int8 [S, Hk, hd], k_scale / v_scale f32
// [S, Hk]; `dtype` is q's (and out's).
extern "C" int paged_decode_attention_int8(const void* q, const void* k_pool,
                                           const void* v_pool, const void* k_scale,
                                           const void* v_scale,
                                           const void* page_table,
                                           const void* seq_lens, void* out, int B,
                                           int H, int Hk, int hd, int page_size,
                                           int max_pages, int dtype, void* stream) {
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
      return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, ks, vs, pt, sl, out,
                                           B, H, Hk, hd, page_size, max_pages, s);
  }
  return (int)cudaErrorInvalidValue;
}
