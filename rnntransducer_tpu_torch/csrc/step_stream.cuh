// The per-step recurrent kernels' products with the weight slice streamed
// through shared memory instead of held whole (gru_fwd.cu, gru_bwd.cu,
// lstm_fwd.cu, lstm_bwd.cu, namespace per_step, kStream = true).
//
// A per-step block that copies its whole W_hh slice into shared memory
// bounds H by the card's shared memory.  Above that bound the block walks
// K in chunks of kChunk values: each chunk of its C slice rows is fetched
// with 16-byte cp.async into one of two buffers while the other is used,
// and each lane adds the chunk's partial sums to the fp32 dot buffer it
// owns.  Shared memory is then 2 C kChunk values of W plus the dot
// buffers, whatever H is.  The arithmetic is the whole-slice path's with
// the K sum split at chunk edges (ops/rnn_kernels.py::
// step_chunked_reference mirrors it).

#pragma once

#include "rnn_persistent.cuh"

namespace step_stream {

using rnnp::kThreads;
using rnnp::Split;

constexpr int kChunk = 256;  // K values of every slice row per chunk

// Shared memory of the two chunk buffers for a C-row slice.
template <typename T> __host__ __device__ constexpr size_t ring_bytes(int C) {
  return 2 * sizeof(T) * (size_t)C * kChunk;
}

template <typename T> __device__ __forceinline__ float quant(float x);
template <> __device__ __forceinline__ float quant<float>(float x) { return x; }
template <> __device__ __forceinline__ float quant<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issue the copies of columns [k0, k0 + kw) of the C rows of w (row stride
// ldw) into buf (C, kChunk).  kw * sizeof(T) and k0 * sizeof(T) are
// multiples of 16.
template <typename T, int C>
__device__ __forceinline__ void fetch(T* buf, const T* w, int ldw, int k0, int kw) {
  const int per_row = (int)(kw * sizeof(T) / 16);
  for (int i = threadIdx.x; i < C * per_row; i += kThreads) {
    const int c = i / per_row, q = i % per_row;
    cp_async16(reinterpret_cast<char*>(buf + (size_t)c * kChunk) + 16 * q,
               reinterpret_cast<const char*>(w + (size_t)c * ldw + k0) + 16 * q);
  }
}

// dots[(ks * npad + row) * C + c] (+)= this warp's share of
// sum_{k < kw} quant<T>(act[r0 + row, k]) * w_s[c, k], w_s (C, kChunk);
// every dot entry has one owner lane, the same for every chunk.
template <typename T, typename TA, int C, int R>
__device__ __forceinline__ void chunk_partial(const T* w_s, const TA* act, int lda,
                                              int kw, int r0, int nrows,
                                              const Split& s, float* dots,
                                              bool accumulate) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int my_rg = warp / s.ksplit;
  const int my_ks = warp % s.ksplit;
  for (int g = my_rg; g < s.ngroups; g += s.rg) {
    float acc[R][C];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

    const TA* arow[R];
    bool valid[R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int rl = g * R + i;
      valid[i] = rl < nrows;
      arow[i] = act + (size_t)(r0 + (valid[i] ? rl : 0)) * lda;
    }

    for (int k = 2 * (my_ks * 32 + lane); k < kw; k += 64 * s.ksplit) {
      float2 av[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float2 v = pair(arow[i] + k);
        av[i].x = valid[i] ? quant<T>(v.x) : 0.0f;
        av[i].y = valid[i] ? quant<T>(v.y) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 w = pair(w_s + (size_t)c * kChunk + k);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          acc[i][c] = fmaf(av[i].x, w.x, acc[i][c]);
          acc[i][c] = fmaf(av[i].y, w.y, acc[i][c]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = acc[i][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[i][c] = v;
      }

#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if ((i * C + c) % 32 == lane && valid[i]) {
          float* d = dots + (my_ks * s.npad + g * R + i) * C + c;
          *d = accumulate ? *d + acc[i][c] : acc[i][c];
        }
  }
}

// The whole product of rows [r0, r0 + nrows) of act (K wide, K % 64 == 0)
// with the C rows of the global slice w (row stride ldw), K walked in
// chunks through ring (ring_bytes<T>(C) of shared memory), the next chunk
// in flight while this one is used.  Every thread of the block calls it;
// it ends with a block barrier, so the ring may be reused at once.
template <typename T, typename TA, int C, int R>
__device__ __forceinline__ void streamed_dots(T* ring, const T* w, int ldw,
                                              const TA* act, int lda, int K, int r0,
                                              int nrows, const Split& s, float* dots) {
  const int n = (K + kChunk - 1) / kChunk;
  fetch<T, C>(ring, w, ldw, 0, min(kChunk, K));
  cp_async_commit();
  for (int ci = 0; ci < n; ++ci) {
    const int k0 = ci * kChunk;
    if (ci + 1 < n)
      fetch<T, C>(ring + (size_t)((ci + 1) & 1) * C * kChunk, w, ldw, k0 + kChunk,
                  min(kChunk, K - k0 - kChunk));
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();
    chunk_partial<T, TA, C, R>(ring + (size_t)(ci & 1) * C * kChunk, act + k0, lda,
                               min(kChunk, K - k0), r0, nrows, s, dots, ci > 0);
    __syncthreads();
  }
}

}  // namespace step_stream
