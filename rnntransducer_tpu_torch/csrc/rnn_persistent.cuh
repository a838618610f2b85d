// Pieces shared by the persistent GRU and LSTM kernels (gru_fwd.cu,
// gru_bwd.cu, lstm_fwd.cu, lstm_bwd.cu): the grid-wide barrier, the skinny
// products of a broadcast row against a weight slice resident in shared
// memory, and the element helpers.
//
// A persistent kernel keeps one block per SM for the whole scan.  Each
// block owns a few hidden units j and holds its W_hh slice, C rows of K
// contiguous values, in shared memory.  Every step multiplies the whole
// broadcast row act (rows of the batch, K wide, written by every block in
// the step before) by that slice:
//   dots[(ks * npad + row) * C + c] = partial sum over the warp's share of K
//   of act[r0 + row, k] * w_s[c, k].
// The broadcast row is read with ld.global.cg (L2 only): other SMs wrote
// it during this launch, so an L1 line from two steps back would be stale.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace rnnp {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kJT = 8;          // hidden units per GRU block (the LSTM kernels take 4 or 8)
constexpr int kRowChunk = 64;   // batch rows per pass through the dot buffer
constexpr int kDotRows = 128;   // rows of the dot buffer: ksplit * npad <= 128

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// Row stride of a weight slice in shared memory.  bf16: K + 32 values, so
// rows start 64 bytes apart modulo 128 and the 16-byte B-fragment loads of
// a quarter warp (two rows, four lanes each) hit eight distinct bank groups.
template <typename T> __host__ __device__ constexpr int slice_ld(int K) {
  return sizeof(T) == 2 ? K + 32 : K;
}

// Dynamic shared memory of a kernel with a C-row slice of width K.
template <typename T> __host__ __device__ constexpr size_t slice_smem(int C, int K) {
  return sizeof(T) * (size_t)C * slice_ld<T>(K) + sizeof(float) * kDotRows * C;
}

// Copy the block's (C, K) slice from global memory into shared memory with
// row stride slice_ld<T>(K).  K * sizeof(T) is a multiple of 16.
template <typename T>
__device__ __forceinline__ void load_slice(T* w_s, const T* src, int C, int K) {
  const int per_row = (int)(K * sizeof(T) / 16);
  const int ld = slice_ld<T>(K);
  for (int i = threadIdx.x; i < C * per_row; i += kThreads) {
    const int c = i / per_row, q = i % per_row;
    reinterpret_cast<int4*>(w_s + (size_t)c * ld)[q] =
        __ldg(reinterpret_cast<const int4*>(src + (size_t)c * K) + q);
  }
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long ns;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
  return ns;
}

// Grid-wide barrier on a counter in global memory that the caller zeroed
// before the launch; the target of the s-th barrier is (s + 1) * gridDim.x.
// The launch is cooperative, so every block is resident and none can wait
// on a block that never runs.  Release before the arrival, acquire after.
// A barrier still open after 10 s traps: a fault is an error, never a hang.
__device__ __forceinline__ void grid_sync(unsigned int* count, unsigned int target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    const unsigned long long start = global_ns();
    unsigned int seen, spins = 0;
    while (true) {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen) : "l"(count) : "memory");
      if (seen >= target) break;
      if (++spins % 4096 == 0 && global_ns() - start > 10000000000ull) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// How the warps split a chunk of rows: rg row groups (each `group` rows),
// and K split ksplit ways when there are fewer groups than warps.
struct Split {
  int ngroups, rg, ksplit, npad;
};

__device__ __forceinline__ Split split_rows(int nrows, int group) {
  Split s;
  s.ngroups = (nrows + group - 1) / group;
  s.rg = 1;
  while (s.rg < s.ngroups && s.rg < kWarps) s.rg <<= 1;
  s.ksplit = kWarps / s.rg;
  s.npad = s.ngroups * group;
  return s;
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// bf16 products on the tensor cores (mma.sync m16n8k16, fp32 accumulation).
// Warps take 16-row tiles of the chunk and interleaved 32-wide slabs of K.
// Each lane loads 16 bytes of its A rows g and g + 8 and of its B row g at
// k0 + 8 t (t = lane % 4): the slab's two k16 steps take the first and the
// last 8 bytes.  That permutes k inside the slab the same way for A and B,
// so the sum is unchanged and every load is one full 16-byte transaction.
// NT n-tiles of 8 columns (C = 8 NT); U slabs of loads in flight.
template <int NT, int U>
__device__ __forceinline__ Split mma_dots(const __nv_bfloat16* w_s, int ldw,
                                          const __nv_bfloat16* act, int lda, int K,
                                          int r0, int nrows, float* dots) {
  constexpr int C = 8 * NT;
  const Split s = split_rows(nrows, 16);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int my_rg = warp / s.ksplit;
  const int my_ks = warp % s.ksplit;
  if (my_rg >= s.ngroups) return s;
  const int lo = my_rg * 16 + g, hi = lo + 8;
  const bool ok_lo = lo < nrows, ok_hi = hi < nrows;
  const __nv_bfloat16* a_lo = act + (size_t)(r0 + (ok_lo ? lo : 0)) * lda + 8 * t;
  const __nv_bfloat16* a_hi = act + (size_t)(r0 + (ok_hi ? hi : 0)) * lda + 8 * t;
  const __nv_bfloat16* b_row = w_s + (size_t)g * ldw + 8 * t;
  const int nslab = K / 32;
  const int4 zero = make_int4(0, 0, 0, 0);

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[n][i] = 0.0f;

  for (int base = my_ks; base < nslab; base += U * s.ksplit) {
    int4 alo[U], ahi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slab = base + u * s.ksplit;
      const bool in = slab < nslab;
      alo[u] = in && ok_lo ? __ldcg(reinterpret_cast<const int4*>(a_lo + slab * 32)) : zero;
      ahi[u] = in && ok_hi ? __ldcg(reinterpret_cast<const int4*>(a_hi + slab * 32)) : zero;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int slab = base + u * s.ksplit;
      if (slab >= nslab) break;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int4 b = *reinterpret_cast<const int4*>(b_row + (size_t)n * 8 * ldw + slab * 32);
        mma_bf16(acc[n], alo[u].x, ahi[u].x, alo[u].y, ahi[u].y, b.x, b.y);
        mma_bf16(acc[n], alo[u].z, ahi[u].z, alo[u].w, ahi[u].w, b.z, b.w);
      }
    }
  }

  float* d = dots + (size_t)my_ks * s.npad * C;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ok_lo) {
      d[lo * C + c] = acc[n][0];
      d[lo * C + c + 1] = acc[n][1];
    }
    if (ok_hi) {
      d[hi * C + c] = acc[n][2];
      d[hi * C + c + 1] = acc[n][3];
    }
  }
  return s;
}

// fp32 products on the CUDA cores, register blocked over kRows rows: one
// shared-memory read of W feeds kRows FMAs; lanes stride over K in pairs
// and finish with a shuffle reduction.  K % 64 == 0.  kRows x C
// accumulators per lane: wide slices take 2 rows, so they stay in registers.
template <int C, int kRows = 4>
__device__ __forceinline__ Split simt_dots(const float* w_s, int ldw, const float* act,
                                           int lda, int K, int r0, int nrows,
                                           float* dots) {
  const Split s = split_rows(nrows, kRows);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int my_rg = warp / s.ksplit;
  const int my_ks = warp % s.ksplit;
  for (int gi = my_rg; gi < s.ngroups; gi += s.rg) {
    float acc[kRows][C];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

    const float* arow[kRows];
    bool valid[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rl = gi * kRows + i;
      valid[i] = rl < nrows;
      arow[i] = act + (size_t)(r0 + (valid[i] ? rl : 0)) * lda;
    }

    for (int k = 2 * (my_ks * 32 + lane); k < K; k += 64 * s.ksplit) {
      float2 av[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        av[i] = valid[i] ? __ldcg(reinterpret_cast<const float2*>(arow[i] + k))
                         : make_float2(0.0f, 0.0f);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 w = *reinterpret_cast<const float2*>(w_s + (size_t)c * ldw + k);
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          acc[i][c] = fmaf(av[i].x, w.x, acc[i][c]);
          acc[i][c] = fmaf(av[i].y, w.y, acc[i][c]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float v = acc[i][c];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[i][c] = v;
      }

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if ((i * C + c) % 32 == lane && valid[i])
          dots[(my_ks * s.npad + gi * kRows + i) * C + c] = acc[i][c];
  }
  return s;
}

// One product of either type: bf16 on the tensor cores, fp32 on CUDA cores.
template <int C, int U>
__device__ __forceinline__ Split dots_of(const __nv_bfloat16* w_s, int ldw,
                                         const __nv_bfloat16* act, int lda, int K,
                                         int r0, int nrows, float* dots) {
  return mma_dots<C / 8, U>(w_s, ldw, act, lda, K, r0, nrows, dots);
}
template <int C, int U>
__device__ __forceinline__ Split dots_of(const float* w_s, int ldw, const float* act,
                                         int lda, int K, int r0, int nrows, float* dots) {
  return simt_dots<C, (C > 24 ? 2 : 4)>(w_s, ldw, act, lda, K, r0, nrows, dots);
}

// The most blocks of `kernel`, with `smem` bytes of dynamic shared memory
// each, that can be resident on this card at once, into *blocks.
template <typename K>
inline cudaError_t max_coresident(K kernel, size_t smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) !=
      cudaSuccess)
    return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  *blocks = sms * per_sm;
  return err;
}

// 0, or the error a cooperative launch of `blocks` blocks would give:
// cudaErrorCooperativeLaunchTooLarge when they cannot all be resident.
template <typename K>
inline cudaError_t check_coresident(K kernel, int blocks, size_t smem) {
  int fit = 0;
  const cudaError_t err = max_coresident(kernel, smem, &fit);
  if (err != cudaSuccess) return err;
  return blocks <= fit ? cudaSuccess : cudaErrorCooperativeLaunchTooLarge;
}

}  // namespace rnnp
