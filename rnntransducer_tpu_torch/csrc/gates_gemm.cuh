// The gates GEMM of the backward kernels (gru_bwd.cu, lstm_bwd.cu): the gate
// pre-activations of every step, hw = h_prev @ W_hh + b_hh, in one launch
// before the chain, off the step chain as in the TPU kernels
// (rnn_pallas.py:177-185 for the GRU, :243-245 for the LSTM).  bf16 runs on
// the tensor cores (mma.sync m16n8k16, 128 x 128 block tiles fed by a
// 3-stage cp.async ring), fp32 on the CUDA cores (a register-blocked SIMT
// tile); both accumulate in fp32 and add the bias in fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rnn_persistent.cuh"

namespace rnnp {

// ---------------------------------------------------------------------------
// hw = A @ Bt^T + bias: A (M, K) and Bt (N, K) of T, K % 64 == 0; hw (M, N)
// fp32; bias (N) of T.
// ---------------------------------------------------------------------------

constexpr int kGemmTile = 64;   // the fp32 tile

// bf16: 256 threads, 128 x 128 tile, 32-wide K slabs in a 3-stage cp.async
// ring; each warp a 64 x 32 piece (4 x 4 mma tiles).  Slab rows sit 64
// bytes apart, so the 16-byte fragment loads of a quarter warp (two rows)
// are conflict-free; k is permuted inside the slab as in rnnp::mma_dots.
constexpr int kGemmM = 128, kGemmN = 128, kGemmStages = 3;

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void gemm_bf16(const __nv_bfloat16* __restrict__ A,
                                          const __nv_bfloat16* __restrict__ Bt,
                                          const __nv_bfloat16* __restrict__ bias,
                                          float* __restrict__ hw, int M, int N, int K) {
  __shared__ __align__(128) __nv_bfloat16 As[kGemmStages][kGemmM * 32];
  __shared__ __align__(128) __nv_bfloat16 Bs[kGemmStages][kGemmN * 32];
  const int m0 = blockIdx.x * kGemmM, n0 = blockIdx.y * kGemmN;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int wm = warp / 4, wn = warp % 4;  // 2 x 4 warps of 64 x 32

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mi][ni][i] = 0.0f;

  // slab kb into stage st: 128 rows x 4 chunks of 16 bytes of A and of B
  auto fetch = [&](int kb, int st) {
    const int k0 = kb * 32;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = threadIdx.x + i * 256, row = idx / 4, q = idx % 4;
      const bool va = m0 + row < M, vb = n0 + row < N;
      cp_async16(&As[st][idx * 8], A + (size_t)(va ? m0 + row : 0) * K + k0 + q * 8, va);
      cp_async16(&Bs[st][idx * 8], Bt + (size_t)(vb ? n0 + row : 0) * K + k0 + q * 8, vb);
    }
  };
  const int nk = K / 32;
#pragma unroll
  for (int st = 0; st < kGemmStages - 1; ++st) {
    if (st < nk) fetch(st, st);
    asm volatile("cp.async.commit_group;" ::: "memory");
  }
  for (int kb = 0; kb < nk; ++kb) {
    asm volatile("cp.async.wait_group %0;" ::"n"(kGemmStages - 2) : "memory");
    __syncthreads();
    if (kb + kGemmStages - 1 < nk) fetch(kb + kGemmStages - 1, (kb + kGemmStages - 1) % kGemmStages);
    asm volatile("cp.async.commit_group;" ::: "memory");
    const __nv_bfloat16* as = As[kb % kGemmStages];
    const __nv_bfloat16* bs = Bs[kb % kGemmStages];
    int4 b[4];
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
      b[ni] = *reinterpret_cast<const int4*>(bs + (wn * 32 + ni * 8 + g) * 32 + 8 * t);
#pragma unroll
    for (int mi = 0; mi < 4; ++mi) {
      const int4 lo = *reinterpret_cast<const int4*>(as + (wm * 64 + mi * 16 + g) * 32 + 8 * t);
      const int4 hi =
          *reinterpret_cast<const int4*>(as + (wm * 64 + mi * 16 + 8 + g) * 32 + 8 * t);
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        mma_bf16(acc[mi][ni], lo.x, hi.x, lo.y, hi.y, b[ni].x, b[ni].y);
        mma_bf16(acc[mi][ni], lo.z, hi.z, lo.w, hi.w, b[ni].z, b[ni].w);
      }
    }
  }
  asm volatile("cp.async.wait_group 0;" ::: "memory");

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + wm * 64 + mi * 16 + h * 8 + g;
        const int col = n0 + wn * 32 + ni * 8 + 2 * t;
        if (row >= M) continue;
        float* out = hw + (size_t)row * N + col;
        if (col + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<float2*>(out) =
              make_float2(acc[mi][ni][2 * h] + to_f(bias[col]),
                          acc[mi][ni][2 * h + 1] + to_f(bias[col + 1]));
        } else {
          if (col < N) out[0] = acc[mi][ni][2 * h] + to_f(bias[col]);
          if (col + 1 < N) out[1] = acc[mi][ni][2 * h + 1] + to_f(bias[col + 1]);
        }
      }
}

// fp32: 256 threads, 64 x 64 tile, 16-wide K slabs held k-major in shared
// memory; each thread a 4 x 4 block of outputs.
__device__ __forceinline__ void gemm_f32(const float* __restrict__ A,
                                         const float* __restrict__ Bt,
                                         const float* __restrict__ bias,
                                         float* __restrict__ hw, int M, int N, int K) {
  constexpr int BK = 16, LD = kGemmTile + 4;
  __shared__ __align__(16) float As[BK * LD];
  __shared__ __align__(16) float Bs[BK * LD];
  const int m0 = blockIdx.x * kGemmTile, n0 = blockIdx.y * kGemmTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const int lrow = threadIdx.x / 4, lk = (threadIdx.x % 4) * 4;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += BK) {
    const float4 av = m0 + lrow < M
        ? __ldg(reinterpret_cast<const float4*>(A + (size_t)(m0 + lrow) * K + k0 + lk))
        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 bv = n0 + lrow < N
        ? __ldg(reinterpret_cast<const float4*>(Bt + (size_t)(n0 + lrow) * K + k0 + lk))
        : make_float4(0.f, 0.f, 0.f, 0.f);
    __syncthreads();
    As[(lk + 0) * LD + lrow] = av.x;
    As[(lk + 1) * LD + lrow] = av.y;
    As[(lk + 2) * LD + lrow] = av.z;
    As[(lk + 3) * LD + lrow] = av.w;
    Bs[(lk + 0) * LD + lrow] = bv.x;
    Bs[(lk + 1) * LD + lrow] = bv.y;
    Bs[(lk + 2) * LD + lrow] = bv.z;
    Bs[(lk + 3) * LD + lrow] = bv.w;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(As + k * LD + ty * 4);
      const float4 b = *reinterpret_cast<const float4*>(Bs + k * LD + tx * 4);
      const float ar[4] = {a.x, a.y, a.z, a.w}, br[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(ar[i], br[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= M) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int col = n0 + tx * 4 + jj;
      if (col < N) hw[(size_t)row * N + col] = acc[i][jj] + bias[col];
    }
  }
}

// One product: hw = A @ Bt^T + bias.
static __global__ void __launch_bounds__(256)
gates_gemm_bf16(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ Bt,
                const __nv_bfloat16* __restrict__ bias, float* __restrict__ hw, int M,
                int N, int K) {
  gemm_bf16(A, Bt, bias, hw, M, N, K);
}

static __global__ void __launch_bounds__(256)
gates_gemm_f32(const float* __restrict__ A, const float* __restrict__ Bt,
               const float* __restrict__ bias, float* __restrict__ hw, int M, int N,
               int K) {
  gemm_f32(A, Bt, bias, hw, M, N, K);
}

// The operands of one product.
template <typename T>
struct GemmArgs {
  const T* A;
  const T* Bt;
  const T* bias;
  float* hw;
};

// Two products of one shape in one launch, blockIdx.z choosing the operands:
// the gates of both directions of a bidirectional layer (gru_bwd.cu's pair).
static __global__ void __launch_bounds__(256)
gates_gemm_bf16_pair(GemmArgs<__nv_bfloat16> p0, GemmArgs<__nv_bfloat16> p1, int M, int N,
                     int K) {
  const GemmArgs<__nv_bfloat16> p = blockIdx.z ? p1 : p0;
  gemm_bf16(p.A, p.Bt, p.bias, p.hw, M, N, K);
}

static __global__ void __launch_bounds__(256)
gates_gemm_f32_pair(GemmArgs<float> p0, GemmArgs<float> p1, int M, int N, int K) {
  const GemmArgs<float> p = blockIdx.z ? p1 : p0;
  gemm_f32(p.A, p.Bt, p.bias, p.hw, M, N, K);
}

template <typename T>
cudaError_t launch_gemm(const T* A, const T* Bt, const T* bias, float* hw, int M, int N,
                        int K, cudaStream_t stream);

template <>
inline cudaError_t launch_gemm<__nv_bfloat16>(const __nv_bfloat16* A,
                                              const __nv_bfloat16* Bt,
                                              const __nv_bfloat16* bias, float* hw,
                                              int M, int N, int K, cudaStream_t stream) {
  const dim3 grid((M + kGemmM - 1) / kGemmM, (N + kGemmN - 1) / kGemmN);
  gates_gemm_bf16<<<grid, 256, 0, stream>>>(A, Bt, bias, hw, M, N, K);
  return cudaGetLastError();
}

template <>
inline cudaError_t launch_gemm<float>(const float* A, const float* Bt, const float* bias,
                                      float* hw, int M, int N, int K,
                                      cudaStream_t stream) {
  const dim3 grid((M + kGemmTile - 1) / kGemmTile, (N + kGemmTile - 1) / kGemmTile);
  gates_gemm_f32<<<grid, 256, 0, stream>>>(A, Bt, bias, hw, M, N, K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_gemm_pair(GemmArgs<T> p0, GemmArgs<T> p1, int M, int N, int K,
                             cudaStream_t stream);

template <>
inline cudaError_t launch_gemm_pair<__nv_bfloat16>(GemmArgs<__nv_bfloat16> p0,
                                                   GemmArgs<__nv_bfloat16> p1, int M, int N,
                                                   int K, cudaStream_t stream) {
  const dim3 grid((M + kGemmM - 1) / kGemmM, (N + kGemmN - 1) / kGemmN, 2);
  gates_gemm_bf16_pair<<<grid, 256, 0, stream>>>(p0, p1, M, N, K);
  return cudaGetLastError();
}

template <>
inline cudaError_t launch_gemm_pair<float>(GemmArgs<float> p0, GemmArgs<float> p1, int M,
                                           int N, int K, cudaStream_t stream) {
  const dim3 grid((M + kGemmTile - 1) / kGemmTile, (N + kGemmTile - 1) / kGemmTile, 2);
  gates_gemm_f32_pair<<<grid, 256, 0, stream>>>(p0, p1, M, N, K);
  return cudaGetLastError();
}

}  // namespace rnnp
