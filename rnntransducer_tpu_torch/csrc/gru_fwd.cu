// Masked GRU recurrence (forward), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel rnntransducer_tpu/ops/rnn_pallas.py::_gru_fwd_kernel
// (called through _gru_fwd_call / gru_scan).  Semantics kept exactly:
//   * torch gate order r, z, n; b_hh sits inside r * (h W_hn + b_hn);
//   * reverse walks t = T-1 .. 0;
//   * at t >= lengths[b] the carry stays and h_all[t, b] = 0;
//   * numeric contract: the h carry is fp32, h is rounded to W's type for
//     the product, the product accumulates in fp32, b_hh is added in fp32,
//     xw is read as fp32 and outputs are rounded to xw's type.
//
// What bounds it on this card: each step is a skinny product
// (B, H) x (H, 3H) whose whole weight (6.3 MB in bf16 at H = 1024) must be
// read again every step, because the step depends on the previous one.
// The weight stays resident in the 50 MB L2 across steps, so a step is
// bound by L2 reads of W_hh at small B and by fp32 FMA throughput (CUDA
// cores, no tensor cores yet) at B = 64, plus the launch gap between steps.
//
// Design (simple first):
//   * one launch per timestep, all launched back to back on the caller's
//     stream by gru_scan_fwd below; two fp32 h buffers ping-pong;
//   * each block owns kJT hidden units j and computes their r, z and n
//     columns for all B rows, so the gates fuse into the same block;
//   * the block's (3 kJT, H) slice of W_hh, pre-arranged by the wrapper into
//     one contiguous tile, is copied into shared memory once per step;
//   * warps split rows into groups of kRows (register blocking: one shared
//     memory read of W feeds kRows FMAs) and, when B is small, split K too;
//     lanes stride over K in pairs and finish with a shuffle reduction.
// A persistent kernel that keeps W_hh in shared memory across steps, with
// a grid barrier per step and wgmma for the product, is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // rows of h each lane carries in registers
constexpr int kRowChunk = 64;  // rows per pass through the dot buffer
// Hidden units per block.  The block's W_hh slice (3 kJT rows of Hk) plus
// the dot buffer fit the 227 KB of shared memory up to H ~ 4700 in bf16 and
// ~ 2300 in fp32; a larger H fails cudaFuncSetAttribute and the call
// returns that error.
constexpr int kJT = 8;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// h rounded to W's type (the TPU kernel's h.astype(w.dtype)), back in fp32.
template <typename T> __device__ __forceinline__ float quant(float x);
template <> __device__ __forceinline__ float quant<float>(float x) { return x; }
template <> __device__ __forceinline__ float quant<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ float sigmoidf_(float x) { return 1.0f / (1.0f + expf(-x)); }

// One timestep.  Shapes: xw_t (B, 3H); w_tiles (ceil(H/kJT), 3 kJT, Hk) with
// zero padding for k >= H and j >= H; b_hh (3H); h_prev / h_next (B, Hk)
// fp32 with zero padding for k >= H; hall_t (B, H); h_fin (B, H) or null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
gru_fwd_step(const T* __restrict__ xw_t, const T* __restrict__ w_tiles,
             const T* __restrict__ b_hh, const float* __restrict__ h_prev,
             float* __restrict__ h_next, T* __restrict__ hall_t,
             T* __restrict__ h_fin, const int* __restrict__ lengths,
             int t, int B, int H, int Hk) {
  constexpr int C = 3 * kJT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // (C, Hk)
  float* dots = reinterpret_cast<float*>(smem_raw + sizeof(T) * C * (size_t)Hk);

  const int j0 = blockIdx.x * kJT;
  {
    const int4* src = reinterpret_cast<const int4*>(
        w_tiles + (size_t)blockIdx.x * C * Hk);
    int4* dst = reinterpret_cast<int4*>(w_s);
    const int n16 = (int)(sizeof(T) * C * (size_t)Hk / 16);
    for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = __ldg(src + i);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int r0 = 0; r0 < B; r0 += kRowChunk) {
    const int nrows = min(kRowChunk, B - r0);
    const int ngroups = (nrows + kRows - 1) / kRows;
    int rg = 1;
    while (rg < ngroups && rg < kWarps) rg <<= 1;
    const int ksplit = kWarps / rg;
    const int my_rg = warp / ksplit;
    const int my_ks = warp % ksplit;
    const int npad = ngroups * kRows;

    for (int g = my_rg; g < ngroups; g += rg) {
      float acc[kRows][C];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

      const float* hrow[kRows];
      bool valid[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int rl = g * kRows + i;
        valid[i] = rl < nrows;
        hrow[i] = h_prev + (size_t)(r0 + (valid[i] ? rl : 0)) * Hk;
      }

      for (int k = 2 * (my_ks * 32 + lane); k < Hk; k += 64 * ksplit) {
        float2 hv[kRows];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          float2 v = *reinterpret_cast<const float2*>(hrow[i] + k);
          hv[i].x = valid[i] ? quant<T>(v.x) : 0.0f;
          hv[i].y = valid[i] ? quant<T>(v.y) : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float2 w = load_pair(w_s + (size_t)c * Hk + k);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            acc[i][c] = fmaf(hv[i].x, w.x, acc[i][c]);
            acc[i][c] = fmaf(hv[i].y, w.y, acc[i][c]);
          }
        }
      }

#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float v = acc[i][c];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, off);
          acc[i][c] = v;
        }

#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int c = 0; c < C; ++c)
          if ((i * C + c) % 32 == lane && valid[i])
            dots[(my_ks * npad + g * kRows + i) * C + c] = acc[i][c];
    }
    __syncthreads();

    for (int p = threadIdx.x; p < nrows * kJT; p += kThreads) {
      const int rl = p / kJT;
      const int jj = p % kJT;
      const int j = j0 + jj;
      if (j >= H) continue;
      const int b = r0 + rl;
      float hr = 0.0f, hz = 0.0f, hn = 0.0f;
      for (int ks = 0; ks < ksplit; ++ks) {
        const float* d = dots + (ks * npad + rl) * C;
        hr += d[jj];
        hz += d[kJT + jj];
        hn += d[2 * kJT + jj];
      }
      hr += to_f(b_hh[j]);
      hz += to_f(b_hh[H + j]);
      hn += to_f(b_hh[2 * H + j]);
      const T* x = xw_t + (size_t)b * 3 * H;
      const float r = sigmoidf_(to_f(x[j]) + hr);
      const float z = sigmoidf_(to_f(x[H + j]) + hz);
      const float n = tanhf(to_f(x[2 * H + j]) + r * hn);
      const float hp = h_prev[(size_t)b * Hk + j];
      const float h_new = (1.0f - z) * n + z * hp;
      const bool m = t < lengths[b];
      const float h_carry = m ? h_new : hp;
      h_next[(size_t)b * Hk + j] = h_carry;
      hall_t[(size_t)b * H + j] = from_f<T>(m ? h_new : 0.0f);
      if (h_fin != nullptr) h_fin[(size_t)b * H + j] = from_f<T>(h_carry);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_scan(const void* xw, const void* w_tiles, const void* b_hh,
                void* h_a, void* h_b, void* h_all, void* h_fin,
                const void* lengths, int T_len, int B, int H, int Hk,
                int reverse, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 3 * kJT * (size_t)Hk
                      + sizeof(float) * kRowChunk * 3 * kJT;
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kJT - 1) / kJT);
  const T* xw_p = static_cast<const T*>(xw);
  T* hall_p = static_cast<T*>(h_all);
  float* hp = static_cast<float*>(h_a);
  float* hn = static_cast<float*>(h_b);
  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    gru_fwd_step<T><<<grid, kThreads, smem, stream>>>(
        xw_p + (size_t)t * B * 3 * H, static_cast<const T*>(w_tiles),
        static_cast<const T*>(b_hh), hp, hn, hall_p + (size_t)t * B * H,
        s == T_len - 1 ? static_cast<T*>(h_fin) : nullptr,
        static_cast<const int*>(lengths), t, B, H, Hk);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    float* tmp = hp;
    hp = hn;
    hn = tmp;
  }
  return 0;
}

}  // namespace

// Runs the whole scan: T launches of gru_fwd_step on `stream`, no sync.
// w_tiles is W_hh tiled for jt hidden units per block, which must be kJT.
// dtype: 0 = float32, 1 = bfloat16 (xw, w_tiles, b_hh, h_all, h_fin share
// it).  h_a holds h0 (fp32, (B, Hk), zero padded); h_b is scratch of the same
// shape.  Returns 0 or the first cudaError_t met.
extern "C" int gru_scan_fwd(const void* xw, const void* w_tiles,
                            const void* b_hh, void* h_a, void* h_b,
                            void* h_all, void* h_fin, const void* lengths,
                            int T_len, int B, int H, int Hk, int jt,
                            int reverse, int dtype, void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kJT || Hk % 64 != 0 || Hk < H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scan<float>(xw, w_tiles, b_hh, h_a, h_b, h_all, h_fin,
                              lengths, T_len, B, H, Hk, reverse, s);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(xw, w_tiles, b_hh, h_a, h_b, h_all,
                                      h_fin, lengths, T_len, B, H, Hk,
                                      reverse, s);
  return (int)cudaErrorInvalidValue;
}
