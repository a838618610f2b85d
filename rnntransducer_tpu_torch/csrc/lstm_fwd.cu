// Masked LSTM recurrence (forward), written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel rnntransducer_tpu/ops/rnn_pallas.py::_lstm_fwd_kernel
// (called through _lstm_fwd_call / lstm_scan).  Semantics kept exactly:
//   * torch gate order i, f, g, o on s = xw + (h W_hh + b_hh);
//     c' = f c + i g, h' = o tanh(c');
//   * reverse walks t = T-1 .. 0;
//   * at t >= lengths[b] the h and c carries stay and h_all[t, b] = 0, while
//     c_all[t, b] holds the c carry (not zeroed): the backward reads the
//     predecessor cell state of every valid step from it;
//   * numeric contract: h and c carries are fp32, h is rounded to W's type
//     for the product, the product accumulates in fp32, b_hh is added in
//     fp32, xw is read as fp32 and outputs are rounded to xw's type.
//
// What bounds it on this card: each step is a skinny product
// (B, H) x (H, 4H) whose whole weight (8.4 MB in bf16 at H = 1024) is read
// again every step, because the step depends on the previous one.  The
// weight stays resident in the 50 MB L2 across steps, so a step is bound by
// fp32 FMA throughput on the CUDA cores at B = 64 and by the launch gap and
// the L2 reads of W_hh at small B.
//
// Design (simple first, as the GRU kernel csrc/gru_fwd.cu):
//   * one launch per timestep, all launched back to back on the caller's
//     stream by lstm_scan_fwd below; two fp32 h buffers ping-pong;
//   * each block owns kJT hidden units j and computes their i, f, g and o
//     columns for all B rows, so the gates fuse into the same block; the c
//     carry of unit j is read and written only by that block, so it lives
//     in one fp32 buffer updated in place;
//   * the block's (4 kJT, H) slice of W_hh, pre-arranged by the wrapper into
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
// Hidden units per block.  Four gates per unit make the block's slice
// 4 kJT rows of Hk, so kJT = 4 keeps the accumulators (kRows x 4 kJT) and
// the shared memory of the backward kernel (csrc/lstm_bwd.cu) in bounds;
// the slice plus the dot buffer fit the 227 KB up to H ~ 3500 in bf16 and
// ~ 1750 in fp32.  A larger H fails cudaFuncSetAttribute and the call
// returns that error.
constexpr int kJT = 4;

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

// One timestep.  Shapes: xw_t (B, 4H); w_tiles (ceil(H/kJT), 4 kJT, Hk) with
// zero padding for k >= H and j >= H; b_hh (4H); h_prev / h_next (B, Hk)
// fp32 with zero padding for k >= H; c_state (B, H) fp32; hall_t and call_t
// (B, H); h_fin and c_fin (B, H) or null.
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_step(const T* __restrict__ xw_t, const T* __restrict__ w_tiles,
              const T* __restrict__ b_hh, const float* __restrict__ h_prev,
              float* __restrict__ h_next, float* __restrict__ c_state,
              T* __restrict__ hall_t, T* __restrict__ call_t,
              T* __restrict__ h_fin, T* __restrict__ c_fin,
              const int* __restrict__ lengths, int t, int B, int H, int Hk) {
  constexpr int C = 4 * kJT;
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
      float hw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int ks = 0; ks < ksplit; ++ks) {
        const float* d = dots + (ks * npad + rl) * C;
#pragma unroll
        for (int q = 0; q < 4; ++q) hw[q] += d[q * kJT + jj];
      }
      const T* x = xw_t + (size_t)b * 4 * H;
      float s[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[q] = to_f(x[q * H + j]) + (hw[q] + to_f(b_hh[q * H + j]));
      const float ig = sigmoidf_(s[0]);
      const float fg = sigmoidf_(s[1]);
      const float gg = tanhf(s[2]);
      const float og = sigmoidf_(s[3]);
      const float cp = c_state[(size_t)b * H + j];
      const float c_new = fg * cp + ig * gg;
      const float h_new = og * tanhf(c_new);
      const bool m = t < lengths[b];
      const float h_carry = m ? h_new : h_prev[(size_t)b * Hk + j];
      const float c_carry = m ? c_new : cp;
      h_next[(size_t)b * Hk + j] = h_carry;
      c_state[(size_t)b * H + j] = c_carry;
      hall_t[(size_t)b * H + j] = from_f<T>(m ? h_new : 0.0f);
      call_t[(size_t)b * H + j] = from_f<T>(c_carry);
      if (h_fin != nullptr) {
        h_fin[(size_t)b * H + j] = from_f<T>(h_carry);
        c_fin[(size_t)b * H + j] = from_f<T>(c_carry);
      }
    }
    __syncthreads();
  }
}

template <typename T>
int launch_scan(const void* xw, const void* w_tiles, const void* b_hh,
                void* h_a, void* h_b, void* c_state, void* h_all, void* c_all,
                void* h_fin, void* c_fin, const void* lengths, int T_len, int B,
                int H, int Hk, int reverse, cudaStream_t stream) {
  const size_t smem = sizeof(T) * 4 * kJT * (size_t)Hk
                      + sizeof(float) * kRowChunk * 4 * kJT;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kJT - 1) / kJT);
  const T* xw_p = static_cast<const T*>(xw);
  T* hall_p = static_cast<T*>(h_all);
  T* call_p = static_cast<T*>(c_all);
  float* hp = static_cast<float*>(h_a);
  float* hn = static_cast<float*>(h_b);
  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    const bool last = s == T_len - 1;
    lstm_fwd_step<T><<<grid, kThreads, smem, stream>>>(
        xw_p + (size_t)t * B * 4 * H, static_cast<const T*>(w_tiles),
        static_cast<const T*>(b_hh), hp, hn, static_cast<float*>(c_state),
        hall_p + (size_t)t * B * H, call_p + (size_t)t * B * H,
        last ? static_cast<T*>(h_fin) : nullptr,
        last ? static_cast<T*>(c_fin) : nullptr,
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

// Runs the whole scan: T launches of lstm_fwd_step on `stream`, no sync.
// w_tiles is W_hh tiled for jt hidden units per block, which must be kJT.
// dtype: 0 = float32, 1 = bfloat16 (xw, w_tiles, b_hh, h_all, c_all, h_fin
// and c_fin share it).  h_a holds h0 (fp32, (B, Hk), zero padded); h_b is
// scratch of the same shape; c_state holds c0 (fp32, (B, H)) and is updated
// in place.  Returns 0 or the first cudaError_t met.
extern "C" int lstm_scan_fwd(const void* xw, const void* w_tiles,
                             const void* b_hh, void* h_a, void* h_b,
                             void* c_state, void* h_all, void* c_all,
                             void* h_fin, void* c_fin, const void* lengths,
                             int T_len, int B, int H, int Hk, int jt,
                             int reverse, int dtype, void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kJT || Hk % 64 != 0 || Hk < H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scan<float>(xw, w_tiles, b_hh, h_a, h_b, c_state, h_all,
                              c_all, h_fin, c_fin, lengths, T_len, B, H, Hk,
                              reverse, s);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(xw, w_tiles, b_hh, h_a, h_b, c_state,
                                      h_all, c_all, h_fin, c_fin, lengths,
                                      T_len, B, H, Hk, reverse, s);
  return (int)cudaErrorInvalidValue;
}
