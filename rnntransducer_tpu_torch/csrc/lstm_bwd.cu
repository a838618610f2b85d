// Masked LSTM recurrence, backward through time, written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rnntransducer_tpu/ops/rnn_pallas.py::_lstm_bwd_kernel
// (called from _lstm_bwd, the custom VJP of lstm_scan).  Semantics kept
// exactly:
//   * time is walked opposite to the forward: t = T-1 .. 0 for a forward
//     scan, t = 0 .. T-1 for a reversed one;
//   * the gates are rebuilt from xw and the predecessor states h_prev and
//     c_prev: hw = h_prev @ W_hh + b_hh (h_prev rounded to W's type for the
//     product, fp32 accumulation, b_hh added in fp32), s = xw + hw, torch
//     gate order i, f, g, o, c' = f c_prev + i g, tc = tanh(c');
//   * g_h = (dh + g_out[t]) * m and g_c = dc * m are the grads into h' and
//     c'; then
//       do = g_h tc o (1 - o),  dc' = g_c + g_h o (1 - tc^2),
//       di = dc' g i (1 - i),  df = dc' c_prev f (1 - f),  dg = dc' i (1 - g^2),
//     and dxw = [di, df, dg, do] (== d(hw): every gate is additive in
//     xw + hw) is written in xw's type;
//   * the carries: dh' = dxw @ W_hh^T + (m ? 0 : dh), with dxw rounded to
//     W's type for the product and fp32 accumulation, and
//     dc' = dc' f + (m ? 0 : dc); both carries are fp32, and dh0 / dc0 are
//     written in xw's type after the last step.
// dW_hh and db_hh are reduced outside the loop by the caller, from h_prev and
// dxw, as the TPU version does.
//
// What bounds it on this card: every step does two skinny products,
// (B, H) x (H, 4H) to rebuild the gates and (B, 4H) x (4H, H) for the dh
// chain, 4 B H 4H FLOPs in all, and the chain of step t needs the whole dxw
// row of step t+1.  Both weight layouts (16.8 MB in bf16 at H = 1024) stay
// resident in the 50 MB L2 across launches, so a step is bound by fp32 FMA
// throughput on the CUDA cores and by the L2 reads of the chain's input
// row, which every block reads whole.
//
// Design (simple first, as the GRU backward kernel csrc/gru_bwd.cu):
//   * one launch per step, back to back on the caller's stream: the launch
//     boundary is the grid-wide barrier the dh chain needs.  Launch s
//     finishes the chain of the step before it (dh for its hidden units j
//     from the dgates row that launch s-1 wrote) and then does step s.  One
//     closing launch finishes the chain of the last step into dh0 and copies
//     dc into dc0, so a scan of T steps takes T + 1 launches;
//   * the dc chain, dc' f + (m ? 0 : dc), is local to unit j: it lives in
//     one fp32 buffer that only the block owning j reads and writes;
//   * each block owns kJT hidden units j.  Its chain slice is the kJT
//     contiguous rows j of W_hh (H, 4H); its gate slice is the 4 kJT columns
//     i_j, f_j, g_j, o_j, pre-arranged by the wrapper into one tile as for
//     the forward kernel.  Both are copied into shared memory once per
//     launch (128 KB in fp32 at H = 1024 with kJT = 4);
//   * products are register blocked over kRows rows of the activation with
//     a shuffle reduction over K, as in the forward kernel;
//   * the dgates row and the j-local rest of the dh carry (m ? 0 : dh)
//     ping-pong between two fp32 buffers in global memory.
// A persistent kernel with a grid barrier per step and wgmma for the
// products is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // rows of the activation each lane carries
constexpr int kRowChunk = 64;  // rows per pass through the dot buffers
// Hidden units per block, as in csrc/lstm_fwd.cu.  The block's two weight
// slices (4 kJT rows of Hk and kJT rows of Kc) plus the dot buffers fit the
// 227 KB of shared memory up to H ~ 3500 in bf16 and ~ 1750 in fp32; a
// larger H fails cudaFuncSetAttribute and the call returns that error.
constexpr int kJT = 4;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// x rounded to W's type (the TPU kernel's .astype(w.dtype)), back in fp32.
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

// How the block's warps split a chunk of nrows rows: rg row groups of kRows
// rows, and K split ksplit ways when there are fewer groups than warps.
struct Split {
  int ngroups, rg, ksplit, npad;
};

__device__ __forceinline__ Split split_rows(int nrows) {
  Split s;
  s.ngroups = (nrows + kRows - 1) / kRows;
  s.rg = 1;
  while (s.rg < s.ngroups && s.rg < kWarps) s.rg <<= 1;
  s.ksplit = kWarps / s.rg;
  s.npad = s.ngroups * kRows;
  return s;
}

// dots[(ks * npad + row) * C + c] = partial sum over this warp's share of K
// of quant<T>(act[r0 + row, k]) * w_s[c, k], for rows of the chunk
// [r0, r0 + nrows).  act is (rows, lda) of type TA, zero for k >= its width;
// w_s is (C, K) in shared memory; K % 64 == 0.
template <typename T, typename TA, int C>
__device__ __forceinline__ void chunk_dots(const T* w_s, const TA* act, int lda,
                                           int K, int r0, int nrows,
                                           const Split& s, float* dots) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int my_rg = warp / s.ksplit;
  const int my_ks = warp % s.ksplit;
  for (int g = my_rg; g < s.ngroups; g += s.rg) {
    float acc[kRows][C];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;

    const TA* arow[kRows];
    bool valid[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int rl = g * kRows + i;
      valid[i] = rl < nrows;
      arow[i] = act + (size_t)(r0 + (valid[i] ? rl : 0)) * lda;
    }

    for (int k = 2 * (my_ks * 32 + lane); k < K; k += 64 * s.ksplit) {
      float2 av[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float2 v = load_pair(arow[i] + k);
        av[i].x = valid[i] ? quant<T>(v.x) : 0.0f;
        av[i].y = valid[i] ? quant<T>(v.y) : 0.0f;
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float2 w = load_pair(w_s + (size_t)c * K + k);
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
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        acc[i][c] = v;
      }

#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c)
        if ((i * C + c) % 32 == lane && valid[i])
          dots[(my_ks * s.npad + g * kRows + i) * C + c] = acc[i][c];
  }
}

template <typename T>
__device__ __forceinline__ void copy_tile(T* dst, const T* src, size_t elems) {
  const int4* s = reinterpret_cast<const int4*>(src);
  int4* d = reinterpret_cast<int4*>(dst);
  const int n16 = (int)(sizeof(T) * elems / 16);
  for (int i = threadIdx.x; i < n16; i += kThreads) d[i] = __ldg(s + i);
}

// One launch.  Shapes: xw_t (B, 4H); hprev_t (B, Hk) zero padded for
// k >= H; cprev_t and gout_t (B, H); rec_tiles (ceil(H/kJT), 4 kJT, Hk) and
// chain_tiles (ceil(H/kJT), kJT, Kc), both zero padded; b_hh (4H);
// dg_in / dg_out (B, Kc) fp32, zero for k >= 4H; rest_in / rest_out and dc
// (B, H) fp32; dxw_t (B, 4H).  final != 0: only close the chains into dh0
// and dc0 (B, H).
template <typename T>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step(const T* __restrict__ xw_t, const T* __restrict__ hprev_t,
              const T* __restrict__ cprev_t, const T* __restrict__ gout_t,
              const T* __restrict__ rec_tiles, const T* __restrict__ chain_tiles,
              const T* __restrict__ b_hh, const int* __restrict__ lengths,
              const float* __restrict__ dg_in, float* __restrict__ dg_out,
              const float* __restrict__ rest_in, float* __restrict__ rest_out,
              float* __restrict__ dc, T* __restrict__ dxw_t,
              T* __restrict__ dh0, T* __restrict__ dc0, int t, int B, int H,
              int Hk, int Kc, int final) {
  constexpr int CR = 4 * kJT;  // gate columns of the block
  constexpr int CC = kJT;      // chain rows of the block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wc_s = reinterpret_cast<T*>(smem_raw);          // (CC, Kc)
  T* wr_s = wc_s + (size_t)CC * Kc;                  // (CR, Hk)
  float* dots_c = reinterpret_cast<float*>(wr_s + (size_t)CR * Hk);
  float* dots_r = dots_c + kRowChunk * CC;

  const int j0 = blockIdx.x * kJT;
  copy_tile(wc_s, chain_tiles + (size_t)blockIdx.x * CC * Kc, (size_t)CC * Kc);
  if (!final)
    copy_tile(wr_s, rec_tiles + (size_t)blockIdx.x * CR * Hk, (size_t)CR * Hk);
  __syncthreads();

  for (int r0 = 0; r0 < B; r0 += kRowChunk) {
    const int nrows = min(kRowChunk, B - r0);
    const Split s = split_rows(nrows);
    chunk_dots<T, float, CC>(wc_s, dg_in, Kc, Kc, r0, nrows, s, dots_c);
    if (!final)
      chunk_dots<T, T, CR>(wr_s, hprev_t, Hk, Hk, r0, nrows, s, dots_r);
    __syncthreads();

    for (int p = threadIdx.x; p < nrows * kJT; p += kThreads) {
      const int rl = p / kJT;
      const int jj = p % kJT;
      const int j = j0 + jj;
      if (j >= H) continue;
      const int b = r0 + rl;
      const size_t bj = (size_t)b * H + j;
      float chain = 0.0f;
      for (int ks = 0; ks < s.ksplit; ++ks) chain += dots_c[(ks * s.npad + rl) * CC + jj];
      const float dh = chain + rest_in[bj];
      if (final) {
        dh0[bj] = from_f<T>(dh);
        dc0[bj] = from_f<T>(dc[bj]);
        continue;
      }
      float hw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int ks = 0; ks < s.ksplit; ++ks) {
        const float* d = dots_r + (ks * s.npad + rl) * CR;
#pragma unroll
        for (int q = 0; q < 4; ++q) hw[q] += d[q * kJT + jj];
      }
      const T* x = xw_t + (size_t)b * 4 * H;
      float sg[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        sg[q] = to_f(x[q * H + j]) + (hw[q] + to_f(b_hh[q * H + j]));
      const float ig = sigmoidf_(sg[0]);
      const float fg = sigmoidf_(sg[1]);
      const float gg = tanhf(sg[2]);
      const float og = sigmoidf_(sg[3]);
      const float cp = to_f(cprev_t[bj]);
      const float tc = tanhf(fg * cp + ig * gg);
      const bool m = t < lengths[b];
      const float dc_old = dc[bj];
      const float g_h = m ? dh + to_f(gout_t[bj]) : 0.0f;
      const float g_c = m ? dc_old : 0.0f;
      const float d_o = g_h * tc * og * (1.0f - og);
      const float dc_new = g_c + g_h * og * (1.0f - tc * tc);
      const float d_i = dc_new * gg * ig * (1.0f - ig);
      const float d_f = dc_new * cp * fg * (1.0f - fg);
      const float d_g = dc_new * ig * (1.0f - gg * gg);
      T* dx = dxw_t + (size_t)b * 4 * H;
      dx[j] = from_f<T>(d_i);
      dx[H + j] = from_f<T>(d_f);
      dx[2 * H + j] = from_f<T>(d_g);
      dx[3 * H + j] = from_f<T>(d_o);
      float* dg = dg_out + (size_t)b * Kc;
      dg[j] = d_i;
      dg[H + j] = d_f;
      dg[2 * H + j] = d_g;
      dg[3 * H + j] = d_o;
      rest_out[bj] = m ? 0.0f : dh;
      dc[bj] = dc_new * fg + (m ? 0.0f : dc_old);
    }
    __syncthreads();
  }
}

template <typename T>
int launch_bwd(const void* xw, const void* hprev, const void* cprev,
               const void* gout, const void* rec_tiles, const void* chain_tiles,
               const void* b_hh, const void* lengths, void* dg_a, void* dg_b,
               void* rest_a, void* rest_b, void* dc, void* dxw, void* dh0,
               void* dc0, int T_len, int B, int H, int Hk, int Kc, int reverse,
               cudaStream_t stream) {
  const size_t smem = sizeof(T) * ((size_t)kJT * Kc + (size_t)4 * kJT * Hk)
                      + sizeof(float) * kRowChunk * 5 * kJT;
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_step<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kJT - 1) / kJT);
  const T* xw_p = static_cast<const T*>(xw);
  const T* hp_p = static_cast<const T*>(hprev);
  const T* cp_p = static_cast<const T*>(cprev);
  const T* go_p = static_cast<const T*>(gout);
  T* dxw_p = static_cast<T*>(dxw);
  float* dg[2] = {static_cast<float*>(dg_a), static_cast<float*>(dg_b)};
  float* rest[2] = {static_cast<float*>(rest_a), static_cast<float*>(rest_b)};
  for (int s = 0; s <= T_len; ++s) {
    const int final = s == T_len;
    const int t = final ? 0 : (reverse ? s : T_len - 1 - s);
    lstm_bwd_step<T><<<grid, kThreads, smem, stream>>>(
        xw_p + (size_t)t * B * 4 * H, hp_p + (size_t)t * B * Hk,
        cp_p + (size_t)t * B * H, go_p + (size_t)t * B * H,
        static_cast<const T*>(rec_tiles), static_cast<const T*>(chain_tiles),
        static_cast<const T*>(b_hh), static_cast<const int*>(lengths),
        dg[s % 2], dg[(s + 1) % 2], rest[s % 2], rest[(s + 1) % 2],
        static_cast<float*>(dc), dxw_p + (size_t)t * B * 4 * H,
        static_cast<T*>(dh0), static_cast<T*>(dc0), t, B, H, Hk, Kc, final);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Runs the whole backward scan: T + 1 launches of lstm_bwd_step on `stream`,
// no sync.  dtype: 0 = float32, 1 = bfloat16 (xw, hprev, cprev, gout, both
// tile sets, b_hh, dxw, dh0 and dc0 share it).  dg_a must be zero (B, Kc)
// fp32 and rest_a must hold g_hfin as (B, H) fp32; dg_b (zero) and rest_b
// are scratch of the same shapes; dc holds g_cfin as (B, H) fp32 and is
// updated in place.  jt must be kJT.  Returns 0 or the first cudaError_t met.
extern "C" int lstm_scan_bwd(const void* xw, const void* hprev, const void* cprev,
                             const void* gout, const void* rec_tiles,
                             const void* chain_tiles, const void* b_hh,
                             const void* lengths, void* dg_a, void* dg_b,
                             void* rest_a, void* rest_b, void* dc, void* dxw,
                             void* dh0, void* dc0, int T_len, int B, int H,
                             int Hk, int Kc, int jt, int reverse, int dtype,
                             void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kJT || Hk % 64 != 0 || Hk < H || Kc % 64 != 0 || Kc < 4 * H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(xw, hprev, cprev, gout, rec_tiles, chain_tiles,
                             b_hh, lengths, dg_a, dg_b, rest_a, rest_b, dc, dxw,
                             dh0, dc0, T_len, B, H, Hk, Kc, reverse, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(xw, hprev, cprev, gout, rec_tiles,
                                     chain_tiles, b_hh, lengths, dg_a, dg_b,
                                     rest_a, rest_b, dc, dxw, dh0, dc0, T_len,
                                     B, H, Hk, Kc, reverse, s);
  return (int)cudaErrorInvalidValue;
}
