// Masked LSTM recurrence, backward through time, written by hand for Hopper
// (sm_90a): one GEMM launch and one persistent launch per scan.
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
//     W's type for the product (the TPU kernel's dgates.astype(w.dtype)) and
//     fp32 accumulation, and dc' = dc' f + (m ? 0 : dc); both carries are
//     fp32, and dh0 / dc0 are written in xw's type after the last step.
// dW_hh and db_hh are reduced outside the loop by the caller, from h_prev and
// dxw, as the TPU version does.
//
// Design (persistent, as the GRU backward kernel gru_bwd.cu):
//   * the gate recompute is off the chain, as in the TPU kernel
//     (rnn_pallas.py:243-245): h_prev is known for every step before the
//     scan starts, so the gates GEMM (gates_gemm.cuh) computes
//     hw = h_prev @ W_hh + b_hh for all steps in one launch,
//     (T B, Hk) x (Hk, 4H) into an fp32 scratch (T, B, 4H);
//   * the chain is one cooperative launch of ceil(H / JT) blocks, one per
//     SM.  Each block owns JT hidden units j (8, or 4 for small H) and keeps
//     its chain slice, the rows j of W_hh (JT x 4H, padded to 8 rows for
//     the MMA's n-tile: 64 KB in bf16 at H = 1024, 128 KB in fp32), in
//     shared memory for the whole scan; it does one product per step,
//     (B, 4H) x (4H, 8), on the tensor cores in bf16 (CUDA-core FMAs in
//     fp32);
//   * a grid-wide barrier per step (rnn_persistent.cuh::grid_sync).  The
//     broadcast row is dgates = [di, df, dg, do] rounded to W's type
//     (512 KB at B = 64, H = 1024 in bf16), written once by its owner block
//     and read by every block from L2 with 16-byte ld.global.cg straight
//     into the MMA fragments, ping-ponging between two buffers.  The dc
//     carry and the rest of the dh carry, (m ? 0 : dh), are local to the
//     block's units, each updated in place in a buffer only that block
//     touches.  Step s closes the chain of step s-1 (dh for its units from
//     the dgates row of step s-1), then does step s; after the last barrier
//     the block closes the chain into dh0 and copies dc into dc0;
//   * the gates' inputs of the next step (hw, xw, c_prev, g_out, lengths,
//     the carries) are loaded into registers before the grid barrier;
//   * batches over 64 rows are walked in 64-row chunks inside a step.
//
// Co-residency limit: one block per SM, so H <= 8 * (the card's SMs), 1056
// on an H100 SXM (ops/rnn_kernels.py::lstm_route reads the card before any
// launch).  A
// larger H takes the per-step route below (the first design: T + 1 launches
// per scan, both slices copied into shared memory every launch, CUDA-core
// FMAs), which takes H up to ~3500 in bf16 and ~1750 in fp32.
//
// What bounds it on this card: the step chain, not the operations, as for
// the GRU backward kernel: per step the floor (L2 round trips, the gates,
// the grid barrier), then every SM taking in the whole dgates row from L2.
// The gates GEMM writes T B 4H fp32 values once and the chain reads them
// back once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gates_gemm.cuh"
#include "rnn_persistent.cuh"
#include "step_stream.cuh"

namespace {

using namespace rnnp;

constexpr int CC = 8;        // chain rows of a block: its JT units, padded to an n-tile
constexpr int kUnroll = 8;   // K slabs of A in flight per warp, as in gru_bwd.cu

// Shapes: xw (T, B, 4H); hw (T, B, 4H) fp32; cprev and gout (T, B, H);
// chain_tiles (ceil(H/JT), CC, Kc) zero padded; dg (2, B, Kc) of T, zero;
// rest (B, H) fp32 = g_hfin; dc (B, H) fp32 = g_cfin; dxw (T, B, 4H);
// dh0 and dc0 (B, H); count a zeroed barrier counter.
template <typename T, int JT>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_persistent(const T* __restrict__ xw, const float* __restrict__ hw,
                    const T* __restrict__ cprev, const T* __restrict__ gout,
                    const T* __restrict__ chain_tiles, const int* __restrict__ lengths,
                    T* dg, float* rest, float* dc, T* __restrict__ dxw,
                    T* __restrict__ dh0, T* __restrict__ dc0, unsigned int* count,
                    int T_len, int B, int H, int Kc, int reverse) {
  // Inputs of the first 64-row chunk a thread prefetches: its items
  // p = threadIdx.x + i kThreads all have the unit j0 + threadIdx.x % JT.
  constexpr int kPre = kRowChunk * JT / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wc_s = reinterpret_cast<T*>(smem_raw);
  const int ldw = slice_ld<T>(Kc);
  float* dots = reinterpret_cast<float*>(wc_s + (size_t)CC * ldw);
  load_slice(wc_s, chain_tiles + (size_t)blockIdx.x * CC * Kc, CC, Kc);
  __syncthreads();

  // Step s < T_len closes the chain of step s-1 (dh for the block's units
  // from the dgates row of step s-1; zero at s = 0), then does step s;
  // s == T_len closes the chain of the last step into dh0.  The inputs of
  // the first chunk are loaded for the next step before the grid barrier,
  // so their latency hides behind it.
  const int jj = threadIdx.x % JT, j = blockIdx.x * JT + jj;
  const bool j_ok = j < H;
  struct In {
    float hw[4], x[4], cp, go, rest, dc;
    int len;
  };
  auto load_in = [&](int s, int b) {
    In v{};
    v.rest = rest[(size_t)b * H + j];
    v.dc = dc[(size_t)b * H + j];
    if (s == T_len) return v;
    const int t = reverse ? s : T_len - 1 - s;
    const size_t row = (size_t)t * B + b;
    const float* hwr = hw + row * 4 * H;
    const T* x = xw + row * 4 * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v.hw[q] = hwr[q * H + j];
      v.x[q] = to_f(x[q * H + j]);
    }
    v.cp = to_f(cprev[row * H + j]);
    v.go = to_f(gout[row * H + j]);
    v.len = lengths[b];
    return v;
  };
  In pre[kPre];
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int b = (threadIdx.x + i * kThreads) / JT;
      if (j_ok && b < min(B, kRowChunk)) pre[i] = load_in(s, b);
    }
  };
  prefetch(0);

  for (int s = 0; s <= T_len; ++s) {
    const bool last = s == T_len;
    const int t = reverse ? s : T_len - 1 - s;
    const T* dg_in = dg + (size_t)((s + 1) % 2) * B * Kc;
    T* dg_out = dg + (size_t)(s % 2) * B * Kc;
    // one unit of one row: its chain dots (chunk row rl) and its inputs
    auto item = [&](const Split& sp, int b, int rl, const In& v) {
      float chain = 0.0f;
      for (int ks = 0; ks < sp.ksplit; ++ks) chain += dots[(ks * sp.npad + rl) * CC + jj];
      const float dh = chain + v.rest;
      const size_t bj = (size_t)b * H + j;
      if (last) {
        dh0[bj] = from_f<T>(dh);
        dc0[bj] = from_f<T>(v.dc);
        return;
      }
      const float ig = sigmoidf_(v.x[0] + v.hw[0]);
      const float fg = sigmoidf_(v.x[1] + v.hw[1]);
      const float gg = tanhf(v.x[2] + v.hw[2]);
      const float og = sigmoidf_(v.x[3] + v.hw[3]);
      const float tc = tanhf(fg * v.cp + ig * gg);
      const bool m = t < v.len;
      const float g_h = m ? dh + v.go : 0.0f;
      const float g_c = m ? v.dc : 0.0f;
      const float d_o = g_h * tc * og * (1.0f - og);
      const float dc_new = g_c + g_h * og * (1.0f - tc * tc);
      const float d[4] = {dc_new * gg * ig * (1.0f - ig), dc_new * v.cp * fg * (1.0f - fg),
                          dc_new * ig * (1.0f - gg * gg), d_o};
      T* dx = dxw + ((size_t)t * B + b) * 4 * H;
      T* dr = dg_out + (size_t)b * Kc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        dx[q * H + j] = from_f<T>(d[q]);
        dr[q * H + j] = from_f<T>(d[q]);
      }
      rest[bj] = m ? 0.0f : dh;
      dc[bj] = dc_new * fg + (m ? 0.0f : v.dc);
    };
    for (int r0 = 0; r0 < B; r0 += kRowChunk) {
      const int nrows = min(kRowChunk, B - r0);
      Split sp = {0, 0, 0, 0};
      if (s > 0) sp = dots_of<CC, kUnroll>(wc_s, ldw, dg_in, Kc, Kc, r0, nrows, dots);
      __syncthreads();
      if (j_ok && r0 == 0) {
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int p = threadIdx.x + i * kThreads;
          if (p < nrows * JT) item(sp, p / JT, p / JT, pre[i]);
        }
      } else if (j_ok) {
        for (int p = threadIdx.x; p < nrows * JT; p += kThreads)
          item(sp, r0 + p / JT, p / JT, load_in(s, r0 + p / JT));
      }
      __syncthreads();
    }
    if (!last) {
      prefetch(s + 1);
      grid_sync(count, (unsigned int)(s + 1) * gridDim.x);
    }
  }
}

template <typename T, int JT>
int launch_chain(const void* xw, const void* hw, const void* cprev, const void* gout,
                 const void* chain_tiles, const void* lengths, void* dg, void* rest,
                 void* dc, void* dxw, void* dh0, void* dc0, void* count, int T_len,
                 int B, int H, int Kc, int reverse, cudaStream_t stream) {
  const int blocks = (H + JT - 1) / JT;
  const size_t smem = slice_smem<T>(CC, Kc);
  void* args[] = {&xw, &hw, &cprev, &gout, &chain_tiles, &lengths, &dg, &rest,
                  &dc, &dxw, &dh0, &dc0, &count, &T_len, &B, &H, &Kc, &reverse};
  return (int)cudaLaunchCooperativeKernel((const void*)lstm_bwd_persistent<T, JT>,
                                          dim3(blocks), dim3(kThreads), args, smem,
                                          stream);
}

template <typename T>
int max_blocks(int jt, int Kc) {
  int blocks = -1;
  const size_t smem = slice_smem<T>(CC, Kc);
  const cudaError_t err =
      jt == 8 ? max_coresident(lstm_bwd_persistent<T, 8>, smem, &blocks)
              : max_coresident(lstm_bwd_persistent<T, 4>, smem, &blocks);
  return err == cudaSuccess ? blocks : -1;
}

template <typename T>
int launch_bwd(const void* xw, const void* hprev, const void* cprev, const void* gout,
               const void* w_t, const void* chain_tiles, const void* b_hh,
               const void* lengths, void* hw, void* dg, void* rest, void* dc,
               void* dxw, void* dh0, void* dc0, void* count, int T_len, int B, int H,
               int Hk, int Kc, int jt, int reverse, cudaStream_t stream) {
  const int fit = max_blocks<T>(jt, Kc);
  if (fit < 0) return (int)cudaErrorInvalidValue;
  if ((H + jt - 1) / jt > fit) return (int)cudaErrorCooperativeLaunchTooLarge;
  cudaError_t err = launch_gemm<T>(static_cast<const T*>(hprev), static_cast<const T*>(w_t),
                                   static_cast<const T*>(b_hh), static_cast<float*>(hw),
                                   T_len * B, 4 * H, Hk, stream);
  if (err != cudaSuccess) return (int)err;
  if (jt == 8)
    return launch_chain<T, 8>(xw, hw, cprev, gout, chain_tiles, lengths, dg, rest, dc,
                              dxw, dh0, dc0, count, T_len, B, H, Kc, reverse, stream);
  return launch_chain<T, 4>(xw, hw, cprev, gout, chain_tiles, lengths, dg, rest, dc, dxw,
                            dh0, dc0, count, T_len, B, H, Kc, reverse, stream);
}

}  // namespace

// ---------------------------------------------------------------------------
// The per-step route, for H above the persistent grid's limit: one launch per
// step, back to back on the caller's stream; the launch boundary is the
// grid-wide barrier the dh chain needs.  Launch s finishes the chain of the
// step before it and then does step s, rebuilding the gates from h_prev
// itself; one closing launch finishes the chain of the last step into dh0
// and copies dc into dc0, so a scan of T steps takes T + 1 launches.  Each
// block owns kStepJT units and copies its chain slice (kStepJT rows of W_hh)
// and its gate slice (4 kStepJT columns) into shared memory every launch;
// the fp32 dgates row and the rest of the dh carry ping-pong.
// ---------------------------------------------------------------------------

namespace per_step {

using namespace rnnp;

constexpr int kRows = 4;     // rows of the activation each lane carries
// Hidden units per block: the block's two weight slices (4 kStepJT rows of
// Hk and kStepJT rows of Kc) plus the dot buffers fit the 227 KB of shared
// memory up to H ~ 3500 in bf16 and ~ 1750 in fp32; a larger H fails
// cudaFuncSetAttribute and the call returns that error.
constexpr int kStepJT = 4;

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
// k >= H; cprev_t and gout_t (B, H); rec_tiles (ceil(H/kStepJT), 4 kStepJT, Hk) and
// chain_tiles (ceil(H/kStepJT), kStepJT, Kc), both zero padded; b_hh (4H);
// dg_in / dg_out (B, Kc) fp32, zero for k >= 4H; rest_in / rest_out and dc
// (B, H) fp32; dxw_t (B, 4H).  final != 0: only close the chains into dh0
// and dc0 (B, H).
template <typename T, bool kStream>
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
  constexpr int CR = 4 * kStepJT;  // gate columns of the block
  constexpr int CC = kStepJT;      // chain rows of the block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wc_s = reinterpret_cast<T*>(smem_raw);          // (CC, Kc), or the chunk ring
  T* wr_s = wc_s + (size_t)CC * Kc;                  // (CR, Hk)
  float* dots_c = reinterpret_cast<float*>(
      kStream ? smem_raw + step_stream::ring_bytes<T>(CR)
              : reinterpret_cast<unsigned char*>(wr_s + (size_t)CR * Hk));
  float* dots_r = dots_c + kRowChunk * CC;

  const int j0 = blockIdx.x * kStepJT;
  if constexpr (!kStream) {
    copy_tile(wc_s, chain_tiles + (size_t)blockIdx.x * CC * Kc, (size_t)CC * Kc);
    if (!final)
      copy_tile(wr_s, rec_tiles + (size_t)blockIdx.x * CR * Hk, (size_t)CR * Hk);
    __syncthreads();
  }

  for (int r0 = 0; r0 < B; r0 += kRowChunk) {
    const int nrows = min(kRowChunk, B - r0);
    const Split s = split_rows(nrows, kRows);
    if constexpr (kStream) {
      step_stream::streamed_dots<T, float, CC, kRows>(
          wc_s, chain_tiles + (size_t)blockIdx.x * CC * Kc, Kc, dg_in, Kc, Kc, r0,
          nrows, s, dots_c);
      if (!final)
        step_stream::streamed_dots<T, T, CR, kRows>(
            wc_s, rec_tiles + (size_t)blockIdx.x * CR * Hk, Hk, hprev_t, Hk, Hk, r0,
            nrows, s, dots_r);
    } else {
      chunk_dots<T, float, CC>(wc_s, dg_in, Kc, Kc, r0, nrows, s, dots_c);
      if (!final)
        chunk_dots<T, T, CR>(wr_s, hprev_t, Hk, Hk, r0, nrows, s, dots_r);
    }
    __syncthreads();

    for (int p = threadIdx.x; p < nrows * kStepJT; p += kThreads) {
      const int rl = p / kStepJT;
      const int jj = p % kStepJT;
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
        for (int q = 0; q < 4; ++q) hw[q] += d[q * kStepJT + jj];
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

// Dynamic shared memory of one per-step block: its two whole slices (kStepJT
// rows of Kc, 4 kStepJT rows of Hk), or, streamed, the chunk ring of the
// wider one, whatever H is; plus the two dot buffers.
template <typename T, bool kStream> constexpr size_t step_smem(int Hk, int Kc) {
  return (kStream ? step_stream::ring_bytes<T>(4 * kStepJT)
                  : sizeof(T) * ((size_t)kStepJT * Kc + (size_t)4 * kStepJT * Hk))
         + sizeof(float) * kRowChunk * 5 * kStepJT;
}

template <typename T, bool kStream>
int launch_steps(const void* xw, const void* hprev, const void* cprev,
                 const void* gout, const void* rec_tiles, const void* chain_tiles,
                 const void* b_hh, const void* lengths, void* dg_a, void* dg_b,
                 void* rest_a, void* rest_b, void* dc, void* dxw, void* dh0,
                 void* dc0, int T_len, int B, int H, int Hk, int Kc, int reverse,
                 cudaStream_t stream) {
  const size_t smem = step_smem<T, kStream>(Hk, Kc);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_step<T, kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kStepJT - 1) / kStepJT);
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
    lstm_bwd_step<T, kStream><<<grid, kThreads, smem, stream>>>(
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

}  // namespace per_step

// Runs the whole backward scan on `stream`, no sync: the gates GEMM into hw
// (T, B, 4H) fp32 scratch, then one cooperative launch of the chain.
// dtype: 0 = float32, 1 = bfloat16 (xw, hprev, cprev, gout, w_t,
// chain_tiles, b_hh, dg, dxw, dh0 and dc0 share it).  hprev is (T, B, Hk)
// zero padded for k >= H; w_t is W_hh^T, (4H, Hk) zero padded; chain_tiles
// is (ceil(H/jt), 8, Kc), block i's rows j = jt i + jj of W_hh, zero padded;
// dg is (2, B, Kc) zero; rest and dc are (B, H) fp32 holding g_hfin and
// g_cfin, updated in place; count is one zeroed uint32.  jt is 8 or 4.
// Returns 0 or the first cudaError_t met (cudaErrorCooperativeLaunchTooLarge
// when the grid cannot be co-resident).
extern "C" int lstm_scan_bwd(const void* xw, const void* hprev, const void* cprev,
                             const void* gout, const void* w_t, const void* chain_tiles,
                             const void* b_hh, const void* lengths, void* hw, void* dg,
                             void* rest, void* dc, void* dxw, void* dh0, void* dc0,
                             void* count, int T_len, int B, int H, int Hk, int Kc,
                             int jt, int reverse, int dtype, void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if ((jt != 4 && jt != 8) || Hk % 64 != 0 || Hk < H || Kc % 64 != 0 || Kc < 4 * H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(xw, hprev, cprev, gout, w_t, chain_tiles, b_hh, lengths,
                             hw, dg, rest, dc, dxw, dh0, dc0, count, T_len, B, H, Hk,
                             Kc, jt, reverse, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(xw, hprev, cprev, gout, w_t, chain_tiles, b_hh,
                                     lengths, hw, dg, rest, dc, dxw, dh0, dc0, count,
                                     T_len, B, H, Hk, Kc, jt, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one chain block, for the wrapper's limit.
extern "C" int lstm_scan_bwd_smem(int Kc, int dtype) {
  return (int)(dtype == 0 ? slice_smem<float>(CC, Kc) : slice_smem<__nv_bfloat16>(CC, Kc));
}

// The most chain blocks that can be co-resident on this card, or -1.
extern "C" int lstm_scan_bwd_max_blocks(int Kc, int jt, int dtype) {
  if (jt != 4 && jt != 8) return -1;
  return dtype == 0 ? max_blocks<float>(jt, Kc) : max_blocks<__nv_bfloat16>(jt, Kc);
}

// The per-step route: T + 1 launches of lstm_bwd_step on `stream`, no sync.
// dtype as above (xw, hprev, cprev, gout, both tile sets, b_hh, dxw, dh0 and
// dc0 share it).  dg_a must be zero (B, Kc) fp32 and rest_a must hold
// g_hfin as (B, H) fp32; dg_b (zero) and rest_b are scratch of the same
// shapes; dc holds g_cfin as (B, H) fp32 and is updated in place.  jt must
// be kStepJT.  Returns 0 or the first cudaError_t met.
template <bool kStream>
static int bwd_steps(const void* xw, const void* hprev, const void* cprev,
                     const void* gout, const void* rec_tiles, const void* chain_tiles,
                     const void* b_hh, const void* lengths, void* dg_a, void* dg_b,
                     void* rest_a, void* rest_b, void* dc, void* dxw, void* dh0,
                     void* dc0, int T_len, int B, int H, int Hk, int Kc, int jt,
                     int reverse, int dtype, void* stream) {
  using namespace per_step;
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kStepJT || Hk % 64 != 0 || Hk < H || Kc % 64 != 0 || Kc < 4 * H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_steps<float, kStream>(xw, hprev, cprev, gout, rec_tiles, chain_tiles,
                                        b_hh, lengths, dg_a, dg_b, rest_a, rest_b, dc,
                                        dxw, dh0, dc0, T_len, B, H, Hk, Kc, reverse, s);
  if (dtype == 1)
    return launch_steps<__nv_bfloat16, kStream>(xw, hprev, cprev, gout, rec_tiles,
                                                chain_tiles, b_hh, lengths, dg_a, dg_b,
                                                rest_a, rest_b, dc, dxw, dh0, dc0,
                                                T_len, B, H, Hk, Kc, reverse, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_scan_bwd_step(const void* xw, const void* hprev, const void* cprev,
                                  const void* gout, const void* rec_tiles,
                                  const void* chain_tiles, const void* b_hh,
                                  const void* lengths, void* dg_a, void* dg_b,
                                  void* rest_a, void* rest_b, void* dc, void* dxw,
                                  void* dh0, void* dc0, int T_len, int B, int H,
                                  int Hk, int Kc, int jt, int reverse, int dtype,
                                  void* stream) {
  return bwd_steps<false>(xw, hprev, cprev, gout, rec_tiles, chain_tiles, b_hh, lengths,
                          dg_a, dg_b, rest_a, rest_b, dc, dxw, dh0, dc0, T_len, B, H,
                          Hk, Kc, jt, reverse, dtype, stream);
}

// The same launches with both slices streamed through shared memory in K
// chunks (step_stream.cuh): any H, for H above the whole-slice block's limit.
extern "C" int lstm_scan_bwd_step_chunked(const void* xw, const void* hprev,
                                          const void* cprev, const void* gout,
                                          const void* rec_tiles, const void* chain_tiles,
                                          const void* b_hh, const void* lengths,
                                          void* dg_a, void* dg_b, void* rest_a,
                                          void* rest_b, void* dc, void* dxw, void* dh0,
                                          void* dc0, int T_len, int B, int H, int Hk,
                                          int Kc, int jt, int reverse, int dtype,
                                          void* stream) {
  return bwd_steps<true>(xw, hprev, cprev, gout, rec_tiles, chain_tiles, b_hh, lengths,
                         dg_a, dg_b, rest_a, rest_b, dc, dxw, dh0, dc0, T_len, B, H, Hk,
                         Kc, jt, reverse, dtype, stream);
}

// Dynamic shared memory of one streamed per-step block (any H).
extern "C" int lstm_scan_bwd_step_chunked_smem(int dtype) {
  using namespace per_step;
  return (int)(dtype == 0 ? step_smem<float, true>(0, 0)
                          : step_smem<__nv_bfloat16, true>(0, 0));
}
