// Masked GRU recurrence, backward through time, written by hand for Hopper
// (sm_90a): one GEMM launch and one persistent launch per scan.
//
// Replaces the TPU kernel rnntransducer_tpu/ops/rnn_pallas.py::_gru_bwd_kernel
// (called through _gru_bwd_call, the custom VJP of gru_scan).  Semantics kept
// exactly:
//   * time is walked opposite to the forward: t = T-1 .. 0 for a forward
//     scan, t = 0 .. T-1 for a reversed one;
//   * the gates are rebuilt from xw and the predecessor state h_prev:
//     hw = h_prev @ W_hh + b_hh (h_prev rounded to W's type for the product,
//     fp32 accumulation, b_hh added in fp32), torch gate order r, z, n with
//     b_hn inside r * (...);
//   * g = (dh + g_out[t]) * m, the step's gate grads are
//       dz = g (h_prev - n) z (1 - z),  dn = g (1 - z) (1 - n^2),
//       dr = dn hn r (1 - r),  dnr = dn r,
//     dxw = [dr, dz, dn] and dnr are written in xw's type;
//   * the dh chain: dh' = [dr, dz, dnr] @ W_hh^T + g z + (m ? 0 : dh), with
//     [dr, dz, dnr] rounded to W's type for the product and fp32 accumulation;
//     a masked step has g = 0 and carries dh through; h_prev there is never
//     trusted (it only meets g = 0);
//   * the dh carry is fp32; dh0 is written in xw's type after the last step.
// dW_hh and db_hh are reduced outside by the caller, from h_prev, dxw and
// dnr, as the TPU version does.
//
// Design:
//   * the gate recompute is off the chain, as in the TPU kernel
//     (rnn_pallas.py:177-185): h_prev is known for every step before the
//     scan starts, so the gates GEMM (gates_gemm.cuh) computes
//     hw = h_prev @ W_hh + b_hh for all steps in one launch,
//     (T B, Hk) x (Hk, 3H) into fp32: bf16 on the
//     tensor cores (mma.sync m16n8k16, 128 x 128 block tiles fed by a
//     3-stage cp.async ring), fp32 on the CUDA cores (a register-blocked
//     SIMT tile);
//   * the chain is one cooperative launch of ceil(H / 8) blocks, one per SM.
//     Each block owns 8 hidden units j and keeps its chain slice (the 8 rows
//     j of W_hh, 8 x 3H: 48 KB in bf16 at H = 1024, 96 KB in fp32) in shared
//     memory for the whole scan; it does one product per step,
//     (B, 3H) x (3H, 8), on the tensor cores in bf16 (CUDA-core FMAs in
//     fp32);
//   * a grid-wide barrier per step (rnn_persistent.cuh::grid_sync).  The
//     broadcast row is dhw = [dr, dz, dnr] rounded to W's type (384 KB at
//     B = 64 in bf16), written once by its owner block and read by every
//     block from L2 with 16-byte ld.global.cg straight into the MMA
//     fragments, 8 slabs of K in flight per warp, ping-ponging between two
//     buffers.  The rest of the carry, g z + (m ? 0 : dh), is local to the
//     block's units and is updated in place in a buffer only that block
//     touches.  Step s closes the chain of step s-1 (dh for its units from
//     the dhw row of step s-1), then does step s; after the last barrier the
//     block closes the chain into dh0;
//   * the gates' inputs of the next step (hw, xw, h_prev, g_out, lengths,
//     the rest) are loaded into registers before the grid barrier;
//   * batches over 64 rows are walked in 64-row chunks inside a step.
//
// Co-residency limit: one block per SM, so H <= 8 * 132 = 1056 on an H100
// SXM (ops/rnn_kernels.py::gru_max_hidden says so before any launch).
//
// What bounds it on this card: the step chain, not the operations.  At
// B = 1 a chain step takes ~5 us (L2 round trips, the gates, the grid
// barrier); at B = 64 ~16 us, most of it every SM taking in the whole
// 384 KB dhw row from L2 (~48 MB per step over 128 SMs).  The chain product
// is ~0.4 us of tensor-core time per step.  The gates GEMM (~1 ms at
// T = 512, B = 64, H = 1024) writes 403 MB of fp32 hw, ~0.12 ms of HBM time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gates_gemm.cuh"
#include "rnn_persistent.cuh"

namespace {

using namespace rnnp;

constexpr int CC = kJT;      // chain rows of the block
constexpr int kUnroll = 8;   // K slabs of A in flight per warp (12 and 16 were no faster)
// Inputs of the first 64-row chunk a thread prefetches: its items
// p = threadIdx.x + i kThreads all have the unit j0 + threadIdx.x % kJT.
constexpr int kPre = kRowChunk * kJT / kThreads;

// ---------------------------------------------------------------------------
// the persistent chain
// ---------------------------------------------------------------------------

// Shapes: xw (T, B, 3H); hw (T, B, 3H) fp32; hprev (T, B, Hk); gout
// (T, B, H); chain_tiles (ceil(H/kJT), CC, Kc) zero padded; dhw (2, B, Kc)
// of T, zero; rest (B, H) fp32 = g_hfin; dxw (T, B, 3H); dnr (T, B, H);
// dh0 (B, H); count a zeroed barrier counter.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_persistent(const T* __restrict__ xw, const float* __restrict__ hw,
                   const T* __restrict__ hprev, const T* __restrict__ gout,
                   const T* __restrict__ chain_tiles, const int* __restrict__ lengths,
                   T* dhw, float* rest, T* __restrict__ dxw, T* __restrict__ dnr,
                   T* __restrict__ dh0, unsigned int* count, int T_len, int B, int H,
                   int Hk, int Kc, int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wc_s = reinterpret_cast<T*>(smem_raw);
  const int ldw = slice_ld<T>(Kc);
  float* dots = reinterpret_cast<float*>(wc_s + (size_t)CC * ldw);
  const int j0 = blockIdx.x * kJT;
  load_slice(wc_s, chain_tiles + (size_t)blockIdx.x * CC * Kc, CC, Kc);
  __syncthreads();

  // Step s < T_len closes the chain of step s-1 (dh for the block's units
  // from the dhw row of step s-1; zero at s = 0), then does step s; s ==
  // T_len closes the chain of the last step into dh0.  The inputs of the
  // first chunk are loaded for the next step before the grid barrier, so
  // their latency hides behind it.
  const int jj = threadIdx.x % kJT, j = j0 + jj;
  const bool j_ok = j < H;
  struct In {
    float hr, hz, hn, xr, xz, xn, hp, go, rest;
    int len;
  };
  auto load_in = [&](int s, int b) {
    In v{};
    v.rest = rest[(size_t)b * H + j];
    if (s == T_len) return v;
    const int t = reverse ? s : T_len - 1 - s;
    const size_t row = (size_t)t * B + b;
    const float* hwr = hw + row * 3 * H;
    const T* x = xw + row * 3 * H;
    v.hr = hwr[j];
    v.hz = hwr[H + j];
    v.hn = hwr[2 * H + j];
    v.xr = to_f(x[j]);
    v.xz = to_f(x[H + j]);
    v.xn = to_f(x[2 * H + j]);
    v.hp = to_f(hprev[row * Hk + j]);
    v.go = to_f(gout[row * H + j]);
    v.len = lengths[b];
    return v;
  };
  In pre[kPre];
  auto prefetch = [&](int s) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int b = (threadIdx.x + i * kThreads) / kJT;
      if (j_ok && b < min(B, kRowChunk)) pre[i] = load_in(s, b);
    }
  };
  prefetch(0);

  for (int s = 0; s <= T_len; ++s) {
    const bool last = s == T_len;
    const int t = reverse ? s : T_len - 1 - s;
    const T* dhw_in = dhw + (size_t)((s + 1) % 2) * B * Kc;
    T* dhw_out = dhw + (size_t)(s % 2) * B * Kc;
    // one unit of one row: its chain dots (chunk row rl) and its inputs
    auto item = [&](const Split& sp, int b, int rl, const In& v) {
      float chain = 0.0f;
      for (int ks = 0; ks < sp.ksplit; ++ks) chain += dots[(ks * sp.npad + rl) * CC + jj];
      const float dh = chain + v.rest;
      if (last) {
        dh0[(size_t)b * H + j] = from_f<T>(dh);
        return;
      }
      const size_t row = (size_t)t * B + b;
      const float r = sigmoidf_(v.xr + v.hr);
      const float z = sigmoidf_(v.xz + v.hz);
      const float n = tanhf(v.xn + r * v.hn);
      const bool m = t < v.len;
      const float g = m ? dh + v.go : 0.0f;
      const float dz = g * (v.hp - n) * z * (1.0f - z);
      const float dn = g * (1.0f - z) * (1.0f - n * n);
      const float dr = dn * v.hn * r * (1.0f - r);
      const float dnr_v = dn * r;
      T* dx = dxw + row * 3 * H;
      dx[j] = from_f<T>(dr);
      dx[H + j] = from_f<T>(dz);
      dx[2 * H + j] = from_f<T>(dn);
      dnr[row * H + j] = from_f<T>(dnr_v);
      T* dw = dhw_out + (size_t)b * Kc;
      dw[j] = from_f<T>(dr);
      dw[H + j] = from_f<T>(dz);
      dw[2 * H + j] = from_f<T>(dnr_v);
      rest[(size_t)b * H + j] = g * z + (m ? 0.0f : dh);
    };
    for (int r0 = 0; r0 < B; r0 += kRowChunk) {
      const int nrows = min(kRowChunk, B - r0);
      Split sp = {0, 0, 0, 0};
      if (s > 0) sp = dots_of<CC, kUnroll>(wc_s, ldw, dhw_in, Kc, Kc, r0, nrows, dots);
      __syncthreads();
      if (j_ok && r0 == 0) {
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int p = threadIdx.x + i * kThreads;
          if (p < nrows * kJT) item(sp, p / kJT, p / kJT, pre[i]);
        }
      } else if (j_ok) {
        for (int p = threadIdx.x; p < nrows * kJT; p += kThreads)
          item(sp, r0 + p / kJT, p / kJT, load_in(s, r0 + p / kJT));
      }
      __syncthreads();
    }
    if (!last) {
      prefetch(s + 1);
      grid_sync(count, (unsigned int)(s + 1) * gridDim.x);
    }
  }
}


template <typename T>
int launch_bwd(const void* xw, const void* hprev, const void* gout, const void* w_t,
               const void* chain_tiles, const void* b_hh, const void* lengths,
               void* hw, void* dhw, void* rest, void* dxw, void* dnr, void* dh0,
               void* count, int T_len, int B, int H, int Hk, int Kc, int reverse,
               cudaStream_t stream) {
  const int blocks = (H + kJT - 1) / kJT;
  const size_t smem = slice_smem<T>(CC, Kc);
  cudaError_t err = check_coresident(gru_bwd_persistent<T>, blocks, smem);
  if (err != cudaSuccess) return (int)err;
  err = launch_gemm<T>(static_cast<const T*>(hprev), static_cast<const T*>(w_t),
                       static_cast<const T*>(b_hh), static_cast<float*>(hw),
                       T_len * B, 3 * H, Hk, stream);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&xw, &hw, &hprev, &gout, &chain_tiles, &lengths, &dhw, &rest,
                  &dxw, &dnr, &dh0, &count, &T_len, &B, &H, &Hk, &Kc, &reverse};
  err = cudaLaunchCooperativeKernel((const void*)gru_bwd_persistent<T>, dim3(blocks),
                                    dim3(kThreads), args, smem, stream);
  return (int)err;
}

}  // namespace

// Runs the whole backward scan on `stream`, no sync: the gates GEMM into hw
// (T, B, 3H) fp32 scratch, then one cooperative launch of the chain.
// dtype: 0 = float32, 1 = bfloat16 (xw, hprev, gout, w_t, chain_tiles,
// b_hh, dhw, dxw, dnr and dh0 share it).  hprev is (T, B, Hk) zero padded
// for k >= H; w_t is W_hh^T, (3H, Hk) zero padded; dhw is (2, B, Kc) zero;
// rest is (B, H) fp32 holding g_hfin and is updated in place; count is one
// zeroed uint32.  jt must be kJT.  Returns 0 or the first cudaError_t met
// (cudaErrorCooperativeLaunchTooLarge when the grid cannot be co-resident).
extern "C" int gru_scan_bwd(const void* xw, const void* hprev, const void* gout,
                            const void* w_t, const void* chain_tiles, const void* b_hh,
                            const void* lengths, void* hw, void* dhw, void* rest,
                            void* dxw, void* dnr, void* dh0, void* count, int T_len,
                            int B, int H, int Hk, int Kc, int jt, int reverse,
                            int dtype, void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kJT || Hk % 64 != 0 || Hk < H || Kc % 64 != 0 || Kc < 3 * H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(xw, hprev, gout, w_t, chain_tiles, b_hh, lengths, hw, dhw,
                             rest, dxw, dnr, dh0, count, T_len, B, H, Hk, Kc, reverse, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(xw, hprev, gout, w_t, chain_tiles, b_hh, lengths,
                                     hw, dhw, rest, dxw, dnr, dh0, count, T_len, B, H,
                                     Hk, Kc, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// The gates GEMM alone, hw = hprev @ w_t^T + b_hh over M rows: for checking
// it against its plain version.
extern "C" int gru_bwd_gates(const void* hprev, const void* w_t, const void* b_hh,
                             void* hw, int M, int H, int Hk, int dtype, void* stream) {
  if (M <= 0) return 0;
  if (Hk % 64 != 0 || Hk < H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = launch_gemm<float>(static_cast<const float*>(hprev),
                             static_cast<const float*>(w_t),
                             static_cast<const float*>(b_hh), static_cast<float*>(hw),
                             M, 3 * H, Hk, s);
  else if (dtype == 1)
    err = launch_gemm<__nv_bfloat16>(static_cast<const __nv_bfloat16*>(hprev),
                                     static_cast<const __nv_bfloat16*>(w_t),
                                     static_cast<const __nv_bfloat16*>(b_hh),
                                     static_cast<float*>(hw), M, 3 * H, Hk, s);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}

// Dynamic shared memory of one chain block, for the wrapper's limit.
extern "C" int gru_scan_bwd_smem(int Kc, int dtype) {
  return (int)(dtype == 0 ? slice_smem<float>(CC, Kc)
                          : slice_smem<__nv_bfloat16>(CC, Kc));
}

// The most blocks that can be co-resident on this card at width Kc, or -1.
extern "C" int gru_scan_bwd_max_blocks(int Kc, int dtype) {
  int blocks = -1;
  const cudaError_t err =
      dtype == 0 ? max_coresident(gru_bwd_persistent<float>, slice_smem<float>(CC, Kc), &blocks)
                 : max_coresident(gru_bwd_persistent<__nv_bfloat16>,
                                  slice_smem<__nv_bfloat16>(CC, Kc), &blocks);
  return err == cudaSuccess ? blocks : -1;
}
