// Masked GRU recurrence, backward through time, written by hand for Hopper
// (sm_90a): one GEMM launch and one persistent launch per scan, or per pair
// of scans (both directions of a bidirectional layer).
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
//   * batches over 64 rows are walked in 64-row chunks inside a step;
//   * the paired scan (gru_bwd_pair): the two directions of a bidirectional
//     layer are independent chains of the same T, B and lengths, so one
//     cooperative launch runs both, each on its own half of the SMs: blocks
//     [0, n) walk the forward direction's backward (t = T-1 .. 0), blocks
//     [n, 2n) the reversed one's (t = 0 .. T-1), n = ceil(H / 16).  A block
//     owns 16 units (its 16 x 3H slice: 96 KB in bf16, 192 KB in fp32 at
//     H = 1024), and each direction has its own dhw ping-pong, rest carry
//     and barrier counter, so neither waits on the other.  Every SM still
//     takes in one dhw row a step, and a layer takes T serial steps instead
//     of 2 T.  A unit's dh sum runs over K in the order of the 8-unit block
//     (the warps' split of K depends on the rows alone, and each column of
//     the slice accumulates on its own), so the pair equals two single
//     launches bit for bit.  Its gates GEMM is one launch of both products
//     (gates_gemm.cuh, *_pair) just before the chain on the same stream.
//
// Co-residency limit: one block per SM, so H <= 8 * (the card's SMs), 1056
// on an H100 SXM (ops/rnn_kernels.py::gru_route reads the card before any
// launch); a pair needs 2 ceil(H / 16) blocks, so H <= 16 * (SMs / 2),
// also 1056 (ops/rnn_kernels.py::gru_pair_fits).  A larger H takes the
// per-step route at the end of this file (the first design: T + 1 launches
// per scan, both slices copied into shared memory every launch, CUDA-core
// FMAs), one direction at a time.
//
// What bounds it on this card: the step chain, not the operations.  At
// B = 1 a chain step takes ~5 us (L2 round trips, the gates, the grid
// barrier); at B = 64 ~16 us, most of it every SM taking in the whole
// 384 KB dhw row from L2 (~48 MB per step over 128 SMs).  The chain product
// is ~0.4 us of tensor-core time per step, ~0.8 us in a paired block, whose
// SM takes in the same one row a step: the pair's step should cost about a
// single one's, over half as many steps.  The gates GEMM (~1 ms at T = 512,
// B = 64, H = 1024) writes 403 MB of fp32 hw, ~0.12 ms of HBM time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "gates_gemm.cuh"
#include "rnn_persistent.cuh"
#include "step_stream.cuh"

namespace {

using namespace rnnp;

constexpr int CC = kJT;       // chain rows of a single scan's block
constexpr int kPairJT = 16;   // chain rows of a paired block (gru_bwd_pair)
constexpr int kUnroll = 8;    // K slabs of A in flight per warp (12 and 16 were no faster)

// ---------------------------------------------------------------------------
// the persistent chain
// ---------------------------------------------------------------------------

// The chain of one direction, walked by nblk blocks of C units each, this
// block being the blk-th.  Shapes: xw (T, B, 3H); hw (T, B, 3H) fp32; hprev
// (T, B, Hk); gout (T, B, H); chain_tiles (ceil(H/C), C, Kc) zero padded;
// dhw (2, B, Kc) of T, zero; rest (B, H) fp32 = g_hfin; dxw (T, B, 3H); dnr
// (T, B, H); dh0 (B, H); count a zeroed barrier counter of this direction's
// blocks alone.  A unit's dh sum is the same whatever C is: dots_of splits K
// among the warps by the rows of the chunk alone, and each column of the
// slice accumulates on its own.
template <typename T, int C>
__device__ __forceinline__ void chain_scan(
    const T* __restrict__ xw, const float* __restrict__ hw, const T* __restrict__ hprev,
    const T* __restrict__ gout, const T* __restrict__ chain_tiles,
    const int* __restrict__ lengths, T* dhw, float* rest, T* __restrict__ dxw,
    T* __restrict__ dnr, T* __restrict__ dh0, unsigned int* count, int T_len, int B,
    int H, int Hk, int Kc, int reverse, int blk, int nblk) {
  // Inputs of the first 64-row chunk a thread prefetches: its items
  // p = threadIdx.x + i kThreads all have the unit j0 + threadIdx.x % C.
  constexpr int kPre = kRowChunk * C / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wc_s = reinterpret_cast<T*>(smem_raw);
  const int ldw = slice_ld<T>(Kc);
  float* dots = reinterpret_cast<float*>(wc_s + (size_t)C * ldw);
  const int j0 = blk * C;
  load_slice(wc_s, chain_tiles + (size_t)blk * C * Kc, C, Kc);
  __syncthreads();

  // Step s < T_len closes the chain of step s-1 (dh for the block's units
  // from the dhw row of step s-1; zero at s = 0), then does step s; s ==
  // T_len closes the chain of the last step into dh0.  The inputs of the
  // first chunk are loaded for the next step before the grid barrier, so
  // their latency hides behind it.
  const int jj = threadIdx.x % C, j = j0 + jj;
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
      const int b = (threadIdx.x + i * kThreads) / C;
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
      for (int ks = 0; ks < sp.ksplit; ++ks) chain += dots[(ks * sp.npad + rl) * C + jj];
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
      if (s > 0) sp = dots_of<C, kUnroll>(wc_s, ldw, dhw_in, Kc, Kc, r0, nrows, dots);
      __syncthreads();
      if (j_ok && r0 == 0) {
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int p = threadIdx.x + i * kThreads;
          if (p < nrows * C) item(sp, p / C, p / C, pre[i]);
        }
      } else if (j_ok) {
        for (int p = threadIdx.x; p < nrows * C; p += kThreads)
          item(sp, r0 + p / C, p / C, load_in(s, r0 + p / C));
      }
      __syncthreads();
    }
    if (!last) {
      prefetch(s + 1);
      grid_sync(count, (unsigned int)(s + 1) * nblk);
    }
  }
}

// One direction: ceil(H / kJT) blocks, one per SM.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_persistent(const T* __restrict__ xw, const float* __restrict__ hw,
                   const T* __restrict__ hprev, const T* __restrict__ gout,
                   const T* __restrict__ chain_tiles, const int* __restrict__ lengths,
                   T* dhw, float* rest, T* __restrict__ dxw, T* __restrict__ dnr,
                   T* __restrict__ dh0, unsigned int* count, int T_len, int B, int H,
                   int Hk, int Kc, int reverse) {
  chain_scan<T, CC>(xw, hw, hprev, gout, chain_tiles, lengths, dhw, rest, dxw, dnr, dh0,
                    count, T_len, B, H, Hk, Kc, reverse, blockIdx.x, gridDim.x);
}

// The buffers of one direction's chain (chain_scan's arguments).
template <typename T>
struct Chain {
  const T* xw;
  const float* hw;
  const T* hprev;
  const T* gout;
  const T* tiles;
  T* dhw;
  float* rest;
  T* dxw;
  T* dnr;
  T* dh0;
  unsigned int* count;
};

// Both directions of a bidirectional layer: blocks [0, n) walk the forward
// direction's chain (t = T-1 .. 0), blocks [n, 2n) the reversed one's
// (t = 0 .. T-1), n = ceil(H / kPairJT) each.  Each direction barriers on
// its own counter, so neither waits on the other.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gru_bwd_pair(Chain<T> fwd, Chain<T> rev, const int* __restrict__ lengths, int T_len,
             int B, int H, int Hk, int Kc) {
  const int n = gridDim.x / 2;
  const int second = blockIdx.x >= n;
  const Chain<T> c = second ? rev : fwd;
  chain_scan<T, kPairJT>(c.xw, c.hw, c.hprev, c.gout, c.tiles, lengths, c.dhw, c.rest,
                         c.dxw, c.dnr, c.dh0, c.count, T_len, B, H, Hk, Kc, second,
                         blockIdx.x - second * n, n);
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

// p[d * kPairPtrs + i]: the i-th buffer of direction d (0 forward, 1
// reversed), in the order xw, hprev, gout, w_t, chain_tiles, b_hh, hw, dhw,
// rest, dxw, dnr, dh0.
constexpr int kPairPtrs = 12;

template <typename T>
int launch_pair(void* const* p, const void* lengths, unsigned int* count, int T_len, int B,
                int H, int Hk, int Kc, cudaStream_t stream) {
  const int blocks = 2 * ((H + kPairJT - 1) / kPairJT);
  const size_t smem = slice_smem<T>(kPairJT, Kc);
  cudaError_t err = check_coresident(gru_bwd_pair<T>, blocks, smem);
  if (err != cudaSuccess) return (int)err;
  GemmArgs<T> gemm[2];
  Chain<T> chain[2];
  for (int d = 0; d < 2; ++d) {
    void* const* q = p + d * kPairPtrs;
    gemm[d] = {static_cast<const T*>(q[1]), static_cast<const T*>(q[3]),
               static_cast<const T*>(q[5]), static_cast<float*>(q[6])};
    chain[d] = {static_cast<const T*>(q[0]), static_cast<const float*>(q[6]),
                static_cast<const T*>(q[1]), static_cast<const T*>(q[2]),
                static_cast<const T*>(q[4]), static_cast<T*>(q[7]),
                static_cast<float*>(q[8]), static_cast<T*>(q[9]),
                static_cast<T*>(q[10]), static_cast<T*>(q[11]), count + d};
  }
  err = launch_gemm_pair<T>(gemm[0], gemm[1], T_len * B, 3 * H, Hk, stream);
  if (err != cudaSuccess) return (int)err;
  const int* lens = static_cast<const int*>(lengths);
  void* args[] = {&chain[0], &chain[1], &lens, &T_len, &B, &H, &Hk, &Kc};
  err = cudaLaunchCooperativeKernel((const void*)gru_bwd_pair<T>, dim3(blocks),
                                    dim3(kThreads), args, smem, stream);
  return (int)err;
}

}  // namespace

// ---------------------------------------------------------------------------
// The per-step route, for H above the persistent grid's limit: one launch per
// step, back to back on the caller's stream; the launch boundary is the
// grid-wide barrier the dh chain needs.  Launch s finishes the chain of the
// step before it (dh for its hidden units j from the dhw row that launch s-1
// wrote) and then does step s, rebuilding the gates from h_prev itself; one
// closing launch finishes the chain of the last step into dh0, so a scan of
// T steps takes T + 1 launches.  Each block owns kJT units and copies its
// chain slice (kJT rows of W_hh) and its gate slice (3 kJT columns) into
// shared memory every launch; the fp32 dhw row and the j-local rest of the
// carry (g z + (m ? 0 : dh)) ping-pong between two buffers.
// ---------------------------------------------------------------------------

namespace per_step {

using namespace rnnp;

constexpr int kRows = 4;  // rows of the activation each lane carries

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

// Dynamic shared memory of one block: the chain slice (kJT rows of Kc), the
// gate slice (3 kJT rows of Hk) and the two 64-row dot buffers.  It must fit
// the card's opt-in limit, which bounds H (ops/rnn_kernels.py::
// gru_step_max_hidden).
template <typename T> constexpr size_t step_smem(int Hk, int Kc) {
  return sizeof(T) * ((size_t)kJT * Kc + (size_t)3 * kJT * Hk)
         + sizeof(float) * kRowChunk * 4 * kJT;
}

// A block that streams both slices (kStream) holds the chunk ring of the
// wider one and the two dot buffers, whatever H is.
template <typename T> constexpr size_t stream_smem() {
  return step_stream::ring_bytes<T>(3 * kJT) + sizeof(float) * kRowChunk * 4 * kJT;
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

// One launch.  Shapes: xw_t (B, 3H); hprev_t (B, Hk) zero padded for
// k >= H; gout_t (B, H); rec_tiles (ceil(H/kJT), 3 kJT, Hk) and chain_tiles
// (ceil(H/kJT), kJT, Kc), both zero padded; b_hh (3H); dhw_in / dhw_out
// (B, Kc) fp32, zero for k >= 3H; rest_in / rest_out (B, H) fp32; dxw_t
// (B, 3H); dnr_t (B, H).  final != 0: only close the chain into dh0 (B, H).
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
gru_bwd_step(const T* __restrict__ xw_t, const T* __restrict__ hprev_t,
             const T* __restrict__ gout_t, const T* __restrict__ rec_tiles,
             const T* __restrict__ chain_tiles, const T* __restrict__ b_hh,
             const int* __restrict__ lengths, const float* __restrict__ dhw_in,
             float* __restrict__ dhw_out, const float* __restrict__ rest_in,
             float* __restrict__ rest_out, T* __restrict__ dxw_t,
             T* __restrict__ dnr_t, T* __restrict__ dh0, int t, int B, int H,
             int Hk, int Kc, int final) {
  constexpr int CR = 3 * kJT;  // gate columns of the block
  constexpr int CC = kJT;      // chain rows of the block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* wc_s = reinterpret_cast<T*>(smem_raw);          // (CC, Kc), or the chunk ring
  T* wr_s = wc_s + (size_t)CC * Kc;                  // (CR, Hk)
  float* dots_c = reinterpret_cast<float*>(
      kStream ? smem_raw + step_stream::ring_bytes<T>(CR)
              : reinterpret_cast<unsigned char*>(wr_s + (size_t)CR * Hk));
  float* dots_r = dots_c + kRowChunk * CC;

  const int j0 = blockIdx.x * kJT;
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
          wc_s, chain_tiles + (size_t)blockIdx.x * CC * Kc, Kc, dhw_in, Kc, Kc, r0,
          nrows, s, dots_c);
      if (!final)
        step_stream::streamed_dots<T, T, CR, kRows>(
            wc_s, rec_tiles + (size_t)blockIdx.x * CR * Hk, Hk, hprev_t, Hk, Hk, r0,
            nrows, s, dots_r);
    } else {
      chunk_dots<T, float, CC>(wc_s, dhw_in, Kc, Kc, r0, nrows, s, dots_c);
      if (!final)
        chunk_dots<T, T, CR>(wr_s, hprev_t, Hk, Hk, r0, nrows, s, dots_r);
    }
    __syncthreads();

    for (int p = threadIdx.x; p < nrows * kJT; p += kThreads) {
      const int rl = p / kJT;
      const int jj = p % kJT;
      const int j = j0 + jj;
      if (j >= H) continue;
      const int b = r0 + rl;
      float chain = 0.0f;
      for (int ks = 0; ks < s.ksplit; ++ks) chain += dots_c[(ks * s.npad + rl) * CC + jj];
      const float dh = chain + rest_in[(size_t)b * H + j];
      if (final) {
        dh0[(size_t)b * H + j] = from_f<T>(dh);
        continue;
      }
      float hr = 0.0f, hz = 0.0f, hn = 0.0f;
      for (int ks = 0; ks < s.ksplit; ++ks) {
        const float* d = dots_r + (ks * s.npad + rl) * CR;
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
      const float hp = to_f(hprev_t[(size_t)b * Hk + j]);
      const bool m = t < lengths[b];
      const float g = m ? dh + to_f(gout_t[(size_t)b * H + j]) : 0.0f;
      const float dz = g * (hp - n) * z * (1.0f - z);
      const float dn = g * (1.0f - z) * (1.0f - n * n);
      const float dr = dn * hn * r * (1.0f - r);
      const float dnr = dn * r;
      T* dx = dxw_t + (size_t)b * 3 * H;
      dx[j] = from_f<T>(dr);
      dx[H + j] = from_f<T>(dz);
      dx[2 * H + j] = from_f<T>(dn);
      dnr_t[(size_t)b * H + j] = from_f<T>(dnr);
      float* dw = dhw_out + (size_t)b * Kc;
      dw[j] = dr;
      dw[H + j] = dz;
      dw[2 * H + j] = dnr;
      rest_out[(size_t)b * H + j] = g * z + (m ? 0.0f : dh);
    }
    __syncthreads();
  }
}

template <typename T, bool kStream>
int launch_steps(const void* xw, const void* hprev, const void* gout,
                 const void* rec_tiles, const void* chain_tiles, const void* b_hh,
                 const void* lengths, void* dhw_a, void* dhw_b, void* rest_a,
                 void* rest_b, void* dxw, void* dnr, void* dh0, int T_len, int B,
                 int H, int Hk, int Kc, int reverse, cudaStream_t stream) {
  const size_t smem = kStream ? stream_smem<T>() : step_smem<T>(Hk, Kc);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_step<T, kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kJT - 1) / kJT);
  const T* xw_p = static_cast<const T*>(xw);
  const T* hp_p = static_cast<const T*>(hprev);
  const T* go_p = static_cast<const T*>(gout);
  T* dxw_p = static_cast<T*>(dxw);
  T* dnr_p = static_cast<T*>(dnr);
  float* dhw[2] = {static_cast<float*>(dhw_a), static_cast<float*>(dhw_b)};
  float* rest[2] = {static_cast<float*>(rest_a), static_cast<float*>(rest_b)};
  for (int s = 0; s <= T_len; ++s) {
    const int final = s == T_len;
    const int t = final ? 0 : (reverse ? s : T_len - 1 - s);
    gru_bwd_step<T, kStream><<<grid, kThreads, smem, stream>>>(
        xw_p + (size_t)t * B * 3 * H, hp_p + (size_t)t * B * Hk,
        go_p + (size_t)t * B * H, static_cast<const T*>(rec_tiles),
        static_cast<const T*>(chain_tiles), static_cast<const T*>(b_hh),
        static_cast<const int*>(lengths), dhw[s % 2], dhw[(s + 1) % 2],
        rest[s % 2], rest[(s + 1) % 2], dxw_p + (size_t)t * B * 3 * H,
        dnr_p + (size_t)t * B * H, static_cast<T*>(dh0), t, B, H, Hk, Kc,
        final);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace per_step

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

// Both directions of a bidirectional layer's backward scan in two launches
// on `stream`, no sync: the gates GEMM of both into their hw, then one
// cooperative launch of both chains, ceil(H / 16) blocks each (gru_bwd_pair).
// p holds 2 x 12 buffers, direction-major (forward, then reversed), each as
// gru_scan_bwd takes them: xw, hprev, gout, w_t, chain_tiles (16 rows a
// block), b_hh, hw, dhw, rest, dxw, dnr, dh0.  lengths are shared; count is
// two zeroed uint32, one per direction.  jt must be 16.  Returns 0 or the
// first cudaError_t met.
extern "C" int gru_scan_bwd_pair(void* const* p, const void* lengths, void* count, int T_len,
                                 int B, int H, int Hk, int Kc, int jt, int dtype,
                                 void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kPairJT || Hk % 64 != 0 || Hk < H || Kc % 64 != 0 || Kc < 3 * H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned int* c = static_cast<unsigned int*>(count);
  if (dtype == 0) return launch_pair<float>(p, lengths, c, T_len, B, H, Hk, Kc, s);
  if (dtype == 1) return launch_pair<__nv_bfloat16>(p, lengths, c, T_len, B, H, Hk, Kc, s);
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

// Dynamic shared memory of one paired block, for the wrapper's limit.
extern "C" int gru_scan_bwd_pair_smem(int Kc, int dtype) {
  return (int)(dtype == 0 ? slice_smem<float>(kPairJT, Kc)
                          : slice_smem<__nv_bfloat16>(kPairJT, Kc));
}

// The most paired blocks that can be co-resident on this card at width Kc,
// or -1.
extern "C" int gru_scan_bwd_pair_max_blocks(int Kc, int dtype) {
  int blocks = -1;
  const cudaError_t err =
      dtype == 0 ? max_coresident(gru_bwd_pair<float>, slice_smem<float>(kPairJT, Kc), &blocks)
                 : max_coresident(gru_bwd_pair<__nv_bfloat16>,
                                  slice_smem<__nv_bfloat16>(kPairJT, Kc), &blocks);
  return err == cudaSuccess ? blocks : -1;
}

// The per-step route: T + 1 launches of gru_bwd_step on `stream`, no sync.
// dtype as above (xw, hprev, gout, both tile sets, b_hh, dxw, dnr and dh0
// share it).  hprev is (T, B, Hk) zero padded for k >= H; rec_tiles is W_hh
// tiled as for the forward scan, chain_tiles its rows as for the persistent
// chain (jt = kJT units per block).  dhw_a must be zero (B, Kc) fp32 and
// rest_a must hold g_hfin as (B, H) fp32; dhw_b (zero) and rest_b are
// scratch of the same shapes.  Returns 0 or the first cudaError_t met.
template <bool kStream>
static int bwd_steps(const void* xw, const void* hprev, const void* gout,
                     const void* rec_tiles, const void* chain_tiles, const void* b_hh,
                     const void* lengths, void* dhw_a, void* dhw_b, void* rest_a,
                     void* rest_b, void* dxw, void* dnr, void* dh0, int T_len, int B,
                     int H, int Hk, int Kc, int jt, int reverse, int dtype,
                     void* stream) {
  using namespace per_step;
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kJT || Hk % 64 != 0 || Hk < H || Kc % 64 != 0 || Kc < 3 * H)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_steps<float, kStream>(xw, hprev, gout, rec_tiles, chain_tiles, b_hh,
                                        lengths, dhw_a, dhw_b, rest_a, rest_b, dxw, dnr,
                                        dh0, T_len, B, H, Hk, Kc, reverse, s);
  if (dtype == 1)
    return launch_steps<__nv_bfloat16, kStream>(xw, hprev, gout, rec_tiles, chain_tiles,
                                                b_hh, lengths, dhw_a, dhw_b, rest_a,
                                                rest_b, dxw, dnr, dh0, T_len, B, H, Hk,
                                                Kc, reverse, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gru_scan_bwd_step(const void* xw, const void* hprev, const void* gout,
                                 const void* rec_tiles, const void* chain_tiles,
                                 const void* b_hh, const void* lengths, void* dhw_a,
                                 void* dhw_b, void* rest_a, void* rest_b, void* dxw,
                                 void* dnr, void* dh0, int T_len, int B, int H, int Hk,
                                 int Kc, int jt, int reverse, int dtype, void* stream) {
  return bwd_steps<false>(xw, hprev, gout, rec_tiles, chain_tiles, b_hh, lengths, dhw_a,
                          dhw_b, rest_a, rest_b, dxw, dnr, dh0, T_len, B, H, Hk, Kc, jt,
                          reverse, dtype, stream);
}

// The same launches with both slices streamed through shared memory in K
// chunks (step_stream.cuh): any H, for H above the whole-slice block's limit.
extern "C" int gru_scan_bwd_step_chunked(const void* xw, const void* hprev,
                                         const void* gout, const void* rec_tiles,
                                         const void* chain_tiles, const void* b_hh,
                                         const void* lengths, void* dhw_a, void* dhw_b,
                                         void* rest_a, void* rest_b, void* dxw,
                                         void* dnr, void* dh0, int T_len, int B, int H,
                                         int Hk, int Kc, int jt, int reverse, int dtype,
                                         void* stream) {
  return bwd_steps<true>(xw, hprev, gout, rec_tiles, chain_tiles, b_hh, lengths, dhw_a,
                         dhw_b, rest_a, rest_b, dxw, dnr, dh0, T_len, B, H, Hk, Kc, jt,
                         reverse, dtype, stream);
}

// Dynamic shared memory of one per-step block, for the wrapper's limit.
extern "C" int gru_scan_bwd_step_smem(int Hk, int Kc, int dtype) {
  return (int)(dtype == 0 ? per_step::step_smem<float>(Hk, Kc)
                          : per_step::step_smem<__nv_bfloat16>(Hk, Kc));
}

// Dynamic shared memory of one streamed per-step block (any H).
extern "C" int gru_scan_bwd_step_chunked_smem(int dtype) {
  return (int)(dtype == 0 ? per_step::stream_smem<float>()
                          : per_step::stream_smem<__nv_bfloat16>());
}
