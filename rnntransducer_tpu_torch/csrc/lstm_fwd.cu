// Masked LSTM recurrence (forward), written by hand for Hopper (sm_90a): one
// persistent launch per scan.
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
// Design (persistent, as the GRU forward kernel gru_fwd.cu):
//   * one cooperative launch of ceil(H / JT) blocks, one per SM, for the
//     whole scan; each block owns JT hidden units j (8, or 4 for small H)
//     and keeps its W_hh slice, the i, f, g and o columns of its units
//     (4 JT rows of Hk: 66 KB in bf16 at H = 1024 with JT = 8, 128 KB in
//     fp32), in shared memory from the first step to the last, as the TPU
//     kernel keeps W_hh resident (rnn_pallas.py:121-158);
//   * a grid-wide barrier per step (rnn_persistent.cuh::grid_sync) takes the
//     place of the launch boundary.  The launch is cooperative: a grid that
//     cannot be co-resident is refused with an error, never run;
//   * the broadcast row is h rounded to W's type, (B, Hk), written once by
//     its owner block and read by every block from L2 with 16-byte
//     ld.global.cg straight into the MMA fragments; it ping-pongs between
//     two buffers, so one barrier per step is enough.  A masked step
//     broadcasts its fp32 h carry rounded, never a rounded value read back;
//   * the h and c carries are fp32, local to the block's units, each in a
//     buffer only that block touches, updated in place;
//   * bf16: the (B, Hk) x (Hk, 4 JT) product of a step runs on the tensor
//     cores (mma.sync m16n8k16, fp32 accumulation); fp32 keeps CUDA-core
//     FMAs;
//   * the gates' inputs (xw, the carries, lengths) of the next step are
//     loaded into registers before the grid barrier, so their latency hides
//     behind it;
//   * batches over 64 rows are walked in 64-row chunks inside a step.
//
// Co-residency limit: one block per SM, so H <= 8 * (the card's SMs), 1056
// on an H100 SXM (ops/rnn_kernels.py::lstm_route reads the card before any
// launch).  A
// larger H takes the per-step route below (the first design: one launch per
// step, the block's slice copied into shared memory every launch, CUDA-core
// FMAs), which takes H up to ~3500 in bf16 and ~1750 in fp32.
//
// What bounds it on this card: the step chain, not the operations, as for
// the GRU forward kernel: per step an L2 round trip for the row, the gates
// and the grid barrier, then every SM taking in the whole row from L2
// (128 KB at B = 64, H = 1024 in bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rnn_persistent.cuh"
#include "step_stream.cuh"

namespace {

using namespace rnnp;

constexpr int kUnroll = 4;   // K slabs of A in flight per warp, as in gru_fwd.cu

// Shapes: xw (T, B, 4H); w_tiles (ceil(H/JT), 4 JT, Hk) zero padded for
// k >= H and j >= H; b_hh (4H); hb (2, B, Hk) of T, hb[0] = h0 rounded, zero
// for k >= H; hc and cc (B, H) fp32 = h0 and c0; h_all and c_all (T, B, H);
// h_fin and c_fin (B, H); count a zeroed barrier counter.
template <typename T, int JT>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent(const T* __restrict__ xw, const T* __restrict__ w_tiles,
                    const T* __restrict__ b_hh, T* hb, float* hc, float* cc,
                    T* __restrict__ h_all, T* __restrict__ c_all,
                    T* __restrict__ h_fin, T* __restrict__ c_fin,
                    const int* __restrict__ lengths, unsigned int* count, int T_len,
                    int B, int H, int Hk, int reverse) {
  constexpr int C = 4 * JT;  // gate columns of the block
  // Gate inputs of the first 64-row chunk a thread prefetches: its items
  // p = threadIdx.x + i kThreads all have the unit j0 + threadIdx.x % JT.
  constexpr int kPre = kRowChunk * JT / kThreads;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  const int ldw = slice_ld<T>(Hk);
  float* dots = reinterpret_cast<float*>(w_s + (size_t)C * ldw);
  load_slice(w_s, w_tiles + (size_t)blockIdx.x * C * Hk, C, Hk);
  __syncthreads();

  const int jj = threadIdx.x % JT, j = blockIdx.x * JT + jj;
  const bool j_ok = j < H;
  float bias[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) bias[q] = j_ok ? to_f(b_hh[q * H + j]) : 0.0f;
  struct In {
    float x[4], h, c;
    int len;
  };
  auto load_in = [&](int t, int b) {
    In v;
    const T* x = xw + ((size_t)t * B + b) * 4 * H;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.x[q] = to_f(x[q * H + j]);
    v.h = hc[(size_t)b * H + j];
    v.c = cc[(size_t)b * H + j];
    v.len = lengths[b];
    return v;
  };
  In pre[kPre];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int b = (threadIdx.x + i * kThreads) / JT;
      if (j_ok && b < min(B, kRowChunk)) pre[i] = load_in(t, b);
    }
  };
  prefetch(reverse ? T_len - 1 : 0);

  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    const T* h_in = hb + (size_t)(s % 2) * B * Hk;
    T* h_out = hb + (size_t)((s + 1) % 2) * B * Hk;
    // one unit of one row: its dots (chunk row rl) and its inputs
    auto gate = [&](const Split& sp, int b, int rl, const In& v) {
      float g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float hw = 0.0f;
        for (int ks = 0; ks < sp.ksplit; ++ks) hw += dots[(ks * sp.npad + rl) * C + q * JT + jj];
        g[q] = v.x[q] + (hw + bias[q]);
      }
      const float ig = sigmoidf_(g[0]);
      const float fg = sigmoidf_(g[1]);
      const float gg = tanhf(g[2]);
      const float og = sigmoidf_(g[3]);
      const float c_new = fg * v.c + ig * gg;
      const float h_new = og * tanhf(c_new);
      const bool m = t < v.len;
      const float h_carry = m ? h_new : v.h;
      const float c_carry = m ? c_new : v.c;
      const size_t bj = (size_t)b * H + j;
      hc[bj] = h_carry;
      cc[bj] = c_carry;
      h_out[(size_t)b * Hk + j] = from_f<T>(h_carry);
      h_all[(size_t)t * B * H + bj] = from_f<T>(m ? h_new : 0.0f);
      c_all[(size_t)t * B * H + bj] = from_f<T>(c_carry);
      if (s == T_len - 1) {
        h_fin[bj] = from_f<T>(h_carry);
        c_fin[bj] = from_f<T>(c_carry);
      }
    };
    for (int r0 = 0; r0 < B; r0 += kRowChunk) {
      const int nrows = min(kRowChunk, B - r0);
      const Split sp = dots_of<C, kUnroll>(w_s, ldw, h_in, Hk, Hk, r0, nrows, dots);
      __syncthreads();
      if (j_ok && r0 == 0) {
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int p = threadIdx.x + i * kThreads;
          if (p < nrows * JT) gate(sp, p / JT, p / JT, pre[i]);
        }
      } else if (j_ok) {
        for (int p = threadIdx.x; p < nrows * JT; p += kThreads)
          gate(sp, r0 + p / JT, p / JT, load_in(t, r0 + p / JT));
      }
      __syncthreads();
    }
    if (s + 1 < T_len) {
      prefetch(reverse ? t - 1 : t + 1);
      grid_sync(count, (unsigned int)(s + 1) * gridDim.x);
    }
  }
}

template <typename T, int JT>
int launch_width(const void* xw, const void* w_tiles, const void* b_hh, void* hb,
                 void* hc, void* cc, void* h_all, void* c_all, void* h_fin,
                 void* c_fin, const void* lengths, void* count, int T_len, int B,
                 int H, int Hk, int reverse, cudaStream_t stream) {
  const int blocks = (H + JT - 1) / JT;
  const size_t smem = slice_smem<T>(4 * JT, Hk);
  cudaError_t err = check_coresident(lstm_fwd_persistent<T, JT>, blocks, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&xw, &w_tiles, &b_hh, &hb, &hc, &cc, &h_all, &c_all, &h_fin,
                  &c_fin, &lengths, &count, &T_len, &B, &H, &Hk, &reverse};
  err = cudaLaunchCooperativeKernel((const void*)lstm_fwd_persistent<T, JT>,
                                    dim3(blocks), dim3(kThreads), args, smem, stream);
  return (int)err;
}

template <typename T>
int launch_persistent(int jt, const void* xw, const void* w_tiles, const void* b_hh,
                      void* hb, void* hc, void* cc, void* h_all, void* c_all,
                      void* h_fin, void* c_fin, const void* lengths, void* count,
                      int T_len, int B, int H, int Hk, int reverse, cudaStream_t s) {
  if (jt == 8)
    return launch_width<T, 8>(xw, w_tiles, b_hh, hb, hc, cc, h_all, c_all, h_fin, c_fin,
                              lengths, count, T_len, B, H, Hk, reverse, s);
  if (jt == 4)
    return launch_width<T, 4>(xw, w_tiles, b_hh, hb, hc, cc, h_all, c_all, h_fin, c_fin,
                              lengths, count, T_len, B, H, Hk, reverse, s);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
size_t persistent_smem(int jt, int Hk) {
  return slice_smem<T>(4 * jt, Hk);
}

template <typename T>
int persistent_max_blocks(int jt, int Hk) {
  int blocks = -1;
  const cudaError_t err =
      jt == 8 ? max_coresident(lstm_fwd_persistent<T, 8>, persistent_smem<T>(8, Hk), &blocks)
              : max_coresident(lstm_fwd_persistent<T, 4>, persistent_smem<T>(4, Hk), &blocks);
  return err == cudaSuccess ? blocks : -1;
}

}  // namespace

// ---------------------------------------------------------------------------
// The per-step route, for H above the persistent grid's limit: one launch per
// step, back to back on the caller's stream, two fp32 h buffers ping-pong;
// each block owns kStepJT units and copies its (4 kStepJT, Hk) slice of W_hh
// into shared memory every launch; warps split rows into groups of kRows
// (one shared-memory read of W feeds kRows FMAs) and, when B is small, split
// K too; lanes stride over K in pairs and finish with a shuffle reduction.
// ---------------------------------------------------------------------------

namespace per_step {

using namespace rnnp;

constexpr int kRows = 4;     // rows of h each lane carries in registers
// Hidden units per block: the slice plus the dot buffer fit the 227 KB up
// to H ~ 3500 in bf16 and ~ 1750 in fp32.  A larger H fails
// cudaFuncSetAttribute and the call returns that error.
constexpr int kStepJT = 4;

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

// One timestep.  Shapes: xw_t (B, 4H); w_tiles (ceil(H/kStepJT),
// 4 kStepJT, Hk) with zero padding for k >= H and j >= H; b_hh (4H); h_prev / h_next (B, Hk)
// fp32 with zero padding for k >= H; c_state (B, H) fp32; hall_t and call_t
// (B, H); h_fin and c_fin (B, H) or null.  kStream: the slice is streamed
// through shared memory in K chunks (step_stream.cuh) instead of copied
// whole.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
lstm_fwd_step(const T* __restrict__ xw_t, const T* __restrict__ w_tiles,
              const T* __restrict__ b_hh, const float* __restrict__ h_prev,
              float* __restrict__ h_next, float* __restrict__ c_state,
              T* __restrict__ hall_t, T* __restrict__ call_t,
              T* __restrict__ h_fin, T* __restrict__ c_fin,
              const int* __restrict__ lengths, int t, int B, int H, int Hk) {
  constexpr int C = 4 * kStepJT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // (C, Hk), or the chunk ring
  float* dots = reinterpret_cast<float*>(
      smem_raw + (kStream ? step_stream::ring_bytes<T>(C) : sizeof(T) * C * (size_t)Hk));

  const int j0 = blockIdx.x * kStepJT;
  if constexpr (!kStream) {
    const int4* src = reinterpret_cast<const int4*>(
        w_tiles + (size_t)blockIdx.x * C * Hk);
    int4* dst = reinterpret_cast<int4*>(w_s);
    const int n16 = (int)(sizeof(T) * C * (size_t)Hk / 16);
    for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = __ldg(src + i);
    __syncthreads();
  }

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

    if constexpr (kStream)
      step_stream::streamed_dots<T, float, C, kRows>(
          w_s, w_tiles + (size_t)blockIdx.x * C * Hk, Hk, h_prev, Hk, Hk, r0, nrows,
          split_rows(nrows, kRows), dots);
    else
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

    for (int p = threadIdx.x; p < nrows * kStepJT; p += kThreads) {
      const int rl = p / kStepJT;
      const int jj = p % kStepJT;
      const int j = j0 + jj;
      if (j >= H) continue;
      const int b = r0 + rl;
      float hw[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      for (int ks = 0; ks < ksplit; ++ks) {
        const float* d = dots + (ks * npad + rl) * C;
#pragma unroll
        for (int q = 0; q < 4; ++q) hw[q] += d[q * kStepJT + jj];
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

// Dynamic shared memory of one per-step block: its whole slice, or the two
// chunk buffers when it streams the slice; plus the dot buffer.
template <typename T, bool kStream> constexpr size_t step_smem(int Hk) {
  return (kStream ? step_stream::ring_bytes<T>(4 * kStepJT)
                  : sizeof(T) * 4 * kStepJT * (size_t)Hk)
         + sizeof(float) * kRowChunk * 4 * kStepJT;
}

template <typename T, bool kStream>
int launch_steps(const void* xw, const void* w_tiles, const void* b_hh,
                 void* h_a, void* h_b, void* c_state, void* h_all, void* c_all,
                 void* h_fin, void* c_fin, const void* lengths, int T_len, int B,
                 int H, int Hk, int reverse, cudaStream_t stream) {
  const size_t smem = step_smem<T, kStream>(Hk);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_step<T, kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kStepJT - 1) / kStepJT);
  const T* xw_p = static_cast<const T*>(xw);
  T* hall_p = static_cast<T*>(h_all);
  T* call_p = static_cast<T*>(c_all);
  float* hp = static_cast<float*>(h_a);
  float* hn = static_cast<float*>(h_b);
  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    const bool last = s == T_len - 1;
    lstm_fwd_step<T, kStream><<<grid, kThreads, smem, stream>>>(
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

}  // namespace per_step

// Runs the whole scan: one cooperative launch on `stream`, no sync.
// w_tiles is W_hh tiled for jt hidden units per block (8, or 4).  dtype: 0 =
// float32, 1 = bfloat16 (xw, w_tiles, b_hh, hb, h_all, c_all, h_fin and
// c_fin share it).  hb is (2, B, Hk) with hb[0] = h0 in that dtype and zero
// padding for k >= H in both halves; hc and cc are (B, H) fp32 holding h0
// and c0, updated in place; count is one zeroed uint32.  Returns 0 or the
// first cudaError_t met (cudaErrorCooperativeLaunchTooLarge when the grid
// cannot be co-resident).
extern "C" int lstm_scan_fwd(const void* xw, const void* w_tiles, const void* b_hh,
                             void* hb, void* hc, void* cc, void* h_all, void* c_all,
                             void* h_fin, void* c_fin, const void* lengths, void* count,
                             int T_len, int B, int H, int Hk, int jt, int reverse,
                             int dtype, void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if (Hk % 64 != 0 || Hk < H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_persistent<float>(jt, xw, w_tiles, b_hh, hb, hc, cc, h_all, c_all,
                                    h_fin, c_fin, lengths, count, T_len, B, H, Hk,
                                    reverse, s);
  if (dtype == 1)
    return launch_persistent<__nv_bfloat16>(jt, xw, w_tiles, b_hh, hb, hc, cc, h_all,
                                            c_all, h_fin, c_fin, lengths, count, T_len,
                                            B, H, Hk, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one persistent block, for the wrapper's limit.
extern "C" int lstm_scan_fwd_smem(int Hk, int jt, int dtype) {
  return (int)(dtype == 0 ? persistent_smem<float>(jt, Hk)
                          : persistent_smem<__nv_bfloat16>(jt, Hk));
}

// The most persistent blocks that can be co-resident on this card, or -1.
extern "C" int lstm_scan_fwd_max_blocks(int Hk, int jt, int dtype) {
  if (jt != 4 && jt != 8) return -1;
  return dtype == 0 ? persistent_max_blocks<float>(jt, Hk)
                    : persistent_max_blocks<__nv_bfloat16>(jt, Hk);
}

// The per-step route: T launches of lstm_fwd_step on `stream`, no sync.
// w_tiles is W_hh tiled for jt hidden units per block, which must be
// kStepJT.  dtype as above.  h_a holds h0 (fp32, (B, Hk), zero padded); h_b
// is scratch of the same shape; c_state holds c0 (fp32, (B, H)) and is
// updated in place.  Returns 0 or the first cudaError_t met.
template <bool kStream>
static int fwd_steps(const void* xw, const void* w_tiles, const void* b_hh, void* h_a,
                     void* h_b, void* c_state, void* h_all, void* c_all, void* h_fin,
                     void* c_fin, const void* lengths, int T_len, int B, int H, int Hk,
                     int jt, int reverse, int dtype, void* stream) {
  using namespace per_step;
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kStepJT || Hk % 64 != 0 || Hk < H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_steps<float, kStream>(xw, w_tiles, b_hh, h_a, h_b, c_state, h_all,
                                        c_all, h_fin, c_fin, lengths, T_len, B, H, Hk,
                                        reverse, s);
  if (dtype == 1)
    return launch_steps<__nv_bfloat16, kStream>(xw, w_tiles, b_hh, h_a, h_b, c_state,
                                                h_all, c_all, h_fin, c_fin, lengths,
                                                T_len, B, H, Hk, reverse, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int lstm_scan_fwd_step(const void* xw, const void* w_tiles,
                                  const void* b_hh, void* h_a, void* h_b,
                                  void* c_state, void* h_all, void* c_all,
                                  void* h_fin, void* c_fin, const void* lengths,
                                  int T_len, int B, int H, int Hk, int jt,
                                  int reverse, int dtype, void* stream) {
  return fwd_steps<false>(xw, w_tiles, b_hh, h_a, h_b, c_state, h_all, c_all, h_fin,
                          c_fin, lengths, T_len, B, H, Hk, jt, reverse, dtype, stream);
}

// The same launches with the slice streamed through shared memory in K
// chunks (step_stream.cuh): any H, for H above the whole-slice block's limit.
extern "C" int lstm_scan_fwd_step_chunked(const void* xw, const void* w_tiles,
                                          const void* b_hh, void* h_a, void* h_b,
                                          void* c_state, void* h_all, void* c_all,
                                          void* h_fin, void* c_fin, const void* lengths,
                                          int T_len, int B, int H, int Hk, int jt,
                                          int reverse, int dtype, void* stream) {
  return fwd_steps<true>(xw, w_tiles, b_hh, h_a, h_b, c_state, h_all, c_all, h_fin,
                         c_fin, lengths, T_len, B, H, Hk, jt, reverse, dtype, stream);
}

// Dynamic shared memory of one streamed per-step block (any H).
extern "C" int lstm_scan_fwd_step_chunked_smem(int dtype) {
  using namespace per_step;
  return (int)(dtype == 0 ? step_smem<float, true>(0) : step_smem<__nv_bfloat16, true>(0));
}
