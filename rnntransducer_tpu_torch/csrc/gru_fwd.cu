// Masked GRU recurrence (forward), written by hand for Hopper (sm_90a): one
// persistent launch per scan.
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
// Design (persistent):
//   * one cooperative launch of ceil(H / 8) blocks, one per SM, for the
//     whole scan; each block owns 8 hidden units j and keeps its W_hh slice
//     (their r, z, n columns: 24 rows of Hk, 48 KB in bf16 at H = 1024,
//     96 KB in fp32) in shared memory from the first step to the last;
//   * a grid-wide barrier per step (rnn_persistent.cuh::grid_sync) takes the
//     place of the launch boundary.  The launch is cooperative: a grid that
//     cannot be co-resident is refused with an error, never run;
//   * the broadcast row is h rounded to W's type (bf16 h, 128 KB at B = 64),
//     written once by its owner block and read by every block from L2 with
//     16-byte ld.global.cg straight into the MMA fragments, 4 slabs of K in
//     flight per warp; it ping-pongs between two buffers, so one barrier
//     per step is enough.  (Streaming it through a shared-memory ring with
//     bulk copies, multicast to a cluster of 2, was measured slower: the
//     ring's per-tile waits cost more latency than the L2 reads it saved.)
//     The fp32 carry is local to the block's units and lives in a buffer
//     only that block touches, updated in place;
//   * bf16: the (B, Hk) x (Hk, 24) product of a step runs on the tensor
//     cores (mma.sync m16n8k16, fp32 accumulation); fp32 keeps CUDA-core
//     FMAs;
//   * the gates' inputs (xw, the carry, lengths) of the next step are loaded
//     into registers before the grid barrier, so their latency hides
//     behind it;
//   * batches over 64 rows are walked in 64-row chunks inside a step.
//
// Co-residency limit: one block per SM, so H <= 8 * (the card's SMs), 1056
// on an H100 SXM (ops/rnn_kernels.py::gru_route reads the card and sends a
// larger H to the per-step kernel at the end of this file, before any
// launch).
//
// What bounds it on this card: the step chain, not the operations.  At
// B = 1 a step takes ~3.5 us (an L2 round trip for the row, the gates and
// the grid barrier); at B = 64 ~8 us, the rest being every SM taking in the
// whole 128 KB row from L2 (~16 MB per step over 128 SMs).  The product is
// ~0.4 us of tensor-core time per step at B = 64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "rnn_persistent.cuh"
#include "step_stream.cuh"

namespace {

using namespace rnnp;

constexpr int C = 3 * kJT;   // gate columns of the block
constexpr int kUnroll = 4;   // K slabs of A in flight per warp (2 and 8 were slower)
// Gate inputs of the first 64-row chunk a thread prefetches: its items
// p = threadIdx.x + i kThreads all have the unit j0 + threadIdx.x % kJT.
constexpr int kPre = kRowChunk * kJT / kThreads;

// Shapes: xw (T, B, 3H); w_tiles (ceil(H/kJT), C, Hk) zero padded for k >= H
// and j >= H; b_hh (3H); hb (2, B, Hk) of T, hb[0] = h0 rounded, zero for
// k >= H; carry (B, H) fp32 = h0; h_all (T, B, H); h_fin (B, H); count a
// zeroed barrier counter.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
gru_fwd_persistent(const T* __restrict__ xw, const T* __restrict__ w_tiles,
                   const T* __restrict__ b_hh, T* hb, float* carry,
                   T* __restrict__ h_all, T* __restrict__ h_fin,
                   const int* __restrict__ lengths, unsigned int* count, int T_len,
                   int B, int H, int Hk, int reverse) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);
  const int ldw = slice_ld<T>(Hk);
  float* dots = reinterpret_cast<float*>(w_s + (size_t)C * ldw);
  const int j0 = blockIdx.x * kJT;
  load_slice(w_s, w_tiles + (size_t)blockIdx.x * C * Hk, C, Hk);
  __syncthreads();

  const int jj = threadIdx.x % kJT, j = j0 + jj;
  const bool j_ok = j < H;
  const float br = j_ok ? to_f(b_hh[j]) : 0.0f, bz = j_ok ? to_f(b_hh[H + j]) : 0.0f,
              bn = j_ok ? to_f(b_hh[2 * H + j]) : 0.0f;
  // The gates' inputs of the first chunk are loaded for the next step
  // before the grid barrier, so their latency hides behind it.
  float pre_x[kPre][3], pre_h[kPre];
  int pre_len[kPre];
  auto prefetch = [&](int t) {
#pragma unroll
    for (int i = 0; i < kPre; ++i) {
      const int b = (threadIdx.x + i * kThreads) / kJT;
      if (j_ok && b < min(B, kRowChunk)) {
        const T* x = xw + ((size_t)t * B + b) * 3 * H;
        pre_x[i][0] = to_f(x[j]);
        pre_x[i][1] = to_f(x[H + j]);
        pre_x[i][2] = to_f(x[2 * H + j]);
        pre_h[i] = carry[(size_t)b * H + j];
        pre_len[i] = lengths[b];
      }
    }
  };
  prefetch(reverse ? T_len - 1 : 0);

  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    const T* h_in = hb + (size_t)(s % 2) * B * Hk;
    T* h_out = hb + (size_t)((s + 1) % 2) * B * Hk;
    // one unit of one row: its dots (chunk row rl) and its inputs
    auto gate = [&](const Split& sp, int b, int rl, float xr, float xz, float xn,
                    float hp, int len) {
      float hr = br, hz = bz, hn = bn;
      for (int ks = 0; ks < sp.ksplit; ++ks) {
        const float* d = dots + (ks * sp.npad + rl) * C;
        hr += d[jj];
        hz += d[kJT + jj];
        hn += d[2 * kJT + jj];
      }
      const float r = sigmoidf_(xr + hr);
      const float z = sigmoidf_(xz + hz);
      const float n = tanhf(xn + r * hn);
      const float h_new = (1.0f - z) * n + z * hp;
      const bool m = t < len;
      const float h_carry = m ? h_new : hp;
      carry[(size_t)b * H + j] = h_carry;
      h_out[(size_t)b * Hk + j] = from_f<T>(h_carry);
      h_all[((size_t)t * B + b) * H + j] = from_f<T>(m ? h_new : 0.0f);
      if (s == T_len - 1) h_fin[(size_t)b * H + j] = from_f<T>(h_carry);
    };
    for (int r0 = 0; r0 < B; r0 += kRowChunk) {
      const int nrows = min(kRowChunk, B - r0);
      const Split sp = dots_of<C, kUnroll>(w_s, ldw, h_in, Hk, Hk, r0, nrows, dots);
      __syncthreads();
      if (j_ok && r0 == 0) {
#pragma unroll
        for (int i = 0; i < kPre; ++i) {
          const int p = threadIdx.x + i * kThreads;
          if (p < nrows * kJT)
            gate(sp, p / kJT, p / kJT, pre_x[i][0], pre_x[i][1], pre_x[i][2], pre_h[i],
                 pre_len[i]);
        }
      } else if (j_ok) {
        for (int p = threadIdx.x; p < nrows * kJT; p += kThreads) {
          const int rl = p / kJT, b = r0 + rl;
          const T* x = xw + ((size_t)t * B + b) * 3 * H;
          gate(sp, b, rl, to_f(x[j]), to_f(x[H + j]), to_f(x[2 * H + j]),
               carry[(size_t)b * H + j], lengths[b]);
        }
      }
      __syncthreads();
    }
    if (s + 1 < T_len) {
      prefetch(reverse ? t - 1 : t + 1);
      grid_sync(count, (unsigned int)(s + 1) * gridDim.x);
    }
  }
}

template <typename T>
int launch_scan(const void* xw, const void* w_tiles, const void* b_hh, void* hb,
                void* carry, void* h_all, void* h_fin, const void* lengths,
                void* count, int T_len, int B, int H, int Hk, int reverse,
                cudaStream_t stream) {
  const int blocks = (H + kJT - 1) / kJT;
  const size_t smem = slice_smem<T>(C, Hk);
  cudaError_t err = check_coresident(gru_fwd_persistent<T>, blocks, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&xw, &w_tiles, &b_hh, &hb, &carry, &h_all, &h_fin, &lengths,
                  &count, &T_len, &B, &H, &Hk, &reverse};
  err = cudaLaunchCooperativeKernel((const void*)gru_fwd_persistent<T>, dim3(blocks),
                                    dim3(kThreads), args, smem, stream);
  return (int)err;
}

}  // namespace

// Runs the whole scan: one cooperative launch on `stream`, no sync.
// w_tiles is W_hh tiled for jt hidden units per block, which must be kJT.
// dtype: 0 = float32, 1 = bfloat16 (xw, w_tiles, b_hh, hb, h_all, h_fin
// share it).  hb is (2, B, Hk) with hb[0] = h0 in that dtype and zero
// padding for k >= H in both halves; carry is (B, H) fp32 holding h0 and is
// updated in place; count is one zeroed uint32.  Returns 0 or the first
// cudaError_t met (cudaErrorCooperativeLaunchTooLarge when the grid cannot
// be co-resident).
extern "C" int gru_scan_fwd(const void* xw, const void* w_tiles, const void* b_hh,
                            void* hb, void* carry, void* h_all, void* h_fin,
                            const void* lengths, void* count, int T_len, int B,
                            int H, int Hk, int jt, int reverse, int dtype,
                            void* stream) {
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kJT || Hk % 64 != 0 || Hk < H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_scan<float>(xw, w_tiles, b_hh, hb, carry, h_all, h_fin, lengths,
                              count, T_len, B, H, Hk, reverse, s);
  if (dtype == 1)
    return launch_scan<__nv_bfloat16>(xw, w_tiles, b_hh, hb, carry, h_all, h_fin,
                                      lengths, count, T_len, B, H, Hk, reverse, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block, for the wrapper's co-residency limit.
extern "C" int gru_scan_fwd_smem(int Hk, int dtype) {
  return (int)(dtype == 0 ? slice_smem<float>(C, Hk) : slice_smem<__nv_bfloat16>(C, Hk));
}

// ---------------------------------------------------------------------------
// The per-step route, for H above the persistent grid's limit: one launch per
// step, back to back on the caller's stream, two fp32 h buffers ping-pong;
// each block owns kJT units and copies its (3 kJT, Hk) slice of W_hh into
// shared memory every launch; warps split rows into groups of kRows (one
// shared-memory read of W feeds kRows FMAs) and, when B is small, split K
// too; lanes stride over K in pairs and finish with a shuffle reduction.
// ---------------------------------------------------------------------------

namespace per_step {

using namespace rnnp;

constexpr int kRows = 4;  // rows of h each lane carries in registers

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

// Dynamic shared memory of one block: the (3 kJT, Hk) slice and the
// 64-row dot buffer.  It must fit the card's opt-in limit, which bounds H
// (ops/rnn_kernels.py::gru_step_max_hidden).
template <typename T> constexpr size_t step_smem(int Hk) {
  return sizeof(T) * 3 * kJT * (size_t)Hk + sizeof(float) * kRowChunk * 3 * kJT;
}

// Dynamic shared memory of a block that streams its slice (kStream):
// the two chunk buffers and the dot buffer, whatever H is.
template <typename T> constexpr size_t stream_smem() {
  return step_stream::ring_bytes<T>(3 * kJT) + sizeof(float) * kRowChunk * 3 * kJT;
}

// One timestep.  Shapes: xw_t (B, 3H); w_tiles (ceil(H/kJT), 3 kJT, Hk) with
// zero padding for k >= H and j >= H; b_hh (3H); h_prev / h_next (B, Hk)
// fp32 with zero padding for k >= H; hall_t (B, H); h_fin (B, H) or null.
// kStream: the slice is streamed through shared memory in K chunks
// (step_stream.cuh) instead of copied whole.
template <typename T, bool kStream>
__global__ void __launch_bounds__(kThreads)
gru_fwd_step(const T* __restrict__ xw_t, const T* __restrict__ w_tiles,
             const T* __restrict__ b_hh, const float* __restrict__ h_prev,
             float* __restrict__ h_next, T* __restrict__ hall_t,
             T* __restrict__ h_fin, const int* __restrict__ lengths,
             int t, int B, int H, int Hk) {
  constexpr int C = 3 * kJT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* w_s = reinterpret_cast<T*>(smem_raw);  // (C, Hk), or the chunk ring
  float* dots = reinterpret_cast<float*>(
      smem_raw + (kStream ? step_stream::ring_bytes<T>(C) : sizeof(T) * C * (size_t)Hk));

  const int j0 = blockIdx.x * kJT;
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

template <typename T, bool kStream>
int launch_steps(const void* xw, const void* w_tiles, const void* b_hh, void* h_a,
                 void* h_b, void* h_all, void* h_fin, const void* lengths,
                 int T_len, int B, int H, int Hk, int reverse, cudaStream_t stream) {
  const size_t smem = kStream ? stream_smem<T>() : step_smem<T>(Hk);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_step<T, kStream>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((H + kJT - 1) / kJT);
  const T* xw_p = static_cast<const T*>(xw);
  T* hall_p = static_cast<T*>(h_all);
  float* hp = static_cast<float*>(h_a);
  float* hn = static_cast<float*>(h_b);
  for (int s = 0; s < T_len; ++s) {
    const int t = reverse ? T_len - 1 - s : s;
    gru_fwd_step<T, kStream><<<grid, kThreads, smem, stream>>>(
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

}  // namespace per_step

// The most blocks that can be co-resident on this card at width Hk, or -1.
extern "C" int gru_scan_fwd_max_blocks(int Hk, int dtype) {
  int blocks = -1;
  const cudaError_t err =
      dtype == 0 ? max_coresident(gru_fwd_persistent<float>, slice_smem<float>(C, Hk), &blocks)
                 : max_coresident(gru_fwd_persistent<__nv_bfloat16>,
                                  slice_smem<__nv_bfloat16>(C, Hk), &blocks);
  return err == cudaSuccess ? blocks : -1;
}

// The per-step route: T launches of gru_fwd_step on `stream`, no sync.
// w_tiles is W_hh tiled for jt = kJT hidden units per block, as for the
// persistent scan.  dtype as above.  h_a holds h0 (fp32, (B, Hk), zero
// padded); h_b is scratch of the same shape.  Returns 0 or the first
// cudaError_t met.
template <bool kStream>
static int fwd_steps(const void* xw, const void* w_tiles, const void* b_hh, void* h_a,
                     void* h_b, void* h_all, void* h_fin, const void* lengths,
                     int T_len, int B, int H, int Hk, int jt, int reverse, int dtype,
                     void* stream) {
  using namespace per_step;
  if (T_len <= 0 || B <= 0) return 0;
  if (jt != kJT || Hk % 64 != 0 || Hk < H) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_steps<float, kStream>(xw, w_tiles, b_hh, h_a, h_b, h_all, h_fin,
                                        lengths, T_len, B, H, Hk, reverse, s);
  if (dtype == 1)
    return launch_steps<__nv_bfloat16, kStream>(xw, w_tiles, b_hh, h_a, h_b, h_all,
                                                h_fin, lengths, T_len, B, H, Hk,
                                                reverse, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" int gru_scan_fwd_step(const void* xw, const void* w_tiles, const void* b_hh,
                                 void* h_a, void* h_b, void* h_all, void* h_fin,
                                 const void* lengths, int T_len, int B, int H, int Hk,
                                 int jt, int reverse, int dtype, void* stream) {
  return fwd_steps<false>(xw, w_tiles, b_hh, h_a, h_b, h_all, h_fin, lengths, T_len,
                          B, H, Hk, jt, reverse, dtype, stream);
}

// The same launches with the slice streamed through shared memory in K
// chunks (step_stream.cuh): any H, for H above the whole-slice block's limit.
extern "C" int gru_scan_fwd_step_chunked(const void* xw, const void* w_tiles,
                                         const void* b_hh, void* h_a, void* h_b,
                                         void* h_all, void* h_fin, const void* lengths,
                                         int T_len, int B, int H, int Hk, int jt,
                                         int reverse, int dtype, void* stream) {
  return fwd_steps<true>(xw, w_tiles, b_hh, h_a, h_b, h_all, h_fin, lengths, T_len,
                         B, H, Hk, jt, reverse, dtype, stream);
}

// Dynamic shared memory of one per-step block, for the wrapper's limit.
extern "C" int gru_scan_fwd_step_smem(int Hk, int dtype) {
  return (int)(dtype == 0 ? per_step::step_smem<float>(Hk)
                          : per_step::step_smem<__nv_bfloat16>(Hk));
}

// Dynamic shared memory of one streamed per-step block (any H).
extern "C" int gru_scan_fwd_step_chunked_smem(int dtype) {
  return (int)(dtype == 0 ? per_step::stream_smem<float>()
                          : per_step::stream_smem<__nv_bfloat16>());
}
