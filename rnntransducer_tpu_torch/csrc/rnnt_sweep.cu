// RNN-T lattice sweep (the alpha recursion), written by hand for Hopper
// (sm_90a).
//
// Replaces the TPU kernel rnntransducer_tpu/ops/rnnt_pallas.py::_sweep_kernel
// (public sweep_pallas).  Same recurrence, solved per label column u in
// closed form with two prefix scans along time:
//
//   alpha[:, 0] = exclusive_cumsum(be[:, 0])
//   alpha[:, u] = cb + cumlogsumexp(alpha[:, u-1] + le[:, u-1] - cb),
//   cb          = exclusive_cumsum(be[:, u])
//
// with logaddexp(a, b) = max(a, b) + log1p(exp(-|a - b|)), which stays
// finite for the -1e30 fills of the loss.  Lanes past T hold the scans'
// identities (0 for the sum, -1e30 for the running logsumexp); scans only
// move values towards later times, so they never reach a valid lane.
//
// What bounds it on this card: the sweep reads be and le and writes alpha
// once, 3 N T (U+1) 4 bytes (38.5 MB for the alpha and beta sweeps of one
// flagship loss, N = 128, T = 512, U+1 = 49: ~11.5 us at 3.35 TB/s), and
// does ~O(N T (U+1)) cheap arithmetic.  The U+1 columns of a lattice are
// sequential, so the floor in practice is the latency of 2 (U+1) block-wide
// scans per lattice, each a few shuffles and two barriers.
//
// Design (simple first): one block per lattice; the block's threads span T
// (PER consecutive time steps per thread when T exceeds 1024); the block
// loops over u, keeping the previous column in registers.  A column does two
// block-wide scans: per thread over its own steps, then warp shuffles, then
// one warp over the per-warp totals in shared memory.  The wrapper lays the
// edges out time-contiguous, (N, U+1, T), so column reads coalesce.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kMaxThreads = 1024;
constexpr int kMaxPer = 8;  // time steps per thread: T <= 8192

struct Add {
  __device__ __forceinline__ float operator()(float a, float b) const { return a + b; }
};

struct LogAddExp {
  __device__ __forceinline__ float operator()(float a, float b) const {
    const float m = fmaxf(a, b);
    return m + log1pf(expf(-fabsf(a - b)));
  }
};

// Exclusive scan over the block of one value per thread (threads in order);
// `ident` is op's identity.  `sm` holds 32 floats.  All threads must call.
template <typename Op>
__device__ __forceinline__ float block_exclusive(float v, Op op, float ident,
                                                 float* sm) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nwarps = (blockDim.x + 31) / 32;
  float incl = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl = op(y, incl);
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = ident;
  if (lane == 31) sm[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    float w = lane < nwarps ? sm[lane] : ident;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w = op(y, w);
    }
    sm[lane] = w;
  }
  __syncthreads();
  const float pre = warp > 0 ? sm[warp - 1] : ident;
  __syncthreads();  // sm is free for the next scan
  return warp > 0 ? op(pre, excl) : excl;
}

// One lattice per block, PER consecutive time steps per thread.
// be, le, alpha: (N, U1, T) fp32, time contiguous.
template <int PER>
__global__ void __launch_bounds__(kMaxThreads)
rnnt_sweep_kernel(const float* __restrict__ be, const float* __restrict__ le,
                  float* __restrict__ alpha, int T, int U1) {
  __shared__ float sm[32];
  const size_t base = (size_t)blockIdx.x * U1 * T;
  const int t0 = threadIdx.x * PER;

  float prev[PER];
  float cb[PER];
  for (int u = 0; u < U1; ++u) {
    // cb = exclusive cumsum of be[:, u] along time
    const float* bcol = be + base + (size_t)u * T;
    float e[PER];
    float tot = 0.0f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = t0 + i;
      e[i] = t < T ? bcol[t] : 0.0f;
      tot += e[i];
    }
    float run = block_exclusive(tot, Add(), 0.0f, sm);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      cb[i] = run;
      run += e[i];
    }

    float* acol = alpha + base + (size_t)u * T;
    if (u == 0) {
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        prev[i] = cb[i];
        const int t = t0 + i;
        if (t < T) acol[t] = cb[i];
      }
      continue;
    }

    // new = cb + cumlogsumexp(prev + le[:, u-1] - cb)
    const float* lcol = le + base + (size_t)(u - 1) * T;
    const LogAddExp lae;
    float d[PER];
    float dtot = kNeg;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int t = t0 + i;
      d[i] = t < T ? prev[i] + lcol[t] - cb[i] : kNeg;
      dtot = i == 0 ? d[0] : lae(dtot, d[i]);
    }
    const float lpre = block_exclusive(dtot, lae, kNeg, sm);
    float lrun = lpre;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      // logaddexp(-1e30, d) == d in fp32 for every d >= -1e30
      lrun = lae(lrun, d[i]);
      const float v = cb[i] + lrun;
      prev[i] = v;
      const int t = t0 + i;
      if (t < T) acol[t] = v;
    }
  }
}

}  // namespace

// alpha = sweep(be, le) for N lattices on `stream`, one launch, no sync.
// be, le, alpha: (N, U1, T) fp32, contiguous.  Returns 0 or a cudaError_t.
extern "C" int rnnt_sweep(const void* be, const void* le, void* alpha, int N,
                          int T, int U1, void* stream) {
  if (N <= 0 || T <= 0 || U1 <= 0) return 0;
  int threads = ((T + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  const int per = (T + threads - 1) / threads;
  const float* b = static_cast<const float*>(be);
  const float* l = static_cast<const float*>(le);
  float* a = static_cast<float*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (per == 1)
    rnnt_sweep_kernel<1><<<N, threads, 0, s>>>(b, l, a, T, U1);
  else if (per == 2)
    rnnt_sweep_kernel<2><<<N, threads, 0, s>>>(b, l, a, T, U1);
  else if (per <= 4)
    rnnt_sweep_kernel<4><<<N, threads, 0, s>>>(b, l, a, T, U1);
  else if (per <= kMaxPer)
    rnnt_sweep_kernel<kMaxPer><<<N, threads, 0, s>>>(b, l, a, T, U1);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
