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
// with the running logsumexp of logaddexp(a, b) = max(a, b) +
// log1p(exp(-|a - b|)) (kept here as a (max, scaled sum) pair, the same
// function), which stays finite for the -1e30 fills of the loss.  Lanes past T hold the scans'
// identities (0 for the sum, -1e30 for the running logsumexp); scans only
// move values towards later times, so they never reach a valid lane.
//
// What bounds it on this card: the sweep reads be and le and writes alpha
// once, 3 N T (U+1) 4 bytes (38.5 MB for the alpha and beta sweeps of one
// flagship loss, N = 128, T = 512, U+1 = 49: ~11.5 us at 3.35 TB/s).  The
// U+1 columns of a lattice are sequential, so in practice the floor is the
// latency of U+1 block-wide logsumexp scans per lattice.
//
// Design:
//   * one block per lattice (NW warps, PER consecutive time steps per
//     thread, TC = 32 NW PER steps per chunk); T runs in chunks of TC steps
//     with each column's running sum and running logsumexp carried from
//     chunk to chunk (in `carry`), so any T is taken;
//   * the edges are read in the loss's own layout, (N, T, U+1): a group of
//     kGroup columns over TC steps is staged into shared memory with 4-byte
//     cp.async (a lattice row, 196 bytes at U+1 = 49, is no multiple of 16,
//     so neither 16-byte copies nor TMA describe it unpadded; a warp's 32
//     copies cover 4 rows of 8 columns, whole 32-byte sectors), transposed to
//     time-contiguous columns, through a ring of kStages groups: the next
//     groups arrive while the current one scans, so device-memory latency
//     stays off the chain;
//   * the cb sum scans do not depend on alpha: they run for a whole group at
//     once when it arrives (kGroup independent scans, in place), so each
//     column puts only one logsumexp scan on the chain;
//   * a column's scan: PER steps per thread in registers, then warp
//     shuffles; no block barrier: each warp takes the prefix of the warps
//     before it from the one just before (a value and a flag in shared
//     memory) and passes its own on, so the warps work through the columns
//     as a pipeline, warp 0 ahead.  The running logsumexp is carried as
//     (largest term, scaled sum), so each combine on the chain costs one
//     exp, and the log is taken per element at the end (struct Lse);
//   * alpha is written back into the staged cb, and each group's tile is
//     stored to (N, T, U+1) in rows of 8 columns, so no transpose is left to
//     the wrapper.

#include <cuda_runtime.h>

namespace {

constexpr float kNeg = -1e30f;
constexpr int kGroup = 8;   // label columns per staged group
constexpr int kStages = 3;  // groups in flight

// A running logsumexp as (m, s): the largest term and the sum of exp(term -
// m), worth m + log(s).  Combining two takes one exp on the chain, where
// logaddexp takes an exp and a log1p; the log is taken once per element, off
// the chain.  {kNeg, 0} is the identity, and a -1e30 fill stays -1e30 (its
// s counts the fills, and -1e30 + log(k) == -1e30 in fp32), as logaddexp
// keeps it.
struct Lse {
  float m, s;
};

__device__ __forceinline__ Lse combine(Lse a, Lse b) {
  const float e = expf(-fabsf(a.m - b.m));
  return a.m >= b.m ? Lse{a.m, fmaf(b.s, e, a.s)} : Lse{b.m, fmaf(a.s, e, b.s)};
}

__device__ __forceinline__ Lse shfl_up(Lse v, int off) {
  return Lse{__shfl_up_sync(0xffffffffu, v.m, off), __shfl_up_sync(0xffffffffu, v.s, off)};
}

__device__ __forceinline__ float value(Lse v) { return v.m + logf(v.s); }

// 4-byte asynchronous copy into shared memory; `valid` false fills 0.
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The block: 4 warps of 4 consecutive steps per thread, 512 steps per chunk
// (of 4x4, 8x2, 16x1, 4x1 and 4x8 warps x steps, the fastest at the loss's
// (128, 512, 49), 8x2 within the spread between calls).
constexpr int NW = 4, PER = 4;
constexpr int kThreads = 32 * NW;
constexpr int TC = kThreads * PER;  // time steps per chunk
constexpr int LD = TC + 4;          // column stride: conflict-free staging
constexpr size_t kSlot = (size_t)kGroup * LD;
// the staged edges, then the warps' published prefixes (float2) and their
// flags (int) for the group's columns, then the cb scans' warp totals
constexpr size_t kSmem = sizeof(float) * (2 * kStages * kSlot + 3 * NW * kGroup + kGroup * NW);

// be, le, alpha: (N, T, U1) fp32, contiguous.  carry: (N, 2, U1) fp32
// scratch (running sum and running logsumexp of each column at the end of a
// chunk), read only when T > TC.
__global__ void __launch_bounds__(kThreads)
rnnt_sweep_kernel(const float* __restrict__ be, const float* __restrict__ le,
                  float* __restrict__ alpha, float* __restrict__ carry, int T, int U1) {
  extern __shared__ __align__(16) float smem[];
  float* be_s = smem;                                 // [kStages][kGroup][LD]
  float* le_s = be_s + kStages * kSlot;             // [kStages][kGroup][LD]
  float2* pub = reinterpret_cast<float2*>(le_s + kStages * kSlot);  // [NW][kGroup]
  volatile int* flag = reinterpret_cast<volatile int*>(pub + NW * kGroup);  // [NW][kGroup]
  float* ctot = reinterpret_cast<float*>(pub + NW * kGroup) + NW * kGroup;  // [kGroup][NW]

  const int tid = threadIdx.x, lane = tid % 32, w = tid / 32;
  if (tid < NW * kGroup) flag[tid] = -1;
  const size_t base = (size_t)blockIdx.x * T * U1;
  float* cb_carry = carry + (size_t)blockIdx.x * 2 * U1;
  float* l_carry = cb_carry + U1;
  const int nchunks = (T + TC - 1) / TC;
  const int ngroups = (U1 + kGroup - 1) / kGroup;
  const int nstages = nchunks * ngroups;
  const int tl = tid * PER;  // this thread's first step in a chunk

  // A thread moves one column (ul = tid % 8) of a group's tile, every
  // kRowStep-th step from tid / 8 on: a warp covers 4 rows of 8 columns.
  constexpr int kRowStep = kThreads / kGroup;
  const int my_ul = tid % kGroup, my_t = tid / kGroup;

  // Stage s = (chunk s / ngroups, group s % ngroups): be columns u0 .. u0+7
  // and the le columns u0-1 .. u0+6 their alphas read, steps t0 .. t0+TC-1.
  auto issue = [&](int s) {
    if (s < nstages) {
      const int t0 = (s / ngroups) * TC, u = (s % ngroups) * kGroup + my_ul;
      float* bs = be_s + (s % kStages) * kSlot + my_ul * LD + my_t;
      float* ls = le_s + (s % kStages) * kSlot + my_ul * LD + my_t;
      const int rows = min(TC, T - t0) - my_t;  // valid steps from my_t on
      const bool col_b = u < U1, col_l = u >= 1 && u < U1;
      const size_t at = base + (size_t)(t0 + my_t) * U1 + u;
#pragma unroll 4
      for (int j = 0; j < TC / kRowStep; ++j) {
        const bool ok = j * kRowStep < rows;
        const size_t off = at + (size_t)j * kRowStep * U1;
        cp_async4(bs + j * kRowStep, ok && col_b ? be + off : be, ok && col_b);
        cp_async4(ls + j * kRowStep, ok && col_l ? le + off - 1 : le, ok && col_l);
      }
    }
    cp_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  float prev[PER];
  int seq = 0;  // columns scanned so far: the flags' sequence numbers
  for (int s = 0; s < nstages; ++s) {
    cp_wait<kStages - 2>();
    __syncthreads();  // group s has landed; every thread is done with slot s-1
    issue(s + kStages - 1);
    const int c = s / ngroups, t0 = c * TC, u0 = (s % ngroups) * kGroup;
    float* bs = be_s + (s % kStages) * kSlot;
    const float* ls = le_s + (s % kStages) * kSlot;

    // ---- cb = exclusive cumsum of be over the group's columns, in place ----
    float x[kGroup][PER], run[kGroup], cbase[kGroup];
#pragma unroll
    for (int ul = 0; ul < kGroup; ++ul) {
      cbase[ul] = (c > 0 && u0 + ul < U1) ? cb_carry[u0 + ul] : 0.0f;
      float sum = 0.0f;
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float v = bs[ul * LD + tl + i];
        x[ul][i] = sum;  // exclusive within the thread
        sum += v;
      }
      run[ul] = sum;
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1)
#pragma unroll
      for (int ul = 0; ul < kGroup; ++ul) {
        const float y = __shfl_up_sync(0xffffffffu, run[ul], off);
        if (lane >= off) run[ul] += y;
      }
    if (lane == 31)
#pragma unroll
      for (int ul = 0; ul < kGroup; ++ul) ctot[ul * NW + w] = run[ul];
    __syncthreads();
#pragma unroll
    for (int ul = 0; ul < kGroup; ++ul) {
      float excl = __shfl_up_sync(0xffffffffu, run[ul], 1);
      if (lane == 0) excl = 0.0f;
      float wsum = cbase[ul];  // the column's sum before this warp's steps
      for (int v = 0; v < w; ++v) wsum += ctot[ul * NW + v];
      const float pre = wsum + excl;
#pragma unroll
      for (int i = 0; i < PER; ++i) bs[ul * LD + tl + i] = pre + x[ul][i];
      // the last thread's inclusive sum is the column's sum through the chunk
      if (nchunks > 1 && tid == kThreads - 1 && u0 + ul < U1)
        cb_carry[u0 + ul] = wsum + run[ul];
    }

    // ---- the chain: one logsumexp scan per column --------------------------
    const int ucount = min(kGroup, U1 - u0);
    for (int ul = 0; ul < ucount; ++ul) {
      const int u = u0 + ul;
      float* col = bs + ul * LD + tl;
      float cb[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) cb[i] = col[i];
      if (u == 0) {  // alpha[:, 0] = cb, already in place
#pragma unroll
        for (int i = 0; i < PER; ++i) prev[i] = cb[i];
        continue;
      }
      const Lse lbase = c > 0 ? Lse{l_carry[u], 1.0f} : Lse{kNeg, 0.0f};
      const float* lcol = ls + ul * LD + tl;
      Lse p[PER];
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const Lse d{t0 + tl + i < T ? (prev[i] + lcol[i]) - cb[i] : kNeg, 1.0f};
        p[i] = i == 0 ? d : combine(p[i - 1], d);
      }
      Lse v = p[PER - 1];
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const Lse y = shfl_up(v, off);
        if (lane >= off) v = combine(y, v);
      }
      Lse ex = shfl_up(v, 1);
      if (lane == 0) ex = Lse{kNeg, 0.0f};
      // The prefix of the warps before this one: warp w - 1 publishes it
      // with its own total folded in as soon as it has its warp scan, so the
      // warps run the columns as a pipeline, warp 0 ahead, with no barrier.
      Lse pre = lbase;
      if (w > 0) {
        while (flag[(w - 1) * kGroup + ul] != seq) {
        }
        __threadfence_block();
        const volatile float2* q = pub + (w - 1) * kGroup + ul;
        pre = Lse{q->x, q->y};
      }
      if (w + 1 < NW && lane == 31) {
        const Lse inc = combine(pre, v);
        pub[w * kGroup + ul] = make_float2(inc.m, inc.s);
        __threadfence_block();
        flag[w * kGroup + ul] = seq;
      }
      ++seq;
      const Lse exb = combine(pre, ex);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const float l = value(combine(exb, p[i]));
        const float a = cb[i] + l;
        prev[i] = a;
        col[i] = a;
        if (i == PER - 1 && nchunks > 1 && tid == kThreads - 1) l_carry[u] = l;
      }
    }

    // ---- store the group's alpha tile to (N, T, U1) -------------------------
    __syncthreads();
    if (u0 + my_ul < U1) {
      const int rows = min(TC, T - t0) - my_t;
      float* a = alpha + base + (size_t)(t0 + my_t) * U1 + u0 + my_ul;
      const float* col = bs + my_ul * LD + my_t;
#pragma unroll 4
      for (int j = 0; j < TC / kRowStep; ++j)
        if (j * kRowStep < rows) a[(size_t)j * kRowStep * U1] = col[j * kRowStep];
    }
  }
  cp_wait<0>();
}

}  // namespace

// alpha = sweep(be, le) for N lattices on `stream`, one launch, no sync.
// be, le, alpha: (N, T, U1) fp32, contiguous; carry: (N, 2, U1) fp32
// scratch.  Returns 0 or a cudaError_t.
extern "C" int rnnt_sweep(const void* be, const void* le, void* alpha, void* carry,
                          int N, int T, int U1, void* stream) {
  if (N <= 0 || T <= 0 || U1 <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      rnnt_sweep_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmem);
  if (err != cudaSuccess) return (int)err;
  rnnt_sweep_kernel<<<N, kThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(be), static_cast<const float*>(le),
      static_cast<float*>(alpha), static_cast<float*>(carry), T, U1);
  return (int)cudaGetLastError();
}
