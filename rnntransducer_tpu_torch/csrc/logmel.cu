// Fused log-mel of framed audio, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
// rnntransducer_tpu/frontend/pallas_frontend.py::_logmel_kernel (called by
// logmel_pallas).  Semantics kept exactly, per row of n_fft samples:
//   re = frame @ Wc, im = frame @ Ws   (the windowed DFT)
//   power = re^2 + im^2
//   out = log1p(power @ Fb)            (the HTK filterbank)
// with the TPU's precision: every product takes bf16 operands and
// accumulates in fp32.  high != 0 is the TPU's high_precision mode: the DFT
// becomes the three products xh wh + xh wl + xl wh of _dot3, with
// x = xh + xl and w = wh + wl split into bf16 high and low parts (the
// wrapper splits W, this kernel splits the frames).  The mel product is one
// bf16 pass in both modes.
//
// What bounds it on this card: at the flagship raw-PCM shape (32768 rows of
// 400 samples) the fp32 frames (52 MB) are read once and the (rows, 80)
// output written once, ~19 us at 3.35 TB/s, against 13.4 GFLOP of
// tensor-core work (~14 us at the bf16 peak; three times that with high).
// So it sits near the ridge: both the loads and the tensor cores count.
//
// Three engines share the operands' values and the padding; the wrapper
// picks the wgmma engine wherever its 64-row slab fits the shared memory,
// else the mma.sync engine's 32- or 16-row tiles, else (windows too wide
// for even 16 rows of frames) the chunked engine at the end of this file.
// At the flagship shape the wgmma engine took 0.081 ms against the mma.sync
// engine's 0.114 at the same 128-row tiles, 0.135 against 0.231 in high
// mode at 64 rows (chip_smoke.py, H100 SXM at 700 W).
//
// The wgmma engine (namespace wg):
//   * a persistent grid, one block per SM walking tiles of 128 frame rows
//     (64 in high mode): two (one) consumer warpgroups of 4 warps, each
//     owning a 64-row slab whose bf16 frames (and their bf16 remainders in
//     high mode) and bf16 power stay in its own shared memory, so the
//     warpgroups meet only at the ring, and one producer warp;
//   * the B operands stream through a ring of 3 stages of 32 samples (bins
//     for the mel product): the producer's one thread waits on a stage's
//     "empty" mbarrier and fills it with one bulk copy that completes on its
//     "full" mbarrier; the consumer warps wait on "full", and each gives the
//     stage back with one arrival once its products on it are done.  The
//     wrapper lays each stage out as one contiguous block in the products'
//     shared-memory layout, 8 x 8 core matrices, so no tensor map is needed:
//     per pass of 64 bins 128 rows, cos and sin of 32 bins in turn (and the
//     same of their low parts, copied only in high mode), then per pass of
//     64 filters the filterbank;
//   * the products are wgmma m64n128k16 (the DFT: re and im of 64 bins at
//     once; three per k-step in high mode) and m64n64k16 (the mel product),
//     A and B read from shared memory through descriptors, fp32
//     accumulators in registers, one stage's products in flight while the
//     next stage is waited for; power = re^2 + im^2 is formed in registers,
//     rounded to bf16 into the slab's power for the mel product, and log1p
//     and the store of the real rows and filters follow in registers;
//   * frames arrive 32 samples at a time with 16-byte vector loads, fetched
//     two stages ahead of their conversion to bf16: the first tile's before
//     its first pass, every later tile's while the tile before it runs its
//     last DFT pass (each chunk once that pass's products on it are done)
//     and its mel product; a warpgroup barrier and a proxy fence per tile
//     (and one before the mel product) make them visible to wgmma.
//
// The mma.sync engine (logmel_persistent), for windows whose 64-row slab
// does not fit:
//   * one block of 8 warps per SM walking tiles of 32 or 16 rows, the
//     tile's frames and power in shared memory with padded rows;
//   * the B operands n-major, 64-byte rows, through a ring of 3 stages fed
//     by 16-byte cp.async with one block barrier per stage;
//   * ldmatrix + mma.sync m16n8k16, a warp owning rows x (the same bins of
//     cos and sin); the frames pipeline as above, each chunk put in after
//     the stage barrier that follows its last read.
// Bins are padded to a multiple of 64 (at least 128: two DFT passes, so the
// next tile's frames go in during the last), filters to a multiple of 64
// and the sample axis to a multiple of 32; padded rows and columns are zero.
// Each mel pass multiplies only its filters' window of bins (at least two
// 32-bin chunks), outside which they are zero.
// Framing and normalisation stay outside the kernel, as in the JAX package.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps
constexpr int kKC = 32;        // K of one ring stage
constexpr int kStages = 3;     // ring depth (up to 8 stages timed no faster)
constexpr int kPass = 64;      // bins of a DFT pass, filters of a mel pass
constexpr int kLDS = kKC + 8;  // stage row stride (bf16): conflict-free ldmatrix

template <int TR, bool HIGH>
struct Cfg {
  static constexpr int WR = TR / 16;                 // warps along rows
  static constexpr int WN = 8 / WR;                  // warps along bins / filters
  static constexpr int MT = TR / (16 * WR);          // m16 tiles per warp
  static constexpr int NT = kPass / (8 * WN);        // n8 tiles per warp (per half)
  static constexpr int kRowsD = (HIGH ? 4 : 2) * kPass;  // B rows of a DFT stage
};

__host__ __device__ inline size_t smem_bytes(int TR, int Kf, int Kbp, bool high) {
  return 2 * ((size_t)(high ? 2 : 1) * TR * (Kf + 8) + (size_t)TR * (Kbp + 8)
              + (size_t)kStages * (high ? 4 : 2) * kPass * kLDS);
}

__device__ __forceinline__ unsigned saddr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(saddr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(saddr(p)));
}
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A fragment of the 16 x 16 block at (r0, k0) of a row-major (ld) matrix.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* m, int ld, int r0,
                                       int k0, int lane) {
  ldsm_x4(a, m + (size_t)(r0 + lane % 16) * ld + k0 + (lane / 16) * 8);
}

// B fragments of NT n8 tiles from an n-major stage (rows n0 .., k0 .. k0+15).
template <int NT>
__device__ __forceinline__ void load_b(uint32_t (&b)[NT][2], const bf16* st, int n0, int k0,
                                       int lane) {
  if constexpr (NT == 1) {
    ldsm_x2(b[0], st + (n0 + lane % 8) * kLDS + k0 + ((lane / 8) % 2) * 8);
  } else {
#pragma unroll
    for (int j = 0; j < NT; j += 2) {
      uint32_t r[4];
      ldsm_x4(r, st + (n0 + j * 8 + lane % 8 + (lane / 16) * 8) * kLDS + k0 +
                     ((lane / 8) % 2) * 8);
      b[j][0] = r[0];
      b[j][1] = r[1];
      b[j + 1][0] = r[2];
      b[j + 1][1] = r[3];
    }
  }
}

// Shapes: frames (rows, n_fft) fp32; bd (Kbp / 64, 4, 64, Kf) bf16: per pass
// of 64 bins the cos, sin, cos-low and sin-low rows (n-major, samples
// contiguous, zero for samples >= n_fft and bins past the real ones; the
// low parts are read only in high mode); bm (Mp / 64, 64, Kbp) bf16: the
// filterbank transposed, zero padded; mel_k0 (Mp / 64) int: the first
// 32-bin chunk of each pass's window of ncm chunks, outside which its
// filters are zero; out (rows, n_mels) fp32; power (rows, Kbp) fp32 or
// null.
template <int TR, bool HIGH>
__global__ void __launch_bounds__(kThreads, 1)
logmel_persistent(const float* __restrict__ frames, int rows, int n_fft, int Kf, int Kbp,
                  int Mp, const bf16* __restrict__ bd, const bf16* __restrict__ bm,
                  const int* __restrict__ mel_k0, int ncm, float* __restrict__ out,
                  int n_mels, float* __restrict__ power) {
  using C = Cfg<TR, HIGH>;
  constexpr int MT = C::MT, NT = C::NT;
  // frames of one 32-sample chunk of a tile: TR x 8 float4, kAPer a thread
  constexpr int kAPer = TR * 8 >= kThreads ? TR * 8 / kThreads : 1;
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDA = Kf + 8, LDP = Kbp + 8;
  bf16* a_hi = reinterpret_cast<bf16*>(smem);                   // (TR, LDA)
  bf16* a_lo = a_hi + (size_t)TR * LDA;                         // (TR, LDA), high
  bf16* pw = a_lo + (HIGH ? (size_t)TR * LDA : 0);              // (TR, LDP)
  bf16* ring = pw + (size_t)TR * LDP;                           // kStages stages
  const int stage_elems = C::kRowsD * kLDS;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int wr = warp / C::WN, wn = warp % C::WN;
  const int g = lane / 4, tq = lane % 4;
  const int ntiles = (rows + TR - 1) / TR;
  const int my_tiles = ntiles > (int)blockIdx.x
                           ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int kcd = Kf / kKC;
  const int n_dp = Kbp / kPass, n_mp = Mp / kPass;  // DFT and mel passes
  const int n_d = n_dp * kcd, n_m = n_mp * ncm;
  const int per_tile = n_d + n_m;
  const int total = my_tiles * per_tile;

  // The ring's producer walks the stages in order: (pass, chunk) of the DFT,
  // then of the mel product, tile after tile.
  int iss = 0, iss_pass = 0, iss_kc = 0, iss_slot = 0;
  auto issue = [&]() {
    if (iss < total) {
      bf16* dst = ring + iss_slot * stage_elems;
      if (iss_pass < n_dp) {
        const bf16* src = bd + (size_t)iss_pass * 4 * kPass * Kf + iss_kc * kKC;
        for (int i = tid; i < C::kRowsD * 4; i += kThreads)
          cp16(dst + (i / 4) * kLDS + (i % 4) * 8, src + (size_t)(i / 4) * Kf + (i % 4) * 8);
      } else {
        const int q = iss_pass - n_dp;
        const bf16* src = bm + (size_t)q * kPass * Kbp + (mel_k0[q] + iss_kc) * kKC;
        for (int i = tid; i < kPass * 4; i += kThreads)
          cp16(dst + (i / 4) * kLDS + (i % 4) * 8, src + (size_t)(i / 4) * Kbp + (i % 4) * 8);
      }
      ++iss;
      iss_slot = iss_slot + 1 == kStages ? 0 : iss_slot + 1;
      if (++iss_kc == (iss_pass < n_dp ? kcd : ncm)) {
        iss_kc = 0;
        if (++iss_pass == n_dp + n_mp) iss_pass = 0;
      }
    }
    cp_commit();
  };

  // A tile's frames, fp32 -> bf16 (and the bf16 remainder in high mode), one
  // 32-sample chunk at a time, zero past n_fft and past the last row: fetched
  // into registers two stages before they are put into shared memory.
  const bool vec = n_fft % 4 == 0;
  auto a_fetch = [&](float4 (&buf)[kAPer], int tile, int chunk) {
#pragma unroll
    for (int u = 0; u < kAPer; ++u) {
      const int idx = u * kThreads + tid;  // (row, float4 of the chunk)
      const int r = idx / 8, c = chunk * kKC + (idx % 8) * 4, grow = tile * TR + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < TR && grow < rows && c < n_fft) {
        const float* p = frames + (size_t)grow * n_fft + c;
        if (vec) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = __ldg(p);
          v.y = c + 1 < n_fft ? __ldg(p + 1) : 0.0f;
          v.z = c + 2 < n_fft ? __ldg(p + 2) : 0.0f;
          v.w = c + 3 < n_fft ? __ldg(p + 3) : 0.0f;
        }
      }
      buf[u] = v;
    }
  };
  auto a_put = [&](const float4 (&buf)[kAPer], int chunk) {
#pragma unroll
    for (int u = 0; u < kAPer; ++u) {
      const int idx = u * kThreads + tid;
      const int r = idx / 8, c = chunk * kKC + (idx % 8) * 4;
      if (r < TR) {
        const float4 v = buf[u];
        const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
        const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
        uint2 hv;
        hv.x = *reinterpret_cast<const uint32_t*>(&h01);
        hv.y = *reinterpret_cast<const uint32_t*>(&h23);
        *reinterpret_cast<uint2*>(a_hi + (size_t)r * LDA + c) = hv;
        if (HIGH) {
          const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
          const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
          const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
          uint2 lv;
          lv.x = *reinterpret_cast<const uint32_t*>(&l01);
          lv.y = *reinterpret_cast<const uint32_t*>(&l23);
          *reinterpret_cast<uint2*>(a_lo + (size_t)r * LDA + c) = lv;
        }
      }
    }
  };
  // put chunk `put` (if in range) from the buffer of its parity, then fetch
  // chunk `fetch` of `tile` into it (put and fetch share their parity)
  float4 abuf0[kAPer], abuf1[kAPer];
  auto a_step = [&](int tile, int put, int fetch) {
    if ((put & 1) == 0) {
      if (put >= 0 && put < kcd) a_put(abuf0, put);
      if (fetch < kcd) a_fetch(abuf0, tile, fetch);
    } else {
      if (put >= 0 && put < kcd) a_put(abuf1, put);
      if (fetch < kcd) a_fetch(abuf1, tile, fetch);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) issue();
  if (my_tiles > 0) {  // the first tile's chunks 0 .. 2; chunk j > 0 is put at stage j - 1
    a_fetch(abuf0, blockIdx.x, 0);
    if (1 < kcd) a_fetch(abuf1, blockIdx.x, 1);
    a_put(abuf0, 0);
    if (2 < kcd) a_fetch(abuf0, blockIdx.x, 2);
  }

  const int r_w = wr * MT * 16;  // the warp's first row in the tile
  const int last_pass = (n_dp - 1) * kcd;  // the stage the last DFT pass starts at
  int slot = 0;
  for (int ti = 0; ti < my_tiles; ++ti) {
    const int tile = blockIdx.x + ti * gridDim.x;
    const int row0 = tile * TR;
    const bool next = ti + 1 < my_tiles;
    int ls = 0;  // stage within the tile
    // After the stage's barrier: the first tile's chunk ls + 1 goes in just
    // before the stage that reads it; the next tile's chunk j goes in two
    // stages after the current tile's last DFT pass read it.
    auto frames_step = [&]() {
      if (ti == 0 && ls + 1 < kcd) a_step(tile, ls + 1, ls + 3);
      if (next && ls >= last_pass) {
        const int f = ls - last_pass;
        if (f < kcd + 2) a_step(tile + gridDim.x, f - 2, f);
      }
    };

    // ---- DFT passes: re, im of 64 bins, then power into shared memory -----
    for (int p = 0; p < n_dp; ++p) {
      float re[MT][NT][4], im[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) re[m][j][e] = im[m][j][e] = 0.0f;
      for (int kc = 0; kc < kcd; ++kc, ++ls) {
        cp_wait<kStages - 2>();
        __syncthreads();  // this stage landed; every warp is done with the last one
        issue();
        frames_step();
        const bf16* st = ring + slot * stage_elems;
        slot = slot + 1 == kStages ? 0 : slot + 1;
        // the stage's products go into fresh accumulators, added to the
        // running sums after it: the tensor cores' accumulation truncates,
        // so summing all of K in one accumulator drifts with n_fft
        float sr[MT][NT][4], si[MT][NT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) sr[m][j][e] = si[m][j][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < kKC; ks += 16) {
          uint32_t ah[MT][4], al[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m) {
            load_a(ah[m], a_hi, LDA, r_w + m * 16, kc * kKC + ks, lane);
            if (HIGH) load_a(al[m], a_lo, LDA, r_w + m * 16, kc * kKC + ks, lane);
          }
          uint32_t bc[NT][2], bs[NT][2];
          load_b<NT>(bc, st, wn * NT * 8, ks, lane);
          load_b<NT>(bs, st, kPass + wn * NT * 8, ks, lane);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j) {
              mma(sr[m][j], ah[m], bc[j]);
              mma(si[m][j], ah[m], bs[j]);
              if (HIGH) {
                mma(sr[m][j], al[m], bc[j]);
                mma(si[m][j], al[m], bs[j]);
              }
            }
          if (HIGH) {
            load_b<NT>(bc, st, 2 * kPass + wn * NT * 8, ks, lane);
            load_b<NT>(bs, st, 3 * kPass + wn * NT * 8, ks, lane);
#pragma unroll
            for (int m = 0; m < MT; ++m)
#pragma unroll
              for (int j = 0; j < NT; ++j) {
                mma(sr[m][j], ah[m], bc[j]);
                mma(si[m][j], ah[m], bs[j]);
              }
          }
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              re[m][j][e] += sr[m][j][e];
              im[m][j][e] += si[m][j][e];
            }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m16 tile
            const int r = r_w + m * 16 + g + 8 * h;
            const int bin = p * kPass + wn * NT * 8 + j * 8 + 2 * tq;
            const float p0 = re[m][j][2 * h] * re[m][j][2 * h] + im[m][j][2 * h] * im[m][j][2 * h];
            const float p1 = re[m][j][2 * h + 1] * re[m][j][2 * h + 1]
                             + im[m][j][2 * h + 1] * im[m][j][2 * h + 1];
            *reinterpret_cast<__nv_bfloat162*>(pw + (size_t)r * LDP + bin) =
                __floats2bfloat162_rn(p0, p1);
            if (power != nullptr && row0 + r < rows)
              *reinterpret_cast<float2*>(power + (size_t)(row0 + r) * Kbp + bin) =
                  make_float2(p0, p1);
          }
    }

    // ---- mel passes: log1p(power @ fb) of 64 filters over their window ----
    for (int q = 0; q < n_mp; ++q) {
      const int k0 = mel_k0[q] * kKC;
      float acc[MT][NT][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.0f;
      for (int kc = 0; kc < ncm; ++kc, ++ls) {
        cp_wait<kStages - 2>();
        __syncthreads();
        issue();
        frames_step();
        const bf16* st = ring + slot * stage_elems;
        slot = slot + 1 == kStages ? 0 : slot + 1;
#pragma unroll
        for (int ks = 0; ks < kKC; ks += 16) {
          uint32_t a[MT][4];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            load_a(a[m], pw, LDP, r_w + m * 16, k0 + kc * kKC + ks, lane);
          uint32_t b[NT][2];
          load_b<NT>(b, st, wn * NT * 8, ks, lane);
#pragma unroll
          for (int m = 0; m < MT; ++m)
#pragma unroll
            for (int j = 0; j < NT; ++j) mma(acc[m][j], a[m], b[j]);
        }
      }
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int grow = row0 + r_w + m * 16 + g + 8 * (e / 2);
            const int f = q * kPass + wn * NT * 8 + j * 8 + 2 * tq + e % 2;
            if (grow < rows && f < n_mels) out[(size_t)grow * n_mels + f] = log1pf(acc[m][j][e]);
          }
    }
  }
  cp_wait<0>();
}

template <int TR, bool HIGH>
int launch(const void* frames, int rows, int n_fft, int Kf, int Kbp, int Mp,
           const void* bd, const void* bm, const void* mel_k0, int ncm, void* out,
           int n_mels, void* power, int grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(TR, Kf, Kbp, HIGH);
  cudaError_t err = cudaFuncSetAttribute(logmel_persistent<TR, HIGH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (rows + TR - 1) / TR;
  logmel_persistent<TR, HIGH><<<grid < ntiles ? grid : ntiles, kThreads, smem, stream>>>(
      static_cast<const float*>(frames), rows, n_fft, Kf, Kbp, Mp,
      static_cast<const bf16*>(bd), static_cast<const bf16*>(bm),
      static_cast<const int*>(mel_k0), ncm, static_cast<float*>(out), n_mels,
      static_cast<float*>(power));
  return (int)cudaGetLastError();
}

template <bool HIGH>
int launch_rows(int tile_rows, const void* frames, int rows, int n_fft, int Kf, int Kbp,
                int Mp, const void* bd, const void* bm, const void* k0, int ncm, void* out,
                int n_mels, void* power, int grid, cudaStream_t s) {
  switch (tile_rows) {
    case 32:
      return launch<32, HIGH>(frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, k0, ncm, out,
                              n_mels, power, grid, s);
    case 16:
      return launch<16, HIGH>(frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, k0, ncm, out,
                              n_mels, power, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// The wgmma engine: 64-row slabs of frames, one consumer warpgroup each.
// ---------------------------------------------------------------------------
namespace wg {

constexpr int kStages = 3;                       // ring depth (2 slower, 4 and 6 no faster)
constexpr int kPartBytes = 2 * kPass * kKC * 2;  // 128 B rows x 32 samples, bf16
constexpr int kMelBytes = kPass * kKC * 2;       // 64 filters x 32 bins, bf16
constexpr int kStageSbo = kKC * 16;              // bytes from one 8-row group to the next

__host__ __device__ inline size_t smem_bytes(int nwg, int Kf, int Kbp, bool high) {
  return 128 + (size_t)kStages * (high ? 2 : 1) * kPartBytes
         + (size_t)nwg * 2 * ((high ? 2 : 1) * 64 * (size_t)Kf + 64 * (size_t)Kbp);
}

// A shared-memory matrix descriptor of a K-major bf16 operand without
// swizzle: 8 x 8 core matrices of 128 contiguous bytes, the next 8 K 128
// bytes on (LBO), the next 8 rows sbo bytes on (SBO).
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t sbo) {
  return (uint64_t)((saddr(p) & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(sbo >> 4) << 32);
}

// d (64 x 128, fp32, the m64n128 fragment layout) += A (64 x 16) B (128 x 16)^T,
// A and B read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46,"
      "%47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32, the m64n64 fragment layout) += A (64 x 16) B (64 x 16)^T,
// A and B read from shared memory through their descriptors.
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16,"
      "%17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// generic-proxy stores to shared memory made visible to wgmma's reads
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wg_bar(int w) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* b, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(saddr(b)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* b, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(saddr(b)), "r"(parity)
        : "memory");
  } while (!done);
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(saddr(b)) : "memory");
}
// the copy of `bytes` contiguous bytes, completing on barrier b's phase
__device__ __forceinline__ void bulk_load(void* dst, const void* src, unsigned bytes,
                                          uint64_t* b) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(saddr(b)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(saddr(dst)), "l"(src), "r"(bytes), "r"(saddr(b))
      : "memory");
}

// Shapes: frames (rows, n_fft) fp32; bd (Kbp / 64, Kf / 32, 2, 16, 4, 8, 8)
// bf16: per DFT pass p and 32-sample chunk c two parts (the bf16 values and,
// read only in high mode, their bf16 low parts), each 128 B rows (cos of
// bins 0-31 of the pass, sin of 0-31, cos of 32-63, sin of 32-63) x 32
// samples in 8 x 8 core matrices (row group, sample group, row, sample); bm
// (Mp / 64, Kbp / 32, 8, 4, 8, 8) bf16: per mel pass q and 32-bin chunk the
// 64 filters x 32 bins alike; mel_k0, ncm, out, power as for the mma.sync
// engine.  NWG consumer warpgroups each own 64 rows of a tile (their bf16
// frames, low parts in high mode, and power stay in the warpgroup's own
// shared memory, so the warpgroups meet only at the ring); one more warp
// feeds the ring with bulk copies on mbarriers.
template <int NWG, bool HIGH>
__global__ void __launch_bounds__(NWG * 128 + 32, 1)
logmel_wgmma(const float* __restrict__ frames, int rows, int n_fft, int Kf, int Kbp, int Mp,
             const bf16* __restrict__ bd, const bf16* __restrict__ bm,
             const int* __restrict__ mel_k0, int ncm, float* __restrict__ out, int n_mels,
             float* __restrict__ power) {
  constexpr int TR = 64 * NWG;
  constexpr unsigned kSlot = (HIGH ? 2 : 1) * kPartBytes;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kStages;
  unsigned char* ring = smem + 128;
  bf16* slabs = reinterpret_cast<bf16*>(ring + kStages * kSlot);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ntiles = (rows + TR - 1) / TR;
  const int my_tiles = ntiles > (int)blockIdx.x
                           ? (ntiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int kcd = Kf / kKC, cpb = Kbp / kKC;
  const int n_dp = Kbp / kPass, n_mp = Mp / kPass;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, 4 * NWG);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * NWG) {  // the producer: (pass, chunk) of the DFT, then of the mel product
    if (lane == 0) {
      int slot = 0;
      unsigned round = 0;
      auto next = [&]() {
        if (++slot == kStages) { slot = 0; round ^= 1; }
      };
      for (int ti = 0; ti < my_tiles; ++ti) {
        for (int p = 0; p < n_dp; ++p)
          for (int c = 0; c < kcd; ++c, next()) {
            mbar_wait(empty + slot, round ^ 1);
            bulk_load(ring + slot * kSlot, bd + ((size_t)p * kcd + c) * (2 * kPartBytes / 2), kSlot,
                      full + slot);
          }
        for (int q = 0; q < n_mp; ++q)
          for (int c = 0; c < ncm; ++c, next()) {
            mbar_wait(empty + slot, round ^ 1);
            bulk_load(ring + slot * kSlot,
                      bm + ((size_t)q * cpb + mel_k0[q] + c) * (kMelBytes / 2), kMelBytes,
                      full + slot);
          }
      }
    }
    return;
  }

  // ---- a consumer warpgroup: rows w * 64 .. w * 64 + 63 of each tile ----
  const int w = warp / 4, wt = tid % 128, wi = warp % 4;
  const int g = lane / 4, tq = lane % 4;
  bf16* a_hi = slabs + (size_t)w * ((HIGH ? 2 : 1) * 64 * Kf + 64 * Kbp);  // (8, Kf / 8, 8, 8)
  bf16* a_lo = a_hi + 64 * Kf;                                             // high mode
  bf16* pw = a_hi + (HIGH ? 2 : 1) * 64 * Kf;                              // (8, Kbp / 8, 8, 8)
  const uint32_t sbo_a = Kf * 16, sbo_p = Kbp * 16;

  // a 32-sample chunk of the slab's frames: 64 rows x 8 float4, 4 a thread;
  // lanes walk 8 rows x 4 float4 so the bf16 stores spread over the banks
  const bool vec = n_fft % 4 == 0;
  auto a_fetch = [&](float4 (&buf)[4], int tile, int chunk) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = u * 128 + wt;
      const int r = (idx / 64) * 8 + idx % 8, c = chunk * kKC + ((idx / 8) % 8) * 4;
      const int grow = tile * TR + w * 64 + r;
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (grow < rows && c < n_fft) {
        const float* src = frames + (size_t)grow * n_fft + c;
        if (vec) {
          v = __ldg(reinterpret_cast<const float4*>(src));
        } else {
          v.x = __ldg(src);
          v.y = c + 1 < n_fft ? __ldg(src + 1) : 0.0f;
          v.z = c + 2 < n_fft ? __ldg(src + 2) : 0.0f;
          v.w = c + 3 < n_fft ? __ldg(src + 3) : 0.0f;
        }
      }
      buf[u] = v;
    }
  };
  auto a_put = [&](const float4 (&buf)[4], int chunk) {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int idx = u * 128 + wt;
      const int r = (idx / 64) * 8 + idx % 8, c = chunk * kKC + ((idx / 8) % 8) * 4;
      const size_t off = (size_t)(r / 8) * Kf * 8 + (c / 8) * 64 + (r % 8) * 8 + c % 8;
      const float4 v = buf[u];
      const __nv_bfloat162 h01 = __floats2bfloat162_rn(v.x, v.y);
      const __nv_bfloat162 h23 = __floats2bfloat162_rn(v.z, v.w);
      uint2 hv;
      hv.x = *reinterpret_cast<const uint32_t*>(&h01);
      hv.y = *reinterpret_cast<const uint32_t*>(&h23);
      *reinterpret_cast<uint2*>(a_hi + off) = hv;
      if (HIGH) {
        const float2 f01 = __bfloat1622float2(h01), f23 = __bfloat1622float2(h23);
        const __nv_bfloat162 l01 = __floats2bfloat162_rn(v.x - f01.x, v.y - f01.y);
        const __nv_bfloat162 l23 = __floats2bfloat162_rn(v.z - f23.x, v.w - f23.y);
        uint2 lv;
        lv.x = *reinterpret_cast<const uint32_t*>(&l01);
        lv.y = *reinterpret_cast<const uint32_t*>(&l23);
        *reinterpret_cast<uint2*>(a_lo + off) = lv;
      }
    }
  };
  // put chunk `put` (if in range) from the buffer of its parity, then fetch
  // chunk `fetch` of `tile` into it
  float4 abuf0[4], abuf1[4];
  auto a_step = [&](int tile, int put, int fetch) {
    if ((put & 1) == 0) {
      if (put >= 0 && put < kcd) a_put(abuf0, put);
      if (fetch < kcd) a_fetch(abuf0, tile, fetch);
    } else {
      if (put >= 0 && put < kcd) a_put(abuf1, put);
      if (fetch < kcd) a_fetch(abuf1, tile, fetch);
    }
  };
  if (my_tiles > 0) {  // the first tile's frames, two chunks in flight
    a_fetch(abuf0, blockIdx.x, 0);
    if (1 < kcd) a_fetch(abuf1, blockIdx.x, 1);
    for (int c = 0; c < kcd; ++c) a_step(blockIdx.x, c, c + 2);
  }

  int slot = 0, held = -1;  // held: the slot whose products may still be running
  unsigned round = 0;
  // after a stage's products are issued: wait for the stage before, give its
  // slot back (one arrival per warp), and step the ring
  auto retire = [&]() {
    wg_wait<1>();
    if (held >= 0 && lane == 0) mbar_arrive(empty + held);
    held = slot;
    if (++slot == kStages) { slot = 0; round ^= 1; }
  };
  auto drain = [&]() {
    wg_wait<0>();
    if (held >= 0 && lane == 0) mbar_arrive(empty + held);
    held = -1;
  };

  const int last_pass = (n_dp - 1) * kcd;  // the stage the last DFT pass starts at
  for (int ti = 0; ti < my_tiles; ++ti) {
    const int tile = blockIdx.x + ti * gridDim.x;
    const int row0 = tile * TR + w * 64;
    const bool next = ti + 1 < my_tiles;
    fence_async();
    wg_bar(w);  // the tile's frames are in; the last tile's mel products read their power
    int ls = 0;  // stage within the tile
    // the next tile's chunk j goes in two stages after this tile's last DFT
    // pass read it (the stage before the current one is done by then)
    auto frames_step = [&]() {
      if (next && ls >= last_pass) {
        const int f = ls - last_pass;
        if (f < kcd + 2) a_step(tile + gridDim.x, f - 2, f);
      }
    };

    // ---- DFT passes: re, im of 64 bins, then power into shared memory -----
    for (int p = 0; p < n_dp; ++p) {
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
      for (int c = 0; c < kcd; ++c, ++ls) {
        mbar_wait(full + slot, round);
        const unsigned char* st = ring + slot * kSlot;
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int ka = (c * 4 + ks * 2) * 64;  // the chunk's k16 step in the slab
          const uint64_t da = desc(a_hi + ka, sbo_a);
          const uint64_t db = desc(st + ks * 256, kStageSbo);
          wgmma_n128(acc, da, db, 1);
          if (HIGH) {
            wgmma_n128(acc, desc(a_lo + ka, sbo_a), db, 1);
            wgmma_n128(acc, da, desc(st + kPartBytes + ks * 256, kStageSbo), 1);
          }
        }
        wg_commit();
        retire();
        frames_step();
      }
      drain();
      fence_acc(acc);
      // n8 tile j holds cos (j % 8 < 4) or sin (j % 8 >= 4) of bins
      // 32 (j / 8) + 8 (j % 4) + 2 tq, + 1 in rows g and g + 8 of the warp's 16
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int jr = hb * 8 + j, ji = jr + 4;
            const int r = wi * 16 + g + 8 * h;
            const int bin = p * kPass + hb * 32 + 8 * j + 2 * tq;
            const float p0 = acc[4 * jr + 2 * h] * acc[4 * jr + 2 * h]
                             + acc[4 * ji + 2 * h] * acc[4 * ji + 2 * h];
            const float p1 = acc[4 * jr + 2 * h + 1] * acc[4 * jr + 2 * h + 1]
                             + acc[4 * ji + 2 * h + 1] * acc[4 * ji + 2 * h + 1];
            *reinterpret_cast<__nv_bfloat162*>(
                pw + (size_t)(r / 8) * Kbp * 8 + (bin / 8) * 64 + (r % 8) * 8 + bin % 8) =
                __floats2bfloat162_rn(p0, p1);
            if (power != nullptr && row0 + r < rows)
              *reinterpret_cast<float2*>(power + (size_t)(row0 + r) * Kbp + bin) =
                  make_float2(p0, p1);
          }
    }
    fence_async();
    wg_bar(w);  // the slab's power is in

    // ---- mel passes: log1p(power @ fb) of 64 filters over their window ----
    for (int q = 0; q < n_mp; ++q) {
      const int k0 = mel_k0[q] * kKC;
      float acc[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = 0.0f;
      for (int c = 0; c < ncm; ++c, ++ls) {
        mbar_wait(full + slot, round);
        const unsigned char* st = ring + slot * kSlot;
        fence_acc(acc);
        wg_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks)
          wgmma_n64(acc, desc(pw + ((k0 + c * kKC + ks * 16) / 8) * 64, sbo_p),
                    desc(st + ks * 256, kStageSbo), 1);
        wg_commit();
        retire();
        frames_step();
      }
      drain();
      fence_acc(acc);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int grow = row0 + wi * 16 + g + 8 * (e / 2);
          const int f = q * kPass + 8 * j + 2 * tq + e % 2;
          if (grow < rows && f < n_mels) out[(size_t)grow * n_mels + f] = log1pf(acc[4 * j + e]);
        }
    }
  }
}

template <int NWG, bool HIGH>
int launch(const void* frames, int rows, int n_fft, int Kf, int Kbp, int Mp, const void* bd,
           const void* bm, const void* mel_k0, int ncm, void* out, int n_mels, void* power,
           int grid, cudaStream_t stream) {
  const size_t smem = smem_bytes(NWG, Kf, Kbp, HIGH);
  cudaError_t err = cudaFuncSetAttribute(logmel_wgmma<NWG, HIGH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int ntiles = (rows + 64 * NWG - 1) / (64 * NWG);
  logmel_wgmma<NWG, HIGH><<<grid < ntiles ? grid : ntiles, NWG * 128 + 32, smem, stream>>>(
      static_cast<const float*>(frames), rows, n_fft, Kf, Kbp, Mp,
      static_cast<const bf16*>(bd), static_cast<const bf16*>(bm),
      static_cast<const int*>(mel_k0), ncm, static_cast<float*>(out), n_mels,
      static_cast<float*>(power));
  return (int)cudaGetLastError();
}

template <bool HIGH>
int launch_rows(int tile_rows, const void* frames, int rows, int n_fft, int Kf, int Kbp,
                int Mp, const void* bd, const void* bm, const void* k0, int ncm, void* out,
                int n_mels, void* power, int grid, cudaStream_t s) {
  switch (tile_rows) {
    case 128:
      return launch<2, HIGH>(frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, k0, ncm, out, n_mels,
                             power, grid, s);
    case 64:
      return launch<1, HIGH>(frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, k0, ncm, out, n_mels,
                             power, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace wg

// ---------------------------------------------------------------------------
// The chunked engine (namespace wide), for windows whose tile of frames does
// not fit the shared memory at all (n_fft above ~3500, ~2200 in high mode,
// on an H100): two launches that hold only K chunks.
//   * dft_chunked: a block per 32 frame rows and DFT pass of 64 bins walks
//     the sample axis 32 values at a time: the chunk's frames (split into
//     bf16 high and low parts in high mode) and its cos / sin rows of the
//     pass (and their low parts) go into shared memory, ldmatrix +
//     mma.sync m16n8k16 accumulate re and im in fp32 registers; then
//     power = re^2 + im^2 is written to global memory rounded to bf16 (and
//     in fp32 where the caller asks for it);
//   * mel_chunked: a block per 32 rows and mel pass of 64 filters walks its
//     pass's window of 32-bin chunks of that power with the filterbank, then
//     log1p and the store of the real rows and filters.
// Shared memory is the same for every n_fft (wide::kSmem).
// ---------------------------------------------------------------------------

namespace wide {

constexpr int kRows = 32;       // frame rows of a block
constexpr int kWideThreads = 128;  // 4 warps: 2 along rows x 2 along bins / filters

__host__ __device__ constexpr size_t smem_bytes() {
  return 2 * ((size_t)2 * kRows * kLDS + (size_t)4 * kPass * kLDS);
}

// Shapes as logmel_rows's; pw (rows, Kbp) bf16 receives the power rounded
// to bf16, power (rows, Kbp) fp32 (or null) the power before rounding.
template <bool HIGH>
__global__ void __launch_bounds__(kWideThreads)
dft_chunked(const float* __restrict__ frames, int rows, int n_fft, int Kf, int Kbp,
            const bf16* __restrict__ bd, bf16* __restrict__ pw, float* __restrict__ power) {
  __shared__ __align__(16) bf16 fh[kRows * kLDS];
  __shared__ __align__(16) bf16 fl[kRows * kLDS];
  __shared__ __align__(16) bf16 st[4 * kPass * kLDS];  // cos, sin, cos-low, sin-low
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * kRows, p = blockIdx.y;
  const int wr = (warp % 2) * 16, wn = (warp / 2) * 32;
  constexpr int NQ = HIGH ? 4 : 2;
  float re[4][4] = {}, im[4][4] = {};

  for (int k0 = 0; k0 < Kf; k0 += kKC) {
    __syncthreads();  // the chunk before is no longer read
    for (int i = threadIdx.x; i < NQ * kPass * 4; i += kWideThreads) {
      const int row = i / 4, q16 = i % 4;
      cp16(st + row * kLDS + 8 * q16,
           bd + ((size_t)(p * 4 + row / kPass) * kPass + row % kPass) * Kf + k0 + 8 * q16);
    }
    cp_commit();
    for (int i = threadIdx.x; i < kRows * kKC; i += kWideThreads) {
      const int r = i / kKC, k = i % kKC;
      const float x = (r0 + r < rows && k0 + k < n_fft)
                          ? frames[(size_t)(r0 + r) * n_fft + k0 + k] : 0.0f;
      const bf16 h = __float2bfloat16(x);
      fh[r * kLDS + k] = h;
      if (HIGH) fl[r * kLDS + k] = __float2bfloat16(x - __bfloat162float(h));
    }
    cp_wait<0>();
    __syncthreads();
    // the chunk's products into fresh accumulators, then added to the
    // running sums (the tensor cores' accumulation truncates)
    float sr[4][4] = {}, si[4][4] = {};
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      uint32_t ah[4], al[4], bc[4][2], bs[4][2];
      load_a(ah, fh, kLDS, wr, ks, lane);
      load_b<4>(bc, st, wn, ks, lane);
      load_b<4>(bs, st + kPass * kLDS, wn, ks, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma(sr[j], ah, bc[j]);
        mma(si[j], ah, bs[j]);
      }
      if (HIGH) {
        uint32_t bcl[4][2], bsl[4][2];
        load_a(al, fl, kLDS, wr, ks, lane);
        load_b<4>(bcl, st + 2 * kPass * kLDS, wn, ks, lane);
        load_b<4>(bsl, st + 3 * kPass * kLDS, wn, ks, lane);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          mma(sr[j], ah, bcl[j]);
          mma(si[j], ah, bsl[j]);
          mma(sr[j], al, bc[j]);
          mma(si[j], al, bs[j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        re[j][e] += sr[j][e];
        im[j][e] += si[j][e];
      }
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + wr + g + (e / 2) * 8;
      const int bin = p * kPass + wn + 8 * j + 2 * t + e % 2;
      if (row >= rows) continue;
      const float v = re[j][e] * re[j][e] + im[j][e] * im[j][e];
      pw[(size_t)row * Kbp + bin] = __float2bfloat16(v);
      if (power != nullptr) power[(size_t)row * Kbp + bin] = v;
    }
}

// pw (rows, Kbp) bf16 from dft_chunked; bm, mel_k0, ncm, out as
// logmel_rows's.
__global__ void __launch_bounds__(kWideThreads)
mel_chunked(const bf16* __restrict__ pw, int rows, int Kbp, const bf16* __restrict__ bm,
            const int* __restrict__ mel_k0, int ncm, float* __restrict__ out, int n_mels) {
  __shared__ __align__(16) bf16 pa[kRows * kLDS];
  __shared__ __align__(16) bf16 st[kPass * kLDS];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int r0 = blockIdx.x * kRows, q = blockIdx.y;
  const int wr = (warp % 2) * 16, wn = (warp / 2) * 32;
  float acc[4][4] = {};
  const int c0 = mel_k0[q];

  for (int c = c0; c < c0 + ncm; ++c) {
    const int k0 = c * kKC;
    __syncthreads();
    for (int i = threadIdx.x; i < (kRows + kPass) * 4; i += kWideThreads) {
      const int row = i / 4, q16 = i % 4;
      if (row < kRows) {
        bf16* dst = pa + row * kLDS + 8 * q16;
        if (r0 + row < rows)
          cp16(dst, pw + (size_t)(r0 + row) * Kbp + k0 + 8 * q16);
        else
          *reinterpret_cast<int4*>(dst) = make_int4(0, 0, 0, 0);
      } else {
        const int n = row - kRows;
        cp16(st + n * kLDS + 8 * q16, bm + ((size_t)q * kPass + n) * Kbp + k0 + 8 * q16);
      }
    }
    cp_commit();
    cp_wait<0>();
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kKC; ks += 16) {
      uint32_t a[4], b[4][2];
      load_a(a, pa, kLDS, wr, ks, lane);
      load_b<4>(b, st, wn, ks, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) mma(acc[j], a, b[j]);
    }
  }

  const int g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + wr + g + (e / 2) * 8;
      const int f = q * kPass + wn + 8 * j + 2 * t + e % 2;
      if (row < rows && f < n_mels) out[(size_t)row * n_mels + f] = log1pf(acc[j][e]);
    }
}

template <bool HIGH>
int launch(const void* frames, int rows, int n_fft, int Kf, int Kbp, int Mp, const void* bd,
           const void* bm, const void* mel_k0, int ncm, void* out, int n_mels, void* power,
           void* pw, cudaStream_t stream) {
  const dim3 grid_d((rows + kRows - 1) / kRows, Kbp / kPass);
  dft_chunked<HIGH><<<grid_d, kWideThreads, 0, stream>>>(
      static_cast<const float*>(frames), rows, n_fft, Kf, Kbp, static_cast<const bf16*>(bd),
      static_cast<bf16*>(pw), static_cast<float*>(power));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid_m((rows + kRows - 1) / kRows, Mp / kPass);
  mel_chunked<<<grid_m, kWideThreads, 0, stream>>>(
      static_cast<const bf16*>(pw), rows, Kbp, static_cast<const bf16*>(bm),
      static_cast<const int*>(mel_k0), ncm, static_cast<float*>(out), n_mels);
  return (int)cudaGetLastError();
}

}  // namespace wide

}  // namespace

// One launch over all rows on `stream`, no sync: a persistent grid of at
// most `grid` blocks (one per SM).  engine 1 is the wgmma engine, walking
// tiles of tile_rows = 128 or 64 rows (two or one consumer warpgroups), with
// bd and bm in its core-matrix layout (see logmel_wgmma); engine 0 the
// mma.sync engine, tiles of 32 or 16 rows, bd and bm n-major (see
// logmel_persistent).  frames (rows, n_fft) fp32; Kf = n_fft rounded up to
// 32, Kbp the bins (n_fft / 2 + 1) and Mp the filters rounded up to 64;
// mel_k0 (Mp / 64) int and ncm the mel passes' windows of 32-bin chunks; out
// (rows, n_mels) fp32; power (rows, Kbp) fp32 or null.  Returns 0 or the
// cudaError_t met.
extern "C" int logmel_rows(const void* frames, int rows, int n_fft, int Kf, int Kbp, int Mp,
                           const void* bd, const void* bm, const void* mel_k0, int ncm,
                           void* out, int n_mels, void* power, int high, int tile_rows,
                           int engine, int grid, void* stream) {
  if (rows <= 0) return 0;
  if (Kf % kKC != 0 || Kf < n_fft || Kbp % kPass != 0 || Kbp < n_fft / 2 + 1 || Kbp < 2 * kPass
      || Mp % kPass != 0 || n_mels <= 0 || Mp < n_mels || grid <= 0 || ncm < 1
      || ncm > Kbp / kKC || (engine != 0 && engine != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (engine == 1) {
    if (high)
      return wg::launch_rows<true>(tile_rows, frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, mel_k0,
                                   ncm, out, n_mels, power, grid, s);
    return wg::launch_rows<false>(tile_rows, frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, mel_k0,
                                  ncm, out, n_mels, power, grid, s);
  }
  if (high)
    return launch_rows<true>(tile_rows, frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, mel_k0,
                             ncm, out, n_mels, power, grid, s);
  return launch_rows<false>(tile_rows, frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, mel_k0,
                            ncm, out, n_mels, power, grid, s);
}

// The chunked engine (any n_fft): two launches on `stream`, no sync, of
// the DFT power into pw (rows, Kbp) bf16 scratch and of the mel product
// from it.  Arguments otherwise as logmel_rows's, with bd and bm n-major.
extern "C" int logmel_rows_chunked(const void* frames, int rows, int n_fft, int Kf, int Kbp,
                                   int Mp, const void* bd, const void* bm,
                                   const void* mel_k0, int ncm, void* out, int n_mels,
                                   void* power, void* pw, int high, void* stream) {
  if (rows <= 0) return 0;
  if (Kf % kKC != 0 || Kf < n_fft || Kbp % kPass != 0 || Kbp < n_fft / 2 + 1
      || Mp % kPass != 0 || n_mels <= 0 || Mp < n_mels || ncm < 1 || ncm > Kbp / kKC)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (high)
    return wide::launch<true>(frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, mel_k0, ncm, out,
                              n_mels, power, pw, s);
  return wide::launch<false>(frames, rows, n_fft, Kf, Kbp, Mp, bd, bm, mel_k0, ncm, out,
                             n_mels, power, pw, s);
}

// Shared memory of one block, for the wrapper's choice of engine and
// tile_rows (engine 2, the chunked engine: its static shared memory).
extern "C" int logmel_smem(int tile_rows, int Kf, int Kbp, int high, int engine) {
  if (engine == 2) return (int)wide::smem_bytes();
  if (engine == 1) return (int)wg::smem_bytes(tile_rows / 64, Kf, Kbp, high != 0);
  return (int)smem_bytes(tile_rows, Kf, Kbp, high != 0);
}
