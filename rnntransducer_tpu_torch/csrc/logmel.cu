// Fused log-mel of framed audio, written by hand for Hopper (sm_90a).
//
// Replaces the TPU kernel
// rnntransducer_tpu/frontend/pallas_frontend.py::_logmel_kernel (called by
// logmel_pallas).  Semantics kept exactly, per row of n_fft samples:
//   re = frame @ Wc, im = frame @ Ws   (the windowed DFT, bins padded to 256)
//   power = re^2 + im^2
//   out = log1p(power @ Fb)            (the HTK filterbank, padded to 128)
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
// Design (simple first):
//   * one block of 8 warps per tile of 64 frame rows; the rows are staged in
//     shared memory as bf16 (and their bf16 remainders in high mode);
//   * the DFT runs on the tensor cores through WMMA (16 x 16 x 16 bf16
//     tiles, fp32 accumulators): warp w owns rows 16 (w % 4) .. + 16 and
//     bins 128 (w / 4) .. + 128 of both re and im, 16 accumulator tiles;
//     the cos / sin matrices stream through shared memory 16 samples at a
//     time, all warps sharing each chunk;
//   * power is formed in the accumulators, rounded to bf16 into shared
//     memory (over the frames, which are no longer needed), the filterbank
//     is staged beside it, and the mel product runs on the tensor cores too;
//     each warp owns 16 rows x 64 filters of it;
//   * log1p and the store of the n_mels real filters of the rows < rows
//     go through a per-warp 16 x 16 fp32 scratch tile.
// Framing stays outside the kernel, as in the JAX package; fusing it in,
// TMA loads and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kTileRows = 64;  // frame rows per block
constexpr int kBins = 256;     // DFT bins, padded
constexpr int kMels = 128;     // mel filters, padded
constexpr int kKs = 16;        // K of one tensor-core step

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Shared memory layout: region A holds the bf16 frames (and their
// remainders in high mode) during the DFT, then the bf16 power (64, 256)
// and the filterbank (256, 128); then the DFT chunk (2 or 4 matrices of
// (16, 256) bf16); then one (16, 16) fp32 scratch tile per warp.
__host__ __device__ inline size_t region_a_bytes(int Kf, bool high) {
  const size_t frames = (size_t)(high ? 2 : 1) * kTileRows * Kf * 2;
  const size_t mel = (size_t)kTileRows * kBins * 2 + (size_t)kBins * kMels * 2;
  const size_t a = frames > mel ? frames : mel;
  return (a + 127) / 128 * 128;
}

__host__ __device__ inline size_t chunk_bytes(bool high) {
  return (size_t)(high ? 4 : 2) * kKs * kBins * 2;
}

__host__ __device__ inline size_t smem_bytes(int Kf, bool high) {
  return region_a_bytes(Kf, high) + chunk_bytes(high) + (size_t)kWarps * 256 * 4;
}

// Shapes: frames (rows, n_fft) fp32; cos_* / sin_* (Kf, 256) bf16, zero for
// samples >= n_fft and bins past the real ones; fb (256, 128) bf16; out
// (rows, n_mels) fp32; power_out (rows, 256) fp32 or null.
template <bool kHigh>
__global__ void __launch_bounds__(kThreads)
logmel_tile(const float* __restrict__ frames, int rows, int n_fft, int Kf,
            const __nv_bfloat16* __restrict__ cos_hi,
            const __nv_bfloat16* __restrict__ sin_hi,
            const __nv_bfloat16* __restrict__ cos_lo,
            const __nv_bfloat16* __restrict__ sin_lo,
            const __nv_bfloat16* __restrict__ fb, float* __restrict__ out,
            int n_mels, float* __restrict__ power_out) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* fr_hi = reinterpret_cast<__nv_bfloat16*>(smem);  // (64, Kf)
  __nv_bfloat16* fr_lo = fr_hi + (size_t)kTileRows * Kf;          // (64, Kf)
  __nv_bfloat16* pw = reinterpret_cast<__nv_bfloat16*>(smem);     // (64, 256)
  __nv_bfloat16* fb_s = pw + kTileRows * kBins;                    // (256, 128)
  __nv_bfloat16* chunk =
      reinterpret_cast<__nv_bfloat16*>(smem + region_a_bytes(Kf, kHigh));
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* scratch = reinterpret_cast<float*>(
                       smem + region_a_bytes(Kf, kHigh) + chunk_bytes(kHigh))
                   + warp * 256;
  const int row0 = blockIdx.x * kTileRows;

  for (int idx = threadIdx.x; idx < kTileRows * Kf; idx += kThreads) {
    const int r = idx / Kf;
    const int k = idx - r * Kf;
    const int row = row0 + r;
    const float v = (row < rows && k < n_fft) ? frames[(size_t)row * n_fft + k] : 0.0f;
    const __nv_bfloat16 h = __float2bfloat16(v);
    fr_hi[idx] = h;
    if (kHigh) fr_lo[idx] = __float2bfloat16(v - __bfloat162float(h));
  }

  // ---- DFT: re, im (64, 256) in fp32 accumulators --------------------------
  const int rt = warp % 4;  // row tile of this warp
  const int ch = warp / 4;  // half of the bins (DFT) / of the filters (mel)
  FragC re[8], im[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    wmma::fill_fragment(re[c], 0.0f);
    wmma::fill_fragment(im[c], 0.0f);
  }
  constexpr int kMats = kHigh ? 4 : 2;
  constexpr int kVecPerMat = kKs * kBins / 8;  // int4 of 8 bf16
  for (int k0 = 0; k0 < Kf; k0 += kKs) {
    __syncthreads();  // frames staged / the previous chunk consumed
    for (int i = threadIdx.x; i < kMats * kVecPerMat; i += kThreads) {
      const int m = i / kVecPerMat;
      const __nv_bfloat16* src =
          m == 0 ? cos_hi : m == 1 ? sin_hi : m == 2 ? cos_lo : sin_lo;
      const int4* row = reinterpret_cast<const int4*>(src + (size_t)k0 * kBins);
      reinterpret_cast<int4*>(chunk)[i] = __ldg(row + (i - m * kVecPerMat));
    }
    __syncthreads();
    FragA a_hi, a_lo;
    wmma::load_matrix_sync(a_hi, fr_hi + (size_t)rt * 16 * Kf + k0, Kf);
    if (kHigh) wmma::load_matrix_sync(a_lo, fr_lo + (size_t)rt * 16 * Kf + k0, Kf);
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int col = ch * 128 + c * 16;
      FragB b;
      wmma::load_matrix_sync(b, chunk + col, kBins);  // cos, high part
      wmma::mma_sync(re[c], a_hi, b, re[c]);
      if (kHigh) {
        wmma::mma_sync(re[c], a_lo, b, re[c]);
        wmma::load_matrix_sync(b, chunk + 2 * kKs * kBins + col, kBins);  // cos, low
        wmma::mma_sync(re[c], a_hi, b, re[c]);
      }
      wmma::load_matrix_sync(b, chunk + kKs * kBins + col, kBins);  // sin, high part
      wmma::mma_sync(im[c], a_hi, b, im[c]);
      if (kHigh) {
        wmma::mma_sync(im[c], a_lo, b, im[c]);
        wmma::load_matrix_sync(b, chunk + 3 * kKs * kBins + col, kBins);  // sin, low
        wmma::mma_sync(im[c], a_hi, b, im[c]);
      }
    }
  }
  __syncthreads();  // every warp is done with the frames: region A is reused

  // ---- power, rounded to bf16 into shared memory ----------------------------
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    // re and im share a fragment type, so element e is the same (row, col)
    for (int e = 0; e < re[c].num_elements; ++e)
      re[c].x[e] = re[c].x[e] * re[c].x[e] + im[c].x[e] * im[c].x[e];
    wmma::store_matrix_sync(scratch, re[c], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int lr = rt * 16 + e / 16;
      const int col = ch * 128 + c * 16 + e % 16;
      const float p = scratch[e];
      pw[lr * kBins + col] = __float2bfloat16(p);
      if (power_out != nullptr && row0 + lr < rows)
        power_out[(size_t)(row0 + lr) * kBins + col] = p;
    }
    __syncwarp();
  }
  for (int i = threadIdx.x; i < kBins * kMels / 8; i += kThreads)
    reinterpret_cast<int4*>(fb_s)[i] = __ldg(reinterpret_cast<const int4*>(fb) + i);
  __syncthreads();

  // ---- mel = power @ fb, then log1p ------------------------------------------
  FragC mel[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) wmma::fill_fragment(mel[m], 0.0f);
  for (int k0 = 0; k0 < kBins; k0 += kKs) {
    FragA a;
    wmma::load_matrix_sync(a, pw + rt * 16 * kBins + k0, kBins);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      FragB b;
      wmma::load_matrix_sync(b, fb_s + k0 * kMels + (ch * 4 + m) * 16, kMels);
      wmma::mma_sync(mel[m], a, b, mel[m]);
    }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    wmma::store_matrix_sync(scratch, mel[m], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int row = row0 + rt * 16 + e / 16;
      const int col = (ch * 4 + m) * 16 + e % 16;
      if (row < rows && col < n_mels) out[(size_t)row * n_mels + col] = log1pf(scratch[e]);
    }
    __syncwarp();
  }
}

template <bool kHigh>
int launch(const void* frames, int rows, int n_fft, int Kf, const void* cos_hi,
           const void* sin_hi, const void* cos_lo, const void* sin_lo,
           const void* fb, void* out, int n_mels, void* power,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(Kf, kHigh);
  cudaError_t err = cudaFuncSetAttribute(
      logmel_tile<kHigh>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((rows + kTileRows - 1) / kTileRows);
  logmel_tile<kHigh><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(frames), rows, n_fft, Kf,
      static_cast<const __nv_bfloat16*>(cos_hi),
      static_cast<const __nv_bfloat16*>(sin_hi),
      static_cast<const __nv_bfloat16*>(cos_lo),
      static_cast<const __nv_bfloat16*>(sin_lo),
      static_cast<const __nv_bfloat16*>(fb), static_cast<float*>(out), n_mels,
      static_cast<float*>(power));
  return (int)cudaGetLastError();
}

}  // namespace

// One launch over all rows on `stream`, no sync.  frames (rows, n_fft) fp32;
// Kf = n_fft rounded up to 16; cos_hi / sin_hi / cos_lo / sin_lo (Kf, 256)
// and fb (256, 128) bf16 as the wrapper prepares them (the low parts are
// read only when high != 0); out (rows, n_mels) fp32; power (rows, 256)
// fp32 or null.  Returns 0 or the cudaError_t met.
extern "C" int logmel_rows(const void* frames, int rows, int n_fft, int Kf,
                           const void* cos_hi, const void* sin_hi,
                           const void* cos_lo, const void* sin_lo,
                           const void* fb, void* out, int n_mels, void* power,
                           int high, void* stream) {
  if (rows <= 0) return 0;
  if (Kf % kKs != 0 || Kf < n_fft || n_fft / 2 + 1 > kBins || n_mels <= 0
      || n_mels > kMels)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (high)
    return launch<true>(frames, rows, n_fft, Kf, cos_hi, sin_hi, cos_lo, sin_lo,
                        fb, out, n_mels, power, s);
  return launch<false>(frames, rows, n_fft, Kf, cos_hi, sin_hi, cos_lo, sin_lo,
                       fb, out, n_mels, power, s);
}
