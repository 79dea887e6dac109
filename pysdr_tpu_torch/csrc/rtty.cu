// Soft bits + matched filter of the wideband RTTY decoder, hand-written
// for Hopper (sm_90a). Plain C ABI, loaded with ctypes by
// pysdr_tpu_torch/kernels.
//
// rtty_scores_kernel replaces pysdr_tpu/models/rtty.py:soft_bits and
// matched_scores, which XLA ran as a gather, an elementwise pass, a
// windows gather of (n_off, L, C) and one matmul:
//
//   soft[r, c]      = tail[r, c]                                 r < T
//                   = (m - s) / (m + s + 1e-9),                  r >= T
//                     m = mags[r-T, mark[c]], s = mags[r-T, space[c]]
//   scores[o, c, k] = sum_t soft[o+t, c] * H[k, t]     o < T+F-L+1
//
// with H the 32 Baudot +-1 templates of L frames. The windows tensor is
// never built.
//
// What bounds it at the full width (F, nfft, C, T, L) = (43, 4096, 100,
// 64, 32): the launch and one block's staging, not the card's bandwidth
// or FLOPs. It reads 2*43*100 magnitudes, writes 43 KB of soft bits and
// 76*100*32*4 = 973 KB of scores and does 7.8 MFLOP: 0.32 us of bytes at
// 3.35 TB/s, which no launch reaches. The earlier design (a block per
// channel and tile of 8 offsets, 1000 blocks each staging all 32
// templates for 8 x 32 x 32 multiply-adds) took 5.4 us on an H100 80GB
// HBM3 at its 700 W limit. This one:
//
// - A block per channel owns all of its offsets; it stages the 32
//   templates (rows padded to L+1 floats, so the 32 symbols of a warp read
//   32 different banks) and the channel's soft rows once, with the
//   template loads issued before the soft rows' so the latencies overlap.
//   Offsets go in chunks of kChunk, so shared memory stays bounded for
//   any F.
// - 16 warps loop over groups of kGroup consecutive offsets with lane =
//   symbol. A thread slides a window of kGroup soft values (shared-memory
//   broadcasts) in registers, so each tap costs one template read and one
//   soft read for kGroup multiply-adds, and a warp writes the 32 scores of
//   one (o, c) as one 128-byte line.
// Sums run in template order with fmaf; the division is IEEE (no fast
// math), so the soft bits equal the plain twin's bit for bit.
//
// On that H100 (probes/torch_pfb_rtty_variants.py): 3.7 us, of which 3.0
// us remain without the multiply-add loop (the launch, the staging and
// the stores).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSymbols = 32;   // Baudot codes: lane = symbol
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * kSymbols;
constexpr int kGroup = 8;      // offsets a thread sums at once
constexpr int kChunk = 256;    // offsets a block stages at once
constexpr int kPrefetch = 2;   // template values a thread loads early
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory, no opt-in

__device__ __forceinline__ int wrap(int b, int nfft) {
  const int r = b % nfft;
  return r < 0 ? r + nfft : r;
}

// Block c handles channel c, all offsets, kChunk at a time. A chunk at
// o0 writes soft rows [o0, o0 + kChunk), or through the last row when it
// is the last chunk (so a call with no offsets still writes all its soft
// rows). Replaces rtty.py:soft_bits + matched_scores. Bound: the launch;
// see the note at the top.
__global__ void __launch_bounds__(kThreads)
rtty_scores_kernel(const float* __restrict__ mags,
                   const int* __restrict__ mark,
                   const int* __restrict__ space,
                   const float* __restrict__ tail,
                   const float* __restrict__ templates,
                   float* __restrict__ soft, float* __restrict__ scores,
                   int f, int nfft, int nch, int t_rows, int len,
                   int n_off) {
  extern __shared__ float smem[];
  float* h = smem;                          // kSymbols x (len + 1)
  float* s_soft = smem + kSymbols * (len + 1);
  const int c = blockIdx.x;
  const int rows_total = t_rows + f;
  const int mb = wrap(mark[c], nfft);
  const int sb = wrap(space[c], nfft);
  const int lane = threadIdx.x % kSymbols;
  const int warp = threadIdx.x / kSymbols;

  // the first kPrefetch template values of each thread (all of them at
  // L = 32) are loaded now and stored after the first chunk's soft rows,
  // so their latency overlaps the soft rows' two dependent loads
  float early[kPrefetch > 0 ? kPrefetch : 1];
#pragma unroll
  for (int j = 0; j < kPrefetch; ++j) {
    const int i = threadIdx.x + j * kThreads;
    early[j] = i < kSymbols * len ? templates[i] : 0.f;
  }
  for (int i = threadIdx.x + kPrefetch * kThreads; i < kSymbols * len;
       i += kThreads)
    h[(i / len) * (len + 1) + i % len] = templates[i];
  const float* hk = h + lane * (len + 1);

  const int chunks = n_off > 0 ? (n_off + kChunk - 1) / kChunk : 1;
  for (int ch = 0; ch < chunks; ++ch) {
    const int o0 = ch * kChunk;
    const int o_end = min(o0 + kChunk, n_off);
    const int write_end = ch == chunks - 1 ? rows_total : o0 + kChunk;
    // the rows this chunk's groups read (zeros past the last row) and
    // the soft rows it writes
    const int stage_end = max(o_end + kGroup - 1 + len - 1, write_end);
    if (ch > 0) __syncthreads();   // the last chunk's sums are done
    for (int r = o0 + threadIdx.x; r < stage_end; r += blockDim.x) {
      float val = 0.f;
      if (r < t_rows) {
        val = tail[(size_t)r * nch + c];
      } else if (r < rows_total) {
        const float* row = mags + (size_t)(r - t_rows) * nfft;
        const float m = row[mb];
        const float s = row[sb];
        val = (m - s) / (m + s + 1e-9f);
      }
      s_soft[r - o0] = val;
      if (r < write_end) soft[(size_t)r * nch + c] = val;
    }
    if (ch == 0) {
#pragma unroll
      for (int j = 0; j < kPrefetch; ++j) {
        const int i = threadIdx.x + j * kThreads;
        if (i < kSymbols * len) h[(i / len) * (len + 1) + i % len] = early[j];
      }
    }
    __syncthreads();

    for (int o = o0 + warp * kGroup; o < o_end; o += kWarps * kGroup) {
      const float* w = s_soft + (o - o0);
      // soft row o + t + q lives in win[(t + q) % kGroup]; the tap loop
      // is unrolled by kGroup so every index is a constant
      float acc[kGroup], win[kGroup];
#pragma unroll
      for (int q = 0; q < kGroup; ++q) acc[q] = 0.f;
#pragma unroll
      for (int q = 0; q < kGroup - 1; ++q) win[q] = w[q];
      for (int t0 = 0; t0 < len; t0 += kGroup) {
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          if (t0 + u >= len) break;
          win[(u + kGroup - 1) % kGroup] = w[t0 + u + kGroup - 1];
          const float ht = hk[t0 + u];
#pragma unroll
          for (int q = 0; q < kGroup; ++q)
            acc[q] = fmaf(win[(u + q) % kGroup], ht, acc[q]);
        }
      }
#pragma unroll
      for (int q = 0; q < kGroup; ++q)
        if (o + q < o_end)
          scores[((size_t)(o + q) * nch + c) * kSymbols + lane] = acc[q];
    }
  }
}

// Shared memory bytes one block needs for templates of `len` frames: the
// padded templates and one chunk's soft rows.
size_t smem_bytes(int len) {
  return sizeof(float) *
         ((size_t)kSymbols * (len + 1) + kChunk + kGroup - 1 + len - 1);
}

}  // namespace

extern "C" {

// mags (f, nfft) float32; mark, space (nch,) int32 bins (taken modulo
// nfft); tail (t_rows, nch) float32; templates (32, len) float32; soft
// (t_rows + f, nch) float32; scores (max(t_rows + f - len + 1, 0), nch,
// 32) float32. Returns the cudaError_t of the launch (0 on success), or
// cudaErrorInvalidValue for templates too long for one block's shared
// memory.
int pysdr_rtty_scores(const float* mags, const int* mark, const int* space,
                      const float* tail, const float* templates, float* soft,
                      float* scores, int f, int nfft, int nch, int t_rows,
                      int len, void* stream) {
  if (f < 0 || nfft < 1 || nch < 1 || t_rows < 0 || len < 1 ||
      t_rows + f < 1 || smem_bytes(len) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  const int n_off = t_rows + f - len + 1 > 0 ? t_rows + f - len + 1 : 0;
  rtty_scores_kernel<<<nch, kThreads, smem_bytes(len),
                       (cudaStream_t)stream>>>(
      mags, mark, space, tail, templates, soft, scores, f, nfft, nch, t_rows,
      len, n_off);
  return (int)cudaGetLastError();
}

}  // extern "C"
