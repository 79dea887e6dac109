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
// never built: each block stages the soft rows of its offsets in shared
// memory once and every (offset, symbol) thread reads them from there.
//
// What bounds it at the full width (F, nfft, C, T, L) = (43, 4096, 100,
// 64, 32): launch latency, not the card's bandwidth or FLOPs. It reads
// 2*43*100 magnitudes, writes 43 KB of soft bits and 76*100*32*4 = 973 KB
// of scores, and does 7.8 MFLOP: 5.458 us of device time on an H100 80GB
// HBM3 at a 700 W limit (torch.profiler), against ~0.07 ms of CUDA-event
// time around the wrapper, whose host cost sets the call. The design is
// the simple one:
// grid (C, offset tiles of kTile); a block of kTile*32 threads, one per
// (offset, symbol) with the symbol fastest, so a warp shares one soft
// window (a shared-memory broadcast) and writes the 32 scores of one
// (o, c) as one 128-byte line. H sits in shared memory with rows padded
// to L+1 floats, so the 32 symbols of a warp read 32 different banks.
// Sums run in template order with fmaf; the division is IEEE (no fast
// math), so the soft bits equal the plain twin's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSymbols = 32;   // Baudot codes: one warp per (offset, c)
constexpr int kTile = 8;       // frame offsets per block
constexpr int kThreads = kTile * kSymbols;
constexpr int kMaxSmem = 48 * 1024;  // dynamic shared memory, no opt-in

__device__ __forceinline__ int wrap(int b, int nfft) {
  const int r = b % nfft;
  return r < 0 ? r + nfft : r;
}

// Block (c, j) handles channel c, offsets [j*kTile, j*kTile + kTile).
// It writes soft rows [j*kTile, (j+1)*kTile), or through the last row
// when it is the last tile (so a call with no offsets still writes all
// its soft rows). Replaces rtty.py:soft_bits + matched_scores.
// Bound: launch latency; see the note at the top.
__global__ void rtty_scores_kernel(const float* __restrict__ mags,
                                   const int* __restrict__ mark,
                                   const int* __restrict__ space,
                                   const float* __restrict__ tail,
                                   const float* __restrict__ templates,
                                   float* __restrict__ soft,
                                   float* __restrict__ scores, int f,
                                   int nfft, int nch, int t_rows, int len,
                                   int n_off) {
  extern __shared__ float smem[];
  float* h = smem;                          // kSymbols x (len + 1)
  float* s_soft = smem + kSymbols * (len + 1);
  const int c = blockIdx.x;
  const int o0 = blockIdx.y * kTile;
  const int rows_total = t_rows + f;
  const bool last = blockIdx.y == gridDim.y - 1;
  const int stage_end = min(o0 + kTile + len - 1, rows_total);
  const int write_end = last ? rows_total : o0 + kTile;
  const int mb = wrap(mark[c], nfft);
  const int sb = wrap(space[c], nfft);

  for (int i = threadIdx.x; i < kSymbols * len; i += blockDim.x)
    h[(i / len) * (len + 1) + i % len] = templates[i];
  for (int r = o0 + threadIdx.x; r < stage_end; r += blockDim.x) {
    float v;
    if (r < t_rows) {
      v = tail[(size_t)r * nch + c];
    } else {
      const float* row = mags + (size_t)(r - t_rows) * nfft;
      const float m = row[mb];
      const float s = row[sb];
      v = (m - s) / (m + s + 1e-9f);
    }
    s_soft[r - o0] = v;
    if (r < write_end) soft[(size_t)r * nch + c] = v;
  }
  __syncthreads();

  const int o = o0 + threadIdx.x / kSymbols;
  const int k = threadIdx.x % kSymbols;
  if (o >= n_off) return;
  const float* w = s_soft + (o - o0);
  const float* hk = h + k * (len + 1);
  float acc = 0.f;
  for (int t = 0; t < len; ++t) acc = fmaf(w[t], hk[t], acc);
  scores[((size_t)o * nch + c) * kSymbols + k] = acc;
}

// Shared memory bytes one block needs for templates of `len` frames.
size_t smem_bytes(int len) {
  return sizeof(float) * ((size_t)kSymbols * (len + 1) + kTile + len - 1);
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
  const int tiles = n_off > 0 ? (n_off + kTile - 1) / kTile : 1;
  const dim3 grid(nch, tiles);
  rtty_scores_kernel<<<grid, kThreads, smem_bytes(len),
                       (cudaStream_t)stream>>>(
      mags, mark, space, tail, templates, soft, scores, f, nfft, nch, t_rows,
      len, n_off);
  return (int)cudaGetLastError();
}

}  // extern "C"
