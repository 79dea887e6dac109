// Polyphase filterbank (PFB) branch filter for the channelizer bank,
// hand-written for Hopper (sm_90a). Plain C ABI, loaded with ctypes by
// pysdr_tpu_torch/kernels.
//
// pfb_branch_kernel replaces pysdr_tpu/ops/channelizer.py:branch_filter
// (with the ops/cplx.py:dequantize in front of it), which XLA fused on the
// TPU into one pass of K shifted multiply-adds over the (M, N) block view:
//
//   v[m, r] = sum_k h[r, k] * xp[(m + K-1-k)*N + r],   xp = [hist | x]
//
// with x the wire block dequantized in the load (int8 / int16 / float32
// pairs) and hist the last (K-1)*N dequantized samples of the previous
// block. Each thread also writes at most one sample of the new history
// xp[n : n + (K-1)*N], so one launch is the whole branch filter.
//
// What bounds it at the chan64 shape (M, N, K) = (49152, 64, 12): bytes.
// It reads the 6.3 MB i8 wire block (25 MB on the f32 wire) and writes
// the 25 MB complex64 v; 12 complex multiply-adds per output are ~75
// MFLOP, nothing for the card. The design: one thread per output (m, r),
// r fastest, so a warp reads 32 neighbouring samples of one row of the
// block view and writes 32 neighbouring outputs (coalesced both ways).
// The K row reads of one output are K*N samples apart; the K-1 other
// threads that read the same sample run in nearby blocks, so repeats hit
// L2 (the whole block fits in its 50 MB). Taps are 3 KB and stay in L1.
// Shared-memory tiling of the rows and TMA loads are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float2 load_wire(const float* x, size_t i,
                                            float) {
  return reinterpret_cast<const float2*>(x)[i];
}

__device__ __forceinline__ float2 load_wire(const int16_t* x, size_t i,
                                            float scale) {
  const short2 s = reinterpret_cast<const short2*>(x)[i];
  return make_float2((float)s.x * scale, (float)s.y * scale);
}

__device__ __forceinline__ float2 load_wire(const int8_t* x, size_t i,
                                            float scale) {
  const char2 s = reinterpret_cast<const char2*>(x)[i];
  return make_float2((float)s.x * scale, (float)s.y * scale);
}

// Sample j of xp = [hist | dequantized x].
template <typename T>
__device__ __forceinline__ float2 xp_at(const T* x, const float2* hist,
                                        int j, int h_len, float scale) {
  return j < h_len ? hist[j] : load_wire(x, (size_t)(j - h_len), scale);
}

// One thread per output v[m, r] (t = m*N + r), and per new-history sample
// t < (K-1)*N. Replaces pysdr_tpu/ops/channelizer.py:branch_filter.
// Bound: device-memory bytes (wire block in, complex64 (M, N) out).
template <typename T>
__global__ void pfb_branch_kernel(const T* __restrict__ x,
                                  const float2* __restrict__ hist,
                                  const float* __restrict__ taps,
                                  float2* __restrict__ v,
                                  float2* __restrict__ new_hist, int n,
                                  int nch, int k, float scale) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int h_len = (k - 1) * nch;
  if (t < n) {
    const int m = t / nch;
    const int r = t - m * nch;
    const float* h = taps + (size_t)r * k;
    // same term order as the reference: k = 0 first, then k = 1 .. K-1
    float2 acc = make_float2(0.f, 0.f);
    for (int kk = 0; kk < k; ++kk) {
      const float w = __ldg(h + kk);
      const float2 s = xp_at(x, hist, (m + k - 1 - kk) * nch + r, h_len,
                             scale);
      acc.x = fmaf(w, s.x, acc.x);
      acc.y = fmaf(w, s.y, acc.y);
    }
    v[t] = acc;
  }
  if (t < h_len) new_hist[t] = xp_at(x, hist, n + t, h_len, scale);
}

template <typename T>
int launch(const void* x, const float2* hist, const float* taps, float2* v,
           float2* new_hist, int n, int nch, int k, float scale,
           cudaStream_t stream) {
  const int h_len = (k - 1) * nch;
  const int total = n > h_len ? n : h_len;
  const int blocks = (total + kThreads - 1) / kThreads;
  pfb_branch_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), hist, taps, v, new_hist, n, nch, k, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (n, 2) wire pairs, wire 0 = float32, 1 = int16, 2 = int8, each
// dequantized as value * scale; hist, new_hist: ((k-1)*nch,) complex64;
// taps: (nch, k) float32; v: (n/nch, nch) complex64. n % nch == 0.
// Returns the cudaError_t of the launch (0 on success).
int pysdr_pfb_branch(const void* x, int wire, float scale, const void* hist,
                     const float* taps, void* v, void* new_hist, int n,
                     int nch, int k, void* stream) {
  if (n < 1 || nch < 1 || k < 1 || n % nch != 0)
    return (int)cudaErrorInvalidValue;
  const float2* h = static_cast<const float2*>(hist);
  float2* vo = static_cast<float2*>(v);
  float2* nh = static_cast<float2*>(new_hist);
  cudaStream_t s = (cudaStream_t)stream;
  switch (wire) {
    case 0:
      return launch<float>(x, h, taps, vo, nh, n, nch, k, scale, s);
    case 1:
      return launch<int16_t>(x, h, taps, vo, nh, n, nch, k, scale, s);
    case 2:
      return launch<int8_t>(x, h, taps, vo, nh, n, nch, k, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
