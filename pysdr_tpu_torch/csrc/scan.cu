// First-order recurrence scans for the demod path, hand-written for Hopper
// (sm_90a). Plain C ABI, loaded with ctypes by pysdr_tpu_torch/kernels.
//
// linrec_kernel replaces `jax.lax.associative_scan` in
// pysdr_tpu/ops/scanops.py:linrec (callers: the 4-column de-emphasis +
// squelch-envelope pass, demod.py:248; the 2-column gate-smoothing + DC
// blocker pass, demod.py:276; the AGC window-rate one-pole, agc.py:58).
// sr_latch_kernel replaces it in pysdr_tpu/ops/scanops.py:sr_latch (the
// squelch hysteresis latch, demod.py:260).
//
// What bounds them at the main path's shapes: (B, n, k) = (4, 24576, 4),
// (4, 24576, 2), (4, 384, 1) and the (4, 24576) latch. One thread block
// runs per (batch, column), so only B*k = 16, 8 or 4 blocks are in flight
// on a 132-SM card, and about 2.4 MB move per step: the kernels are
// latency- and occupancy-bound, not bandwidth-bound. The design keeps the
// serial part short: each thread folds a contiguous chunk of ~n/T samples
// into one composite, a block-level scan over the T composites runs in
// shared memory (log2 T steps), and each thread then re-scans its chunk
// from the carried-in value. Its cost: neighbouring threads read addresses
// a chunk apart, so every 4-byte load takes its own 32-byte sector, on
// 16 SMs at most (the 4-column pass takes ~83 us on an H100 SXM at 700 W).
// The real fix for both is to fuse these passes with the demod epilogue
// into one kernel per (channel, block) with coalesced tile loads
// (ROADMAP K2), a later change.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;

// y[i] = a[i] * y[i-1] + b[i] along n, for column `col` of batch `batch`.
// Composites compose as (a1, b1) then (a2, b2) = (a1*a2, a2*b1 + b2).
// Replaces jax.lax.associative_scan in pysdr_tpu/ops/scanops.py:linrec.
// Bound: latency and occupancy (B*k = 16 or 8 blocks of 1024 threads at
// n = 24576, 4 blocks at the AGC's n = 384), not the ~2 MB it moves per
// step. Later fix: fuse with the demod epilogue (ROADMAP K2).
__global__ void linrec_kernel(const float* __restrict__ a,
                              const float* __restrict__ b,
                              const float* __restrict__ y_prev,
                              float* __restrict__ y,
                              float* __restrict__ y_last, int n, int k) {
  __shared__ float sa[kMaxThreads];
  __shared__ float sb[kMaxThreads];
  const int col = blockIdx.x % k;
  const int batch = blockIdx.x / k;
  const size_t base = (size_t)batch * (size_t)n * (size_t)k + (size_t)col;
  const float* A = a + base;
  const float* B = b + base;
  float* Y = y + base;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int chunk = (n + T - 1) / T;
  const int s = min(t * chunk, n);
  const int e = min(s + chunk, n);

  float ca = 1.f, cb = 0.f;
  for (int i = s; i < e; ++i) {
    const float ai = A[(size_t)i * k];
    ca *= ai;
    cb = ai * cb + B[(size_t)i * k];
  }
  sa[t] = ca;
  sb[t] = cb;
  __syncthreads();
  // inclusive Hillis-Steele scan of the chunk composites
  for (int off = 1; off < T; off <<= 1) {
    float pa = 1.f, pb = 0.f;
    if (t >= off) {
      pa = sa[t - off];
      pb = sb[t - off];
    }
    __syncthreads();
    if (t >= off) {
      const float a2 = sa[t];
      sb[t] = a2 * pb + sb[t];
      sa[t] = pa * a2;
    }
    __syncthreads();
  }
  const float y0 = y_prev[(size_t)batch * k + col];
  float carry = t == 0 ? y0 : sa[t - 1] * y0 + sb[t - 1];
  for (int i = s; i < e; ++i) {
    carry = A[(size_t)i * k] * carry + B[(size_t)i * k];
    Y[(size_t)i * k] = carry;
  }
  if (s < e && e == n) y_last[(size_t)batch * k + col] = carry;
}

__device__ __forceinline__ int latch_cmd(uint8_t set, uint8_t reset) {
  return set ? 1 : (reset ? -1 : 0);
}

// Set/reset latch along n for row `blockIdx.x`: the effective command is
// the last non-hold (non-zero) one; before any, the gate keeps g_prev.
// Replaces jax.lax.associative_scan in pysdr_tpu/ops/scanops.py:sr_latch.
// Bound: latency and occupancy (B = 4 blocks at n = 24576; ~0.3 MB per
// step). Later fix: fuse with the demod epilogue (ROADMAP K2).
__global__ void sr_latch_kernel(const uint8_t* __restrict__ set,
                                const uint8_t* __restrict__ reset,
                                const float* __restrict__ g_prev,
                                float* __restrict__ gate,
                                float* __restrict__ gate_last, int n) {
  __shared__ int sc[kMaxThreads];
  const size_t base = (size_t)blockIdx.x * (size_t)n;
  const uint8_t* S = set + base;
  const uint8_t* R = reset + base;
  float* G = gate + base;
  const int t = threadIdx.x;
  const int T = blockDim.x;
  const int chunk = (n + T - 1) / T;
  const int s = min(t * chunk, n);
  const int e = min(s + chunk, n);

  int c = 0;
  for (int i = s; i < e; ++i) {
    const int cmd = latch_cmd(S[i], R[i]);
    if (cmd) c = cmd;
  }
  sc[t] = c;
  __syncthreads();
  for (int off = 1; off < T; off <<= 1) {
    const int prev = t >= off ? sc[t - off] : 0;
    __syncthreads();
    if (t >= off && sc[t] == 0) sc[t] = prev;
    __syncthreads();
  }
  const int init = g_prev[blockIdx.x] > 0.5f ? 1 : -1;
  int cur = (t == 0 || sc[t - 1] == 0) ? init : sc[t - 1];
  for (int i = s; i < e; ++i) {
    const int cmd = latch_cmd(S[i], R[i]);
    if (cmd) cur = cmd;
    G[i] = cur > 0 ? 1.f : 0.f;
  }
  if (s < e && e == n) gate_last[blockIdx.x] = cur > 0 ? 1.f : 0.f;
}

}  // namespace

extern "C" {

// a, b, y: (batch, n, k) float32 contiguous; y_prev, y_last: (batch, k).
// Returns the cudaError_t of the launch (0 on success).
int pysdr_linrec_f32(const float* a, const float* b, const float* y_prev,
                     float* y, float* y_last, int batch, int n, int k,
                     int threads, void* stream) {
  if (batch < 1 || n < 1 || k < 1 || threads < 1 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  linrec_kernel<<<batch * k, threads, 0, (cudaStream_t)stream>>>(
      a, b, y_prev, y, y_last, n, k);
  return (int)cudaGetLastError();
}

// set, reset: (batch, n) uint8 (0/1); g_prev, gate_last: (batch,);
// gate: (batch, n) float32.
int pysdr_sr_latch_u8(const uint8_t* set, const uint8_t* reset,
                      const float* g_prev, float* gate, float* gate_last,
                      int batch, int n, int threads, void* stream) {
  if (batch < 1 || n < 1 || threads < 1 || threads > kMaxThreads)
    return (int)cudaErrorInvalidValue;
  sr_latch_kernel<<<batch, threads, 0, (cudaStream_t)stream>>>(
      set, reset, g_prev, gate, gate_last, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
