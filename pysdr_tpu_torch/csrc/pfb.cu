// Polyphase filterbank (PFB) branch filter for the channelizer bank,
// hand-written for Hopper (sm_90a). Plain C ABI, loaded with ctypes by
// pysdr_tpu_torch/kernels.
//
// pfb_branch_kernel replaces pysdr_tpu/ops/channelizer.py:branch_filter
// (with the ops/cplx.py:dequantize in front of it), which XLA fused on the
// TPU into one pass of K shifted multiply-adds over the (M, N) block view:
//
//   v[m, r] = sum_k h[r, k] * xb[m + K-1-k, r],   xb = [hist | x] as rows of N
//
// with x the wire block dequantized in the load (int8 / int16 / float32
// pairs) and hist the last (K-1)*N dequantized samples of the previous
// block. The last row tile also writes the new history, rows [M, M+K-1)
// of xb, so one launch is the whole branch filter.
//
// What bounds it at the chan64 shape (M, N, K) = (49152, 64, 12): bytes.
// It reads the 6.3 MB i8 wire block (25 MB on the f32 wire) and writes
// the 25 MB complex64 v: 9.4 us at 3.35 TB/s on the i8 wire. The earlier
// design (one thread per output, K loads and K dequantizes of 2 bytes
// each) ran at 42 us on an H100 80GB HBM3 at its 700 W limit: it was
// bound by load instructions and int-to-float conversions, not bytes.
// This design makes each byte one load and each sample one conversion:
//
// - A block owns tile_rows(N) = 256 / min(N, 64) * kRun consecutive output
//   rows x up to 64 branches (128 rows x 64 branches at chan64: 384 blocks,
//   about three per SM, all resident at once).
// - It stages the raw wire bytes of its tile's tile_rows + K - 1 view rows in
//   shared memory once (17.8 KB on the i8 wire at chan64): one contiguous
//   range when the tile spans every branch, copied with 16-byte cp.async
//   where the addresses allow, else in the widest unit they allow. The
//   view rows before the block (hist) are read from global memory.
// - A thread owns one branch and a run of kRun rows. It holds the K taps
//   and a circular window of K dequantized samples in registers (K is a
//   template argument up to kMaxTaps; the row loop is unrolled by K so
//   every window index is a constant), so each staged sample is read and
//   converted once per thread. Sums run k = 0 first with fmaf, the
//   dequantize is the twin's value * scale, so the new history is the
//   twin's bit for bit and v agrees to float32 rounding.
// - A warp writes 32 neighbouring branches of one row (256 bytes), with no
//   integer division after the block's set-up.
// A K above kMaxTaps takes the same kernel with K as a runtime argument:
// nothing staged, each tap read from global memory.
//
// On that H100 (probes/torch_pfb_rtty_variants.py): 11.3 us on the i8
// wire against its 9.4 us bound, 9.0 us with the multiply-adds removed
// (staging and stores alone); 19 us on the f32 wire against 15.0 us.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBranches = 64;    // branches of a block's tile
constexpr int kRun = 32;         // output rows of a thread
constexpr int kMaxTaps = 16;     // K with a register window
constexpr int kDefaultSmem = 48 * 1024;

template <typename T> struct Wire;
template <> struct Wire<float> { using Pair = float2; };
template <> struct Wire<int16_t> { using Pair = short2; };
template <> struct Wire<int8_t> { using Pair = char2; };

__device__ __forceinline__ float2 dequant(float2 p, float) { return p; }

__device__ __forceinline__ float2 dequant(short2 p, float scale) {
  return make_float2((float)p.x * scale, (float)p.y * scale);
}

__device__ __forceinline__ float2 dequant(char2 p, float scale) {
  return make_float2((float)p.x * scale, (float)p.y * scale);
}

// Output rows of a block: 256 threads in groups of min(N, 64) branches,
// kRun rows a group.
__host__ __device__ __forceinline__ int tile_rows(int nch) {
  return kThreads / (nch < kBranches ? nch : kBranches) * kRun;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// Copy `rows` wire rows from `src` (row stride `stride` bytes, `seg`
// bytes of each) to shared memory, row after row: one range when the rows
// are contiguous (seg == stride), in 16-byte cp.async units where the
// addresses and lengths allow, else in 8-, 4- or `pair`-byte loads.
__device__ void stage(unsigned char* dst, const unsigned char* src,
                      int rows, int seg, size_t stride, int pair) {
  const bool one = (size_t)seg == stride;
  const int n_rows = one ? 1 : rows;
  const int len = one ? rows * seg : seg;
  int unit = 16;
  while (unit > pair &&
         (((uintptr_t)src | (one ? 0 : stride) | (size_t)len) & (unit - 1)))
    unit >>= 1;
  const int per_row = len / unit;
  const int total = n_rows * per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per_row;
    const int o = (i - r * per_row) * unit;
    const unsigned char* s = src + r * stride + o;
    unsigned char* d = dst + (size_t)r * len + o;
    switch (unit) {
      case 16: cp_async16(d, s); break;
      case 8: *reinterpret_cast<uint2*>(d) =
                  *reinterpret_cast<const uint2*>(s); break;
      case 4: *reinterpret_cast<uint32_t*>(d) =
                  *reinterpret_cast<const uint32_t*>(s); break;
      default: *reinterpret_cast<uint16_t*>(d) =
                   *reinterpret_cast<const uint16_t*>(s); break;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Block (x, y): output rows [x*tile, (x+1)*tile) of branches [y*64,
// y*64 + 64) (fewer in a last partial tile). KC = K with a register
// window, or 0 for any K read from global memory. Replaces
// pysdr_tpu/ops/channelizer.py:branch_filter. Bound: device-memory
// bytes (wire block in, complex64 (M, N) out); see the note at the top.
template <typename T, int KC>
__global__ void __launch_bounds__(kThreads)
pfb_branch_kernel(const T* __restrict__ x, const float2* __restrict__ hist,
                  const float* __restrict__ taps, float2* __restrict__ v,
                  float2* __restrict__ new_hist, int m_rows, int nch,
                  int k_rt, float scale) {
  using Pair = typename Wire<T>::Pair;
  extern __shared__ __align__(16) unsigned char smem[];
  const Pair* sx = reinterpret_cast<const Pair*>(smem);
  const Pair* xw = reinterpret_cast<const Pair*>(x);
  const int k = KC > 0 ? KC : k_rt;
  const int h_rows = k - 1;
  const int tile = tile_rows(nch);
  const int m0 = blockIdx.x * tile;
  const int c0 = blockIdx.y * kBranches;
  const int nb = min(nch - c0, kBranches);
  // view rows [jlo, jhi) of the tile that lie in the wire block
  const int jlo = max(m0, h_rows);
  const int jhi = min(m0 + tile + h_rows, m_rows + h_rows);
  if (KC > 0 && jhi > jlo)
    stage(smem,
          reinterpret_cast<const unsigned char*>(
              xw + (size_t)(jlo - h_rows) * nch + c0),
          jhi - jlo, nb * (int)sizeof(Pair), (size_t)nch * sizeof(Pair),
          (int)sizeof(Pair));
  __syncthreads();

  // sample (view row j, branch c0 + b), dequantized
  auto at = [&](int j, int b) -> float2 {
    if (j < h_rows) return hist[(size_t)j * nch + c0 + b];
    if (KC > 0) return dequant(sx[(j - jlo) * nb + b], scale);
    return dequant(xw[(size_t)(j - h_rows) * nch + c0 + b], scale);
  };

  const int nbf = min(nch, kBranches);
  const int g = threadIdx.x / nbf;
  const int b = threadIdx.x - g * nbf;
  const int ma = m0 + g * kRun;
  const int run = min(kRun, m_rows - ma);
  if (g < kThreads / nbf && b < nb && run > 0) {
    float2* vo = v + (size_t)ma * nch + c0 + b;
    if constexpr (KC > 0) {
      const float* hb = taps + (size_t)(c0 + b) * KC;
      float h[KC];
#pragma unroll
      for (int i = 0; i < KC; ++i) h[i] = __ldg(hb + i);
      // view row ma + q lives in w[q % KC]
      float2 w[KC];
#pragma unroll
      for (int i = 0; i < KC - 1; ++i) w[i] = at(ma + i, b);
      for (int base = 0; base < run; base += KC) {
#pragma unroll
        for (int i = 0; i < KC; ++i) {
          if (base + i >= run) break;
          w[(i + KC - 1) % KC] = at(ma + base + i + KC - 1, b);
          float2 acc = make_float2(0.f, 0.f);
#pragma unroll
          for (int kk = 0; kk < KC; ++kk) {
            const float2 s = w[(i + KC - 1 - kk) % KC];
            acc.x = fmaf(h[kk], s.x, acc.x);
            acc.y = fmaf(h[kk], s.y, acc.y);
          }
          vo[(size_t)(base + i) * nch] = acc;
        }
      }
    } else {
      const float* h = taps + (size_t)(c0 + b) * k;
      for (int i = 0; i < run; ++i) {
        float2 acc = make_float2(0.f, 0.f);
        for (int kk = 0; kk < k; ++kk) {
          const float wk = __ldg(h + kk);
          const float2 s = at(ma + i + k - 1 - kk, b);
          acc.x = fmaf(wk, s.x, acc.x);
          acc.y = fmaf(wk, s.y, acc.y);
        }
        vo[(size_t)i * nch] = acc;
      }
    }
  }

  // the new history, view rows [M, M + K-1): all staged by the last tile
  if (blockIdx.x == gridDim.x - 1) {
    for (int i = threadIdx.x; i < h_rows * nb; i += blockDim.x) {
      const int r = i / nb;
      const int bb = i - r * nb;
      new_hist[(size_t)r * nch + c0 + bb] = at(m_rows + r, bb);
    }
  }
}

template <typename T, int KC>
int launch(const void* x, const float2* hist, const float* taps, float2* v,
           float2* new_hist, int m_rows, int nch, int k, float scale,
           cudaStream_t stream) {
  using Pair = typename Wire<T>::Pair;
  const int tile = tile_rows(nch);
  const dim3 grid((m_rows + tile - 1) / tile,
                  (nch + kBranches - 1) / kBranches);
  const int nbf = nch < kBranches ? nch : kBranches;
  const size_t smem = KC > 0 ? (size_t)(tile + KC - 1) * nbf * sizeof(Pair)
                             : 0;
  if (smem > kDefaultSmem) {
    // at most (256 * kRun + 15 * 64) pairs: 73 KB on the f32 wire
    const cudaError_t rc = cudaFuncSetAttribute(
        pfb_branch_kernel<T, KC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  pfb_branch_kernel<T, KC><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), hist, taps, v, new_hist, m_rows, nch, k,
      scale);
  return (int)cudaGetLastError();
}

// K = KC, KC - 1, ..., 1 with a register window; any other K at 0.
template <typename T, int KC = kMaxTaps>
int dispatch(const void* x, const float2* hist, const float* taps,
             float2* v, float2* new_hist, int m_rows, int nch, int k,
             float scale, cudaStream_t stream) {
  if constexpr (KC == 0) {
    return launch<T, 0>(x, hist, taps, v, new_hist, m_rows, nch, k, scale,
                        stream);
  } else {
    if (k == KC)
      return launch<T, KC>(x, hist, taps, v, new_hist, m_rows, nch, k,
                           scale, stream);
    return dispatch<T, KC - 1>(x, hist, taps, v, new_hist, m_rows, nch, k,
                               scale, stream);
  }
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
  const int m_rows = n / nch;
  cudaStream_t s = (cudaStream_t)stream;
  switch (wire) {
    case 0:
      return dispatch<float>(x, h, taps, vo, nh, m_rows, nch, k, scale, s);
    case 1:
      return dispatch<int16_t>(x, h, taps, vo, nh, m_rows, nch, k, scale, s);
    case 2:
      return dispatch<int8_t>(x, h, taps, vo, nh, m_rows, nch, k, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
