// First-order recurrence scans for the demod path, hand-written for Hopper
// (sm_90a). Plain C ABI, loaded with ctypes by pysdr_tpu_torch/kernels.
//
// linrec_kernel replaces `jax.lax.associative_scan` in
// pysdr_tpu/ops/scanops.py:linrec (callers: the 4-column de-emphasis +
// squelch-envelope pass, demod.py:254; the 2-column gate-smoothing + DC
// blocker pass, demod.py:276; the AGC window-rate one-pole, agc.py:43).
// sr_latch_kernel replaces it in pysdr_tpu/ops/scanops.py:sr_latch (the
// squelch hysteresis latch, demod.py:263).
//
// Both kernels scan a whole (B, n) block in ONE launch, tiled along time:
//  * Each block takes one (row, time tile). Its row is blockIdx mod B;
//    its tile index comes from an atomic ticket of that row, not from
//    blockIdx, so a tile's predecessors in its row already hold an SM
//    when it starts and none waits on a block that is not resident. The
//    block that takes a row's last ticket sets the counter back to 0 for
//    the next launch.
//  * The tile is contiguous in memory. The block reads it with 16-byte
//    loads (scalar ones where a row starts unaligned), and the scan
//    inside the tile is per-thread runs, warp shuffles and one
//    shared-memory pass over the warps' totals.
//  * Tiles carry into each other by look-back over status words, read
//    32 predecessors at a time by one warp. linrec: tile 0 publishes its
//    inclusive prefix (it holds y_prev), every other tile its local
//    aggregate, and a tile composes the aggregates of all its
//    predecessors onto tile 0's prefix in a fixed order, so its float
//    rounding does not depend on which predecessor finished first and a
//    launch gives the same bits every time. sr_latch: a tile with any
//    command, and tile 0, publish a final command at once; a tile
//    without one looks back to the nearest final one (integers: any
//    order gives the same bits).
//  * Every status word holds its own tag (the launch's epoch and the
//    state) beside its value, and is written by one 64-bit (linrec) or
//    8-bit (sr_latch) store, which the card makes single-copy atomic: a
//    reader that sees the tag sees the value, so no fence orders a value
//    before a flag. A word of an earlier launch reads as "not ready", so
//    the buffer is never cleared between launches.
//  * The epoch lives on the card, in the launch's control words beside
//    the row tickets (`ctl`): every block reads it when it starts, and
//    the block that finishes last (a counter of finished blocks) bumps
//    it for the next launch; when it reaches the largest epoch the tag
//    holds, that block also zeroes the whole status buffer and the
//    epoch starts again at 1. So a launch takes nothing from the host
//    that changes from call to call, and a launch captured in a CUDA
//    graph and replayed is as right as an eager one. (The other choice,
//    clearing the launch's status words on the stream before each
//    launch, would add a memset node to every launch.) Launches on one
//    control buffer must run one after another, as launches on one
//    stream, or one graph's replays, do.
//  * The tile length is a template argument: the wrapper takes the longer
//    tile where it still gives >= 128 blocks (kernels/scan.py).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;

// ---- linrec ----
constexpr int kColThreads = 64;             // threads per column: two warps
// a tile is kColThreads runs of RUN samples (8 or 16) of each column
template <int RUN>
struct Tile {
  static constexpr int kLen = RUN * kColThreads;   // 512 or 1024 samples
  // a tile column in shared memory: one padding word after every run, so
  // the 32 runs a warp reads start RUN + 1 words apart (no bank
  // conflict), and 8 more so that the columns of one sample sit 8 banks
  // apart
  static constexpr int kColStride = kLen + kLen / RUN + 8;
  static __device__ __forceinline__ int idx(int s, int c) {
    return c * kColStride + s + s / RUN;
  }
};
// status: three 64-bit words a (row, column, tile), each (tag << 32 |
// float bits) with tag = epoch << 2 | state: the aggregate's a, its b
// (tiles 1 on), and tile 0's inclusive prefix's b (its a is never
// needed)
constexpr unsigned kAggregate = 1, kPrefix = 2;

struct Pair {   // the map y -> a*y + b
  float a, b;
};

// (a1, b1) then (a2, b2) = (a1*a2, a2*b1 + b2)
__device__ __forceinline__ Pair compose(Pair e, Pair l) {
  return {e.a * l.a, fmaf(l.a, e.b, l.b)};
}

__device__ __forceinline__ unsigned long long ld_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_word(unsigned long long* p,
                                        unsigned tag, float x) {
  const unsigned long long v =
      (unsigned long long)tag << 32 | __float_as_uint(x);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

// ---- a launch's control words: ctl[0] the epoch count e (this launch
// tags its words e + 1), ctl[1] the blocks of this launch that finished,
// ctl[2 + r] the tile ticket of row r. All 0 in a new buffer, and each
// launch leaves ctl[1] and the tickets at 0.
constexpr int kCtlTickets = 2;

// Thread 0, when the block starts: this launch's epoch (1..max_epoch).
__device__ __forceinline__ unsigned read_epoch(const unsigned* ctl) {
  unsigned e;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(e) : "l"(ctl) : "memory");
  return e + 1;
}

// Every thread of the block, after the block's last access to the status
// words. The block that finishes last moves the epoch on for the next
// launch; at max_epoch it zeroes all `n_words` status words first and
// the next launch starts again at epoch 1. Every other block of the
// launch has finished, so none reads a word while it is cleared.
template <class Word>
__device__ __forceinline__ void finish_launch(unsigned* ctl, Word* words,
                                              long long n_words,
                                              unsigned epoch,
                                              unsigned max_epoch,
                                              int* s_last) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    *s_last = atomicAdd(ctl + 1, 1u) == gridDim.x - 1;
    if (*s_last) __threadfence();
  }
  __syncthreads();
  if (!*s_last) return;
  const bool wrap = epoch >= max_epoch;
  if (wrap)
    for (long long i = threadIdx.x; i < n_words; i += blockDim.x)
      words[i] = 0;
  if (threadIdx.x == 0) {
    ctl[1] = 0;
    ctl[0] = wrap ? 0u : epoch;
  }
}

// Thread 0: this block's (row, tile). Blocks b, b + batch, ... share row
// b mod batch; the counter of that row hands out its tiles in the order
// the blocks start, and its last taker resets it.
__device__ __forceinline__ void take_ticket(unsigned* tickets, int batch,
                                            int tiles_per_row, int* row,
                                            int* tile) {
  const int r = (int)(blockIdx.x % (unsigned)batch);
  const unsigned t = atomicAdd(tickets + r, 1u);
  if (t == (unsigned)tiles_per_row - 1) atomicExch(tickets + r, 0u);
  *row = r;
  *tile = (int)t;
}

__device__ __forceinline__ unsigned tag_of(unsigned long long w) {
  return (unsigned)(w >> 32);
}

__device__ __forceinline__ float value_of(unsigned long long w) {
  return __uint_as_float((unsigned)w);
}

// m floats of a tile, sample-major (K a sample) as in memory, into the
// column-major padded layout; 16-byte loads where the source is aligned
template <int K, class T>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int m, float* dst) {
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    for (int q = threadIdx.x; q < m / 4; q += blockDim.x) {
      const float4 v = __ldcs(s4 + q);
      const int e = 4 * q;
      dst[T::idx(e / K, e % K)] = v.x;
      dst[T::idx((e + 1) / K, (e + 1) % K)] = v.y;
      dst[T::idx((e + 2) / K, (e + 2) % K)] = v.z;
      dst[T::idx((e + 3) / K, (e + 3) % K)] = v.w;
    }
    e0 = m / 4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < m; e += blockDim.x)
    dst[T::idx(e / K, e % K)] = __ldcs(src + e);
}

template <int K, class T>
__device__ __forceinline__ void store_tile(const float* src, int m,
                                           float* __restrict__ dst) {
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int q = threadIdx.x; q < m / 4; q += blockDim.x) {
      const int e = 4 * q;
      __stcs(d4 + q, make_float4(src[T::idx(e / K, e % K)],
                                 src[T::idx((e + 1) / K, (e + 1) % K)],
                                 src[T::idx((e + 2) / K, (e + 2) % K)],
                                 src[T::idx((e + 3) / K, (e + 3) % K)]));
    }
    e0 = m / 4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < m; e += blockDim.x)
    __stcs(dst + e, src[T::idx(e / K, e % K)]);
}

// One warp: the composite of every sample of this column before `tile`:
// tile 0's inclusive prefix, then the aggregates of tiles 1 .. tile-1,
// composed in windows of 32 (lane i reads tile t-i of the window) by the
// same shuffle tree whatever the timing, so the result is one fixed
// function of the inputs. `row0` points at tile 0's words of this (row,
// column). The value is the same in every lane.
__device__ Pair linrec_lookback(const unsigned long long* row0, int tile,
                                unsigned epoch, int lane) {
  const unsigned agg_tag = epoch << 2 | kAggregate;
  const unsigned pre_tag = epoch << 2 | kPrefix;
  Pair acc = {1.f, 0.f};   // composite of the later tiles already read
  for (int t = tile - 1; t >= 0; t -= 32) {
    const int mine = t - lane;
    const unsigned long long* w = row0 + 3 * (size_t)max(mine, 0);
    bool ready = mine < 0;
    Pair v = {1.f, 0.f};
    for (;;) {
      if (!ready && mine == 0) {
        const unsigned long long p = ld_word(w + 2);
        if (tag_of(p) == pre_tag) {
          ready = true;
          v = {1.f, value_of(p)};
        }
      } else if (!ready) {
        const unsigned long long wa = ld_word(w), wb = ld_word(w + 1);
        if (tag_of(wa) == agg_tag && tag_of(wb) == agg_tag) {
          ready = true;
          v = {value_of(wa), value_of(wb)};
        }
      }
      if (__all_sync(kFull, ready)) break;
    }
    // lane 0 <- v[31] then ... then v[0]: higher lanes are earlier tiles
    for (int off = 1; off < 32; off <<= 1) {
      const Pair o = {__shfl_down_sync(kFull, v.a, off),
                      __shfl_down_sync(kFull, v.b, off)};
      if (lane + off < 32) v = compose(o, v);
    }
    acc = compose({__shfl_sync(kFull, v.a, 0), __shfl_sync(kFull, v.b, 0)},
                  acc);
  }
  return acc;
}

// y[i] = a[i] * y[i-1] + b[i] along n for every column of every row.
// b, y: (B, n, K) contiguous. `a` is per sample (a_mode 2: contiguous like
// b), per (row, column) (a_mode 1: stride 0 along n, strides sa_b, sa_k,
// so a per-column constant costs no bytes and no copy), or the scalar
// a_scalar (a_mode 0, no tensor).
//
// Bound at the main path's shapes (bytes over 3.35 TB/s, each input read
// once and each output written once, a at stride 0 counted as K floats):
// bank4 (4, 24576, 4) 3.15 MB -> 0.94 us, (4, 24576, 2) 1.57 MB -> 0.47 us,
// (4, 384, 1) 12 KB -> 0.004 us; chan64 (64, 12288, 4) 25.2 MB -> 7.51 us,
// (64, 12288, 2) 12.6 MB -> 3.76 us, (64, 192, 1) 0.1 MB -> 0.03 us. What
// the design does about it: b is read and y written once each, coalesced
// through shared memory, a at stride 0 is read once a column; 512-sample
// tiles put 192 blocks on bank4's 4 rows, 1024-sample ones 768 on
// chan64's 64; no fence on the look-back's path, which reads every
// predecessor's aggregate (a warp-wide load of 32 at a time) and waits on
// no predecessor's look-back. What still holds it back: each block's
// chain of ticket, load, scan, look-back and store leaves the memory
// idle between its phases, and the small shapes are bound by the launch
// and the look-back.
template <int K, int RUN>
__global__ void __launch_bounds__(K * kColThreads)
linrec_kernel(const float* __restrict__ a, float a_scalar, long long sa_b,
              long long sa_k, int a_mode, const float* __restrict__ b,
              const float* __restrict__ y_prev, float* __restrict__ y,
              float* __restrict__ y_last, int batch, int n,
              int tiles_per_row, unsigned long long* __restrict__ words,
              long long n_words, unsigned* __restrict__ ctl,
              unsigned max_epoch) {
  using T = Tile<RUN>;
  __shared__ float s_b[K * T::kColStride];
  __shared__ float s_a[K * T::kColStride];
  __shared__ Pair s_warp[2 * K];
  __shared__ float s_carry[K];
  __shared__ int s_row, s_tile, s_last;
  __shared__ unsigned s_epoch;
  unsigned* tickets = ctl + kCtlTickets;

  if (threadIdx.x == 0) {
    s_epoch = read_epoch(ctl);
    take_ticket(tickets, batch, tiles_per_row, &s_row, &s_tile);
  }
  __syncthreads();
  const int row = s_row, tile = s_tile;
  const unsigned epoch = s_epoch;
  const int s0 = tile * T::kLen;
  const int cnt = min(T::kLen, n - s0);
  const size_t base = ((size_t)row * n + s0) * K;

  load_tile<K, T>(b + base, cnt * K, s_b);
  if (a_mode == 2) load_tile<K, T>(a + base, cnt * K, s_a);
  __syncthreads();

  const int c = threadIdx.x / kColThreads;   // this thread's column
  const int j = threadIdx.x % kColThreads;   // its run in the column
  const int w = j / 32;                      // its warp in the column
  const int lane = threadIdx.x % 32;
  const float a_col = a_mode == 0 ? a_scalar
                    : a_mode == 1 ? __ldg(a + row * sa_b + c * sa_k)
                                  : 0.f;

  // the run's composite, then the warp's inclusive scan of runs
  float av[RUN], bv[RUN];
  Pair inc = {1.f, 0.f};
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int s = j * RUN + i;
    const bool in = s < cnt;
    av[i] = in ? (a_mode == 2 ? s_a[T::idx(s, c)] : a_col) : 1.f;
    bv[i] = in ? s_b[T::idx(s, c)] : 0.f;
    inc = compose(inc, {av[i], bv[i]});
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const Pair o = {__shfl_up_sync(kFull, inc.a, off),
                    __shfl_up_sync(kFull, inc.b, off)};
    if (lane >= off) inc = compose(o, inc);
  }
  if (lane == 31) s_warp[threadIdx.x / 32] = inc;
  __syncthreads();
  if (w == 1) inc = compose(s_warp[2 * c], inc);
  Pair ex = {__shfl_up_sync(kFull, inc.a, 1), __shfl_up_sync(kFull, inc.b, 1)};
  if (lane == 0) ex = w == 1 ? s_warp[2 * c] : Pair{1.f, 0.f};

  // publish: tile 0 its inclusive prefix, the others their aggregate
  // (held by the column's last thread)
  unsigned long long* row0 = words + 3 * ((size_t)row * K + c) * tiles_per_row;
  unsigned long long* mine = row0 + 3 * (size_t)tile;
  if (j == kColThreads - 1) {
    if (tile == 0) {
      const float yp = y_prev[row * K + c];
      st_word(mine + 2, epoch << 2 | kPrefix, compose({1.f, yp}, inc).b);
      s_carry[c] = yp;
    } else {
      st_word(mine, epoch << 2 | kAggregate, inc.a);
      st_word(mine + 1, epoch << 2 | kAggregate, inc.b);
    }
  }
  __syncthreads();
  if (tile > 0 && w == 0) {
    const Pair e = linrec_lookback(row0, tile, epoch, lane);
    if (lane == 0) s_carry[c] = e.b;
  }
  __syncthreads();

  // rescan the run from the carried-in value, y over b in shared memory
  float yv = fmaf(ex.a, s_carry[c], ex.b);
#pragma unroll
  for (int i = 0; i < RUN; ++i) {
    const int s = j * RUN + i;
    yv = fmaf(av[i], yv, bv[i]);
    if (s < cnt) s_b[T::idx(s, c)] = yv;
    if (s == cnt - 1 && tile == tiles_per_row - 1) y_last[row * K + c] = yv;
  }
  __syncthreads();
  store_tile<K, T>(s_b, cnt * K, y + base);
  finish_launch(ctl, words, n_words, epoch, max_epoch, &s_last);
}

// ---- sr_latch ----
constexpr int kLatchRun = 16;    // 16 bytes of set, 16 of reset a lane
// status byte: bits 0-1 state, bit 2 the command (1 set, 0 reset), bits
// 3-7 the epoch (1..31)
constexpr unsigned kLatchEmpty = 1, kLatchFinal = 2;

__device__ __forceinline__ int latch_cmd(unsigned set, unsigned reset) {
  return set ? 1 : (reset ? -1 : 0);
}

__device__ __forceinline__ void latch_publish(uint8_t* p, unsigned epoch,
                                              unsigned state, int cmd) {
  *reinterpret_cast<volatile uint8_t*>(p) =
      (uint8_t)(epoch << 3 | (cmd > 0 ? 4u : 0u) | state);
}

// One warp: the effective command (+1 or -1) before `tile`, from the
// status bytes of tiles tile-1, tile-2, ... (lane i reads tile t-i).
__device__ int latch_lookback(const uint8_t* row0, int tile, unsigned epoch,
                              int lane) {
  for (int t = tile - 1;; t -= 32) {
    const int mine = t - lane;
    unsigned v = 0;
    for (;;) {
      if (mine >= 0) v = *reinterpret_cast<const volatile uint8_t*>(row0 + mine);
      if (__all_sync(kFull, mine < 0 || (v >> 3) == epoch)) break;
    }
    // tile 0 is always final, so the window holds one before it runs out
    const unsigned fin =
        __ballot_sync(kFull, mine >= 0 && (v & 3) == kLatchFinal);
    if (fin) return (__shfl_sync(kFull, v, __ffs(fin) - 1) & 4) ? 1 : -1;
  }
}

// Set/reset latch along n: the effective command is the last non-hold
// (non-zero) one; before any, the gate keeps g_prev. The monoid is "the
// later non-zero command wins", so a tile with any command publishes its
// prefix without looking back. set, reset (B, n) bytes (0/1); gate (B, n)
// float32. W warps a block, a tile of W * 512 samples.
//
// Bound at the main path's shapes (bytes over 3.35 TB/s: 2 bytes of
// commands in, 4 bytes of gate out a sample): bank4 (4, 24576) 0.59 MB ->
// 0.18 us; chan64 (64, 12288) 4.72 MB -> 1.41 us. What the design does
// about it: each lane loads 16 bytes of set and 16 of reset, and the
// gate goes out as float4s through shared memory, neighbouring threads on
// neighbouring addresses; one-warp tiles give bank4 192 blocks, four-warp
// ones chan64 384, and a tile looks back on one byte of status. At these sizes the
// launch, the ticket and the look-back chain bound it, not the bytes.
template <int W>
__global__ void __launch_bounds__(32 * W)
sr_latch_kernel(const uint8_t* __restrict__ set,
                const uint8_t* __restrict__ reset,
                const float* __restrict__ g_prev, float* __restrict__ gate,
                float* __restrict__ gate_last, int batch, int n,
                int tiles_per_row, uint8_t* __restrict__ status,
                long long n_words, unsigned* __restrict__ ctl,
                unsigned max_epoch) {
  constexpr int kLen = 32 * W * kLatchRun;
  // the gate, staged for coalesced stores: a lane's 16 floats, padded to
  // 20 so that 8 lanes' float4 writes fall on 32 distinct banks
  constexpr int kLanePad = kLatchRun + 4;
  __shared__ __align__(16) float s_gate[32 * W * kLanePad];
  __shared__ int s_warp[W];
  __shared__ int s_before;
  __shared__ int s_row, s_tile, s_last;
  __shared__ unsigned s_epoch;
  unsigned* tickets = ctl + kCtlTickets;
  const int lane = threadIdx.x % 32, wid = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    s_epoch = read_epoch(ctl);
    take_ticket(tickets, batch, tiles_per_row, &s_row, &s_tile);
  }
  __syncthreads();
  const int row = s_row, tile = s_tile;
  const unsigned epoch = s_epoch;
  const int cnt = min(kLen, n - tile * kLen);
  const size_t base = (size_t)row * n + (size_t)tile * kLen;
  const int first = threadIdx.x * kLatchRun;

  union Bytes {
    uint4 v;
    uint8_t u[16];
  } S, R;
  const bool vec = first + kLatchRun <= cnt &&
      ((reinterpret_cast<uintptr_t>(set + base) |
        reinterpret_cast<uintptr_t>(reset + base)) & 15) == 0;
  if (vec) {
    S.v = __ldcs(reinterpret_cast<const uint4*>(set + base + first));
    R.v = __ldcs(reinterpret_cast<const uint4*>(reset + base + first));
  } else {
#pragma unroll
    for (int i = 0; i < kLatchRun; ++i) {
      const bool in = first + i < cnt;
      S.u[i] = in ? set[base + first + i] : 0;
      R.u[i] = in ? reset[base + first + i] : 0;
    }
  }
  int inc = 0;
#pragma unroll
  for (int i = 0; i < kLatchRun; ++i) {
    const int cmd = latch_cmd(S.u[i], R.u[i]);
    if (cmd) inc = cmd;
  }
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, inc, off);
    if (lane >= off && inc == 0) inc = o;
  }
  int ex = __shfl_up_sync(kFull, inc, 1);
  if (lane == 0) ex = 0;
  if (lane == 31) s_warp[wid] = inc;
  __syncthreads();
  int ex_w = 0, agg = 0;   // the warps before this one; the whole tile
#pragma unroll
  for (int q = 0; q < W; ++q) {
    if (q < wid && s_warp[q]) ex_w = s_warp[q];
    if (s_warp[q]) agg = s_warp[q];
  }

  if (wid == 0) {
    uint8_t* row0 = status + (size_t)row * tiles_per_row;
    int before;   // the effective command before this tile: +1 or -1
    if (tile == 0) {
      before = g_prev[row] > 0.5f ? 1 : -1;
      if (lane == 0)
        latch_publish(row0, epoch, kLatchFinal, agg ? agg : before);
    } else {
      if (lane == 0)
        latch_publish(row0 + tile, epoch, agg ? kLatchFinal : kLatchEmpty,
                      agg);
      before = latch_lookback(row0, tile, epoch, lane);
      if (lane == 0 && agg == 0)
        latch_publish(row0 + tile, epoch, kLatchFinal, before);
    }
    if (lane == 0) s_before = before;
  }
  __syncthreads();

  int cur = ex ? ex : (ex_w ? ex_w : s_before);
  float out[kLatchRun];
#pragma unroll
  for (int i = 0; i < kLatchRun; ++i) {
    const int cmd = latch_cmd(S.u[i], R.u[i]);
    if (cmd) cur = cmd;
    out[i] = cur > 0 ? 1.f : 0.f;
  }
  float4* mine = reinterpret_cast<float4*>(s_gate + threadIdx.x * kLanePad);
#pragma unroll
  for (int q = 0; q < kLatchRun / 4; ++q)
    mine[q] = make_float4(out[4 * q], out[4 * q + 1], out[4 * q + 2],
                          out[4 * q + 3]);
  const int last = cnt - 1 - first;
  if (tile == tiles_per_row - 1 && last >= 0 && last < kLatchRun)
    gate_last[row] = out[last];
  __syncthreads();
  // the tile's gate out in order: a float4 a thread where aligned
  float* G = gate + base;
  int e0 = 0;
  if ((reinterpret_cast<uintptr_t>(G) & 15) == 0) {
    for (int q = threadIdx.x; q < cnt / 4; q += 32 * W) {
      const int e = 4 * q;
      __stcs(reinterpret_cast<float4*>(G) + q,
             *reinterpret_cast<const float4*>(
                 s_gate + e / kLatchRun * kLanePad + e % kLatchRun));
    }
    e0 = cnt / 4 * 4;
  }
  for (int e = e0 + threadIdx.x; e < cnt; e += 32 * W)
    __stcs(G + e, s_gate[e / kLatchRun * kLanePad + e % kLatchRun]);
  finish_launch(ctl, status, n_words, epoch, max_epoch, &s_last);
}

}  // namespace

extern "C" {

// a: see linrec_kernel (null with a_mode 0); b, y: (batch, n, k) float32
// contiguous, k in 1..4; y_prev, y_last: (batch, k); tile 512 or 1024.
// words: n_words u64, at least 3 * batch * k * ceil(n / tile), each 0 or
// written by an earlier launch on this ctl; ctl: 2 + batch u32 control
// words (above: all 0 in a new buffer, as each launch leaves them but
// the epoch); max_epoch in 2..2^30-1, the same on every launch on this
// ctl. Returns the cudaError_t of the launch.
int pysdr_linrec_f32(const float* a, float a_scalar, long long sa_b,
                     long long sa_k, int a_mode, const float* b,
                     const float* y_prev, float* y, float* y_last,
                     int batch, int n, int k, int tile, void* words,
                     long long n_words, void* ctl, unsigned max_epoch,
                     void* stream) {
  if (batch < 1 || n < 1 || k < 1 || k > 4 ||
      (tile != Tile<8>::kLen && tile != Tile<16>::kLen) || a_mode < 0 ||
      a_mode > 2 || (a_mode > 0 && a == nullptr) || max_epoch < 2 ||
      max_epoch >= (1u << 30))
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + tile - 1) / tile;
  if ((long long)batch * tiles >= (1LL << 31) ||
      n_words < 3LL * batch * k * tiles)
    return (int)cudaErrorInvalidValue;
  const dim3 grid(batch * tiles);
  cudaStream_t s = (cudaStream_t)stream;
  unsigned long long* wd = (unsigned long long*)words;
  unsigned* c = (unsigned*)ctl;
#define PYSDR_LINREC(K, RUN)                                                \
  linrec_kernel<K, RUN><<<grid, K * kColThreads, 0, s>>>(                   \
      a, a_scalar, sa_b, sa_k, a_mode, b, y_prev, y, y_last, batch, n,      \
      tiles, wd, n_words, c, max_epoch)
#define PYSDR_LINREC_K(RUN)            \
  switch (k) {                         \
    case 1: PYSDR_LINREC(1, RUN); break; \
    case 2: PYSDR_LINREC(2, RUN); break; \
    case 3: PYSDR_LINREC(3, RUN); break; \
    default: PYSDR_LINREC(4, RUN); break; \
  }
  if (tile == Tile<8>::kLen) {
    PYSDR_LINREC_K(8)
  } else {
    PYSDR_LINREC_K(16)
  }
#undef PYSDR_LINREC_K
#undef PYSDR_LINREC
  return (int)cudaGetLastError();
}

// set, reset: (batch, n) uint8 (0/1); g_prev, gate_last: (batch,); gate:
// (batch, n) float32; tile 512 (one warp) or 2048 (four). status: n_words
// bytes, at least batch * ceil(n / tile); ctl as for linrec; max_epoch in
// 2..31.
int pysdr_sr_latch_u8(const uint8_t* set, const uint8_t* reset,
                      const float* g_prev, float* gate, float* gate_last,
                      int batch, int n, int tile, void* status,
                      long long n_words, void* ctl, unsigned max_epoch,
                      void* stream) {
  if (batch < 1 || n < 1 || (tile != 512 && tile != 2048) ||
      max_epoch < 2 || max_epoch > 31)
    return (int)cudaErrorInvalidValue;
  const int tiles = (n + tile - 1) / tile;
  if ((long long)batch * tiles >= (1LL << 31) ||
      n_words < (long long)batch * tiles)
    return (int)cudaErrorInvalidValue;
  uint8_t* st = (uint8_t*)status;
  unsigned* c = (unsigned*)ctl;
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 512)
    sr_latch_kernel<1><<<batch * tiles, 32, 0, s>>>(
        set, reset, g_prev, gate, gate_last, batch, n, tiles, st, n_words,
        c, max_epoch);
  else
    sr_latch_kernel<4><<<batch * tiles, 128, 0, s>>>(
        set, reset, g_prev, gate, gate_last, batch, n, tiles, st, n_words,
        c, max_epoch);
  return (int)cudaGetLastError();
}

}  // extern "C"
