// Keyed gamma and Poisson draws on NVIDIA Hopper (sm_90a): R1 and R2.
//
// Replaces no Pallas kernel: the JAX package leaves these draws to XLA
// (jax.random.gamma and jax.random.poisson, called from
// mxfusion_tpu/components/distributions/random_gen.py:26 and :66). They
// exist so that a gamma or Poisson draw is a pure function of (key,
// parameter, element index), as JAX's draws are, and so one operator node of
// an exported program: the key is a program input, the draws are not.
//
// The counter layout, the uniforms and both algorithms are the ones written
// down in mxfusion_tpu_torch/ops/keyed_random.py, whose plain versions this
// file follows operation for operation:
//
//   (y0, y1) = Threefry-2x32, 20 rounds (JAX's key hash) of the counter
//              (word 0, word 1) = (i, 4 r + j) under the key (k0, k1):
//              i the element's flat index, r the round, j the draw in it;
//   uniform  = (2 m + 1) 2^-24 with m = y0 >> 9 (float32), or
//              (2 m + 1) 2^-53 with m = (y0 << 20) | (y1 >> 12) (float64):
//              in (0, 1), both ends excluded, exact in its type;
//   R1 (gamma): Marsaglia-Tsang on Gamma(a) for a >= 1 and on Gamma(a + 1)
//              boosted by U^(1/a) below, a Box-Muller normal (j = 0, 1) and
//              the acceptance uniform (j = 2) a round, the boost's uniform at
//              (i, 3); clamped at the type's smallest normal for a > 0;
//   R2 (Poisson): Knuth's product of uniforms (as a sum of logs, j = 0)
//              below rate 10, Hormann's transformed rejection (PTRS, j = 0
//              and 1) from 10 up; rate 0 gives 0, a negative or NaN rate -1.
//
// An element that accepts in none of its 64 rounds is written as NaN, never
// as a biased value (acceptance is above 0.9 a round: it does not happen in
// practice). The file is built with --fmad=false (ops/keyed_random.py), so
// no multiply and add are fused into one rounding, and without fast math, so
// logf, sqrtf, cosf, powf and lgammaf are the functions that torch's CUDA
// operations call: the plain version on the card gives the same bits.
//
// What bounds it on the card: integer issue. A round of R1 hashes three
// counters, about 70-88 32-bit integer instructions each (adds, funnel
// shifts, xors), which Hopper issues at half its fp32 lane rate, beside a
// log, a sqrt, a cos and a second log; the data are at most 8 or 16 bytes
// an element. The work an element needs depends on its own draws: 1.01
// rounds on average at a = 2.5, up to 64. With one thread an element, a
// warp runs rounds until its slowest element accepts, and the lanes whose
// elements have accepted sit idle: counted from the plain versions'
// hashes (keyed_random.emulate_schedule), 74% of R1's lane slots at
// a = 2.5 and 39-61% of R2's did useful work.
//
// Design:
//   * While n fits the lanes of the warps the card holds at once (its
//     occupancy, from the kernel's registers): tiles of 32 consecutive
//     elements, one a lane, each drawn to its end.
//   * R1, above the resident lanes: n split evenly over every resident
//     warp, so each SM holds as much work, and no lane waits for another's
//     element. Each lane holds the state of one element and runs one round
//     of it an iteration; a lane whose element is drawn writes it and takes
//     the tile's next one: one ballot an iteration finds the idle lanes,
//     each taking the warp's cursor plus the count of idle lanes below it.
//     Every lane reaches every ballot and shuffle; no atomics, no block
//     barrier. Each draw is written as it finishes. A dense parameter is
//     read 32 at a time, with its d and c computed by every lane together,
//     a window before the cursor reaches it, and handed to a lane by
//     shuffles; at stride 0 it is one register, its d and c computed once.
//     The boost below a = 1 (a hash and a pow an element) runs after the
//     loop, over the tile with every lane busy, on the raw draws the loop
//     wrote.
//   * R2, above the resident lanes: still one element a lane, a block for
//     each 256, which the card hands to its SMs as earlier ones finish (one
//     wave of warps striding over the tiles was 3-9% slower at 2^20). The
//     hand-out pays only where a round is dear: at 2^20 elements it was
//     1.16-1.40x faster at PTRS's rates and none at Knuth's (0.90-1.03x),
//     whose cheap rounds carry the bookkeeping, and no path draws more
//     PTRS rates than the card has resident lanes.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <mutex>

namespace {

constexpr int kRounds = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32 with 20 rounds, as jax._src.prng._threefry2x32_lowering.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t x0, uint32_t x1,
                                             uint32_t* y0, uint32_t* y1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int b = 0; b < 5; ++b) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[b & 1][j]);
      x1 ^= x0;
    }
    x0 += ks[(b + 1) % 3];
    x1 += ks[(b + 2) % 3] + (uint32_t)(b + 1);
  }
  *y0 = x0;
  *y1 = x1;
}

// The type's functions, by name, so that the templates call logf for float
// and log for double.
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float dcos(float x) { return cosf(x); }
__device__ __forceinline__ double dcos(double x) { return cos(x); }
__device__ __forceinline__ float dpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dpow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float dlgamma(float x) { return lgammaf(x); }
__device__ __forceinline__ double dlgamma(double x) { return lgamma(x); }
__device__ __forceinline__ float dfloor(float x) { return floorf(x); }
__device__ __forceinline__ double dfloor(double x) { return floor(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T> struct Traits;
template <> struct Traits<float> {
  static __device__ __forceinline__ float uniform(uint32_t y0, uint32_t) {
    return (float)(2u * (y0 >> 9) + 1u) * 0x1p-24f;
  }
  static __device__ __forceinline__ float tiny() { return 1.17549435082228751e-38f; }
};
template <> struct Traits<double> {
  static __device__ __forceinline__ double uniform(uint32_t y0, uint32_t y1) {
    const unsigned long long m =
        ((unsigned long long)y0 << 20) | (unsigned long long)(y1 >> 12);
    return (double)(2ull * m + 1ull) * 0x1p-53;
  }
  static __device__ __forceinline__ double tiny() { return 2.2250738585072014e-308; }
};

template <typename T>
__device__ __forceinline__ T uniform(uint32_t k0, uint32_t k1, uint32_t i,
                                     uint32_t w) {
  uint32_t y0, y1;
  threefry2x32(k0, k1, i, w, &y0, &y1);
  return Traits<T>::uniform(y0, y1);
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// The warp's first element and the length of its tile: 0 for a warp past
// the last element (the grid is whole blocks).
__device__ __forceinline__ int warp_tile(long long n, long long tile,
                                         long long* first) {
  *first = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * tile;
  const long long left = n - *first;
  return left <= 0 ? 0 : (int)(left < tile ? left : tile);
}

// Marsaglia-Tsang's d and c for the shape a (a + 1 below a = 1).
template <typename T>
__device__ __forceinline__ void gamma_dc(T a, T* d, T* c) {
  const T one = (T)1, third = (T)(1.0 / 3.0);
  const T al = !(a >= one) ? a + one : a;
  *d = al - third;
  *c = third / dsqrt(*d);
}

// Round r of element i's gamma draw: true, with the draw before any boost
// in *y, once it accepts or its last round rejects (then NaN).
template <typename T>
__device__ __forceinline__ bool gamma_round(uint32_t k0, uint32_t k1,
                                            uint32_t i, int r, T d, T c,
                                            T* y) {
  const T one = (T)1;
  const uint32_t w = 4u * (uint32_t)r;
  const T u1 = uniform<T>(k0, k1, i, w);
  const T u2 = uniform<T>(k0, k1, i, w + 1u);
  const T x = dsqrt(dlog(u1) * (T)-2) * dcos(u2 * (T)6.283185307179586);
  const T v = one + x * c;
  if (!(v <= (T)0)) {
    const T X = x * x;
    const T V = v * v * v;
    const T U = uniform<T>(k0, k1, i, w + 2u);
    const bool reject = (U >= one - (T)0.0331 * (X * X)) &&
                        (dlog(U) >= X * (T)0.5 + d * ((one - V) + dlog(V)));
    if (!reject) {
      *y = d * V;
      return true;
    }
  }
  if (r + 1 == kRounds) {
    *y = (T)NAN;
    return true;
  }
  return false;
}

// The draw the loop writes: clamped at tiny for a >= 1; below, raw, the
// boost pass finishes it.
template <typename T>
__device__ __forceinline__ T gamma_unboosted(T a, T y) {
  return a >= (T)1 && y < Traits<T>::tiny() ? Traits<T>::tiny() : y;
}

// R1's dense parameters, 32 at a time, with their d and c: lane l holds
// those of tile offset base + l in (a, d, c) and of base + 32 + l in
// (an, dn, cn), loaded and computed by all lanes together a window before
// the cursor reaches them.
template <typename T>
struct GammaWindow {
  const T* __restrict__ p;
  int base, count, lane;
  T a, d, c, an, dn, cn;

  __device__ GammaWindow(const T* p_, int count_, int lane_)
      : p(p_), base(0), count(count_), lane(lane_) {
    load(lane, &a, &d, &c);
    load(32 + lane, &an, &dn, &cn);
  }
  __device__ void load(int off, T* x, T* dx, T* cx) const {
    *x = off < count ? p[off] : (T)1;
    gamma_dc(*x, dx, cx);
  }
  // (a, d, c) of offset `off` for the lane that takes it, the lanes
  // taking offsets cursor + j, base <= cursor < base + 32; every lane calls
  // it (it shuffles). The 32 offsets from the cursor fall on 32 distinct
  // lanes, so each lane sends the one window's value they need of it.
  __device__ void fetch(int cursor, int off, T* x, T* dx, T* cx) const {
    const bool first_window = lane >= cursor - base;
    const int s = (off - base) & 31;
    *x = __shfl_sync(kAll, first_window ? a : an, s);
    *dx = __shfl_sync(kAll, first_window ? d : dn, s);
    *cx = __shfl_sync(kAll, first_window ? c : cn, s);
  }
  // Slide once the cursor has left the first window (it moves at most 32
  // a call, so base <= cursor < base + 32 holds again).
  __device__ void advance(int cursor) {
    if (cursor - base >= 32) {
      a = an;
      d = dn;
      c = cn;
      base += 32;
      load(base + 32 + lane, &an, &dn, &cn);
    }
  }
};

// The parameter of element e is alpha[e * stride]: stride 1 for a dense
// parameter, 0 for one value broadcast to every element. Each warp draws
// the `count` elements of its tile from `first`: a lane takes the tile's
// next element as soon as its own is written, or, in a tile of 32, draws
// its one element to the end.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    keyed_gamma_kernel(const T* __restrict__ alpha, long long stride,
                       const int64_t* __restrict__ key, T* __restrict__ out,
                       long long n, long long tile) {
  long long first;
  const int count = warp_tile(n, tile, &first);
  if (count == 0) return;  // the whole warp
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  const uint32_t i0 = (uint32_t)first;  // element first + off is i0 + off
  const int lane = threadIdx.x & 31;
  const T one = (T)1;
  const T* p = stride ? alpha + first : alpha;
  T* o = out + first;
  // at stride 0, the one value and its d and c
  const T a0 = p[0];
  T d0, c0;
  gamma_dc(a0, &d0, &c0);
  bool boosts = false;
  if (tile == 32) {
    if (lane < count) {
      const T a = stride ? p[lane] : a0;
      T d = d0, c = c0, y;
      if (stride) gamma_dc(a, &d, &c);
      for (int r = 0; !gamma_round(k0, k1, i0 + (uint32_t)lane, r, d, c, &y);
           ++r) {
      }
      o[lane] = gamma_unboosted(a, y);
      boosts = !(a >= one);
    }
  } else {
    const unsigned below = lanes_below();
    GammaWindow<T> win(p, stride ? count : 0, lane);
    // the lane's element: its offset, parameter, d, c and round
    int off = 0, r = 0, next = 0;
    T a = a0, d = d0, c = c0;
    bool live = false;
    for (;;) {
      const unsigned idle = __ballot_sync(kAll, !live);
      if (idle == kAll && next >= count) break;
      if (idle != 0 && next < count) {
        // the j-th idle lane takes offset next + j
        const int mine = next + __popc(idle & below);
        if (stride) {
          T x, dx, cx;
          win.fetch(next, mine, &x, &dx, &cx);
          if (!live) {
            a = x;
            d = dx;
            c = cx;
          }
        }
        if (!live && mine < count) {
          off = mine;
          r = 0;
          live = true;
          boosts |= !(a >= one);
        }
        next += __popc(idle);
        if (stride) win.advance(next);
      }
      if (live) {
        T y;
        if (gamma_round(k0, k1, i0 + (uint32_t)off, r, d, c, &y)) {
          o[off] = gamma_unboosted(a, y);
          live = false;
        } else {
          ++r;
        }
      }
    }
  }
  // the boost below a = 1, every lane on one element of the tile at a time
  if (__any_sync(kAll, boosts)) {
    __syncwarp();
    for (int j = lane; j < count; j += 32) {
      const T a = stride ? p[j] : a0;
      if (!(a >= one)) {
        T y = o[j] * dpow(uniform<T>(k0, k1, i0 + (uint32_t)j, 3u), one / a);
        if (a > (T)0 && y < Traits<T>::tiny()) y = Traits<T>::tiny();
        o[j] = y;
      }
    }
  }
}

// Element i's Poisson count of rate lam, drawn to its end.
template <typename T>
__device__ T poisson_one(T lam, uint32_t k0, uint32_t k1, uint32_t i) {
  if (lam == (T)0) return (T)0;
  if (isnan(lam) || lam < (T)10) {
    // Knuth: the count of uniforms whose log-sum stays above -lam
    const T neg = -lam;
    T lp = (T)0;
    for (int r = 0;; ++r) {
      if (!(lp > neg)) return (T)(r - 1);
      if (r == kRounds) return (T)NAN;
      lp = lp + dlog(uniform<T>(k0, k1, i, 4u * (uint32_t)r));
    }
  }
  // PTRS (Hormann 1993), as jax.random's _poisson_rejection
  const T log_lam = dlog(lam);
  const T b = (T)0.931 + (T)2.53 * dsqrt(lam);
  const T a = (T)-0.059 + (T)0.02483 * b;
  const T inv_alpha = (T)1.1239 + (T)1.1328 / (b - (T)3.4);
  const T v_r = (T)0.9277 - (T)3.6224 / (b - (T)2);
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t w = 4u * (uint32_t)r;
    const T u = uniform<T>(k0, k1, i, w) - (T)0.5;
    const T v = uniform<T>(k0, k1, i, w + 1u);
    const T us = (T)0.5 - dabs(u);
    const T k = dfloor(((T)2 * a / us + b) * u + lam + (T)0.43);
    const T s = dlog(v * inv_alpha / (a / (us * us) + b));
    const T t = -lam + k * log_lam - dlgamma(k + (T)1);
    const bool accept1 = us >= (T)0.07 && v <= v_r;
    const bool reject = k < (T)0 || (us < (T)0.013 && v > us);
    if (accept1 || (!reject && s <= t)) return k;
  }
  return (T)NAN;
}

// The rate of element e is rate[e * stride]. One element a lane, drawn to
// its end, a block for each kThreads elements.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    keyed_poisson_kernel(const T* __restrict__ rate, long long stride,
                         const int64_t* __restrict__ key,
                         T* __restrict__ out, long long n) {
  const long long e = blockIdx.x * (long long)kThreads + threadIdx.x;
  if (e < n)
    out[e] = poisson_one<T>(rate[e * stride], (uint32_t)key[0],
                            (uint32_t)key[1], (uint32_t)e);
}

__global__ void threefry_kernel(const int64_t* __restrict__ key,
                                const int64_t* __restrict__ x0,
                                const int64_t* __restrict__ x1,
                                int64_t* __restrict__ y0,
                                int64_t* __restrict__ y1, long long n) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x) {
    uint32_t a, b;
    threefry2x32(k0, k1, (uint32_t)x0[e], (uint32_t)x1[e], &a, &b);
    y0[e] = (int64_t)a;
    y1[e] = (int64_t)b;
  }
}

// Warps of each kernel the card holds at once (its SMs times the blocks an
// SM holds, from the kernel's registers), found once.
struct Resident {
  const void* fn;
  int warps;
};
Resident g_resident[16];
int g_n_resident = 0;
std::mutex g_resident_lock;

int resident_warps(const void* fn, int* warps) {
  std::lock_guard<std::mutex> hold(g_resident_lock);
  for (int k = 0; k < g_n_resident; ++k)
    if (g_resident[k].fn == fn) {
      *warps = g_resident[k].warps;
      return 0;
    }
  int dev = 0, sms = 0, blocks = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads,
                                                        0);
  if (err != cudaSuccess) return (int)err;
  if (blocks == 0) return (int)cudaErrorInvalidConfiguration;
  *warps = sms * blocks * kWarps;
  if (g_n_resident < 16) g_resident[g_n_resident++] = {fn, *warps};
  return 0;
}

// A launch over n elements in tiles of 32 (one element a lane), a warp a
// tile; R1 (`split`) above the card's resident lanes splits n evenly over
// every resident warp, so each SM holds as much work in one wave, where
// R2's blocks go to the SMs as earlier ones finish.
struct Plan {
  long long tile;
  unsigned grid;
  int warps;  // resident warps of the kernel on this card
};

int plan_for(const void* fn, bool split, long long n, Plan* plan) {
  const int err = resident_warps(fn, &plan->warps);
  if (err != 0) return err;
  plan->tile = split && n > 32ll * plan->warps
                   ? (n + plan->warps - 1) / plan->warps
                   : 32;
  const long long used = (n + plan->tile - 1) / plan->tile;
  plan->grid = (unsigned)((used + kWarps - 1) / kWarps);
  return 0;
}

template <typename T>
const void* gamma_fn() {
  return reinterpret_cast<const void*>(&keyed_gamma_kernel<T>);
}

template <typename T>
const void* poisson_fn() {
  return reinterpret_cast<const void*>(&keyed_poisson_kernel<T>);
}

bool bad_args(int dtype, long long stride, long long n) {
  return n <= 0 || n > 0xFFFFFFFFll || (dtype != 0 && dtype != 1) ||
         (stride != 0 && stride != 1);
}

// The launch R1 (kind 0) or R2 (kind 1) makes over n elements.
int plan_kind(int kind, int dtype, long long n, Plan* plan) {
  if (kind == 0)
    return plan_for(dtype == 0 ? gamma_fn<float>() : gamma_fn<double>(),
                    true, n, plan);
  return plan_for(dtype == 0 ? poisson_fn<float>() : poisson_fn<double>(),
                  false, n, plan);
}

}  // namespace

extern "C" {

// Each launches on `stream` (a cudaStream_t) and returns cudaGetLastError():
// nonzero when the launch was refused. `dtype` is 0 for float32 and 1 for
// float64; `stride` is the parameter's element stride, 1 or 0 (one value
// for every element); `key` points at two int64 words below 2^32 on the
// card; n < 2^32.
int mxf_keyed_gamma(int dtype, const void* alpha, long long stride,
                    const void* key, void* out, long long n, void* stream) {
  if (bad_args(dtype, stride, n)) return (int)cudaErrorInvalidValue;
  Plan plan;
  const int err = plan_kind(0, dtype, n, &plan);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(key);
  if (dtype == 0)
    keyed_gamma_kernel<float><<<plan.grid, kThreads, 0, s>>>(
        static_cast<const float*>(alpha), stride, k, static_cast<float*>(out),
        n, plan.tile);
  else
    keyed_gamma_kernel<double><<<plan.grid, kThreads, 0, s>>>(
        static_cast<const double*>(alpha), stride, k,
        static_cast<double*>(out), n, plan.tile);
  return (int)cudaGetLastError();
}

int mxf_keyed_poisson(int dtype, const void* rate, long long stride,
                      const void* key, void* out, long long n, void* stream) {
  if (bad_args(dtype, stride, n)) return (int)cudaErrorInvalidValue;
  Plan plan;
  const int err = plan_kind(1, dtype, n, &plan);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(key);
  if (dtype == 0)
    keyed_poisson_kernel<float><<<plan.grid, kThreads, 0, s>>>(
        static_cast<const float*>(rate), stride, k, static_cast<float*>(out),
        n);
  else
    keyed_poisson_kernel<double><<<plan.grid, kThreads, 0, s>>>(
        static_cast<const double*>(rate), stride, k,
        static_cast<double*>(out), n);
  return (int)cudaGetLastError();
}

// The launch R1 (kind 0) or R2 (kind 1) makes over n elements: the tile
// (the consecutive elements a warp draws at a time) and the kernel's
// resident warps on this card. Returns a CUDA error code, 0 on success.
int mxf_keyed_plan(int kind, int dtype, long long n, long long* tile,
                   int* warps) {
  if (bad_args(dtype, 1, n) || (kind != 0 && kind != 1))
    return (int)cudaErrorInvalidValue;
  Plan plan;
  const int err = plan_kind(kind, dtype, n, &plan);
  if (err != 0) return err;
  *tile = plan.tile;
  *warps = plan.warps;
  return 0;
}

// The raw words: (y0[e], y1[e]) = Threefry-2x32 of (x0[e], x1[e]).
int mxf_threefry2x32(const void* key, const void* x0, const void* x1,
                     void* y0, void* y1, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  int warps = 0;
  const int err =
      resident_warps(reinterpret_cast<const void*>(&threefry_kernel), &warps);
  if (err != 0) return err;
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most = warps / kWarps;
  threefry_kernel<<<(unsigned)(want < most ? want : most), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<const int64_t*>(x0),
      static_cast<const int64_t*>(x1), static_cast<int64_t*>(y0),
      static_cast<int64_t*>(y1), n);
  return (int)cudaGetLastError();
}

const char* mxf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
