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
// What bounds it on the card: operations. A round of R1 hashes three
// counters (about 90 32-bit integer operations each) and evaluates a log, a
// sqrt, a cos and a second log; the data are at most 8 or 16 bytes an
// element (read the parameter, unless it is one value for all, and write the
// draw). Design: one thread an element, a
// grid-stride loop over the elements, each thread looping its own rounds
// until it accepts. The loop's trip count depends on the element, which is
// why this is CUDA and not a block-wide Triton program. Simple and right
// first: no sharing of the Box-Muller pair, no warp-level compaction of the
// elements still drawing.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRounds = 64;
constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 16;

int g_sms = 0;

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

template <typename T>
__device__ T gamma_one(T a, uint32_t k0, uint32_t k1, uint32_t i) {
  const T one = (T)1, third = (T)(1.0 / 3.0);
  const bool boost = !(a >= one);
  const T al = boost ? a + one : a;
  const T d = al - third;
  const T c = third / dsqrt(d);
  T res = (T)NAN;
  for (int r = 0; r < kRounds; ++r) {
    const uint32_t w = 4u * (uint32_t)r;
    const T u1 = uniform<T>(k0, k1, i, w);
    const T u2 = uniform<T>(k0, k1, i, w + 1u);
    const T x = dsqrt(dlog(u1) * (T)-2) * dcos(u2 * (T)6.283185307179586);
    const T v = one + x * c;
    if (v <= (T)0) continue;
    const T X = x * x;
    const T V = v * v * v;
    const T U = uniform<T>(k0, k1, i, w + 2u);
    const bool reject = (U >= one - (T)0.0331 * (X * X)) &&
                        (dlog(U) >= X * (T)0.5 + d * ((one - V) + dlog(V)));
    if (!reject) {
      res = d * V;
      break;
    }
  }
  if (boost) res = res * dpow(uniform<T>(k0, k1, i, 3u), one / a);
  if (a > (T)0 && res < Traits<T>::tiny()) res = Traits<T>::tiny();
  return res;
}

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

// The parameter of element e is alpha[e * stride]: stride 1 for a dense
// parameter, 0 for one value broadcast to every element.
template <typename T>
__global__ void keyed_gamma_kernel(const T* __restrict__ alpha,
                                   long long stride,
                                   const int64_t* __restrict__ key,
                                   T* __restrict__ out, long long n) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    out[e] = gamma_one<T>(alpha[e * stride], k0, k1, (uint32_t)e);
}

template <typename T>
__global__ void keyed_poisson_kernel(const T* __restrict__ rate,
                                     long long stride,
                                     const int64_t* __restrict__ key,
                                     T* __restrict__ out, long long n) {
  const uint32_t k0 = (uint32_t)key[0], k1 = (uint32_t)key[1];
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < n;
       e += (long long)gridDim.x * blockDim.x)
    out[e] = poisson_one<T>(rate[e * stride], k0, k1, (uint32_t)e);
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

// Enough blocks to fill the card, each walking the elements grid-stride.
int grid_for(long long n, unsigned* grid) {
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const long long want = (n + kThreads - 1) / kThreads;
  const long long most = (long long)kBlocksPerSm * g_sms;
  *grid = (unsigned)(want < most ? want : most);
  return 0;
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
  if (n <= 0 || n > 0xFFFFFFFFll || (dtype != 0 && dtype != 1) ||
      (stride != 0 && stride != 1))
    return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const int err = grid_for(n, &grid);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(key);
  if (dtype == 0)
    keyed_gamma_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(alpha), stride, k, static_cast<float*>(out),
        n);
  else
    keyed_gamma_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(alpha), stride, k,
        static_cast<double*>(out), n);
  return (int)cudaGetLastError();
}

int mxf_keyed_poisson(int dtype, const void* rate, long long stride,
                      const void* key, void* out, long long n, void* stream) {
  if (n <= 0 || n > 0xFFFFFFFFll || (dtype != 0 && dtype != 1) ||
      (stride != 0 && stride != 1))
    return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const int err = grid_for(n, &grid);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* k = static_cast<const int64_t*>(key);
  if (dtype == 0)
    keyed_poisson_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(rate), stride, k, static_cast<float*>(out),
        n);
  else
    keyed_poisson_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(rate), stride, k,
        static_cast<double*>(out), n);
  return (int)cudaGetLastError();
}

// The raw words: (y0[e], y1[e]) = Threefry-2x32 of (x0[e], x1[e]).
int mxf_threefry2x32(const void* key, const void* x0, const void* x1,
                     void* y0, void* y1, long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  unsigned grid = 0;
  const int err = grid_for(n, &grid);
  if (err != 0) return err;
  threefry_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(key), static_cast<const int64_t*>(x0),
      static_cast<const int64_t*>(x1), static_cast<int64_t*>(y0),
      static_cast<int64_t*>(y1), n);
  return (int)cudaGetLastError();
}

const char* mxf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
