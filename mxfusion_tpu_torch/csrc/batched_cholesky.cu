// Batched Cholesky of small SPD matrices on NVIDIA Hopper (sm_90a), fp32.
//
// Kernels over a stack A (B, n, n) of dense row-major float32 matrices,
// 1 <= n <= 128, each writing L (B, n, n): the lower Cholesky factor with
// the upper triangle exactly 0. All factor (A + A^T) / 2, as
// jnp.linalg.cholesky does (exactly A for a symmetric A; the transposed
// read happens once, at load). A matrix whose pivot is not positive (or
// NaN) is not positive definite: its L gets NaN in the whole lower
// triangle and 0 above, the pattern jnp.linalg.cholesky returns and the
// plain version (ops/batched_cholesky.py) copies.
//
// K4 replaces mxfusion_tpu/ops/pallas_batched_cholesky.py::_kernel_v2
// (launched by _pallas_batched_cholesky_v2; public entries
// batched_cholesky and cholesky, which the multivariate normals call).
// Its arithmetic is the TPU kernel's scaled right-looking order: at column
// j, d = sqrt(W[j][j]), inv = 1 / d (IEEE sqrt and division where JAX
// takes rsqrt), c_i = W[i][j] * inv for i > j, L[j][j] = d, L[i][j] = c_i,
// then W[i][k] = fma(-c_i, c_k, W[i][k]) for i, k > j. Two kernels do it
// with the same operations on the same values, so they give the same bits:
//
// - right_looking_warp_kernel<N> (n <= N, N = 32 or 64; every stack of
//   the MVN path): one warp per matrix, several warps per block, no block
//   barrier. What bounds K4 on this card is moving the stack (8192 x 64^2
//   reads and writes 268 MB, 80 us at 3.35 TB/s); the arithmetic (n^3 / 3
//   flops) and the n serial column steps must hide under that. So the
//   working matrix lives in registers: lane l holds row l (its first 32
//   columns, all that a row < 32 needs) and, at N = 64, row 32 + l; rows
//   and columns >= n are padded by the identity, whose factor leaves the
//   leading n x n block unchanged. A column step is one shuffle for the
//   pivot, one store of each lane's c_i to a per-warp shared row, one
//   __syncwarp, and broadcast 16-byte reads of that row feeding the FMAs.
//   Each held row shifts left by one column per step (w[t] = W[i][j + t]),
//   so every register index is static inside a loop over j that is not
//   unrolled: a fully unrolled j loop needs no shift but is some 100 KB of
//   straight-line code that every warp runs once per matrix, more than
//   the instruction cache holds. The loop runs in phases of 16
//   columns over which the entries a row still needs (its columns j .. i)
//   shrink. The stack moves through a per-warp shared tile with 16-byte
//   cp.async copies and 16-byte stores (4-byte ones where n % 4 != 0 or a
//   pointer is not 16-byte aligned); the tile's 16-byte chunks are
//   XOR-swizzled by row so that a lane reading its row (A[i][.]) and a lane
//   reading its column (A[.][i], the symmetrize) both hit 32 banks, and L
//   is written into the tile column by column as it is formed.
// - right_looking_kernel (64 < n <= 128; no path uses it): one block of
//   32 x 8 threads per matrix in shared memory (row pitch n|1, so that a
//   column read by 32 threads hits 32 banks), one __syncthreads per
//   column. Column j is not written at step j, so the reads and writes of
//   a step never overlap; c_i and c_k are formed where they are used and
//   the last pass writes L[i][j] = W[i][j] * inv_j.
//
// K5, left_looking_kernel, replaces ::_kernel (the r3 variant, launched
// by _pallas_batched_cholesky). Same factorization, left-looking (Crout)
// column order, natural layout: thread i owns row i; at column j every
// thread forms s_j = A[j][j] - sum_{k<j} L[j][k]^2 (the same reads, so the
// same value), and thread i > j forms s_i = A[i][j] - sum_{k<j} L[i][k]
// L[j][k] and stores L[i][j] = s_i / sqrt(s_j). One __syncthreads per
// column; the diagonal goes to a separate array so that no thread
// overwrites A[j][j] while others read it. Bound by its n serial,
// synchronized column steps; it could take K4's warp design (later work).
//
// Sums run in a fixed order with no atomics, so every result is bitwise
// repeatable. Above 48 KB the launch raises the block's dynamic shared
// memory limit with cudaFuncSetAttribute.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kRowThreads = 32;  // block kernels: threads along a row (k)
constexpr int kColThreads = 8;   // block kernels: threads along a column (i)
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;

// warps (matrices) per block of the warp kernel at tier N: 36 KB and
// 68 KB of shared memory; at least two and three blocks per SM (at most
// 128 and 170 registers a thread, so that neither spills)
template <int N>
__host__ __device__ constexpr int warps_per_block() {
  return N == 32 ? 8 : 4;
}

// floats of shared memory per warp: the N x N tile and two column rows
// of 2N
template <int N>
__host__ __device__ constexpr int warp_floats() { return N * N + 4 * N; }

__host__ __device__ inline int row_pitch(int n) { return n | 1; }

size_t block_smem_bytes(int n) {
  return (size_t)n * row_pitch(n) * sizeof(float) + 2 * (size_t)n * sizeof(float);
}

template <int N>
size_t warp_smem_bytes() {
  return (size_t)warps_per_block<N>() * warp_floats<N>() * sizeof(float);
}

__device__ inline float quiet_nan() { return __int_as_float(0x7fffffff); }

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Word offset of element (r, k) in a warp's N x N tile: 16-byte chunk k/4
// of row r sits at chunk (k/4) ^ (r & 7).
template <int N>
__device__ __forceinline__ int swz(int r, int k) {
  return r * N + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// One column step on a held row. On entry w[t] = W[i][j + t]; on exit
// w[t] = W'[i][j + 1 + t] after W'[i][k] = fma(-c_i, c_k, W[i][k]), for
// t < USED (the rest of w is not read again). cr4 points at the column
// row cr (c_k at cr[k]) plus j - S, 16-byte aligned; S = j % 4 is static.
// Shifting by one column per step keeps every register index static in a
// loop over j that is not unrolled, so the code stays small.
template <int S, int USED, int LEN>
__device__ __forceinline__ void shift_update(float (&w)[LEN], float c,
                                             const float* cr4) {
#pragma unroll
  for (int g = 0; g <= (S + USED - 1) / 4; ++g) {
    const float4 v = reinterpret_cast<const float4*>(cr4)[g];
    const float ck[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = 4 * g + e - S;  // w[t] pairs with row j + t
      if (t >= 1 && t < USED) w[t - 1] = fmaf(-c, ck[e], w[t]);
    }
  }
  w[USED - 1] = 0.f;
}

template <int USED, int LEN>
__device__ __forceinline__ void shift_update(float (&w)[LEN], float c,
                                             const float* cr4, int s) {
  switch (s) {  // s is a constant once the caller's loop is unrolled
    case 0: shift_update<0, USED>(w, c, cr4); break;
    case 1: shift_update<1, USED>(w, c, cr4); break;
    case 2: shift_update<2, USED>(w, c, cr4); break;
    default: shift_update<3, USED>(w, c, cr4); break;
  }
}

// Columns ja .. jb-1 (multiples of 4 apart from jb) of the warp's matrix.
// Lane l holds row l in w0 and row 32 + l in w1 (w[0] = W[i][j]); U0 and
// U1 are how many entries of each are still needed (0: the row is done),
// and HP the half that holds the pivot rows. Per column: the pivot by
// shuffle from the lane that holds it, L[i][j] into the tile, c_i into the
// column row cr, one __syncwarp, then the shifted update. Returns false
// if a pivot was not positive (uniform across the warp).
template <int N, int U0, int U1, int HP, int LEN1>
__device__ __forceinline__ bool columns(float (&w0)[kWarp], float (&w1)[LEN1],
                                        int ja, int jb, int lane, float* tile,
                                        float* colrow) {
  for (int j4 = ja; j4 < jb; j4 += 4) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int j = j4 + s;
      const float p = __shfl_sync(kFullMask, HP == 0 ? w0[0] : w1[0], j % kWarp);
      if (!(p > 0.f)) return false;
      const float d = sqrtf(p);
      const float inv = 1.f / d;
      float* cr = colrow + (s & 1) * 2 * N;  // j's parity: j4 % 4 == 0
      float c0 = 0.f;
      float c1 = 0.f;
      if (U0 > 0) {
        const int i = lane;
        c0 = i > j ? w0[0] * inv : 0.f;
        if (i >= j) tile[swz<N>(i, j)] = i > j ? c0 : d;
        cr[i] = c0;
      }
      if (U1 > 0) {
        const int i = kWarp + lane;
        c1 = i > j ? w1[0] * inv : 0.f;
        if (i >= j) tile[swz<N>(i, j)] = i > j ? c1 : d;
        cr[i] = c1;
      }
      __syncwarp();
      if (U0 > 0) shift_update<U0>(w0, c0, cr + j4, s);
      if (U1 > 0) shift_update<U1>(w1, c1, cr + j4, s);
      // the next column writes the other row: one __syncwarp per column
    }
  }
  return true;
}

template <int N>
__global__ void __launch_bounds__(warps_per_block<N>() * kWarp, N == 32 ? 2 : 3)
right_looking_warp_kernel(const float* __restrict__ A, float* __restrict__ L,
                          int B, int n) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * warps_per_block<N>() + warp;
  if (b >= B) return;  // no block barrier below: a warp may leave alone
  float* tile = smem + warp * warp_floats<N>();
  // two column rows of 2N (rows N .. 2N-1 stay 0), alternating by column
  float* colrow = tile + N * N;
  const size_t nn = (size_t)n * n;
  const float* Ab = A + (size_t)b * nn;
  float* Lb = L + (size_t)b * nn;
  // 16-byte copies need n % 4 == 0 (rows, and so every matrix, start on
  // a 16-byte boundary when the stack does) and 16-byte aligned stacks
  const bool vec = (n % 4 == 0) && ((reinterpret_cast<uintptr_t>(A) |
                                     reinterpret_cast<uintptr_t>(L)) % 16 == 0);
  const int q4 = n / 4;

  if (vec) {
    for (int q = lane; q < n * q4; q += kWarp) {
      const int r = q / q4;
      cp_async16(tile + swz<N>(r, 4 * (q - r * q4)), Ab + 4 * (size_t)q);
    }
  } else {
    for (int e = lane; e < n * n; e += kWarp) {
      const int r = e / n;
      cp_async4(tile + swz<N>(r, e - r * n), Ab + e);
    }
  }
  for (int e = lane; e < 4 * N; e += kWarp) colrow[e] = 0.f;
  cp_async_wait_all();
  __syncwarp();

  // symmetrize into registers: lane l holds row l in w0 (its first 32
  // columns: the lower triangle of a row < 32 needs no more) and, at
  // N = 64, row 32 + l in w1; padded rows and columns (>= n) are the
  // identity's
  float w0[kWarp];
  float w1[N];  // unused at N = 32
#pragma unroll
  for (int h = 0; h < N / kWarp; ++h) {
    const int i = h * kWarp + lane;
#pragma unroll
    for (int c = 0; c < (h == 0 ? kWarp : N) / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(
          tile + i * N + ((c ^ (i & 7)) << 2));
      const float row[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * c + e;
        const float x = (i < n && k < n)
                            ? 0.5f * (row[e] + tile[swz<N>(k, i)])
                            : (i == k ? 1.f : 0.f);
        if (h == 0)
          w0[k] = x;
        else
          w1[k] = x;
      }
    }
  }
  __syncwarp();

  // columns in groups of 4 (so that cr + j - j % 4 is 16-byte aligned) up
  // to n rounded up, within N (a padded column's pivot is 1 and leaves the
  // rest unchanged), in phases of 16 over which the entries a row still
  // needs (its columns j .. i) shrink
  const int jend = min((n + 3) & ~3, N);
  bool ok;
  if (N == 32) {
    ok = columns<N, 32, 0, 0>(w0, w1, 0, min(jend, 16), lane, tile, colrow) &&
         columns<N, 16, 0, 0>(w0, w1, 16, jend, lane, tile, colrow);
  } else {
    ok = columns<N, 32, 64, 0>(w0, w1, 0, 16, lane, tile, colrow) &&
         columns<N, 16, 48, 0>(w0, w1, 16, 32, lane, tile, colrow) &&
         columns<N, 0, 32, 1>(w0, w1, 32, min(jend, 48), lane, tile, colrow) &&
         columns<N, 0, 16, 1>(w0, w1, 48, jend, lane, tile, colrow);
  }
  const bool failed = !ok;
  __syncwarp();

  // L from the tile: its lower triangle holds every L[i][j]; 0 above it,
  // all NaN below it on failure
  if (vec) {
    for (int q = lane; q < n * q4; q += kWarp) {
      const int r = q / q4;
      const int k0 = 4 * (q - r * q4);
      const float4 t = *reinterpret_cast<const float4*>(tile + swz<N>(r, k0));
      const float x[4] = {t.x, t.y, t.z, t.w};
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = k0 + e <= r ? (failed ? quiet_nan() : x[e]) : 0.f;
      *reinterpret_cast<float4*>(Lb + 4 * (size_t)q) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int e = lane; e < n * n; e += kWarp) {
      const int r = e / n;
      const int k = e - r * n;
      Lb[e] = k <= r ? (failed ? quiet_nan() : tile[swz<N>(r, k)]) : 0.f;
    }
  }
}

__global__ void __launch_bounds__(kRowThreads* kColThreads)
right_looking_kernel(const float* __restrict__ A, float* __restrict__ L,
                     int n) {
  extern __shared__ float smem[];
  const int p = row_pitch(n);
  float* W = smem;               // n x p, lower triangle used
  float* diag = smem + n * p;    // d_j = sqrt of each pivot
  float* rdiag = diag + n;       // 1 / d_j
  const size_t off = (size_t)blockIdx.x * n * n;
  const float* Ab = A + off;
  float* Lb = L + off;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  for (int i = ty; i < n; i += kColThreads)
    for (int k = tx; k <= i; k += kRowThreads)
      W[i * p + k] = 0.5f * (Ab[(size_t)i * n + k] + Ab[(size_t)k * n + i]);
  __syncthreads();

  bool failed = false;
  for (int j = 0; j < n; ++j) {
    // every thread reads the same pivot, so the branch is uniform
    const float piv = W[j * p + j];
    if (!(piv > 0.f)) {
      failed = true;
      break;
    }
    const float d = sqrtf(piv);
    const float inv = 1.f / d;
    if (tx == 0 && ty == 0) {
      diag[j] = d;
      rdiag[j] = inv;
    }
    for (int i = j + 1 + ty; i < n; i += kColThreads) {
      const float ci = W[i * p + j] * inv;
      for (int k = j + 1 + tx; k <= i; k += kRowThreads)
        W[i * p + k] = fmaf(-ci, W[k * p + j] * inv, W[i * p + k]);
    }
    __syncthreads();
  }
  __syncthreads();

  for (int i = ty; i < n; i += kColThreads) {
    for (int k = tx; k < n; k += kRowThreads) {
      float v = 0.f;
      if (k <= i) {
        if (failed)
          v = quiet_nan();
        else if (k == i)
          v = diag[i];
        else
          v = W[i * p + k] * rdiag[k];
      }
      Lb[(size_t)i * n + k] = v;
    }
  }
}

__global__ void __launch_bounds__(kMaxN)
left_looking_kernel(const float* __restrict__ A, float* __restrict__ L, int n) {
  extern __shared__ float smem[];
  const int p = row_pitch(n);
  float* S = smem;           // n x p: A's lower triangle, then L's
  float* diag = smem + n * p;
  const size_t off = (size_t)blockIdx.x * n * n;
  const float* Ab = A + off;
  float* Lb = L + off;
  const int t = threadIdx.x;
  const int nt = blockDim.x;

  for (int idx = t; idx < n * n; idx += nt) {
    const int r = idx / n;
    const int c = idx - r * n;
    if (c <= r) S[r * p + c] = 0.5f * (Ab[idx] + Ab[(size_t)c * n + r]);
  }
  __syncthreads();

  bool failed = false;
  for (int j = 0; j < n; ++j) {
    float sj = S[j * p + j];
    for (int k = 0; k < j; ++k) sj = fmaf(-S[j * p + k], S[j * p + k], sj);
    if (!(sj > 0.f)) {
      failed = true;
      break;
    }
    const float d = sqrtf(sj);
    if (t == j) diag[j] = d;
    if (t > j && t < n) {
      float si = S[t * p + j];
      for (int k = 0; k < j; ++k) si = fmaf(-S[t * p + k], S[j * p + k], si);
      S[t * p + j] = si / d;
    }
    __syncthreads();
  }
  __syncthreads();

  for (int idx = t; idx < n * n; idx += nt) {
    const int r = idx / n;
    const int c = idx - r * n;
    float v = 0.f;
    if (c <= r) v = failed ? quiet_nan() : (c == r ? diag[r] : S[r * p + c]);
    Lb[idx] = v;
  }
}

bool valid(int B, int n) { return B > 0 && n > 0 && n <= kMaxN; }

cudaError_t set_smem(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <int N>
cudaError_t launch_warp(const float* A, float* L, int B, int n,
                        cudaStream_t stream) {
  const size_t smem = warp_smem_bytes<N>();
  cudaError_t err = set_smem((const void*)right_looking_warp_kernel<N>, smem);
  if (err != cudaSuccess) return err;
  const int wpb = warps_per_block<N>();
  right_looking_warp_kernel<N><<<(B + wpb - 1) / wpb, wpb * kWarp, smem, stream>>>(
      A, L, B, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mxf_batched_cholesky_max_n() { return kMaxN; }

// Dynamic shared memory of a block at this n (ptxas reports static shared
// memory only): K4 (variant 4; a block holds several matrices for
// n <= 64) or K5 (variant 5).
long long mxf_batched_cholesky_smem_bytes(int n, int variant) {
  if (variant == 4 && n <= 32) return (long long)warp_smem_bytes<32>();
  if (variant == 4 && n <= 64) return (long long)warp_smem_bytes<64>();
  return (long long)block_smem_bytes(n);
}

// Matrices per block of K4 at this n.
int mxf_batched_cholesky_per_block(int n) {
  if (n <= 32) return warps_per_block<32>();
  if (n <= 64) return warps_per_block<64>();
  return 1;
}

// K4 on `stream` (a cudaStream_t); returns the launch's cudaError_t.
int mxf_batched_cholesky_f32(const float* A, float* L, int B, int n, void* stream) {
  if (!valid(B, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32) return (int)launch_warp<32>(A, L, B, n, s);
  if (n <= 64) return (int)launch_warp<64>(A, L, B, n, s);
  const size_t smem = block_smem_bytes(n);
  cudaError_t err = set_smem((const void*)right_looking_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  right_looking_kernel<<<B, dim3(kRowThreads, kColThreads), smem, s>>>(A, L, n);
  return (int)cudaGetLastError();
}

// K5 on `stream`: one block of n threads rounded up to a warp per matrix.
int mxf_batched_cholesky_r3_f32(const float* A, float* L, int B, int n, void* stream) {
  if (!valid(B, n)) return (int)cudaErrorInvalidValue;
  const size_t smem = block_smem_bytes(n);
  cudaError_t err = set_smem((const void*)left_looking_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (n + 31) / 32 * 32;
  left_looking_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(A, L, n);
  return (int)cudaGetLastError();
}

const char* mxf_batched_cholesky_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
