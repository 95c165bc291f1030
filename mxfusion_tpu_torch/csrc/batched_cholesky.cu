// Batched Cholesky of small SPD matrices on NVIDIA Hopper (sm_90a), fp32.
//
// Two kernels over a stack A (B, n, n) of dense row-major float32 matrices,
// 1 <= n <= 128, each writing L (B, n, n): the lower Cholesky factor with
// the upper triangle exactly 0. Both factor (A + A^T) / 2, as
// jnp.linalg.cholesky does (exactly A for a symmetric A; the transposed
// read happens once, at load). A matrix whose pivot is not positive (or
// NaN) is not positive definite: its L gets NaN in the whole lower
// triangle and 0 above, the pattern jnp.linalg.cholesky returns and the
// plain version (ops/batched_cholesky.py) copies.
//
// K4, right_looking_kernel, replaces
// mxfusion_tpu/ops/pallas_batched_cholesky.py::_kernel_v2 (launched by
// _pallas_batched_cholesky_v2; public entries batched_cholesky and
// cholesky, which the multivariate normals call). The TPU kernel runs a
// chunk of matrices side by side on the vector lanes and updates the whole
// (chunk, n, n) working matrix per column. Here one thread block (32 x 8
// threads) owns one matrix, held in shared memory (lower triangle, row
// pitch n|1 so that a column read by 32 threads hits 32 banks). At column j
// every thread reads the pivot p = W[j][j] and applies the rank-1 update
// W[i][k] -= (W[i][j] / p) * W[k][j] to the trailing lower triangle
// j < k <= i. Column j itself is not written at step j, so the reads and
// writes of a step never overlap and one __syncthreads per column
// suffices. Column j keeps its unscaled values; the last pass writes
// L[i][j] = W[i][j] / sqrt(W[j][j]).
//
// K5, left_looking_kernel, replaces ::_kernel (the r3 variant, launched
// by _pallas_batched_cholesky). Same factorization, left-looking (Crout)
// column order, natural layout: thread i owns row i; at column j every
// thread forms s_j = A[j][j] - sum_{k<j} L[j][k]^2 (the same reads, so the
// same value), and thread i > j forms s_i = A[i][j] - sum_{k<j} L[i][k]
// L[j][k] and stores L[i][j] = s_i / sqrt(s_j). Again one __syncthreads
// per column; the diagonal goes to a separate array so that no thread
// overwrites A[j][j] while others read it.
//
// What bounds them on this card: the n serial, synchronized column steps
// of each matrix, not bytes (2 * B * n^2 * 4) or flops (B * n^3 / 3). The
// design answers with one block per matrix, so that a stack of B >= 512
// keeps all 132 SMs busy (at n = 128 the 66 KB working matrix lets three
// blocks share an SM), and with one barrier per step. Sums run in a fixed
// order with no atomics, so the result is bitwise repeatable. Above 48 KB
// the launch raises the block's dynamic shared memory limit with
// cudaFuncSetAttribute. Faster variants (several small matrices per warp,
// register blocking, tensor cores for the trailing update) are later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kRowThreads = 32;  // K4: threads along a row (k)
constexpr int kColThreads = 8;   // K4: threads along a column (i)

__host__ __device__ inline int row_pitch(int n) { return n | 1; }

size_t smem_bytes(int n) {
  return (size_t)n * row_pitch(n) * sizeof(float) + (size_t)n * sizeof(float);
}

__device__ inline float quiet_nan() { return __int_as_float(0x7fffffff); }

__global__ void __launch_bounds__(kRowThreads* kColThreads)
right_looking_kernel(const float* __restrict__ A, float* __restrict__ L,
                     int n) {
  extern __shared__ float smem[];
  const int p = row_pitch(n);
  float* W = smem;           // n x p, lower triangle used
  float* diag = smem + n * p;  // sqrt of each pivot
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
    if (tx == 0 && ty == 0) diag[j] = sqrtf(piv);
    const float inv = 1.f / piv;
    for (int i = j + 1 + ty; i < n; i += kColThreads) {
      const float a = W[i * p + j] * inv;
      for (int k = j + 1 + tx; k <= i; k += kRowThreads)
        W[i * p + k] = fmaf(-a, W[k * p + j], W[i * p + k]);
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
          v = W[i * p + k] / diag[k];
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

cudaError_t prepare(const void* kernel, int B, int n, size_t* smem) {
  if (B <= 0 || n <= 0 || n > kMaxN) return cudaErrorInvalidValue;
  *smem = smem_bytes(n);
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)*smem);
}

}  // namespace

extern "C" {

int mxf_batched_cholesky_max_n() { return kMaxN; }

// Dynamic shared memory of a K4 or K5 block at this n (ptxas reports
// static shared memory only).
long long mxf_batched_cholesky_smem_bytes(int n) { return (long long)smem_bytes(n); }

// K4 on `stream` (a cudaStream_t); returns the launch's cudaError_t.
int mxf_batched_cholesky_f32(const float* A, float* L, int B, int n, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare((const void*)right_looking_kernel, B, n, &smem);
  if (err != cudaSuccess) return (int)err;
  right_looking_kernel<<<B, dim3(kRowThreads, kColThreads), smem,
                         static_cast<cudaStream_t>(stream)>>>(A, L, n);
  return (int)cudaGetLastError();
}

// K5 on `stream`: one block of n threads rounded up to a warp per matrix.
int mxf_batched_cholesky_r3_f32(const float* A, float* L, int B, int n, void* stream) {
  size_t smem = 0;
  cudaError_t err = prepare((const void*)left_looking_kernel, B, n, &smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = (n + 31) / 32 * 32;
  left_looking_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(A, L, n);
  return (int)cudaGetLastError();
}

const char* mxf_batched_cholesky_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
