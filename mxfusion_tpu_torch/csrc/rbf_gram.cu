// RBF gram matrix on NVIDIA Hopper (sm_90a), fp32.
//
// Replaces mxfusion_tpu/ops/pallas_kernels.py::_rbf_block_kernel (launched
// by _rbf_pallas_2d, public entry rbf_kernel_matrix). For each sample b:
//
//   xs = X[b] / ls[b],  x2s = X2[b] / ls[b]
//   K[b, i, j] = var[b] * exp(-0.5 * max(|xs_i|^2 + |x2s_j|^2 - 2 xs_i.x2s_j, 0))
//
// X (S, N, D), X2 (S, M, D), ls (S, L) with L = D (ARD) or L = 1 (one
// lengthscale for all features), var (S,) and K (S, N, M) are dense row-major
// float32. The wrapper passes X2 = X for the symmetric Kuu call.
//
// What bounds it on the card: the one N*M*4-byte store of K (at the serving
// shape N = 512 inducing points, M = 8192 rows, D = 32, that store is 16 MiB
// against 1.1 MiB of inputs), and, for large D, the fp32 FMA rate of the cross
// term: 2*N*M*D flops on the CUDA cores. The cross term stays in IEEE fp32
// (no TF32): the |x|^2 + |x2|^2 - 2 x.x2 expansion cancels, and a
// three-digit cross term moves exp(-r2/2) by O(1) where points are close.
//
// Design: one block computes a 64 x 64 tile of K with 256 threads, each
// thread a 4 x 4 sub-tile held in registers. D is walked in chunks of 32
// staged through shared memory (padded rows, no bank conflicts); the
// scaled values are written there once and feed both the cross term and the
// row norms, so the norms and the products see the same rounded inputs.
// The epilogue clamps r2 at 0 and applies var * exp(-r2/2) before the single
// store of K. Ragged edges in N, M and D are masked (zero-filled loads,
// guarded stores), so any shape is taken. Faster variants (wgmma, TMA,
// the symmetric half of Kuu) are later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kTile = 64;      // output tile edge
constexpr int kChunk = 32;     // features staged per pass
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kSub = 4;        // 4 x 4 outputs per thread

__global__ void __launch_bounds__(kThreads)
rbf_gram_kernel(const float* __restrict__ X, const float* __restrict__ X2,
                const float* __restrict__ ls, int L,
                const float* __restrict__ var, float* __restrict__ K, int N,
                int M, int D) {
  __shared__ float xs[kTile][kChunk + 1];
  __shared__ float x2s[kTile][kChunk + 1];
  __shared__ float sq[2][kTile];

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;

  const float* Xb = X + (size_t)b * N * D;
  const float* X2b = X2 + (size_t)b * M * D;
  const float* lsb = ls + (size_t)b * L;

  float acc[kSub][kSub];
#pragma unroll
  for (int i = 0; i < kSub; ++i)
#pragma unroll
    for (int j = 0; j < kSub; ++j) acc[i][j] = 0.f;
  // threads 0..63 sum |xs|^2 of tile row tid, 64..127 |x2s|^2 of row tid-64
  float norm = 0.f;

  for (int d0 = 0; d0 < D; d0 += kChunk) {
    for (int idx = tid; idx < kTile * kChunk; idx += kThreads) {
      const int r = idx / kChunk;
      const int k = idx % kChunk;
      const int d = d0 + k;
      float v = 0.f;
      float v2 = 0.f;
      if (d < D) {
        const float l = lsb[L == 1 ? 0 : d];
        if (row0 + r < N) v = Xb[(size_t)(row0 + r) * D + d] / l;
        if (col0 + r < M) v2 = X2b[(size_t)(col0 + r) * D + d] / l;
      }
      xs[r][k] = v;
      x2s[r][k] = v2;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kChunk; ++k) {
      float a[kSub];
      float c[kSub];
#pragma unroll
      for (int i = 0; i < kSub; ++i) a[i] = xs[ty + 16 * i][k];
#pragma unroll
      for (int j = 0; j < kSub; ++j) c[j] = x2s[tx + 16 * j][k];
#pragma unroll
      for (int i = 0; i < kSub; ++i)
#pragma unroll
        for (int j = 0; j < kSub; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    }
    if (tid < kTile) {
      for (int k = 0; k < kChunk; ++k) norm = fmaf(xs[tid][k], xs[tid][k], norm);
    } else if (tid < 2 * kTile) {
      const int r = tid - kTile;
      for (int k = 0; k < kChunk; ++k) norm = fmaf(x2s[r][k], x2s[r][k], norm);
    }
    __syncthreads();
  }
  if (tid < 2 * kTile) sq[tid / kTile][tid % kTile] = norm;
  __syncthreads();

  const float v = var[b];
  float* Kb = K + (size_t)b * N * M;
#pragma unroll
  for (int i = 0; i < kSub; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= N) continue;
#pragma unroll
    for (int j = 0; j < kSub; ++j) {
      const int c = tx + 16 * j;
      if (col0 + c >= M) continue;
      const float r2 = fmaxf(sq[0][r] + sq[1][c] - 2.f * acc[i][j], 0.f);
      Kb[(size_t)(row0 + r) * M + (col0 + c)] = v * expf(-0.5f * r2);
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): nonzero when the launch was refused.
int mxf_rbf_gram_f32(const float* X, const float* X2, const float* ls, int L,
                     const float* var, float* K, int S, int N, int M, int D,
                     void* stream) {
  if (S <= 0 || N <= 0 || M <= 0 || D <= 0 || (L != 1 && L != D))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((M + kTile - 1) / kTile, (N + kTile - 1) / kTile, S);
  rbf_gram_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      X, X2, ls, L, var, K, N, M, D);
  return (int)cudaGetLastError();
}

const char* mxf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
