// Fused L^-1 * Kuf gram product and its backward on NVIDIA Hopper (sm_90a),
// fp32.
//
// Replaces mxfusion_tpu/ops/pallas_fused_gram.py::_fwd_kernel (K2, launched
// by _call_fwd) and ::_bwd_kernel (K3, launched by _call_bwd), the forward
// and backward of fused_linv_rbf_gram. With zn_k = |zs_k|^2 / 2 and
// xn_n = |xs_n|^2 / 2:
//
//   K[k, n] = var * exp(min(zs_k . xs_n - zn_k - xn_n, 0))     (never stored)
//   forward:  G = U K                                           (M, N)
//   backward: dK = U^T dG, de = K o dK,
//             dU = dG K^T, dZs = de Xs - rowsum(de) o Zs,
//             dXs = de^T Zs - colsum(de) o Xs, skv = sum(de)   (dvar = skv/var)
//
// U (M, M), Zs (M, D), Xs (N, D), dG and G (M, N) are dense row-major
// float32; var is one float on the device. D <= 128.
//
// What bounds it on the card. At the training shape (M = 512, N = 65536,
// D = 32) the forward is 2*M*M*N = 34 GFLOP of G-product plus the gram
// recomputed once per row tile of U (2*M*N*D per tile row), against 128 MiB
// of G to store: it is bound by the fp32 FMA rate of the CUDA cores
// (67 TFLOP/s), not by memory. The backward does twice the forward's
// product work (U^T dG and dG K^T) and reads dG twice. Every product is
// IEEE fp32 FMA (no TF32): the exponent's expansion cancels, and the
// G-product feeds the bound's Kff - Qff cancellation, which the JAX package
// guards at its HIGH floor.
//
// Design. Kuf and dKuf never reach device memory. Each block of K2 owns a
// 128 x 64 tile of G (256 threads, 8 x 4 outputs each): it stages its 64
// rows of Xs once, then walks the contraction in chunks of 32, rebuilding
// that 32 x 64 block of K in shared memory from 32 rows of Zs (D is small)
// and multiplying it with the matching 128 x 32 block of U. The TPU kernel
// walked N on a sequential grid and summed dU, dZs and skv across it; here
// blocks run in parallel and in no order, so K3 writes partial sums into
// buffers in fixed slots and a last kernel adds them in a fixed order. No
// atomics: two calls on the same inputs give the same bits.
//   K3a (fused_bwd_de_kernel): per (128 rows of k) x (64 columns of n):
//       dK = U^T dG over all of M, K recomputed, de = K o dK in shared
//       memory; writes this n-tile's partial of dZs, this k-tile's partial
//       of dXs and the tile's partial of skv.
//   K3b (fused_bwd_du_kernel): per 128 x 64 tile of dU and one of S slices
//       of N: dU partial = dG[:, slice] K[:, slice]^T, K rebuilt in chunks
//       of 32 columns.
//   K3c (reduce_parts_kernel): every output element sums its partials in
//       slot order.
// Ragged M, N and D are masked (zero-filled loads, guarded stores). Faster
// variants (wgmma with 3xTF32, TMA, skipping the upper triangle of U = L^-1)
// are later work.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kRows = 128;     // tile rows: 8 per thread
constexpr int kCols = 64;      // tile columns: 4 per thread
constexpr int kChunk = 32;     // contraction chunk staged in shared memory
constexpr int kMaxD = 128;
constexpr int kReduceTasks = 4;

// Row stride of a staged (rows, D) block: odd, so that a warp reading one
// feature of 32 consecutive rows hits 32 different banks.
__host__ __device__ inline int feat_stride(int D) { return D | 1; }

// dst[r][d] = src[r0 + r][d] for r < nrows, 0 where r0 + r >= R.
__device__ void load_rows(const float* __restrict__ src, int R, int D, int r0,
                          int nrows, float* dst, int ld) {
  for (int idx = threadIdx.x; idx < nrows * D; idx += kThreads) {
    const int r = idx / D;
    const int d = idx - r * D;
    dst[r * ld + d] = (r0 + r < R) ? src[(size_t)(r0 + r) * D + d] : 0.f;
  }
}

__device__ void half_norms(const float* rows, int nrows, int D, int ld,
                           float* out) {
  for (int r = threadIdx.x; r < nrows; r += kThreads) {
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(rows[r * ld + d], rows[r * ld + d], s);
    out[r] = 0.5f * s;
  }
}

// One gram entry; K2 and K3 share it, so the backward sees the forward's K.
__device__ inline float gram(const float* z, const float* x, int D, float zn,
                             float xn, float var) {
  float p = 0.f;
  for (int d = 0; d < D; ++d) p = fmaf(z[d], x[d], p);
  return var * expf(fminf(p - zn - xn, 0.f));
}

// ---------------------------------------------------------------- K2
__global__ void __launch_bounds__(kThreads)
fused_fwd_kernel(const float* __restrict__ U, const float* __restrict__ Zs,
                 const float* __restrict__ Xs, const float* __restrict__ var_p,
                 float* __restrict__ G, int M, int N, int D) {
  extern __shared__ float smem[];
  const int ld = feat_stride(D);
  float* xs = smem;                   // [kCols][ld]
  float* zs = xs + kCols * ld;        // [kChunk][ld]
  float* xn = zs + kChunk * ld;       // [kCols]
  float* zn = xn + kCols;             // [kChunk]
  float* kt = zn + kChunk;            // [kChunk][kCols]
  float* ut = kt + kChunk * kCols;    // [kChunk][kRows + 1], U transposed

  const int n0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float var = *var_p;

  load_rows(Xs, N, D, n0, kCols, xs, ld);
  __syncthreads();
  half_norms(xs, kCols, D, ld, xn);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < M; k0 += kChunk) {
    __syncthreads();
    load_rows(Zs, M, D, k0, kChunk, zs, ld);
    for (int idx = tid; idx < kRows * kChunk; idx += kThreads) {
      const int m = idx / kChunk;
      const int kk = idx % kChunk;
      ut[kk * (kRows + 1) + m] = (m0 + m < M && k0 + kk < M)
                                     ? U[(size_t)(m0 + m) * M + k0 + kk]
                                     : 0.f;
    }
    __syncthreads();
    half_norms(zs, kChunk, D, ld, zn);
    __syncthreads();
    for (int idx = tid; idx < kChunk * kCols; idx += kThreads) {
      const int kk = idx / kCols;
      const int n = idx % kCols;
      kt[idx] = gram(zs + kk * ld, xs + n * ld, D, zn[kk], xn[n], var);
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kChunk; ++kk) {
      float a[8];
      float b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ut[kk * (kRows + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kt[kk * kCols + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) G[(size_t)m * N + n] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- K3a
__global__ void __launch_bounds__(kThreads)
fused_bwd_de_kernel(const float* __restrict__ U, const float* __restrict__ Zs,
                    const float* __restrict__ Xs,
                    const float* __restrict__ var_p,
                    const float* __restrict__ dG, float* __restrict__ pdZs,
                    float* __restrict__ pdXs, float* __restrict__ pskv, int M,
                    int N, int D) {
  extern __shared__ float smem[];
  const int ld = feat_stride(D);
  float* zs = smem;                   // [kRows][ld]
  float* xs = zs + kRows * ld;        // [kCols][ld]
  float* zn = xs + kCols * ld;        // [kRows]
  float* xn = zn + kRows;             // [kCols]
  float* ut = xn + kCols;             // [kChunk][kRows + 1]
  float* dg = ut + kChunk * (kRows + 1);  // [kChunk][kCols]
  float* de = dg + kChunk * kCols;    // [kRows][kCols + 1]
  float* rowde = de + kRows * (kCols + 1);  // [kRows]
  float* colde = rowde + kRows;       // [kCols]

  const int n0 = blockIdx.x * kCols;
  const int k0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float var = *var_p;

  load_rows(Zs, M, D, k0, kRows, zs, ld);
  load_rows(Xs, N, D, n0, kCols, xs, ld);
  __syncthreads();
  half_norms(zs, kRows, D, ld, zn);
  half_norms(xs, kCols, D, ld, xn);

  // dK[k, n] = sum_m U[m, k] dG[m, n] over all of M
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int m0 = 0; m0 < M; m0 += kChunk) {
    __syncthreads();
    for (int idx = tid; idx < kChunk * kRows; idx += kThreads) {
      const int mm = idx / kRows;
      const int k = idx % kRows;
      ut[mm * (kRows + 1) + k] = (m0 + mm < M && k0 + k < M)
                                     ? U[(size_t)(m0 + mm) * M + k0 + k]
                                     : 0.f;
    }
    for (int idx = tid; idx < kChunk * kCols; idx += kThreads) {
      const int mm = idx / kCols;
      const int n = idx % kCols;
      dg[idx] = (m0 + mm < M && n0 + n < N) ? dG[(size_t)(m0 + mm) * N + n0 + n]
                                            : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int mm = 0; mm < kChunk; ++mm) {
      float a[8];
      float b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = ut[mm * (kRows + 1) + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = dg[mm * kCols + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  // de = K o dK (zero on padded rows and columns: U and dG load as zeros)
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int k = ty + 16 * i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = tx + 16 * j;
      de[k * (kCols + 1) + n] =
          gram(zs + k * ld, xs + n * ld, D, zn[k], xn[n], var) * acc[i][j];
    }
  }
  __syncthreads();
  if (tid < kRows) {
    float s = 0.f;
    for (int n = 0; n < kCols; ++n) s += de[tid * (kCols + 1) + n];
    rowde[tid] = s;
  } else if (tid < kRows + kCols) {
    const int n = tid - kRows;
    float s = 0.f;
    for (int k = 0; k < kRows; ++k) s += de[k * (kCols + 1) + n];
    colde[n] = s;
  }
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int k = 0; k < kRows; ++k) s += rowde[k];
    pskv[(size_t)blockIdx.y * gridDim.x + blockIdx.x] = s;
  }
  // this n-tile's partial of dZs: (de Xs)[k, d] - rowde[k] Zs[k, d]
  for (int idx = tid; idx < kRows * D; idx += kThreads) {
    const int k = idx / D;
    const int d = idx - k * D;
    if (k0 + k >= M) continue;
    float s = 0.f;
    for (int n = 0; n < kCols; ++n)
      s = fmaf(de[k * (kCols + 1) + n], xs[n * ld + d], s);
    pdZs[((size_t)blockIdx.x * M + k0 + k) * D + d] = s - rowde[k] * zs[k * ld + d];
  }
  // this k-tile's partial of dXs: (de^T Zs)[n, d] - colde[n] Xs[n, d]
  for (int idx = tid; idx < kCols * D; idx += kThreads) {
    const int n = idx / D;
    const int d = idx - n * D;
    if (n0 + n >= N) continue;
    float s = 0.f;
    for (int k = 0; k < kRows; ++k)
      s = fmaf(de[k * (kCols + 1) + n], zs[k * ld + d], s);
    pdXs[((size_t)blockIdx.y * N + n0 + n) * D + d] = s - colde[n] * xs[n * ld + d];
  }
}

// ---------------------------------------------------------------- K3b
// dU partial of slice s: rows m0.. (kRows) x columns k0.. (kCols) of
// dG[:, slice] K[:, slice]^T.
__global__ void __launch_bounds__(kThreads)
fused_bwd_du_kernel(const float* __restrict__ Zs, const float* __restrict__ Xs,
                    const float* __restrict__ var_p,
                    const float* __restrict__ dG, float* __restrict__ pdU,
                    int M, int N, int D, int slice_len) {
  extern __shared__ float smem[];
  const int ld = feat_stride(D);
  float* zs = smem;                   // [kCols][ld]
  float* xs = zs + kCols * ld;        // [kChunk][ld]
  float* zn = xs + kChunk * ld;       // [kCols]
  float* xn = zn + kCols;             // [kChunk]
  float* dg = xn + kChunk;            // [kRows][kChunk + 1]
  float* kt = dg + kRows * (kChunk + 1);  // [kCols][kChunk + 1]

  const int k0 = blockIdx.x * kCols;
  const int m0 = blockIdx.y * kRows;
  const int s = blockIdx.z;
  const int nb = s * slice_len;
  const int ne = min(N, nb + slice_len);
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float var = *var_p;

  load_rows(Zs, M, D, k0, kCols, zs, ld);
  __syncthreads();
  half_norms(zs, kCols, D, ld, zn);

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int nc = nb; nc < ne; nc += kChunk) {
    __syncthreads();
    load_rows(Xs, ne, D, nc, kChunk, xs, ld);
    for (int idx = tid; idx < kRows * kChunk; idx += kThreads) {
      const int m = idx / kChunk;
      const int nn = idx % kChunk;
      dg[m * (kChunk + 1) + nn] = (m0 + m < M && nc + nn < ne)
                                      ? dG[(size_t)(m0 + m) * N + nc + nn]
                                      : 0.f;
    }
    __syncthreads();
    half_norms(xs, kChunk, D, ld, xn);
    __syncthreads();
    for (int idx = tid; idx < kCols * kChunk; idx += kThreads) {
      const int k = idx / kChunk;
      const int nn = idx % kChunk;
      kt[k * (kChunk + 1) + nn] =
          gram(zs + k * ld, xs + nn * ld, D, zn[k], xn[nn], var);
    }
    __syncthreads();
#pragma unroll 4
    for (int nn = 0; nn < kChunk; ++nn) {
      float a[8];
      float b[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = dg[(ty + 16 * i) * (kChunk + 1) + nn];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = kt[(tx + 16 * j) * (kChunk + 1) + nn];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < M) pdU[((size_t)s * M + m) * M + k] = acc[i][j];
    }
  }
}

// ---------------------------------------------------------------- K3c
struct ReduceTask {
  const float* src;  // (parts, count)
  float* dst;        // (count,)
  long long count;
  int parts;
};
struct ReduceTasks {
  ReduceTask t[kReduceTasks];
};

__global__ void __launch_bounds__(kThreads) reduce_parts_kernel(ReduceTasks tasks) {
  const ReduceTask t = tasks.t[blockIdx.y];
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < t.count;
       i += (long long)gridDim.x * kThreads) {
    float s = 0.f;
    for (int p = 0; p < t.parts; ++p) s += t.src[(size_t)p * t.count + i];
    t.dst[i] = s;
  }
}

size_t fwd_smem(int D) {
  const int ld = feat_stride(D);
  return sizeof(float) * ((size_t)(kCols + kChunk) * ld + kCols + kChunk +
                          kChunk * kCols + kChunk * (kRows + 1));
}

size_t de_smem(int D) {
  const int ld = feat_stride(D);
  return sizeof(float) *
         ((size_t)(kRows + kCols) * ld + kRows + kCols + kChunk * (kRows + 1) +
          kChunk * kCols + kRows * (kCols + 1) + kRows + kCols);
}

size_t du_smem(int D) {
  const int ld = feat_stride(D);
  return sizeof(float) * ((size_t)(kCols + kChunk) * ld + kCols + kChunk +
                          kRows * (kChunk + 1) + kCols * (kChunk + 1));
}

bool bad_shape(int M, int N, int D) {
  return M <= 0 || N <= 0 || D <= 0 || D > kMaxD ||
         (M + kRows - 1) / kRows > 65535;
}

}  // namespace

extern "C" {

int mxf_fused_gram_tile_rows() { return kRows; }
int mxf_fused_gram_tile_cols() { return kCols; }

// Dynamic shared memory of K2 (kernel 0), K3a (1) and K3b (2) at this D.
long long mxf_fused_gram_smem_bytes(int kernel, int D) {
  return (long long)(kernel == 0 ? fwd_smem(D)
                                 : kernel == 1 ? de_smem(D) : du_smem(D));
}

// K2: G = U K. Returns cudaGetLastError() after the launch.
int mxf_fused_gram_fwd_f32(const float* U, const float* Zs, const float* Xs,
                           const float* var, float* G, int M, int N, int D,
                           void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kCols - 1) / kCols, (M + kRows - 1) / kRows);
  fused_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      U, Zs, Xs, var, G, M, N, D);
  return (int)cudaGetLastError();
}

// K3: three launches (K3a, K3b, K3c). The partial buffers are
//   pdZs (ceil(N / kCols), M, D), pdXs (ceil(M / kRows), N, D),
//   pskv (ceil(M / kRows) * ceil(N / kCols)), pdU (slices, M, M),
// with slices * slice_len >= N. Returns the first launch error, or 0.
int mxf_fused_gram_bwd_f32(const float* U, const float* Zs, const float* Xs,
                           const float* var, const float* dG, float* dU,
                           float* dZs, float* dXs, float* skv, float* pdU,
                           float* pdZs, float* pdXs, float* pskv, int M, int N,
                           int D, int slices, int slice_len, void* stream) {
  if (bad_shape(M, N, D) || slices <= 0 || slices > 65535 || slice_len <= 0 ||
      (long long)slices * slice_len < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + kCols - 1) / kCols;
  const int k_tiles = (M + kRows - 1) / kRows;

  const size_t smem_de = de_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_de_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_de);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_de_kernel<<<dim3(n_tiles, k_tiles), kThreads, smem_de, st>>>(
      U, Zs, Xs, var, dG, pdZs, pdXs, pskv, M, N, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_du = du_smem(D);
  err = cudaFuncSetAttribute(fused_bwd_du_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_du);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_du_kernel<<<dim3((M + kCols - 1) / kCols, k_tiles, slices), kThreads,
                        smem_du, st>>>(Zs, Xs, var, dG, pdU, M, N, D, slice_len);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  ReduceTasks tasks;
  tasks.t[0] = {pdU, dU, (long long)M * M, slices};
  tasks.t[1] = {pdZs, dZs, (long long)M * D, n_tiles};
  tasks.t[2] = {pdXs, dXs, (long long)N * D, k_tiles};
  tasks.t[3] = {pskv, skv, 1, k_tiles * n_tiles};
  long long most = 0;
  for (int i = 0; i < kReduceTasks; ++i)
    most = tasks.t[i].count > most ? tasks.t[i].count : most;
  long long blocks = (most + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;
  reduce_parts_kernel<<<dim3((unsigned)blocks, kReduceTasks), kThreads, 0, st>>>(
      tasks);
  return (int)cudaGetLastError();
}

const char* mxf_fused_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
