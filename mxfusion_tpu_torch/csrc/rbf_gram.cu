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
// against 1.1 MiB of inputs: 5.3 us at 3.35 TB/s), and close behind it the
// fp32 FMA rate of the cross term, 2*N*M*D flops on the CUDA cores (4.0 us at
// 67 TFLOP/s). The cross term stays in IEEE fp32 (no TF32): the
// |x|^2 + |x2|^2 - 2 x.x2 expansion cancels, and a three-digit cross term
// moves exp(-r2/2) by O(1) where points are close.
//
// Design: a block of 256 threads computes 64 x 128 tiles of K. Each
// thread holds an 8 x 4 register tile: rows 8*ty .. 8*ty+7 and four
// consecutive columns 4*tx .. 4*tx+3, so a warp (one ty) covers 8 rows of
// 128 consecutive columns. Where D <= 32 (the GP paths' shapes) about two
// blocks per SM walk the column tiles of their row tile: the 64 rows of X
// and their norms are staged once, and the next tile's rows of X2 are
// loaded into registers while this tile is computed and stored, so the
// loads' latency hides behind the FMAs. Otherwise one block per tile walks
// D in chunks of 32. The operands are staged through shared
// memory k-major (xsT[k][row], x2sT[k][col]), scaled by the lengthscale once
// on the way in: per feature a thread reads its 8 rows with two 16-byte
// loads that the whole warp shares (broadcast) and its 4 columns with one
// 16-byte load (the warp reads 512 contiguous bytes), for 32 FMAs. The same
// staged values feed the row and column norms, so the norms and the cross
// term see the same rounded inputs: warp 0 sums the column norms from the
// values it reads for the cross term anyway, and 64 threads the row norms,
// each in a fixed order. The epilogue clamps r2 at 0 and applies
// var * exp(-r2/2) as var * 2^(r2 * (-log2(e)/2)) on the special function
// unit (ex2.approx, relative error below 2^-22; the lengthscale is applied
// as a multiply by its reciprocal, within an ulp of the plain division);
// each thread stores its 4 columns of a row as one 16-byte
// store (a warp writes 512 contiguous bytes per row) where M % 4 == 0, which
// makes every row pitch and every sample's offset b*N*M*4 bytes a multiple
// of 16, and 4-byte stores elsewhere. Inputs are read 16 bytes at a time
// where D % 4 == 0 and X, X2 are 16-byte aligned, 4 bytes otherwise.
// Ragged edges in N, M and D are masked (zero-filled loads, guarded stores),
// so any shape is taken.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // output tile: rows (of X)
constexpr int kCols = 128;     // output tile: columns (of X2)
constexpr int kChunk = 32;     // features staged per pass
constexpr int kThreads = 256;  // 32 column groups x 8 row groups
constexpr int kTm = 8;         // rows per thread
constexpr int kTn = 4;         // consecutive columns per thread
constexpr int kBlocksPerSm = 2;
// exp(-r2 / 2) = 2^(r2 * kNegHalfLog2e)
constexpr float kNegHalfLog2e = -0.72134752044448170f;
// 4-feature groups of a tile chunk that one thread moves
constexpr int kRowGroups = kRows * (kChunk / 4) / kThreads;  // 2
constexpr int kColGroups = kCols * (kChunk / 4) / kThreads;  // 4

// Features d .. d+3 of row `row` of src (rows of D floats): one 16-byte
// load where `vec`, else four 4-byte ones; 0 outside the rows or D.
__device__ __forceinline__ float4 load4(const float* __restrict__ src, int row,
                                        int rows, int d, int D, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (row >= rows || d >= D) return v;
  const float* p = src + (size_t)row * D + d;
  if (vec) return *reinterpret_cast<const float4*>(p);
  v.x = p[0];
  if (d + 1 < D) v.y = p[1];
  if (d + 2 < D) v.z = p[2];
  if (d + 3 < D) v.w = p[3];
  return v;
}

// The loads of one chunk of a tile (rows row0 .. row0 + nrows - 1,
// features d0 .. d0 + kChunk - 1): group q = tid + it * kThreads is row
// q % nrows, features d0 + 4 * (q / nrows) + 0..3. All of a thread's loads
// are issued before any is used.
template <int nrows, int groups>
__device__ __forceinline__ void load_tile(float4 (&x)[groups],
                                          const float* __restrict__ src,
                                          int row0, int rows, int d0, int D,
                                          bool vec, int tid) {
#pragma unroll
  for (int it = 0; it < groups; ++it) {
    const int q = tid + it * kThreads;
    x[it] = load4(src, row0 + q % nrows, rows, d0 + 4 * (q / nrows), D, vec);
  }
}

// ... times 1 / lengthscale (il[k], k < kChunk) into dst[k][r] (pitch
// nrows, k-major); 0 beyond D.
template <int nrows, int groups>
__device__ __forceinline__ void put_tile(float* __restrict__ dst,
                                         const float4 (&x)[groups],
                                         const float* __restrict__ il, int tid) {
#pragma unroll
  for (int it = 0; it < groups; ++it) {
    const int q = tid + it * kThreads;
    const int r = q % nrows;
    const int k = 4 * (q / nrows);
    const float v[4] = {x[it].x, x[it].y, x[it].z, x[it].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(k + e) * nrows + r] = v[e] * il[k + e];
  }
}

// 1 / lengthscale of features d0 .. d0 + kChunk - 1 (0 beyond D, where the
// loads gave 0 too), by threads 0 .. kChunk - 1.
__device__ __forceinline__ void put_inv_ls(float* __restrict__ il,
                                           const float* __restrict__ ls, int L,
                                           int d0, int D, int tid) {
  if (tid < kChunk) {
    const int d = d0 + tid;
    il[tid] = d < D ? 1.f / ls[L == 1 ? 0 : d] : 0.f;
  }
}

// 2^x by the special function unit (relative error below 2^-22).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// acc[i][j] += xs[8 ty + i] . x2s[4 tx + j] over a staged chunk; with
// kNorm also cn[j] += |x2s[4 tx + j]|^2, in the same order.
template <bool kNorm>
__device__ __forceinline__ void cross(float (&acc)[kTm][kTn], float (&cn)[kTn],
                                      const float* xsT, const float* x2sT,
                                      int tx, int ty) {
#pragma unroll 8
  for (int k = 0; k < kChunk; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(xsT + k * kRows + kTm * ty);
    const float4 a1 =
        *reinterpret_cast<const float4*>(xsT + k * kRows + kTm * ty + 4);
    const float4 c4 = *reinterpret_cast<const float4*>(x2sT + k * kCols + kTn * tx);
    const float a[kTm] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float c[kTn] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
    for (int i = 0; i < kTm; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) acc[i][j] = fmaf(a[i], c[j], acc[i][j]);
    if (kNorm) {
#pragma unroll
      for (int j = 0; j < kTn; ++j) cn[j] = fmaf(c[j], c[j], cn[j]);
    }
  }
}

// One block computes the column tiles blockIdx.x, blockIdx.x + gridDim.x,
// ... of row tile blockIdx.y of sample blockIdx.z. kOne (D <= kChunk): the
// X rows and their norms are staged once, and the next column tile's X2
// rows are loaded into registers while this one is computed.
template <bool kOne>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
rbf_gram_kernel(const float* __restrict__ X, const float* __restrict__ X2,
                const float* __restrict__ ls, int L,
                const float* __restrict__ var, float* __restrict__ K, int N,
                int M, int D) {
  __shared__ __align__(16) float xsT[kChunk * kRows];
  __shared__ __align__(16) float x2sT[kChunk * kCols];
  __shared__ __align__(16) float sq[kRows + kCols];  // row, then column norms
  __shared__ float il[kChunk];                        // 1 / lengthscale

  const int b = blockIdx.z;
  const int row0 = blockIdx.y * kRows;
  const int tid = threadIdx.x;
  const int tx = tid % 32;  // column group: columns 4*tx .. 4*tx+3
  const int ty = tid / 32;  // row group (= warp): rows 8*ty .. 8*ty+7
  const int ntiles = (M + kCols - 1) / kCols;

  const float* Xb = X + (size_t)b * N * D;
  const float* X2b = X2 + (size_t)b * M * D;
  const float* lsb = ls + (size_t)b * L;
  const bool vec_in = D % 4 == 0 && ((reinterpret_cast<uintptr_t>(X) |
                                      reinterpret_cast<uintptr_t>(X2)) % 16 == 0);
  // with M % 4 == 0 and K aligned (the wrapper's own allocation) every row
  // of every sample starts on a 16-byte boundary
  const bool vec_out = M % 4 == 0 && reinterpret_cast<uintptr_t>(K) % 16 == 0;
  const float v = var[b];
  float* Kb = K + (size_t)b * N * M;

  float4 xr[kRowGroups];
  float4 x2r[kColGroups];
  if (kOne) {
    load_tile<kRows>(xr, Xb, row0, N, 0, D, vec_in, tid);
    load_tile<kCols>(x2r, X2b, blockIdx.x * kCols, M, 0, D, vec_in, tid);
    put_inv_ls(il, lsb, L, 0, D, tid);
    __syncthreads();
    put_tile<kRows>(xsT, xr, il, tid);
    __syncthreads();
    if (tid < kRows) {
      float norm = 0.f;
#pragma unroll 8
      for (int k = 0; k < kChunk; ++k)
        norm = fmaf(xsT[k * kRows + tid], xsT[k * kRows + tid], norm);
      sq[tid] = norm;
    }
  }

  for (int ct = blockIdx.x; ct < ntiles; ct += gridDim.x) {
    const int col0 = ct * kCols;
    float acc[kTm][kTn];
#pragma unroll
    for (int i = 0; i < kTm; ++i)
#pragma unroll
      for (int j = 0; j < kTn; ++j) acc[i][j] = 0.f;
    // warp 0 sums |x2s|^2 of its 4 columns beside the cross term; without
    // kOne threads 0..63 sum |xs|^2 of row tid; over the chunks in order
    float cn[kTn] = {0.f, 0.f, 0.f, 0.f};
    float rn = 0.f;

    for (int d0 = 0; d0 < D; d0 += kChunk) {
      if (!kOne) {
        load_tile<kRows>(xr, Xb, row0, N, d0, D, vec_in, tid);
        load_tile<kCols>(x2r, X2b, col0, M, d0, D, vec_in, tid);
        put_inv_ls(il, lsb, L, d0, D, tid);
        __syncthreads();
        put_tile<kRows>(xsT, xr, il, tid);
      }
      put_tile<kCols>(x2sT, x2r, il, tid);
      __syncthreads();
      if (kOne && ct + gridDim.x < ntiles)  // the next tile's rows, early
        load_tile<kCols>(x2r, X2b, col0 + gridDim.x * kCols, M, 0, D, vec_in,
                         tid);
      if (!kOne && tid < kRows) {
#pragma unroll 8
        for (int k = 0; k < kChunk; ++k)
          rn = fmaf(xsT[k * kRows + tid], xsT[k * kRows + tid], rn);
      }
      if (ty == 0)
        cross<true>(acc, cn, xsT, x2sT, tx, ty);
      else
        cross<false>(acc, cn, xsT, x2sT, tx, ty);
      // the last chunk's reads are fenced by the barrier before the
      // epilogue
      if (d0 + kChunk < D) __syncthreads();
    }
    if (ty == 0)
      *reinterpret_cast<float4*>(sq + kRows + kTn * tx) =
          make_float4(cn[0], cn[1], cn[2], cn[3]);
    if (!kOne && tid < kRows) sq[tid] = rn;
    __syncthreads();

    const int c0 = col0 + kTn * tx;
    const float4 s2 = *reinterpret_cast<const float4*>(sq + kRows + kTn * tx);
    const float sq2[kTn] = {s2.x, s2.y, s2.z, s2.w};
#pragma unroll
    for (int i = 0; i < kTm; ++i) {
      const int r = kTm * ty + i;
      if (row0 + r >= N) break;
      const float s1 = sq[r];
      float out[kTn];
#pragma unroll
      for (int j = 0; j < kTn; ++j) {
        const float r2 = fmaxf(s1 + sq2[j] - 2.f * acc[i][j], 0.f);
        out[j] = v * ex2(r2 * kNegHalfLog2e);
      }
      float* Krow = Kb + (size_t)(row0 + r) * M;
      if (vec_out) {
        if (c0 < M)
          *reinterpret_cast<float4*>(Krow + c0) =
              make_float4(out[0], out[1], out[2], out[3]);
      } else {
#pragma unroll
        for (int j = 0; j < kTn; ++j)
          if (c0 + j < M) Krow[c0 + j] = out[j];
      }
    }
  }
}

int g_sms = 0;  // streaming multiprocessors of the current device

}  // namespace

extern "C" {

// Launches the kernel on `stream` (a cudaStream_t) and returns
// cudaGetLastError(): nonzero when the launch was refused.
int mxf_rbf_gram_f32(const float* X, const float* X2, const float* ls, int L,
                     const float* var, float* K, int S, int N, int M, int D,
                     void* stream) {
  if (S <= 0 || N <= 0 || M <= 0 || D <= 0 || (L != 1 && L != D))
    return (int)cudaErrorInvalidValue;
  const int ntiles = (M + kCols - 1) / kCols;
  const int row_tiles = (N + kRows - 1) / kRows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D > kChunk) {
    const dim3 grid(ntiles, row_tiles, S);
    rbf_gram_kernel<false><<<grid, kThreads, 0, s>>>(X, X2, ls, L, var, K, N, M, D);
    return (int)cudaGetLastError();
  }
  if (g_sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&g_sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  // about kBlocksPerSm blocks per SM in all, each walking several column
  // tiles of its row tile
  const long long others = (long long)row_tiles * S;
  const long long want = ((long long)kBlocksPerSm * g_sms + others - 1) / others;
  const dim3 grid((unsigned)(want < ntiles ? (want > 0 ? want : 1) : ntiles),
                  row_tiles, S);
  rbf_gram_kernel<true><<<grid, kThreads, 0, s>>>(X, X2, ls, L, var, K, N, M, D);
  return (int)cudaGetLastError();
}

const char* mxf_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
