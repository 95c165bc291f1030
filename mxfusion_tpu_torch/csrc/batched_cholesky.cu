// Batched Cholesky of small SPD matrices on NVIDIA Hopper (sm_90a), fp32.
//
// Kernels over a stack A (B, n, n) of dense row-major float32 matrices,
// 1 <= n <= 128, each writing L (B, n, n): the lower Cholesky factor with
// the upper triangle exactly 0. All factor (A + A^T) / 2, as
// jnp.linalg.cholesky does (exactly A for a symmetric A; the transposed
// read happens once, at load). A matrix whose pivot is not positive (or
// NaN) is not positive definite: its L gets NaN in the whole lower
// triangle and 0 above, the pattern jnp.linalg.cholesky returns and the
// plain version (ops/batched_cholesky.py) copies. Sums run in a fixed
// order with no atomics, so every result is bitwise repeatable.
//
// What bounds both kernels on this card: moving the stack is 8 B n^2 per
// matrix (8192 x 64^2 reads and writes 268 MB, 80 us at 3.35 TB/s) and
// the arithmetic is n^3 / 3 flops, under that; what stands in the way
// is the n serial column steps of each matrix. So the working rows live
// in registers, a column step costs a few shared loads and one barrier
// (a __syncwarp where a warp holds the matrix), and enough matrices are
// resident per SM that their column steps overlap.
//
// K4 replaces mxfusion_tpu/ops/pallas_batched_cholesky.py::_kernel_v2
// (launched by _pallas_batched_cholesky_v2; public entries
// batched_cholesky and cholesky, which the multivariate normals call).
// Its arithmetic is the TPU kernel's scaled right-looking order: at column
// j, d = sqrt(W[j][j]), inv = 1 / d (IEEE sqrt and division where JAX
// takes rsqrt), c_i = W[i][j] * inv for i > j, L[j][j] = d, L[i][j] = c_i,
// then W[i][k] = fma(-c_i, c_k, W[i][k]) for i, k > j. Two kernels do it
// with the same operations on the same values, so they give the same bits
// (and a stack padded by the identity gives the unpadded factor's bits):
//
// - right_looking_warp_kernel<N> (n <= N, N = 32 or 64): one warp per
//   matrix, several warps per block, no block barrier. Lane l holds row l
//   (its first 32 columns, all that a row < 32 needs) and, at N = 64, row
//   32 + l; rows and columns >= n are padded by the identity. A column
//   step is one shuffle for the pivot, one store of each lane's c_i to a
//   per-warp shared row, one __syncwarp, and broadcast 16-byte reads of
//   that row feeding the FMAs. Each held row shifts left by one column per
//   step (w[t] = W[i][j + t]), so every register index is static inside a
//   loop over j that is not unrolled: a fully unrolled j loop needs no
//   shift but is some 100 KB of straight-line code that every warp runs
//   once per matrix, more than the instruction cache holds. The loop runs
//   in phases of 16 columns over which the entries a row still needs (its
//   columns j .. i) shrink. L is written into the staging tile column by
//   column as it is formed.
// - right_looking_tile_kernel (64 < n <= 128): one block of 160 threads
//   per matrix; thread t < 136 holds one 8 x 8 tile (R, C), C <= R, of the
//   lower triangle in registers. At column j every thread reads the pivot
//   and the c of its 8 rows and 8 columns from a shared column row (five
//   shared loads for 64 FMAs), the threads of tile column j / 8 turn their
//   column-j entries into L and publish column j + 1 into the other of two
//   column rows, and one __syncthreads ends the step. Column and row
//   indices inside a tile are static (the 8 columns of a tile column are
//   unrolled), and so is which of a tile's rows and columns are past j;
//   tiles left of the current tile column are finished, and threads take
//   tiles in column-major order so that whole warps of them skip the
//   step. Four matrices an SM (96 registers a thread, so that 512
//   matrices run in one wave; the tile takes 64 and spills a little), each
//   column applied to the tile one column at a time so that only the
//   tile's c_i and one c_k are live. Some 150 instructions a thread a
//   column on five warps: issue and the barrier's latency bound it, not
//   memory. The stack moves by 16-byte loads and stores straight
//   between device memory and registers (4-byte ones where n % 4 != 0 or
//   a pointer is not 16-byte aligned), the mirror tile (C, R) read for the
//   symmetrize and written as zeros.
//
// K5, the left-looking (Crout) variant, replaces ::_kernel (the r3
// variant, launched by _pallas_batched_cholesky). At column j, s_i =
// A[i][j] - sum_{k<j} L[i][k] L[j][k] for i >= j, d = sqrt(s_j),
// L[i][j] = s_i / d. Each sum starts from A[i][j] and runs in k order as
// fmaf(L[i][k], -L[j][k], acc) (a sum from 0 with A[i][j] added last
// rounds each partial sum near the magnitude of A[i][j] and loses more on
// ill-conditioned stacks): a lane keeps its row in registers (L[i][k] for k < j,
// A[i][k] from j on) and dots it with row j of T, a per-matrix shared
// tile that holds -L below the diagonal and 0 elsewhere, read by
// broadcast 16-byte loads. The entries from j on are multiplied by T's
// zeros, so a dot of static length (16 more each phase of 16 columns)
// needs no per-column bound; A[i][j] comes out of the row and L[i][j]
// goes into it by predicated selects (static register indices), and
// -L[i][j] into T's column j. Rows and columns >= n are padded by the
// identity. Bound by the selects, the dots' latency and the column
// steps, not by memory.
//
// - left_looking_warp_kernel<N> (n <= N, N = 32 or 64): one warp per
//   matrix, several per block, lane l holding rows l and 32 + l as K4's
//   warp kernel does; the pivot s_j comes by shuffle from the lane that
//   holds row j; one __syncwarp per column. Four columns to an iteration,
//   so that a select picks among the 4 positions of a phase that share j
//   mod 4 instead of all 16.
// - left_looking_block_kernel (64 < n <= 128): one block of four warps per
//   matrix, thread i holding row i (all 128 entries: every warp runs the
//   same code, each column as long as the longest row's: one code path
//   keeps the instructions the block's warps run at once few).
//   Every lane forms the pivot s_j itself from A[j][j] and row j of T (the
//   same fmaf sequence as the lane that holds row j), so a column needs
//   one barrier, not two. One column to an iteration: four would double
//   the code of its eight phases of dots up to 128 long.
//
// The staging tile of the warp kernels and of K5's block kernel is filled
// by 16-byte cp.async copies (4-byte ones where n % 4 != 0 or a pointer is
// not 16-byte aligned); its 16-byte chunks are XOR-swizzled by row so that
// a lane reading its row (A[i][.]) and a lane reading its column (A[.][i],
// the symmetrize) both hit 32 banks. Above 48 KB the launch raises the
// block's dynamic shared memory limit with cudaFuncSetAttribute.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 128;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kPhase = 16;  // columns per phase of the warp kernels and K5
// K4 above n = 64: 8 x 8 register tiles, 16 tile rows, 136 lower tiles
constexpr int kTile = 8;
constexpr int kTileRows = kMaxN / kTile;
constexpr int kLowerTiles = kTileRows * (kTileRows + 1) / 2;
constexpr int kTileThreads = (kLowerTiles + kWarp - 1) / kWarp * kWarp;
// K5 above n = 64: a row per thread
constexpr int kRowThreads = kMaxN;

// warps (matrices) per block of the warp kernels at tier N: 36 KB and
// 68 KB of shared memory; at least two and three blocks per SM (at most
// 128 and 170 registers a thread, so that neither spills)
template <int N>
__host__ __device__ constexpr int warps_per_block() {
  return N == 32 ? 8 : 4;
}

// floats of shared memory per warp of K4: the N x N tile and two column
// rows of 2N
template <int N>
__host__ __device__ constexpr int k4_warp_floats() { return N * N + 4 * N; }

// floats of shared memory per matrix of K5: the N x N tile T, the
// diagonal of L, and (block kernel) the diagonal of A
template <int N>
__host__ __device__ constexpr int k5_floats() {
  return N * N + (N == kMaxN ? 2 * N : N);
}

template <int N>
size_t k4_warp_smem_bytes() {
  return (size_t)warps_per_block<N>() * k4_warp_floats<N>() * sizeof(float);
}

template <int N>
size_t k5_smem_bytes() {
  return (size_t)(N == kMaxN ? 1 : warps_per_block<N>()) * k5_floats<N>() *
         sizeof(float);
}

size_t k4_tile_smem_bytes() { return 2 * (size_t)kMaxN * sizeof(float); }

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

// 16-byte copies need n % 4 == 0 (rows, and so every matrix, start on a
// 16-byte boundary when the stack does) and 16-byte aligned stacks
__device__ __forceinline__ bool aligned16(const float* A, const float* L, int n) {
  return (n % 4 == 0) &&
         ((reinterpret_cast<uintptr_t>(A) | reinterpret_cast<uintptr_t>(L)) % 16 ==
          0);
}

// Word offset of element (r, k) in an N x N tile: 16-byte chunk k/4 of
// row r sits at chunk (k/4) ^ (r & 7).
template <int N>
__device__ __forceinline__ int swz(int r, int k) {
  return r * N + ((((k >> 2) ^ (r & 7))) << 2) + (k & 3);
}

// Matrix Ab (n x n) into the swizzled N x N tile, by threads t of nt;
// the caller waits (cp_async_wait_all) and synchronizes.
template <int N>
__device__ __forceinline__ void stage_matrix(float* tile, const float* Ab, int n,
                                             bool vec, int t, int nt) {
  if (vec) {
    const int q4 = n / 4;
    for (int q = t; q < n * q4; q += nt) {
      const int r = q / q4;
      cp_async16(tile + swz<N>(r, 4 * (q - r * q4)), Ab + 4 * (size_t)q);
    }
  } else {
    for (int e = t; e < n * n; e += nt) {
      const int r = e / n;
      cp_async4(tile + swz<N>(r, e - r * n), Ab + e);
    }
  }
}

// Row i of the symmetrized matrix, its first LEN entries, from the staged
// tile: w[k] = (A[i][k] + A[k][i]) / 2; padded rows and columns (>= n)
// are the identity's.
template <int N, int LEN>
__device__ __forceinline__ void load_row(const float* tile, int n, int i,
                                         float (&w)[LEN]) {
#pragma unroll
  for (int c = 0; c < LEN / 4; ++c) {
    const float4 v =
        *reinterpret_cast<const float4*>(tile + i * N + ((c ^ (i & 7)) << 2));
    const float row[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int k = 4 * c + e;
      w[k] = (i < n && k < n) ? 0.5f * (row[e] + tile[swz<N>(k, i)])
                              : (i == k ? 1.f : 0.f);
    }
  }
}

// The tile becomes K5's T at the start: all 0.
template <int N>
__device__ __forceinline__ void zero_tile(float* tile, int t, int nt) {
  for (int q = t; q < N * N / 4; q += nt)
    *reinterpret_cast<float4*>(tile + 4 * q) = make_float4(0.f, 0.f, 0.f, 0.f);
}

// L from the tile by threads t of nt: the tile's lower triangle holds
// L (K4, diag == nullptr) or -L below the diagonal with the diagonal in
// diag (K5); 0 above; all NaN below it on failure.
template <int N>
__device__ __forceinline__ void store_factor(const float* tile,
                                             const float* diag, float* Lb,
                                             int n, bool vec, bool failed,
                                             int t, int nt) {
  auto value = [&](int r, int k, float x) {
    if (k > r) return 0.f;
    if (failed) return quiet_nan();
    if (diag == nullptr) return x;
    return k == r ? diag[r] : -x;
  };
  if (vec) {
    const int q4 = n / 4;
    for (int q = t; q < n * q4; q += nt) {
      const int r = q / q4;
      const int k0 = 4 * (q - r * q4);
      const float4 v = *reinterpret_cast<const float4*>(tile + swz<N>(r, k0));
      *reinterpret_cast<float4*>(Lb + 4 * (size_t)q) =
          make_float4(value(r, k0, v.x), value(r, k0 + 1, v.y),
                      value(r, k0 + 2, v.z), value(r, k0 + 3, v.w));
    }
  } else {
    for (int e = t; e < n * n; e += nt) {
      const int r = e / n;
      const int k = e - r * n;
      Lb[e] = value(r, k, tile[swz<N>(r, k)]);
    }
  }
}

// ---------------------------------------------------------------------------
// K4, n <= 64: a warp per matrix
// ---------------------------------------------------------------------------

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
  float* tile = smem + warp * k4_warp_floats<N>();
  // two column rows of 2N (rows N .. 2N-1 stay 0), alternating by column
  float* colrow = tile + N * N;
  const size_t nn = (size_t)n * n;
  const bool vec = aligned16(A, L, n);
  stage_matrix<N>(tile, A + (size_t)b * nn, n, vec, lane, kWarp);
  for (int e = lane; e < 4 * N; e += kWarp) colrow[e] = 0.f;
  cp_async_wait_all();
  __syncwarp();

  // lane l holds row l in w0 (its first 32 columns: the lower triangle of
  // a row < 32 needs no more) and, at N = 64, row 32 + l in w1
  float w0[kWarp];
  float w1[N];  // unused at N = 32
  load_row<N>(tile, n, lane, w0);
  if (N == 64) load_row<N>(tile, n, kWarp + lane, w1);
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
  __syncwarp();
  store_factor<N>(tile, nullptr, L + (size_t)b * nn, n, vec, !ok, lane, kWarp);
}

// ---------------------------------------------------------------------------
// K4, 64 < n <= 128: a block per matrix, an 8 x 8 register tile a thread
// ---------------------------------------------------------------------------

// Row i, columns k0 .. k0+7 of Ab into x (out-of-range entries are the
// identity's).
__device__ __forceinline__ void load_row8(float (&x)[kTile], const float* Ab,
                                          int n, int i, int k0, bool vec) {
#pragma unroll
  for (int h = 0; h < kTile / 4; ++h) {
    const int k = k0 + 4 * h;
    if (vec && i < n && k < n) {  // n % 4 == 0: the chunk is inside the row
      const float4 t = *reinterpret_cast<const float4*>(Ab + (size_t)i * n + k);
      x[4 * h] = t.x, x[4 * h + 1] = t.y, x[4 * h + 2] = t.z, x[4 * h + 3] = t.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        x[4 * h + e] = (i < n && k + e < n) ? Ab[(size_t)i * n + k + e]
                                            : (i == k + e ? 1.f : 0.f);
    }
  }
}

// Rows i0 .. i0+7, columns k0 .. k0+7 of Lb from v (entries past n are
// not written).
__device__ __forceinline__ void store_tile(const float (&v)[kTile][kTile],
                                           float* Lb, int n, int i0, int k0,
                                           bool vec) {
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    const int i = i0 + a;
    if (i >= n) break;
#pragma unroll
    for (int h = 0; h < kTile / 4; ++h) {
      const int k = k0 + 4 * h;
      if (vec) {
        if (k < n)
          *reinterpret_cast<float4*>(Lb + (size_t)i * n + k) = make_float4(
              v[a][4 * h], v[a][4 * h + 1], v[a][4 * h + 2], v[a][4 * h + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k + e < n) Lb[(size_t)i * n + k + e] = v[a][4 * h + e];
      }
    }
  }
}

__global__ void __launch_bounds__(kTileThreads, 4)
right_looking_tile_kernel(const float* __restrict__ A, float* __restrict__ L,
                          int n) {
  extern __shared__ __align__(16) float smem[];  // two column rows of kMaxN
  const int t = threadIdx.x;
  // thread t < 136 holds tile (R, C), C <= R, in column-major order, so
  // that the warps whose tiles are all left of the current tile column
  // (finished) skip whole column steps
  int C = 0;
  int first = 0;  // t of tile (C, C)
  while (C < kTileRows && first + kTileRows - C <= t) first += kTileRows - C++;
  const int R = C + t - first;
  const int i0 = kTile * R;
  const int k0 = kTile * C;
  const int tiles = (n + kTile - 1) / kTile;  // tile rows the matrix spans
  const bool holds = R < tiles;
  const size_t off = (size_t)blockIdx.x * n * n;
  const float* Ab = A + off;
  float* Lb = L + off;
  const bool vec = aligned16(A, L, n);

  float W[kTile][kTile];
  if (holds) {
#pragma unroll
    for (int a = 0; a < kTile; ++a) load_row8(W[a], Ab, n, i0 + a, k0, vec);
    // the mirror tile (C, R) a row at a time: W[a][b] = (A[i][k] +
    // A[k][i]) / 2
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      float m[kTile];  // A[k0 + b][i0 .. i0+7]
      load_row8(m, Ab, n, k0 + b, i0, vec);
#pragma unroll
      for (int a = 0; a < kTile; ++a)
        if (i0 + a < n && k0 + b < n) W[a][b] = 0.5f * (W[a][b] + m[a]);
    }
    if (C == 0)
#pragma unroll
      for (int a = 0; a < kTile; ++a) smem[i0 + a] = W[a][0];
  }
  __syncthreads();

  // column j: the pivot and the c of a thread's rows and columns from the
  // column row of j's parity (W[.][j], published at the end of column
  // j - 1); tile column j / 8 turns its column-j entries into L and, after
  // the update, publishes column j + 1 into the other column row
  bool failed = false;
  for (int jb = 0; jb < tiles && !failed; ++jb) {
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      const int j = kTile * jb + b;
      if (j >= n) break;
      const float* col = smem + (j & 1) * kMaxN;
      const float p = col[j];  // every thread reads it: the branch is uniform
      if (!(p > 0.f)) {
        failed = true;
        break;
      }
      const float d = sqrtf(p);
      const float inv = 1.f / d;
      if (holds && C >= jb) {
        float ci[kTile];
#pragma unroll
        for (int h = 0; h < kTile / 4; ++h) {
          const float4 x = *reinterpret_cast<const float4*>(col + i0 + 4 * h);
          ci[4 * h] = x.x * inv, ci[4 * h + 1] = x.y * inv;
          ci[4 * h + 2] = x.z * inv, ci[4 * h + 3] = x.w * inv;
        }
        // right of tile column jb every row and column is past j; in it,
        // column e of the tile is past j for e > b, and so is row a of a
        // diagonal tile for a > b: c is 0 for the others, so that the
        // finished entries (columns <= j, which hold L) take
        // fma(-c_i, 0, L) = L
        if (C == jb) {
          if (R == C) {
#pragma unroll
            for (int a = 0; a <= b; ++a) ci[a] = 0.f;
            W[b][b] = d;
          }
#pragma unroll
          for (int a = 0; a < kTile; ++a)
            if (R > C || a > b) W[a][b] = ci[a];
        }
        // one column of the tile at a time: c_k and the tile's c_i live
        // (four blocks an SM leave a thread 96 registers)
#pragma unroll
        for (int h = 0; h < kTile / 4; ++h) {
          const float4 y = *reinterpret_cast<const float4*>(col + k0 + 4 * h);
          const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int k = 4 * h + e;
            const float ck = C == jb && k <= b ? 0.f : ys[e] * inv;
#pragma unroll
            for (int a = 0; a < kTile; ++a) W[a][k] = fmaf(-ci[a], ck, W[a][k]);
          }
        }
        // publish column j + 1 (tile column jb, or jb + 1 after b = 7)
        if (C == (b + 1 == kTile ? jb + 1 : jb)) {
          float* next = smem + ((j + 1) & 1) * kMaxN;
#pragma unroll
          for (int a = 0; a < kTile; ++a) next[i0 + a] = W[a][(b + 1) % kTile];
        }
      }
      __syncthreads();
    }
  }

  if (!holds) return;
  // the lower triangle of L from the registers (a diagonal tile's entries
  // above the diagonal are 0), all NaN on failure; the mirror tile's zeros
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b)
      W[a][b] = k0 + b > i0 + a ? 0.f : (failed ? quiet_nan() : W[a][b]);
  store_tile(W, Lb, n, i0, k0, vec);
  if (C < R) {
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) W[a][b] = 0.f;
    store_tile(W, Lb, n, k0, i0, vec);
  }
}

// ---------------------------------------------------------------------------
// K5: left-looking
// ---------------------------------------------------------------------------

// r[BASE + STEP u] = v and r[BASE + STEP u] for a u < COUNT known only
// at run time, as predicated selects over the COUNT positions, so that
// every register index is static.
template <int BASE, int STEP, int COUNT, int LEN>
__device__ __forceinline__ void set_at(float (&r)[LEN], int u, float v) {
#pragma unroll
  for (int w = 0; w < COUNT; ++w)
    if (BASE + STEP * w < LEN && w == u) r[BASE + STEP * w] = v;
}

template <int BASE, int STEP, int COUNT, int LEN>
__device__ __forceinline__ float get_at(const float (&r)[LEN], int u) {
  float v = 0.f;
#pragma unroll
  for (int w = 0; w < COUNT; ++w)
    if (BASE + STEP * w < LEN && w == u) v = r[BASE + STEP * w];
  return v;
}

// The warp kernel's r[BASE + t + 4g]: t < 4 is a constant once the
// caller's loop is unrolled, g < 4 (the group of 4 columns within a
// phase) is known at run time.
template <int BASE, int LEN>
__device__ __forceinline__ float get_entry(const float (&r)[LEN], int t, int g) {
  switch (t) {
    case 0: return get_at<BASE, 4, 4>(r, g);
    case 1: return get_at<BASE + 1, 4, 4>(r, g);
    case 2: return get_at<BASE + 2, 4, 4>(r, g);
    default: return get_at<BASE + 3, 4, 4>(r, g);
  }
}

template <int BASE, int LEN>
__device__ __forceinline__ void set_entry(float (&r)[LEN], int t, int g,
                                          float v) {
  switch (t) {
    case 0: set_at<BASE, 4, 4>(r, g, v); break;
    case 1: set_at<BASE + 1, 4, 4>(r, g, v); break;
    case 2: set_at<BASE + 2, 4, 4>(r, g, v); break;
    default: set_at<BASE + 3, 4, 4>(r, g, v); break;
  }
}

// Columns 16P .. min(16P + 16, jend) - 1 of a warp's matrix (jend: n
// rounded up to a multiple of 4; a padded column's pivot is 1 and leaves
// the rest unchanged), 4 to an iteration of a loop that is not unrolled:
// lane l holds row l in r0 (H0: its rows still need columns of this
// phase) and, at N = 64, row 32 + l in r1 (H1). Each dot reads row j of T
// over its first 16 (P + 1) entries; the pivot comes by shuffle from the
// lane that holds row j. Returns false if a pivot was not positive
// (uniform across the warp).
template <int N, int P, bool H0, bool H1, int LEN1>
__device__ __forceinline__ bool left_columns(float (&r0)[kWarp],
                                             float (&r1)[LEN1], int jend,
                                             int lane, float* tile,
                                             float* diag) {
  constexpr int ja = kPhase * P;
  constexpr int DOT = ja + kPhase;
  constexpr int HP = ja >= kWarp ? 1 : 0;  // the half that holds rows j
  const int jb = min(ja + kPhase, jend);
#pragma unroll 1  // 4 columns' code, not 16: it stays in the instruction cache
  for (int j4 = ja; j4 < jb; j4 += 4) {
    const int g = (j4 - ja) / 4;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int j = j4 + t;
    const float* q = tile + j * N;  // row j of T: -L[j][k<j], then 0
    float s0 = H0 ? get_entry<ja>(r0, t, g) : 0.f;  // A[i][j]
    float s1 = H1 ? get_entry<ja>(r1, t, g) : 0.f;
#pragma unroll
    for (int c = 0; c < DOT / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(q + ((c ^ (j & 7)) << 2));
      const float qk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * c + e;
        if (H0 && k < kWarp) s0 = fmaf(r0[k < kWarp ? k : 0], qk[e], s0);
        if (H1) s1 = fmaf(r1[k < LEN1 ? k : 0], qk[e], s1);
      }
    }
    const float p = __shfl_sync(kFullMask, HP == 0 ? s0 : s1, j % kWarp);
    if (!(p > 0.f)) return false;
    const float d = sqrtf(p);
    if (H0) {
      const int i = lane;
      if (i > j) {
        const float v = s0 / d;
        set_entry<ja>(r0, t, g, v);
        tile[swz<N>(i, j)] = -v;
      } else if (i == j) {
        diag[j] = d;
      }
    }
    if (H1) {
      const int i = kWarp + lane;
      if (i > j) {
        const float v = s1 / d;
        set_entry<ja>(r1, t, g, v);
        tile[swz<N>(i, j)] = -v;
      } else if (i == j) {
        diag[j] = d;
      }
    }
    __syncwarp();  // T's column j before row j + 1 is read
  }
  }
  return true;
}

template <int N>
__global__ void __launch_bounds__(warps_per_block<N>() * kWarp, N == 32 ? 2 : 3)
left_looking_warp_kernel(const float* __restrict__ A, float* __restrict__ L,
                         int B, int n) {
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * warps_per_block<N>() + warp;
  if (b >= B) return;  // no block barrier below: a warp may leave alone
  float* tile = smem + warp * k5_floats<N>();
  float* diag = tile + N * N;
  const size_t nn = (size_t)n * n;
  const bool vec = aligned16(A, L, n);
  stage_matrix<N>(tile, A + (size_t)b * nn, n, vec, lane, kWarp);
  cp_async_wait_all();
  __syncwarp();
  float r0[kWarp];
  float r1[N];  // unused at N = 32
  load_row<N>(tile, n, lane, r0);
  if (N == 64) load_row<N>(tile, n, kWarp + lane, r1);
  __syncwarp();
  zero_tile<N>(tile, lane, kWarp);
  __syncwarp();
  const int jend = min((n + 3) & ~3, N);
  bool ok;
  if (N == 32) {
    ok = left_columns<N, 0, true, false>(r0, r1, jend, lane, tile, diag) &&
         left_columns<N, 1, true, false>(r0, r1, jend, lane, tile, diag);
  } else {
    ok = left_columns<N, 0, true, true>(r0, r1, jend, lane, tile, diag) &&
         left_columns<N, 1, true, true>(r0, r1, jend, lane, tile, diag) &&
         left_columns<N, 2, false, true>(r0, r1, jend, lane, tile, diag) &&
         left_columns<N, 3, false, true>(r0, r1, jend, lane, tile, diag);
  }
  __syncwarp();
  store_factor<N>(tile, diag, L + (size_t)b * nn, n, vec, !ok, lane, kWarp);
}

// Columns 16P .. min(16P + 16, jend) - 1 of K5's block kernel, one to an
// iteration of a loop that is not unrolled, thread t holding row i = t in
// r. Every lane forms the pivot s_j from A[j][j] and row j of T with the
// fmaf sequence of the lane that holds row j (whose row is -T[j][k] for
// k < j; T's zeros take the rest). One barrier per column.
template <int P>
__device__ __forceinline__ bool block_columns(float (&r)[kMaxN], int jend,
                                              int i, float* tile, float* diag,
                                              const float* adiag) {
  constexpr int ja = kPhase * P;
  constexpr int DOT = ja + kPhase;
  const int jb = min(ja + kPhase, jend);
#pragma unroll 1
  for (int j = ja; j < jb; ++j) {
    const float* q = tile + j * kMaxN;
    float s = get_at<ja, 1, kPhase>(r, j - ja);  // A[i][j]
    float p = adiag[j];
#pragma unroll
    for (int c = 0; c < DOT / 4; ++c) {
      const float4 v = *reinterpret_cast<const float4*>(q + ((c ^ (j & 7)) << 2));
      const float qk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s = fmaf(r[4 * c + e], qk[e], s);
        p = fmaf(-qk[e], qk[e], p);
      }
    }
    if (!(p > 0.f)) return false;  // the same p in every thread
    const float d = sqrtf(p);
    if (i > j) {
      const float v = s / d;
      set_at<ja, 1, kPhase>(r, j - ja, v);
      tile[swz<kMaxN>(i, j)] = -v;
    } else if (i == j) {
      diag[j] = d;
    }
    __syncthreads();  // T's column j before row j + 1 is read
  }
  return true;
}

__global__ void __launch_bounds__(kRowThreads, 3)
left_looking_block_kernel(const float* __restrict__ A, float* __restrict__ L,
                          int n) {
  extern __shared__ __align__(16) float smem[];
  float* tile = smem;                    // kMaxN x kMaxN: A, then T
  float* diag = tile + kMaxN * kMaxN;    // L's diagonal
  float* adiag = diag + kMaxN;           // A's diagonal
  const int i = threadIdx.x;             // the row this thread holds
  const size_t off = (size_t)blockIdx.x * n * n;
  const bool vec = aligned16(A, L, n);
  stage_matrix<kMaxN>(tile, A + off, n, vec, i, kRowThreads);
  cp_async_wait_all();
  __syncthreads();
  float r[kMaxN];
  load_row<kMaxN>(tile, n, i, r);
  // as load_row has it: the identity's 1 on a padded row
  adiag[i] = i < n ? 0.5f * (tile[swz<kMaxN>(i, i)] + tile[swz<kMaxN>(i, i)])
                   : 1.f;
  __syncthreads();
  zero_tile<kMaxN>(tile, i, kRowThreads);
  __syncthreads();
  const int jend = min((n + 3) & ~3, kMaxN);
  const bool ok = block_columns<0>(r, jend, i, tile, diag, adiag) &&
                  block_columns<1>(r, jend, i, tile, diag, adiag) &&
                  block_columns<2>(r, jend, i, tile, diag, adiag) &&
                  block_columns<3>(r, jend, i, tile, diag, adiag) &&
                  block_columns<4>(r, jend, i, tile, diag, adiag) &&
                  block_columns<5>(r, jend, i, tile, diag, adiag) &&
                  block_columns<6>(r, jend, i, tile, diag, adiag) &&
                  block_columns<7>(r, jend, i, tile, diag, adiag);
  __syncthreads();
  store_factor<kMaxN>(tile, diag, L + off, n, vec, !ok, i, kRowThreads);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

bool valid(int B, int n) { return B > 0 && n > 0 && n <= kMaxN; }

cudaError_t launch(const void* kernel, dim3 grid, int threads, size_t smem,
                   cudaStream_t stream, void** args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernel(kernel, grid, dim3(threads), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int N>
cudaError_t launch_warp(const void* kernel, size_t smem, const float* A,
                        float* L, int B, int n, cudaStream_t stream) {
  const int wpb = warps_per_block<N>();
  void* args[] = {&A, &L, &B, &n};
  return launch(kernel, dim3((B + wpb - 1) / wpb), wpb * kWarp, smem, stream,
                args);
}

}  // namespace

extern "C" {

int mxf_batched_cholesky_max_n() { return kMaxN; }

// Dynamic shared memory of a block at this n (ptxas reports static shared
// memory only) of K4 (variant 4) or K5 (variant 5).
long long mxf_batched_cholesky_smem_bytes(int n, int variant) {
  if (n <= 32) return (long long)(variant == 4 ? k4_warp_smem_bytes<32>()
                                               : k5_smem_bytes<32>());
  if (n <= 64) return (long long)(variant == 4 ? k4_warp_smem_bytes<64>()
                                               : k5_smem_bytes<64>());
  return (long long)(variant == 4 ? k4_tile_smem_bytes() : k5_smem_bytes<kMaxN>());
}

// Matrices per block of K4 and K5 at this n (a warp each for n <= 64).
int mxf_batched_cholesky_per_block(int n) {
  if (n <= 32) return warps_per_block<32>();
  if (n <= 64) return warps_per_block<64>();
  return 1;
}

// K4 on `stream` (a cudaStream_t); returns the launch's cudaError_t.
int mxf_batched_cholesky_f32(const float* A, float* L, int B, int n, void* stream) {
  if (!valid(B, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32)
    return (int)launch_warp<32>((const void*)right_looking_warp_kernel<32>,
                                k4_warp_smem_bytes<32>(), A, L, B, n, s);
  if (n <= 64)
    return (int)launch_warp<64>((const void*)right_looking_warp_kernel<64>,
                                k4_warp_smem_bytes<64>(), A, L, B, n, s);
  void* args[] = {&A, &L, &n};
  return (int)launch((const void*)right_looking_tile_kernel, dim3(B),
                     kTileThreads, k4_tile_smem_bytes(), s, args);
}

// K5 on `stream`.
int mxf_batched_cholesky_r3_f32(const float* A, float* L, int B, int n, void* stream) {
  if (!valid(B, n)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 32)
    return (int)launch_warp<32>((const void*)left_looking_warp_kernel<32>,
                                k5_smem_bytes<32>(), A, L, B, n, s);
  if (n <= 64)
    return (int)launch_warp<64>((const void*)left_looking_warp_kernel<64>,
                                k5_smem_bytes<64>(), A, L, B, n, s);
  void* args[] = {&A, &L, &n};
  return (int)launch((const void*)left_looking_block_kernel, dim3(B),
                     kRowThreads, k5_smem_bytes<kMaxN>(), s, args);
}

const char* mxf_batched_cholesky_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
