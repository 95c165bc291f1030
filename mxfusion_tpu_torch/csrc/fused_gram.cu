// Fused L^-1 * Kuf gram product and its backward on NVIDIA Hopper (sm_90a),
// fp32 data on the TF32 tensor cores.
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
// skv is taken as sum(dG o G), the same number (sum(K o U^T dG) =
// sum(dG o U K)), from the forward's G: sum(de) cancels to a few hundredths
// of its terms' spread, and the TF32 rounding of dK would show there.
//
// With lower = 1 the function is that of tril(U) (U = L^-1 is lower
// triangular in the SVGP bound): the forward skips the tiles above the
// diagonal, dK sums over m >= k only, and dU = tril(dG K^T) with its upper
// triangle 0. U (M, M), Zs (M, D), Xs (N, D), dG and G (M, N) are dense
// row-major float32; var is one float on the device. D <= 128.
//
// What bounds it on the card. At the training shape (M = 512, N = 65536,
// D = 32, lower) the G-product is about 21.5 GFLOP and each of the two
// cotangent products (U^T dG, dG K^T) as much; G and dG are 128 MiB each.
// That is far above the memory roofline (3.35 TB/s), so arithmetic bounds
// the kernels. PR 2's version ran every product as scalar IEEE fp32 FMAs on
// the CUDA cores (67 TFLOP/s peak) and lost to cuBLAS; here the products
// run on the tensor cores with mma.sync.aligned.m16n8k8 tf32 (wgmma's peak
// is 495 TFLOP/s, mma.sync reaches a part of it). The precision is the TPU
// kernel's, mapped as ops/precision.py maps it: its G-product runs at HIGH
// (3-pass bf16), here 3xTF32: a = hi + lo with hi = cvt.rna.tf32(a),
// lo = cvt.rna.tf32(a - hi), acc += a_lo b_hi + a_hi b_lo + a_hi b_hi in
// fp32. Its cotangent products run at DEFAULT (1 pass), here 1-pass TF32
// (operands rounded with cvt.rna), and so do the D-wide products de Xs and
// de^T Zs. The exponent's cross term zs . xs runs at 3xTF32, as the TPU
// kernel runs it at its 3-pass HIGH (it cancels against the norms), and
// all three kernels take it from one function (cross_term) in the same
// order, so the backward rebuilds the forward's K. With the products on
// the tensor cores, what bounds K2 and K3b is rebuilding the gram (one
// expf, a split and two stores per entry, 2.5 times per entry under lower
// at M = 512) and each chunk's barriers; what bounds K3a is its per-tile
// epilogue (the gram at the accumulator's positions, row and column sums,
// the D-wide products).
//
// Design. Every block owns a 128 x 128 output tile (8 warps as 2 x 4, a
// 64 x 32 tile per warp: 4 x 4 mma tiles), walks the contraction in chunks
// of 32 and streams the operand tiles from device memory through a ring of
// cp.async stages in shared memory: 16-byte copies where the rows are
// 16-byte aligned, 4-byte copies otherwise (ragged M, N or D);
// out-of-range elements are zero-filled. Two blocks share an SM, so that
// one block's gram build, epilogue and barriers overlap the other's
// products. Shared-memory pitches put every fragment read on 32 distinct
// banks. Tiles above the diagonal are not launched, warps skip chunks that
// lie wholly above it, and elements above it inside a chunk are masked to
// 0. The row tiles with the most work run first.
//   K2 (fused_fwd_kernel): per 128 x 128 tile of G; per chunk the block
//       builds the 32 x 128 block of K in shared memory (split into tf32
//       hi and lo) from the staged Zs rows and the Xs tile, and multiplies
//       the staged 128 x 32 block of U with it, pass by pass.
//   K3a (fused_bwd_de_kernel): per (128 k) x (128 n) tile: dK = U^T dG over
//       m, then K recomputed at the accumulator's positions, de = K o dK,
//       and the tile's partials of dZs (slot n-tile) and dXs (slot k-tile),
//       the D-wide products on the tensor cores. The blocks of k-tile 0,
//       which stream every row of dG, also stream G and write the n-tile's
//       partial of skv = sum(dG o G).
//   K3b (fused_bwd_du_kernel): per 128 x 128 tile of dU (lower: only k-tile
//       <= m-tile) and one of S slices of N: dU partial = dG[:, slice]
//       K[:, slice]^T, K rebuilt per chunk of 32 columns of N.
//   K3c (reduce_parts_kernel): every output element sums its partials in a
//       fixed order; the upper triangle of dU is written 0 under lower.
// No atomics: two calls on the same inputs give the same bits.
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kTile = 128;     // rows and columns of a block's output tile
constexpr int kChunk = 32;     // contraction chunk per pipeline stage
// Depth of each kernel's cp.async ring. Two blocks share an SM (at most 128
// registers and about 110 KB of shared memory at D = 32), so that one
// block's gram, epilogue and barriers overlap the other's products.
constexpr int kStagesFwd = 2;
constexpr int kStagesDe = 2;
constexpr int kStagesDu = 2;
constexpr int kMaxD = 128;
constexpr int kReduceTasks = 4;
// Shared-memory pitches. A fragment element (row g, col t) of an mma.sync
// operand is read by lane 4g + t (g < 8, t < 4):
constexpr int kLdRowK = kChunk + 4;  // [row][k]: row g, col t -> bank 4g + t
constexpr int kLdKRow = kTile + 8;   // [k][col]: row t, col g -> bank 8t + g
constexpr int kLdDe = kTile + 4;     // de tile [k][n], read as [row][k]

// ------------------------------------------------------------ primitives
__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to about 21 bits, both tf32 (the 3xTF32 split).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// d += a b, one m16n8k8 tile, tf32 operands, fp32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// 16-byte asynchronous copy to shared memory of the first `bytes` bytes
// (0 to 16) of src; the rest of the 16 is zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4-byte asynchronous copy to shared memory; zero-fills when !in.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool in) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Whether rows of pitch ld_src from src can be copied 16 bytes at a time.
__device__ __forceinline__ bool vec16(const float* src, size_t ld_src) {
  return ld_src % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
}

// Queue the copy of a ROWS x COLS tile of a row-major matrix (row pitch
// ld_src): dst[r][c] = src[r0 + r][c0 + c] where r0 + r < r_end and
// c0 + c < c_end, else 0. ld is a multiple of 4 and dst is 16-byte
// aligned; 16-byte copies where the source rows from column c0 on are
// aligned (one copy per four elements: the copies' issue cost is what
// bounds a 4-byte stream), 4-byte copies otherwise.
template <int ROWS, int COLS>
__device__ void stage_tile(const float* __restrict__ src, size_t ld_src,
                           int r_end, int c_end, int r0, int c0, float* dst,
                           int ld) {
  if (c0 % 4 == 0 && vec16(src, ld_src)) {
    for (int idx = threadIdx.x; idx < ROWS * COLS / 4; idx += kThreads) {
      const int r = idx / (COLS / 4);
      const int c = idx % (COLS / 4) * 4;
      const int n = r0 + r < r_end ? max(0, min(4, c_end - c0 - c)) : 0;
      cp_async16(dst + r * ld + c,
                 n > 0 ? src + (size_t)(r0 + r) * ld_src + c0 + c : src, 4 * n);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * COLS; idx += kThreads) {
    const int r = idx / COLS;
    const int c = idx % COLS;
    const bool in = r0 + r < r_end && c0 + c < c_end;
    cp_async4(dst + r * ld + c, in ? src + (size_t)(r0 + r) * ld_src + c0 + c
                                   : src, in);
  }
}

// Pitch of a [point][d] feature tile: a multiple of 4 (16-byte rows) that
// holds D rounded up to the k-step of 8, congruent to 4 mod 32, so that an
// mma fragment read (point g, feature t) hits bank 4g + t. The tile serves
// as the A operand (points as rows) and as the B operand (points as
// columns) of the cross term, and as the B operand of the D-wide products.
__host__ __device__ inline int feat_pitch(int D) {
  const int padded = (D + 7) / 8 * 8;
  return (padded + 27) / 32 * 32 + 4;
}

// Queue dst[r * ldp + d] = src[r0 + r][d] for r < ROWS and d < ldp, 0 where
// r0 + r >= R or d >= D (the zero padding of the cross term's k-steps).
template <int ROWS>
__device__ void stage_feats(const float* __restrict__ src, int R, int D,
                            int r0, float* dst, int ldp) {
  if (D % 4 == 0 && vec16(src, 4)) {
    const int per_row = ldp / 4;
    for (int idx = threadIdx.x; idx < ROWS * per_row; idx += kThreads) {
      const int r = idx / per_row;
      const int d = idx % per_row * 4;
      const bool in = r0 + r < R && d < D;
      cp_async16(dst + r * ldp + d, in ? src + (size_t)(r0 + r) * D + d : src,
                 in ? 16 : 0);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < ROWS * ldp; idx += kThreads) {
    const int r = idx / ldp;
    const int d = idx - r * ldp;
    const bool in = r0 + r < R && d < D;
    cp_async4(dst + idx, in ? src + (size_t)(r0 + r) * D + d : src, in);
  }
}

// |v|^2 / 2 over the D features of one staged point; every kernel takes
// its norms from here, in this order.
__device__ __forceinline__ float half_norm(const float* v, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(v[d], v[d], s);
  return 0.5f * s;
}

// One gram entry from its cross term p; K2, K3a and K3b share it.
__device__ __forceinline__ float gram_entry(float p, float zn, float xn,
                                            float var) {
  return var * expf(fminf(p - zn - xn, 0.f));
}

// p[i][j] += the cross terms zs . xs between the Zs points a0 + 16 i
// (+ g, + g + 8) of the feature tile za and the Xs points b0 + 8 j (+ g)
// of the tile xb, 3xTF32 on the tensor cores, the k-steps of 8 features
// in order and in each the passes lo*hi, hi*lo, hi*hi. K2, K3a and K3b
// all take the cross term from here with Zs as the A operand, so every
// gram entry goes through the same sequence of products in all three.
template <int MI, int NJ>
__device__ void cross_term(float (&p)[MI][NJ][4], const float* za, int a0,
                           const float* xb, int b0, int ldp, int dp) {
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  for (int s = 0; s < dp / 8; ++s) {
    uint32_t ah[MI][4], al[MI][4], bh[NJ][2], bl[NJ][2];
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      const float* r = za + (a0 + 16 * i + g) * ldp + 8 * s + t;
      split_tf32(r[0], ah[i][0], al[i][0]);
      split_tf32(r[8 * ldp], ah[i][1], al[i][1]);
      split_tf32(r[4], ah[i][2], al[i][2]);
      split_tf32(r[8 * ldp + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const float* r = xb + (b0 + 8 * j + g) * ldp + 8 * s + t;
      split_tf32(r[0], bh[j][0], bl[j][0]);
      split_tf32(r[4], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        mma_tf32(p[i][j], al[i], bh[j]);
        mma_tf32(p[i][j], ah[i], bl[j]);
        mma_tf32(p[i][j], ah[i], bh[j]);
      }
  }
}

// ---------------------------------------------------------------- K2
__host__ __device__ size_t fwd_stage_floats(int D) {
  return (size_t)kTile * kLdRowK + kChunk * feat_pitch(D);
}

size_t fwd_smem(int D) {
  return sizeof(float) * ((size_t)kStagesFwd * fwd_stage_floats(D) +
                          2 * kChunk * kLdKRow + kTile +
                          (size_t)kTile * feat_pitch(D));
}

__global__ void __launch_bounds__(kThreads, 2)
fused_fwd_kernel(const float* __restrict__ U, const float* __restrict__ Zs,
                 const float* __restrict__ Xs, const float* __restrict__ var_p,
                 float* __restrict__ G, int M, int N, int D, int lower) {
  extern __shared__ __align__(16) float smem[];
  // stages of {U [kTile][kLdRowK], Zs [kChunk][ldp]}, then the K block
  // (tf32 hi and lo), the Xs tile's half norms and the Xs tile [kTile][ldp]
  const int ldp = feat_pitch(D);
  const int dp = (D + 7) / 8 * 8;
  const size_t stage_floats = fwd_stage_floats(D);
  float* ring = smem;
  uint32_t* khi = reinterpret_cast<uint32_t*>(ring + kStagesFwd * stage_floats);
  uint32_t* klo = khi + kChunk * kLdKRow;             // [kChunk][kLdKRow]
  float* xn = reinterpret_cast<float*>(klo + kChunk * kLdKRow);  // [kTile]
  float* xs = xn + kTile;                             // [kTile][ldp]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int row_base = (warp / 4) * 64;
  const int col_base = (warp % 4) * 32;
  const int n0 = blockIdx.x * kTile;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kTile;  // longest rows first
  const int k_end = lower ? min(M, m0 + kTile) : M;
  const int n_chunks = (k_end + kChunk - 1) / kChunk;

  auto issue = [&](int c) {
    if (c < n_chunks) {
      float* st = ring + (c % kStagesFwd) * stage_floats;
      stage_tile<kTile, kChunk>(U, M, M, M, m0, c * kChunk, st, kLdRowK);
      stage_feats<kChunk>(Zs, M, D, c * kChunk, st + kTile * kLdRowK, ldp);
    }
    cp_async_commit();
  };
  stage_feats<kTile>(Xs, N, D, n0, xs, ldp);  // lands with chunk 0
  for (int c = 0; c < kStagesFwd - 1; ++c) issue(c);
  const float var = *var_p;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStagesFwd - 2>();
    __syncthreads();  // chunk c landed; everyone is done with chunk c - 1
    issue(c + kStagesFwd - 1);
    if (c == 0) {
      if (tid < kTile) xn[tid] = half_norm(xs + tid * ldp, D);
      __syncthreads();
    }
    const float* ut = ring + (c % kStagesFwd) * stage_floats;
    const float* zc = ut + kTile * kLdRowK;
    const int k0 = c * kChunk;
    {  // the chunk's block of K: warp w takes rows 16 (w / 4) .. + 15 and
       // columns 32 (w % 4) .. + 31
      const int pr = 16 * (warp / 4);
      const int pc = 32 * (warp % 4);
      float pk[1][4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[0][j][e] = 0.f;
      cross_term<1, 4>(pk, zc, pr, xs, pc, ldp, dp);
      const float nz = half_norm(zc + (pr + tid % 16) * ldp, D);
      const float zn[2] = {__shfl_sync(0xffffffffu, nz, g),
                           __shfl_sync(0xffffffffu, nz, g + 8)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = pr + g + 8 * (e / 2);
          const int n = pc + 8 * j + 2 * t + e % 2;
          const float k = (k0 + r < M && n0 + n < N)
                              ? gram_entry(pk[0][j][e], zn[e / 2], xn[n], var)
                              : 0.f;
          split_tf32(k, khi[r * kLdKRow + n], klo[r * kLdKRow + n]);
        }
    }
    __syncthreads();
    const int m_lo = m0 + row_base;  // this warp's rows: m_lo .. m_lo + 63
    if (lower && k0 > m_lo + 63) continue;  // wholly above the diagonal
    const bool diag = lower && k0 + kChunk - 1 > m_lo;
#pragma unroll
    for (int s = 0; s < kChunk / 8; ++s) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col_base + j * 8 + g;
        bh[j][0] = khi[(s * 8 + t) * kLdKRow + col];
        bh[j][1] = khi[(s * 8 + t + 4) * kLdKRow + col];
        bl[j][0] = klo[(s * 8 + t) * kLdKRow + col];
        bl[j][1] = klo[(s * 8 + t + 4) * kLdKRow + col];
      }
      uint32_t ah[4][4], al[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r0 = row_base + i * 16 + g;
        const int c0 = s * 8 + t;
        float a[4] = {ut[r0 * kLdRowK + c0], ut[(r0 + 8) * kLdRowK + c0],
                      ut[r0 * kLdRowK + c0 + 4],
                      ut[(r0 + 8) * kLdRowK + c0 + 4]};
        if (diag) {  // U[m][k] = 0 for k > m
          if (k0 + c0 > m0 + r0) a[0] = 0.f;
          if (k0 + c0 > m0 + r0 + 8) a[1] = 0.f;
          if (k0 + c0 + 4 > m0 + r0) a[2] = 0.f;
          if (k0 + c0 + 4 > m0 + r0 + 8) a[3] = 0.f;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[i][e], al[i][e]);
      }
      // pass by pass, so that 16 independent products separate the three
      // that update one accumulator
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], al[i], bh[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bl[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], ah[i], bh[j]);
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row_base + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = n0 + col_base + j * 8 + 2 * t;
        if (n < N) G[(size_t)m * N + n] = acc[i][j][2 * h];
        if (n + 1 < N) G[(size_t)m * N + n + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// ---------------------------------------------------------------- K3a
size_t de_smem(int D) {
  const size_t ring = (size_t)kStagesDe * 3 * kChunk * kLdKRow;
  const size_t epilogue = (size_t)2 * kTile * feat_pitch(D) + 4 * kTile +
                          (size_t)kTile * kLdDe;
  return sizeof(float) * (ring > epilogue ? ring : epilogue);
}

// out[r][d] (r < kTile, d < dp) of A B for A = de (TRANS_A false: A[r][q] =
// de[r][q]) or de^T (A[r][q] = de[q][r]), q < kTile, and B = feat
// [q][ldf]; 1-pass tf32. Warp w takes the mma tiles w, w + 8, ..., four at
// a time so that four independent products interleave; fn(r, d, value)
// receives each result.
template <bool TRANS_A, typename Fn>
__device__ void de_times_features(const float* de, const float* feat, int ldf,
                                  int dp, Fn fn) {
  constexpr int kWarps = kThreads / 32;
  const int warp = threadIdx.x / 32;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int tiles = (kTile / 16) * (dp / 8);
  for (int base = warp; base < tiles; base += 4 * kWarps) {
    float acc[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
#pragma unroll 2
    for (int s = 0; s < kTile / 8; ++s) {
      const int q = s * 8 + t;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int tile = base + u * kWarps;
        if (tile >= tiles) break;  // the same for the whole warp
        const int r0 = (tile % (kTile / 16)) * 16 + g;
        const int d0 = (tile / (kTile / 16)) * 8;
        uint32_t a[4], b[2];
        if (TRANS_A) {
          a[0] = tf32(de[q * kLdDe + r0]);
          a[1] = tf32(de[q * kLdDe + r0 + 8]);
          a[2] = tf32(de[(q + 4) * kLdDe + r0]);
          a[3] = tf32(de[(q + 4) * kLdDe + r0 + 8]);
        } else {
          a[0] = tf32(de[r0 * kLdDe + q]);
          a[1] = tf32(de[(r0 + 8) * kLdDe + q]);
          a[2] = tf32(de[r0 * kLdDe + q + 4]);
          a[3] = tf32(de[(r0 + 8) * kLdDe + q + 4]);
        }
        b[0] = tf32(feat[q * ldf + d0 + g]);
        b[1] = tf32(feat[(q + 4) * ldf + d0 + g]);
        mma_tf32(acc[u], a, b);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int tile = base + u * kWarps;
      if (tile >= tiles) break;
      const int r0 = (tile % (kTile / 16)) * 16 + g;
      const int d0 = (tile / (kTile / 16)) * 8;
      fn(r0, d0 + 2 * t, acc[u][0]);
      fn(r0, d0 + 2 * t + 1, acc[u][1]);
      fn(r0 + 8, d0 + 2 * t, acc[u][2]);
      fn(r0 + 8, d0 + 2 * t + 1, acc[u][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
fused_bwd_de_kernel(const float* __restrict__ U, const float* __restrict__ Zs,
                    const float* __restrict__ Xs,
                    const float* __restrict__ var_p,
                    const float* __restrict__ dG, const float* __restrict__ G,
                    float* __restrict__ pdZs, float* __restrict__ pdXs,
                    float* __restrict__ pskv, int M, int N, int D, int lower) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float skv_parts[kThreads];
  // main loop: stages of {U [kChunk m][kLdKRow k], dG and G
  // [kChunk m][kLdKRow n]}
  float* ring = smem;
  const size_t stage_floats = 3 * kChunk * kLdKRow;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int row_base = (warp / 4) * 64;  // rows k of the tile
  const int col_base = (warp % 4) * 32;  // columns n
  const int n0 = blockIdx.x * kTile;
  const int kt = blockIdx.y;             // k-tile 0 has the most work
  const int k0 = kt * kTile;
  const int m_begin = lower ? k0 : 0;
  const int n_chunks = (M - m_begin + kChunk - 1) / kChunk;

  auto issue = [&](int c) {
    if (c < n_chunks) {
      float* st = ring + (c % kStagesDe) * stage_floats;
      const int mc = m_begin + c * kChunk;
      stage_tile<kChunk, kTile>(U, M, M, M, mc, k0, st, kLdKRow);
      stage_tile<kChunk, kTile>(dG, N, M, N, mc, n0, st + kChunk * kLdKRow,
                                kLdKRow);
      if (kt == 0)
        stage_tile<kChunk, kTile>(G, N, M, N, mc, n0,
                                  st + 2 * kChunk * kLdKRow, kLdKRow);
    }
    cp_async_commit();
  };
  for (int c = 0; c < kStagesDe - 1; ++c) issue(c);

  // dK[k, n] = sum_m U[m, k] dG[m, n]
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  const int k_lo = k0 + row_base;  // this warp's rows: k_lo .. k_lo + 63
  float skv = 0.f;
  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStagesDe - 2>();
    __syncthreads();
    issue(c + kStagesDe - 1);
    const float* us = ring + (c % kStagesDe) * stage_floats;
    const float* ds = us + kChunk * kLdKRow;
    const int mc = m_begin + c * kChunk;
    if (kt == 0) {
      const float* gs = ds + kChunk * kLdKRow;
      for (int idx = tid; idx < kChunk * kTile; idx += kThreads) {
        const int at = (idx / kTile) * kLdKRow + idx % kTile;
        skv = fmaf(ds[at], gs[at], skv);
      }
    }
    if (lower && mc + kChunk - 1 < k_lo) continue;  // all m < k: U^T is 0
    const bool diag = lower && mc < k_lo + 63;
#pragma unroll
    for (int s = 0; s < kChunk / 8; ++s) {
      const int q = s * 8 + t;  // m within the chunk
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col_base + j * 8 + g;
        b[j][0] = tf32(ds[q * kLdKRow + col]);
        b[j][1] = tf32(ds[(q + 4) * kLdKRow + col]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r0 = row_base + i * 16 + g;
        float a[4] = {us[q * kLdKRow + r0], us[q * kLdKRow + r0 + 8],
                      us[(q + 4) * kLdKRow + r0],
                      us[(q + 4) * kLdKRow + r0 + 8]};
        if (diag) {  // U[m][k] = 0 for k > m
          if (k0 + r0 > mc + q) a[0] = 0.f;
          if (k0 + r0 + 8 > mc + q) a[1] = 0.f;
          if (k0 + r0 > mc + q + 4) a[2] = 0.f;
          if (k0 + r0 + 8 > mc + q + 4) a[3] = 0.f;
        }
        uint32_t at[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) at[e] = tf32(a[e]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], at, b[j]);
      }
    }
  }
  cp_async_wait<0>();
  skv_parts[tid] = skv;
  __syncthreads();  // the ring is free: the epilogue reuses it

  const int ldf = feat_pitch(D);
  float* zs = smem;                    // [kTile][ldf], zero-padded
  float* xs = zs + kTile * ldf;        // [kTile][ldf]
  float* zn = xs + kTile * ldf;        // [kTile]
  float* xn = zn + kTile;              // [kTile]
  float* rowde = xn + kTile;           // [kTile]
  float* colde = rowde + kTile;        // [kTile]
  float* de = colde + kTile;           // [kTile][kLdDe]
  // dK leaves the registers first: the gram below needs them
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        de[(row_base + i * 16 + g + 8 * (e / 2)) * kLdDe + col_base + j * 8 +
           2 * t + e % 2] = acc[i][j][e];
  stage_feats<kTile>(Zs, M, D, k0, zs, ldf);
  stage_feats<kTile>(Xs, N, D, n0, xs, ldf);
  cp_async_commit();
  if (kt == 0 && warp == 0) {  // a fixed tree over the threads' partials
    const int lane = tid % 32;
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < kThreads / 32; ++i)
      v += skv_parts[lane * (kThreads / 32) + i];
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) pskv[blockIdx.x] = v;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < kTile)
    zn[tid] = half_norm(zs + tid * ldf, D);
  else
    xn[tid - kTile] = half_norm(xs + (tid - kTile) * ldf, D);
  __syncthreads();

  // K at the accumulator's positions, from the cross term K2 uses; de =
  // K o dK (0 on padded rows and columns: U and dG were zero-filled there).
  // Two halves of the warp's rows keep the registers under 128.
  const int dp = (D + 7) / 8 * 8;
  const float var = *var_p;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float pk[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[i][j][e] = 0.f;
    cross_term<2, 4>(pk, zs, row_base + 32 * half, xs, col_base, ldf, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = row_base + 32 * half + i * 16 + g + 8 * (e / 2);
          const int n = col_base + j * 8 + 2 * t + e % 2;
          de[k * kLdDe + n] *= gram_entry(pk[i][j][e], zn[k], xn[n], var);
        }
  }
  __syncthreads();
  if (tid < kTile) {
    float s = 0.f;
#pragma unroll 16
    for (int n = 0; n < kTile; ++n) s += de[tid * kLdDe + n];
    rowde[tid] = s;
  } else {
    const int n = tid - kTile;
    float s = 0.f;
#pragma unroll 16
    for (int k = 0; k < kTile; ++k) s += de[k * kLdDe + n];
    colde[n] = s;
  }
  __syncthreads();
  // this n-tile's partial of dZs: (de Xs)[k, d] - rowde[k] Zs[k, d]
  float* dzs = pdZs + (size_t)blockIdx.x * M * D;
  de_times_features<false>(de, xs, ldf, dp, [&](int k, int d, float v) {
    if (k0 + k < M && d < D)
      dzs[(size_t)(k0 + k) * D + d] = v - rowde[k] * zs[k * ldf + d];
  });
  // this k-tile's partial of dXs: (de^T Zs)[n, d] - colde[n] Xs[n, d]
  float* dxs = pdXs + (size_t)kt * N * D;
  de_times_features<true>(de, zs, ldf, dp, [&](int n, int d, float v) {
    if (n0 + n < N && d < D)
      dxs[(size_t)(n0 + n) * D + d] = v - colde[n] * xs[n * ldf + d];
  });
}

// ---------------------------------------------------------------- K3b
__host__ __device__ size_t du_stage_floats(int D) {
  return (size_t)kTile * kLdRowK + kChunk * feat_pitch(D);
}

size_t du_smem(int D) {
  return sizeof(float) * ((size_t)kStagesDu * du_stage_floats(D) +
                          kChunk * kLdKRow + kTile +
                          (size_t)kTile * feat_pitch(D));
}

// dU partial of slice s: rows m0.. x columns k0.. (kTile each) of
// dG[:, slice] K[:, slice]^T. Under lower, blockIdx.x walks the tile pairs
// with k-tile <= m-tile only.
__global__ void __launch_bounds__(kThreads, 2)
fused_bwd_du_kernel(const float* __restrict__ Zs, const float* __restrict__ Xs,
                    const float* __restrict__ var_p,
                    const float* __restrict__ dG, float* __restrict__ pdU,
                    int M, int N, int D, int slice_len, int lower) {
  extern __shared__ __align__(16) float smem[];
  // stages of {dG [kTile][kLdRowK], Xs [kChunk][ldp]}, then the K block
  // (tf32, [n][k]), the Zs tile's half norms and the Zs tile [kTile][ldp]
  const int ldp = feat_pitch(D);
  const int dp = (D + 7) / 8 * 8;
  const size_t stage_floats = du_stage_floats(D);
  float* ring = smem;
  uint32_t* kb = reinterpret_cast<uint32_t*>(ring + kStagesDu * stage_floats);
  float* zn = reinterpret_cast<float*>(kb + kChunk * kLdKRow);  // [kTile]
  float* zs = zn + kTile;                             // [kTile][ldp]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int g = (tid % 32) / 4;
  const int t = tid % 4;
  const int row_base = (warp / 4) * 64;  // rows m
  const int col_base = (warp % 4) * 32;  // columns k
  int mt, kt;
  if (lower) {
    mt = 0;
    while ((mt + 1) * (mt + 2) / 2 <= (int)blockIdx.x) ++mt;
    kt = blockIdx.x - mt * (mt + 1) / 2;
  } else {
    const int k_tiles = (M + kTile - 1) / kTile;
    mt = blockIdx.x / k_tiles;
    kt = blockIdx.x % k_tiles;
  }
  const int m0 = mt * kTile;
  const int k0 = kt * kTile;
  const int nb = blockIdx.y * slice_len;
  const int ne = min(N, nb + slice_len);
  const int n_chunks = (ne - nb + kChunk - 1) / kChunk;

  auto issue = [&](int c) {
    if (c < n_chunks) {
      float* st = ring + (c % kStagesDu) * stage_floats;
      const int nc = nb + c * kChunk;
      stage_tile<kTile, kChunk>(dG, N, M, ne, m0, nc, st, kLdRowK);
      stage_feats<kChunk>(Xs, ne, D, nc, st + kTile * kLdRowK, ldp);
    }
    cp_async_commit();
  };
  stage_feats<kTile>(Zs, M, D, k0, zs, ldp);  // lands with chunk 0
  for (int c = 0; c < kStagesDu - 1; ++c) issue(c);
  const float var = *var_p;
  // under lower, a warp whose columns all lie above its rows writes
  // nothing that survives (K3c zeroes the upper triangle)
  const bool idle = lower && k0 + col_base > m0 + row_base + 63;

  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<kStagesDu - 2>();
    __syncthreads();
    issue(c + kStagesDu - 1);
    if (c == 0) {
      if (tid < kTile) zn[tid] = half_norm(zs + tid * ldp, D);
      __syncthreads();
    }
    const float* dg = ring + (c % kStagesDu) * stage_floats;
    const float* xc = dg + kTile * kLdRowK;
    const int nc = nb + c * kChunk;
    {  // the chunk's block of K, stored as kb[n][k]: warp w takes the Zs
       // points 16 w .. + 15 and all kChunk Xs points of the chunk
      float pk[1][4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) pk[0][j][e] = 0.f;
      cross_term<1, 4>(pk, zs, 16 * warp, xc, 0, ldp, dp);
      const float nx = half_norm(xc + (tid % 32) * ldp, D);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = 16 * warp + g + 8 * (e / 2);
          const int n = 8 * j + 2 * t + e % 2;
          const float xn = __shfl_sync(0xffffffffu, nx, n);
          kb[n * kLdKRow + k] =
              tf32((k0 + k < M && nc + n < ne)
                       ? gram_entry(pk[0][j][e], zn[k], xn, var)
                       : 0.f);
        }
    }
    __syncthreads();
    if (idle) continue;
#pragma unroll
    for (int s = 0; s < kChunk / 8; ++s) {
      const int q = s * 8 + t;  // n within the chunk
      uint32_t b[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = col_base + j * 8 + g;
        b[j][0] = kb[q * kLdKRow + col];
        b[j][1] = kb[(q + 4) * kLdKRow + col];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r0 = row_base + i * 16 + g;
        const uint32_t a[4] = {tf32(dg[r0 * kLdRowK + q]),
                               tf32(dg[(r0 + 8) * kLdRowK + q]),
                               tf32(dg[r0 * kLdRowK + q + 4]),
                               tf32(dg[(r0 + 8) * kLdRowK + q + 4])};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(acc[i][j], a, b[j]);
      }
    }
  }
  cp_async_wait<0>();
  float* out = pdU + (size_t)blockIdx.y * M * M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + row_base + i * 16 + g + 8 * h;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + col_base + j * 8 + 2 * t;
        if (k < M) out[(size_t)m * M + k] = acc[i][j][2 * h];
        if (k + 1 < M) out[(size_t)m * M + k + 1] = acc[i][j][2 * h + 1];
      }
    }
  }
}

// ---------------------------------------------------------------- K3c
struct ReduceTask {
  const float* src;       // (parts, count)
  float* dst;             // (count,)
  long long count;
  long long first_block;  // the task's blocks follow those of the tasks before
  int parts;
  int split;              // 1 or kSplit warps share an element
};
struct ReduceTasks {
  ReduceTask t[kReduceTasks];
};
constexpr int kSplit = kThreads / 32;

// Elements per block, and whether a task's parts are split across warps:
// many parts over few elements (dZs, skv) would leave one thread a long
// chain of loads.
__host__ __device__ inline int reduce_split(int parts) {
  return parts > 64 ? kSplit : 1;
}
__host__ __device__ inline int reduce_width(int split) {
  return split == 1 ? kThreads : 32;
}

// Every output element sums its partials in a fixed order: with split 1,
// one thread takes them in slot order; with split kSplit, warp w takes the
// slots w, w + kSplit, ... in order and the warps' sums are added in warp
// order. Task 0 is dU (M x M): under lower its upper triangle is written 0
// (K3b left those partials unwritten). The blocks of all tasks form one
// flat grid, so no block idles.
__global__ void __launch_bounds__(kThreads)
reduce_parts_kernel(ReduceTasks tasks, int M, int lower) {
  __shared__ float warp_sums[kSplit][32];
  int ti = 0;
  while (ti + 1 < kReduceTasks && blockIdx.x >= tasks.t[ti + 1].first_block)
    ++ti;
  const ReduceTask t = tasks.t[ti];
  const long long b = blockIdx.x - t.first_block;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int split = t.split;
  const long long i =
      split == 1 ? b * kThreads + threadIdx.x : b * 32 + lane;
  const bool zero = i >= t.count || (ti == 0 && lower && i % M > i / M);
  float s = 0.f;
  if (!zero) {
    int p = split == 1 ? 0 : warp;
    for (; p + 7 * split < t.parts; p += 8 * split) {  // eight loads in flight
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        v[u] = t.src[(size_t)(p + u * split) * t.count + i];
#pragma unroll
      for (int u = 0; u < 8; ++u) s += v[u];
    }
    for (; p < t.parts; p += split) s += t.src[(size_t)p * t.count + i];
  }
  if (split == 1) {
    if (i < t.count) t.dst[i] = s;
    return;
  }
  warp_sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && i < t.count) {
    float r = 0.f;
#pragma unroll
    for (int w = 0; w < kSplit; ++w) r += warp_sums[w][lane];
    t.dst[i] = r;
  }
}

bool bad_shape(int M, int N, int D) {
  return M <= 0 || N <= 0 || D <= 0 || D > kMaxD ||
         (M + kTile - 1) / kTile > 65535;
}

int tile_pairs(int M, int lower) {
  const int tiles = (M + kTile - 1) / kTile;
  return lower ? tiles * (tiles + 1) / 2 : tiles * tiles;
}

}  // namespace

extern "C" {

int mxf_fused_gram_tile_rows() { return kTile; }
int mxf_fused_gram_tile_cols() { return kTile; }

// Dynamic shared memory of K2 (kernel 0), K3a (1) and K3b (2) at this D.
long long mxf_fused_gram_smem_bytes(int kernel, int D) {
  return (long long)(kernel == 0 ? fwd_smem(D)
                                 : kernel == 1 ? de_smem(D) : du_smem(D));
}

// K2: G = U K (lower: tril(U) K). Returns cudaGetLastError() after the
// launch.
int mxf_fused_gram_fwd_f32(const float* U, const float* Zs, const float* Xs,
                           const float* var, float* G, int M, int N, int D,
                           int lower, void* stream) {
  if (bad_shape(M, N, D)) return (int)cudaErrorInvalidValue;
  const size_t smem = fwd_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  fused_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      U, Zs, Xs, var, G, M, N, D, lower);
  return (int)cudaGetLastError();
}

// K3: three launches (K3a, K3b, K3c); G is the forward's output. The
// partial buffers are pdZs (ceil(N / kTile), M, D), pdXs (ceil(M / kTile),
// N, D), pskv (ceil(N / kTile)), pdU (slices, M, M), with
// slices * slice_len >= N. Returns the first launch error, or 0.
int mxf_fused_gram_bwd_f32(const float* U, const float* Zs, const float* Xs,
                           const float* var, const float* dG, const float* G,
                           float* dU,
                           float* dZs, float* dXs, float* skv, float* pdU,
                           float* pdZs, float* pdXs, float* pskv, int M, int N,
                           int D, int slices, int slice_len, int lower,
                           void* stream) {
  if (bad_shape(M, N, D) || slices <= 0 || slices > 65535 || slice_len <= 0 ||
      (long long)slices * slice_len < N)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (N + kTile - 1) / kTile;
  const int k_tiles = (M + kTile - 1) / kTile;

  const size_t smem_de = de_smem(D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_de_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_de);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_de_kernel<<<dim3(n_tiles, k_tiles), kThreads, smem_de, st>>>(
      U, Zs, Xs, var, dG, G, pdZs, pdXs, pskv, M, N, D, lower);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem_du = du_smem(D);
  err = cudaFuncSetAttribute(fused_bwd_du_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_du);
  if (err != cudaSuccess) return (int)err;
  fused_bwd_du_kernel<<<dim3(tile_pairs(M, lower), slices), kThreads, smem_du,
                        st>>>(Zs, Xs, var, dG, pdU, M, N, D, slice_len, lower);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const float* srcs[kReduceTasks] = {pdU, pdZs, pdXs, pskv};
  float* dsts[kReduceTasks] = {dU, dZs, dXs, skv};
  const long long counts[kReduceTasks] = {(long long)M * M, (long long)M * D,
                                          (long long)N * D, 1};
  const int parts[kReduceTasks] = {slices, n_tiles, k_tiles, n_tiles};
  ReduceTasks tasks;
  long long blocks = 0;
  for (int i = 0; i < kReduceTasks; ++i) {
    const int split = reduce_split(parts[i]);
    const int width = reduce_width(split);
    tasks.t[i] = {srcs[i], dsts[i], counts[i], blocks, parts[i], split};
    blocks += (counts[i] + width - 1) / width;
  }
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  reduce_parts_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(tasks, M, lower);
  return (int)cudaGetLastError();
}

const char* mxf_fused_gram_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
