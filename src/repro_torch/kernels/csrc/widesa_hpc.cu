// Hand-written Hopper (sm_90a) kernels for the WideSA HPC recurrences: the
// weighted star stencils (jacobi2d, jacobi2d_9pt and each sweep of
// jacobi2d_ms) and MTTKRP.
//
// Arithmetic, as in csrc/widesa_mm.cu and csrc/widesa_sp.cu.  Float32
// inputs accumulate in fp32 (fused multiply-add).  Integer inputs (int8,
// int16, int32) sign-extend to 32 bits and accumulate in *unsigned* 32-bit
// arithmetic, so products and sums wrap modulo 2^32 with defined behaviour:
// arithmetic modulo 2^32 is a ring, so any order of summation is bit-exact
// with XLA's int32 einsum.  Integer inputs give int32 output, float32 gives
// float32 (repro_torch/kernels/runtime.py: out_dtype).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with repro_torch/kernels/build.py
enum DType : int { F32 = 0, BF16 = 1, I8 = 2, I16 = 3, I32 = 4 };

template <typename T> struct Elem;
template <> struct Elem<float> {
  using Acc = float;
  using Acc4 = float4;
  __device__ static Acc load(const float* p) { return *p; }
};
template <> struct Elem<int8_t> {
  using Acc = uint32_t;
  using Acc4 = uint4;
  __device__ static Acc load(const int8_t* p) { return (uint32_t)(int32_t)*p; }
};
template <> struct Elem<int16_t> {
  using Acc = uint32_t;
  using Acc4 = uint4;
  __device__ static Acc load(const int16_t* p) { return (uint32_t)(int32_t)*p; }
};
template <> struct Elem<int32_t> {
  using Acc = uint32_t;
  using Acc4 = uint4;
  __device__ static Acc load(const int32_t* p) { return (uint32_t)*p; }
};

template <typename Acc, typename TOut> struct Flush;
template <> struct Flush<float, float> {
  __device__ static float cast(float v) { return v; }
};
template <> struct Flush<uint32_t, int32_t> {
  __device__ static int32_t cast(uint32_t v) { return (int32_t)v; }
};

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// Star stencil: O[r, c] = sum_s w[s] * G[r + di_s, c + dj_s] for r < oh,
// c < ow, with G of (oh + 2R) x (ow + 2R), row-major, and the star's
// padded-grid offsets (di_s, dj_s) in [0, 2R].  O is row-major with row
// stride out_ld, so a sweep of jacobi2d_ms writes straight into the
// interior of the next state, inside its fixed boundary ring.
//
// Replaces src/repro/kernels/jacobi2d.py jacobi_kernel (pallas_call at :74
// in jacobi2d_stacked), which contracts a (S, bh, bw) block of the
// shifted-point stack that ops._star2d writes to HBM (ops.py:122-126: S full
// copies of the interior, padded to the tile) with the S weights, one grid
// visit per output tile.
//
// What bounds it on an H100: bytes.  2 * S operations per output (10 for
// the 5-point star, 18 for the 9-point one) against 8 bytes moved per
// output in float32 (G read once, O written once): at most ~2 operations
// per byte, far below the ~20 the CUDA cores need at 3.35 TB/s.  The design
// reads each grid element from device memory about once: a block of 256
// threads owns a 32 x 128 output tile, stages the input tile with its
// R-wide halo in shared memory with coalesced row loads (the star's radius
// R = 1 or 2 is a template parameter, so the tile is a fixed array), and
// each thread computes 4 x 4 outputs, the rows 8 apart and the columns 32
// apart, so that a warp reads and writes 32 consecutive addresses.  The
// star's offsets come by value in a kernel argument and its weights from
// device memory, so one kernel serves both stars (the TPU kernel is
// plane-count generic the same way).  Halo rows and columns are the only
// input read twice, from L2: (32 + 2R)(128 + 2R) / (32 * 128) = 1.16 reads
// an element at R = 2.  Ragged edges are masked; no padding copy is made.
// ---------------------------------------------------------------------------
constexpr int kMaxPoints = 16;

struct Star {
  int n;
  int di[kMaxPoints];
  int dj[kMaxPoints];
};

constexpr int kStarCols = 128;                           // BW
constexpr int kColThreads = 32;
constexpr int kRowThreads = kThreads / kColThreads;      // 8
constexpr int kColsPerThread = kStarCols / kColThreads;  // 4
constexpr int kStarRowsPerThread = 4;
constexpr int kStarRows = kRowThreads * kStarRowsPerThread;  // BH = 32

template <typename TIn, typename TOut, int R>
__global__ void __launch_bounds__(kThreads)
star_kernel(const TIn* __restrict__ grid, const typename Elem<TIn>::Acc* __restrict__ weights,
            TOut* __restrict__ out, int oh, int ow, int out_ld, Star star) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int BH = kStarRows;
  constexpr int TILE_H = BH + 2 * R;
  constexpr int TILE_W = kStarCols + 2 * R;
  __shared__ Acc tile[TILE_H][TILE_W];
  __shared__ Acc ws[kMaxPoints];

  const int tx = threadIdx.x % kColThreads;
  const int ty = threadIdx.x / kColThreads;
  const int r0 = blockIdx.y * BH;
  const int c0 = blockIdx.x * kStarCols;
  const int in_h = oh + 2 * R;
  const int in_w = ow + 2 * R;

  if ((int)threadIdx.x < star.n) ws[threadIdx.x] = weights[threadIdx.x];
  for (int rr = ty; rr < TILE_H; rr += kRowThreads) {
    const int gr = r0 + rr;
    const TIn* row = grid + (size_t)gr * in_w;
    for (int cc = tx; cc < TILE_W; cc += kColThreads) {
      const int gc = c0 + cc;
      tile[rr][cc] = (gr < in_h && gc < in_w) ? Elem<TIn>::load(row + gc) : Acc(0);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kStarRowsPerThread; ++i) {
    const int r = ty + i * kRowThreads;
    const int gr = r0 + r;
    if (gr >= oh) break;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const int c = tx + j * kColThreads;
      const int gc = c0 + c;
      if (gc < ow) {
        Acc acc = Acc(0);
        for (int s = 0; s < star.n; ++s) acc += tile[r + star.di[s]][c + star.dj[s]] * ws[s];
        out[(size_t)gr * out_ld + gc] = Flush<Acc, TOut>::cast(acc);
      }
    }
  }
}

template <typename TIn, typename TOut, int R>
int star_radius(const void* grid, const void* weights, void* out, int oh, int ow, int out_ld,
                const Star& star, cudaStream_t stream) {
  using Acc = typename Elem<TIn>::Acc;
  const dim3 grid_dim((unsigned)((ow + kStarCols - 1) / kStarCols),
                      (unsigned)((oh + kStarRows - 1) / kStarRows));
  star_kernel<TIn, TOut, R><<<grid_dim, kThreads, 0, stream>>>(
      static_cast<const TIn*>(grid), static_cast<const Acc*>(weights), static_cast<TOut*>(out),
      oh, ow, out_ld, star);
  return (int)cudaGetLastError();
}

// The compiled stencil tile: (BH, BW) = (32, 128), for radius 1 and 2 (kept
// equal to STENCIL_TILE and STENCIL_RADII in repro_torch/kernels/build.py).
template <typename TIn, typename TOut>
int launch_star(int radius, int bh, int bw, const void* grid, const void* weights, void* out,
                int oh, int ow, int out_ld, const Star& star, cudaStream_t stream) {
  if (bh != kStarRows || bw != kStarCols) return (int)cudaErrorInvalidValue;
  if (radius == 1)
    return star_radius<TIn, TOut, 1>(grid, weights, out, oh, ow, out_ld, star, stream);
  if (radius == 2)
    return star_radius<TIn, TOut, 2>(grid, weights, out, oh, ow, out_ld, star, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// MTTKRP: M[i, j] = sum_{k, l} X[i, k, l] * B[k, j] * C[l, j], with X of
// I x K x L, B of K x J, C of L x J and M of I x J, all row-major.
//
// Replaces src/repro/kernels/mttkrp.py mttkrp_kernel (pallas_call at :94),
// whose grid (i, j, k, l) runs its two reduction dimensions in order on one
// core and carries the (bi, bj) sum in a VMEM accumulator between steps.
//
// Row-major X[i, k, l] is X2[i, k * L + l], so M = X2 @ KR with the
// Khatri-Rao operand KR[k * L + l, j] = B[k, j] * C[l, j]: a GEMM whose B
// operand is generated.  The structure is that of the mm kernel
// (csrc/widesa_mm.cu): blocks run in parallel in no order, so the two
// reduction loops fuse into one loop over k * L + l inside the block.  A
// block owns a 64 x 64 output tile in registers (256 threads, each a 4 x 4
// sub-tile of adjacent rows and columns), and for each 32-deep chunk of
// the fused reduction it stages the X2 slice in shared memory (coalesced
// along k * L + l, stored transposed so that a thread reads its rows and
// its columns as one 16-byte vector each, the rows a broadcast within the
// warp) and builds the KR slice there from rows of B and C, which are small
// and stay in L2; the (k, l) of each KR row comes from one division a
// chunk.  KR is never written to device memory.  Consecutive blocks walk
// the J tiles of one I tile, so they share its X2 slices through L2.
// J = 400 is not a multiple of the tile: columns past J are masked, as are
// rows past I and the tail of the reduction.
//
// What bounds it on an H100: operations on the CUDA cores.  2 * I * J * K * L
// operations of the folded product (2.147e11 at 4096 x 400 x 256 x 256:
// 3.2 ms at the fp32 rate) against 1.07 GB of X read once (0.32 ms).  Each
// thread does 16 multiply-adds for every 2 vector reads of shared memory;
// the KR products add 1 / 64 of the multiply-adds.  The wrapper keeps
// K * L below 2^31.
// ---------------------------------------------------------------------------
constexpr int kMttkrpCols = 64;                              // BJ
constexpr int kMttkrpTN = 4;                                 // columns a thread
constexpr int kThreadsJ = kMttkrpCols / kMttkrpTN;           // 16
constexpr int kThreadsI = kThreads / kThreadsJ;              // 16
constexpr int kMttkrpTM = 4;                                 // rows a thread
constexpr int kMttkrpRows = kThreadsI * kMttkrpTM;           // BI = 64
constexpr int kChunk = 32;                                   // fused (k, l) depth

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kThreads)
mttkrp_kernel(const TIn* __restrict__ x, const TIn* __restrict__ b, const TIn* __restrict__ c,
              TOut* __restrict__ m, int ni, int nj, int nk, int nl) {
  using Acc = typename Elem<TIn>::Acc;
  using Acc4 = typename Elem<TIn>::Acc4;
  constexpr int BI = kMttkrpRows;
  constexpr int TM = kMttkrpTM;
  // X2 slice, transposed; rows padded to keep 16-byte alignment
  __shared__ __align__(16) Acc xs[kChunk][BI + 4];
  __shared__ __align__(16) Acc kr[kChunk][kMttkrpCols];

  const int tj = threadIdx.x % kThreadsJ;
  const int ti = threadIdx.x / kThreadsJ;
  const int j0 = blockIdx.x * kMttkrpCols;
  const int i0 = blockIdx.y * BI;
  const int nkl = nk * nl;  // < 2^31 (the wrapper checks)
  // this thread's KR column, and its first KR row of a chunk: kr_row + 4 q
  const int jj = threadIdx.x % kMttkrpCols;
  const int kr_row = threadIdx.x / kMttkrpCols;
  constexpr int kKrStep = kThreads / kMttkrpCols;  // 4

  Acc acc[TM][kMttkrpTN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < kMttkrpTN; ++j) acc[i][j] = Acc(0);

  for (int kl0 = 0; kl0 < nkl; kl0 += kChunk) {
    for (int e = threadIdx.x; e < BI * kChunk; e += kThreads) {
      const int ii = e / kChunk, kk = e % kChunk;
      const int gi = i0 + ii, gkl = kl0 + kk;
      xs[kk][ii] = (gi < ni && gkl < nkl) ? Elem<TIn>::load(x + (size_t)gi * nkl + gkl) : Acc(0);
    }
    {
      // (k, l) of kl0 + kr_row by one division, then stepped without any
      const int gj = j0 + jj;
      int gkl = kl0 + kr_row;
      int k = gkl / nl, l = gkl - k * nl;
      for (int kk = kr_row; kk < kChunk; kk += kKrStep) {
        Acc v = Acc(0);
        if (gkl < nkl && gj < nj)
          v = Elem<TIn>::load(b + (size_t)k * nj + gj) * Elem<TIn>::load(c + (size_t)l * nj + gj);
        kr[kk][jj] = v;
        gkl += kKrStep;
        l += kKrStep;
        while (l >= nl) {
          l -= nl;
          ++k;
        }
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kChunk; ++kk) {
      const Acc4 a4 = *reinterpret_cast<const Acc4*>(&xs[kk][ti * TM]);
      const Acc av[TM] = {a4.x, a4.y, a4.z, a4.w};
      const Acc4 bv = *reinterpret_cast<const Acc4*>(&kr[kk][tj * kMttkrpTN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] += av[i] * bv.x;
        acc[i][1] += av[i] * bv.y;
        acc[i][2] += av[i] * bv.z;
        acc[i][3] += av[i] * bv.w;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gi = i0 + ti * TM + i;
    if (gi >= ni) continue;
#pragma unroll
    for (int j = 0; j < kMttkrpTN; ++j) {
      const int gj = j0 + tj * kMttkrpTN + j;
      if (gj < nj) m[(size_t)gi * nj + gj] = Flush<Acc, TOut>::cast(acc[i][j]);
    }
  }
}

// The compiled MTTKRP tile: (BI, BJ) = (64, 64) (kept equal to MTTKRP_TILE
// in repro_torch/kernels/build.py).
template <typename TIn, typename TOut>
int launch_mttkrp(int bi, int bj, const void* x, const void* b, const void* c, void* m, int ni,
                  int nj, int nk, int nl, cudaStream_t stream) {
  if (bi != kMttkrpRows || bj != kMttkrpCols) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((nj + kMttkrpCols - 1) / kMttkrpCols),
                  (unsigned)((ni + kMttkrpRows - 1) / kMttkrpRows));
  mttkrp_kernel<TIn, TOut><<<grid, kThreads, 0, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(b), static_cast<const TIn*>(c),
      static_cast<TOut*>(m), ni, nj, nk, nl);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// O[r, c] = sum_s w[s] G[r + di_s, c + dj_s] over an oh x ow output with
// row stride out_ld; `offsets` is a host array of n_points (di, dj) pairs
// in [0, 2 * radius], `weights` n_points device values of the accumulator
// type (float32, or int32 for integer grids).  Returns a cudaError_t.
int widesa_star_launch(const void* grid, const void* weights, void* out, int oh, int ow,
                       int out_ld, int radius, int n_points, const int* offsets, int in_dtype,
                       int out_dtype, int bh, int bw, void* stream) {
  if (n_points < 1 || n_points > kMaxPoints || out_ld < ow) return (int)cudaErrorInvalidValue;
  Star star{};
  star.n = n_points;
  for (int s = 0; s < n_points; ++s) {
    star.di[s] = offsets[2 * s];
    star.dj[s] = offsets[2 * s + 1];
    if (star.di[s] < 0 || star.di[s] > 2 * radius || star.dj[s] < 0 || star.dj[s] > 2 * radius)
      return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32)
    return launch_star<float, float>(radius, bh, bw, grid, weights, out, oh, ow, out_ld, star, s);
  if (in_dtype == I8 && out_dtype == I32)
    return launch_star<int8_t, int32_t>(radius, bh, bw, grid, weights, out, oh, ow, out_ld, star, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_star<int16_t, int32_t>(radius, bh, bw, grid, weights, out, oh, ow, out_ld, star, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_star<int32_t, int32_t>(radius, bh, bw, grid, weights, out, oh, ow, out_ld, star, s);
  return (int)cudaErrorInvalidValue;
}

// M[i, j] = sum_{k,l} X[i, k, l] B[k, j] C[l, j] (the mttkrp recurrence).
// Returns a cudaError_t.
int widesa_mttkrp_launch(const void* x, const void* b, const void* c, void* m, int ni, int nj,
                         int nk, int nl, int in_dtype, int out_dtype, int bi, int bj,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32)
    return launch_mttkrp<float, float>(bi, bj, x, b, c, m, ni, nj, nk, nl, s);
  if (in_dtype == I8 && out_dtype == I32)
    return launch_mttkrp<int8_t, int32_t>(bi, bj, x, b, c, m, ni, nj, nk, nl, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_mttkrp<int16_t, int32_t>(bi, bj, x, b, c, m, ni, nj, nk, nl, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_mttkrp<int32_t, int32_t>(bi, bj, x, b, c, m, ni, nj, nk, nl, s);
  return (int)cudaErrorInvalidValue;
}

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
