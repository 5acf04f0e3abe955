// Hand-written Hopper (sm_90a) GEMM for the WideSA mm and bmm recurrences.
//
// Replaces two Pallas TPU kernels of the reference package:
//   * src/repro/kernels/widesa_mm.py  mm_kernel   (C[m,n]  = A[m,k]  @ B[k,n])
//   * src/repro/kernels/bmm.py        bmm_kernel  (C[b]    = A[b]    @ B[b])
// Both become one templated tiled kernel with a batch grid dimension; mm is
// the batch = 1 launch.
//
// Translation.  On the TPU the grid (b, i, j, k) runs in order on one core
// and the k dimension ("arbitrary") carries an fp32/int32 accumulator in VMEM
// scratch between grid steps.  Here blocks run in parallel in no order, so
// the k loop moves inside the block: each block owns one BM x BN output tile
// of one batch slice, stages BK-deep slices of A and B through shared memory,
// accumulates in registers (fp32 for float inputs, 32-bit for integers) and
// flushes once to the output dtype.  The block masks the ragged edges of
// every dimension itself, so the wrapper makes no padding copies (the
// reference's ops.matmul / ops.bmm pad operands to the plan tiles).  The
// plan's row tile and B's layout pick one of the compiled (BM, BN, BK) shapes
// (repro_torch/kernels/runtime.py: hopper_tiles); the grid's x dimension walks
// the M tiles, so blocks that share a B tile run next to each other and
// share it through L2.
//
// What bounds it on an H100.  Every GEMM of the serving path has M <= 16 (a
// decode batch or one prompt), so each is bound by the bytes of B it reads:
// the tied lm_head alone reads 151936 x 1024 x 2 B = 311 MB, about 93 us at
// 3.35 TB/s.  This first kernel is the simple, exact one: scalar loads, no
// tensor cores, no TMA / wgmma pipeline.  It is not near that bound (PERF.md
// has its times).
//
// Arithmetic.  Float inputs accumulate in fp32 on the CUDA cores in full IEEE
// precision (fused multiply-add, never TF32); bf16 operands widen exactly to
// fp32 and the result rounds once (round-to-nearest-even) to the output
// dtype.  Integer inputs (int8, int16, int32) sign-extend to 32 bits and
// accumulate in *unsigned* 32-bit arithmetic: products and sums wrap modulo
// 2^32 with defined behaviour, which is bit-exact with XLA's int32 wraparound.
//
// Layouts.  A is row-major [batch, M, K]; C is row-major [batch, M, N]; B is
// row-major [batch, K, N] or, with b_col_major, the transpose of a row-major
// [batch, N, K] (the tied lm_head reads the embedding table as its B).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// dtype codes shared with repro_torch/kernels/build.py
enum DType : int { F32 = 0, BF16 = 1, I8 = 2, I16 = 3, I32 = 4 };

template <typename T> struct Elem;
template <> struct Elem<float> {
  using Acc = float;
  __device__ static Acc load(const float* p) { return *p; }
};
template <> struct Elem<__nv_bfloat16> {
  using Acc = float;
  __device__ static Acc load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
};
template <> struct Elem<int8_t> {
  using Acc = uint32_t;
  __device__ static Acc load(const int8_t* p) { return (uint32_t)(int32_t)*p; }
};
template <> struct Elem<int16_t> {
  using Acc = uint32_t;
  __device__ static Acc load(const int16_t* p) { return (uint32_t)(int32_t)*p; }
};
template <> struct Elem<int32_t> {
  using Acc = uint32_t;
  __device__ static Acc load(const int32_t* p) { return (uint32_t)*p; }
};

template <typename Acc, typename TOut> struct Flush;
template <> struct Flush<float, float> {
  __device__ static float cast(float v) { return v; }
};
template <> struct Flush<float, __nv_bfloat16> {
  __device__ static __nv_bfloat16 cast(float v) { return __float2bfloat16_rn(v); }
};
template <> struct Flush<uint32_t, int32_t> {
  __device__ static int32_t cast(uint32_t v) { return (int32_t)v; }
};

// Thread geometry of a BM x BN tile: at most 128 threads, each owning a
// TM x TN register sub-tile of TN adjacent columns.
template <int BM, int BN> struct Geometry {
  static constexpr int kThreads = BM * BN < 128 ? BM * BN : 128;
  static constexpr int kPerThread = BM * BN / kThreads;
  static constexpr int TN = kPerThread < 4 ? kPerThread : 4;
  static constexpr int TM = kPerThread / TN;
  static constexpr int kThreadsN = BN / TN;
  static_assert(kThreadsN * (BM / TM) == kThreads, "tile does not split");
};

template <typename TIn, typename TOut, int BM, int BN, int BK>
__global__ void __launch_bounds__(Geometry<BM, BN>::kThreads)
gemm_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b,
            TOut* __restrict__ c, int m, int n, int k, int b_col_major) {
  using Acc = typename Elem<TIn>::Acc;
  using G = Geometry<BM, BN>;
  constexpr int NT = G::kThreads, TM = G::TM, TN = G::TN;

  __shared__ __align__(16) Acc As[BK][BM];
  __shared__ __align__(16) Acc Bs[BK][BN];

  const int tid = threadIdx.x;
  const int tn = tid % G::kThreadsN;
  const int tm = tid / G::kThreadsN;
  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * BN;
  const size_t z = blockIdx.z;
  a += z * (size_t)m * k;
  b += z * (size_t)k * n;
  c += z * (size_t)m * n;

  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < k; k0 += BK) {
    // A slice [BM, BK]: consecutive threads read consecutive k
    for (int e = tid; e < BM * BK; e += NT) {
      const int r = e / BK, kk = e % BK;
      const int gr = row0 + r, gk = k0 + kk;
      As[kk][r] = (gr < m && gk < k) ? Elem<TIn>::load(a + (size_t)gr * k + gk) : Acc(0);
    }
    // B slice [BK, BN]: consecutive threads follow the unit-stride dimension
    if (b_col_major) {
      for (int e = tid; e < BK * BN; e += NT) {
        const int col = e / BK, kk = e % BK;
        const int gc = col0 + col, gk = k0 + kk;
        Bs[kk][col] = (gc < n && gk < k) ? Elem<TIn>::load(b + (size_t)gc * k + gk) : Acc(0);
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, col = e % BN;
        const int gc = col0 + col, gk = k0 + kk;
        Bs[kk][col] = (gc < n && gk < k) ? Elem<TIn>::load(b + (size_t)gk * n + gc) : Acc(0);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc av[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) av[i] = As[kk][tm * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tn * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + tm * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = col0 + tn * TN + j;
      if (col < n) c[(size_t)r * n + col] = Flush<Acc, TOut>::cast(acc[i][j]);
    }
  }
}

struct Args {
  const void* a;
  const void* b;
  void* c;
  int batch, m, n, k, b_col_major;
  cudaStream_t stream;
};

template <typename TIn, typename TOut, int BM, int BN, int BK>
int launch_tile(const Args& x) {
  const dim3 grid((x.m + BM - 1) / BM, (x.n + BN - 1) / BN, x.batch);
  gemm_kernel<TIn, TOut, BM, BN, BK><<<grid, Geometry<BM, BN>::kThreads, 0, x.stream>>>(
      static_cast<const TIn*>(x.a), static_cast<const TIn*>(x.b), static_cast<TOut*>(x.c),
      x.m, x.n, x.k, x.b_col_major);
  return (int)cudaGetLastError();
}

// The compiled tiles: for each BM, the narrowest BN that still gives a block
// of 128 threads, with BK = 8 or 32 (kept equal to COMPILED_TILES in
// repro_torch/kernels/build.py).  With WIDESA_SWEEP_TILES, every BM x BN x BK
// of {1, 4, 16, 64} x {32, 64, 128} x {8, 32} instead (SWEEP_TILES), for
// timing the tile choice.
#define WIDESA_TILE(BM_, BN_, BK_) \
  if (bm == BM_ && bn == BN_ && bk == BK_) return launch_tile<TIn, TOut, BM_, BN_, BK_>(x);
#define WIDESA_BK(BM_, BN_) WIDESA_TILE(BM_, BN_, 8) WIDESA_TILE(BM_, BN_, 32)
#define WIDESA_BN(BM_) WIDESA_BK(BM_, 32) WIDESA_BK(BM_, 64) WIDESA_BK(BM_, 128)

template <typename TIn, typename TOut>
int launch_dtype(int bm, int bn, int bk, const Args& x) {
#ifdef WIDESA_SWEEP_TILES
  WIDESA_BN(1)
  WIDESA_BN(4)
  WIDESA_BN(16)
  WIDESA_BN(64)
#else
  WIDESA_BK(1, 128)
  WIDESA_BK(4, 32)
  WIDESA_BK(16, 32)
  WIDESA_BK(64, 32)
#endif
  return (int)cudaErrorInvalidValue;
}

int launch(int in_dtype, int out_dtype, int bm, int bn, int bk, const Args& x) {
  if (in_dtype == F32 && out_dtype == F32) return launch_dtype<float, float>(bm, bn, bk, x);
  if (in_dtype == BF16 && out_dtype == BF16)
    return launch_dtype<__nv_bfloat16, __nv_bfloat16>(bm, bn, bk, x);
  if (in_dtype == BF16 && out_dtype == F32) return launch_dtype<__nv_bfloat16, float>(bm, bn, bk, x);
  if (in_dtype == I8 && out_dtype == I32) return launch_dtype<int8_t, int32_t>(bm, bn, bk, x);
  if (in_dtype == I16 && out_dtype == I32) return launch_dtype<int16_t, int32_t>(bm, bn, bk, x);
  if (in_dtype == I32 && out_dtype == I32) return launch_dtype<int32_t, int32_t>(bm, bn, bk, x);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// C[m, n] = A[m, k] @ B[k, n] (the mm recurrence).  Returns a cudaError_t.
int widesa_mm_launch(const void* a, const void* b, void* c, int m, int n, int k,
                     int b_col_major, int in_dtype, int out_dtype, int bm, int bn, int bk,
                     void* stream) {
  const Args x{a, b, c, 1, m, n, k, b_col_major, static_cast<cudaStream_t>(stream)};
  return launch(in_dtype, out_dtype, bm, bn, bk, x);
}

// C[z] = A[z] @ B[z] for z < batch (the bmm recurrence).  Returns a cudaError_t.
int widesa_bmm_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                      int b_col_major, int in_dtype, int out_dtype, int bm, int bn, int bk,
                      void* stream) {
  const Args x{a, b, c, batch, m, n, k, b_col_major, static_cast<cudaStream_t>(stream)};
  return launch(in_dtype, out_dtype, bm, bn, bk, x);
}

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
