// Hand-written Hopper (sm_90a) GEMMs for the WideSA mm and bmm recurrences.
//
// Replaces two Pallas TPU kernels of the reference package:
//   * src/repro/kernels/widesa_mm.py:92  mm_kernel   (C[m,n] = A[m,k] @ B[k,n])
//   * src/repro/kernels/bmm.py:74        bmm_kernel  (C[b]   = A[b]   @ B[b])
// Both become one family with a batch grid dimension; mm is the batch = 1
// launch.  Two kernels serve it: skinny_kernel for A of at most 16 rows (every
// GEMM of the serving paths), gemm_kernel (tiled) for everything else and for
// operands the skinny kernel cannot take (rows of B not 4-byte aligned).
//
// Translation.  On the TPU the grid (b, i, j, k) runs in order on one core
// and the k dimension ("arbitrary") carries an fp32/int32 accumulator in VMEM
// scratch between grid steps.  Here blocks run in parallel in no order, so
// the k loop moves inside the block (or, split, into a cluster of blocks that
// reduce in a fixed order), accumulates in registers (fp32 for float inputs,
// 32-bit for integers) and flushes once to the output dtype.  Both kernels
// mask the ragged edges of every dimension themselves, so the wrapper makes
// no padding copies (the reference's ops.matmul / ops.bmm pad operands to the
// plan tiles).
//
// What bounds it on an H100.  Every serving GEMM has M <= 16 (a decode batch,
// a prompt of at most 16 tokens, an 8-frame audio chunk, one GQA query row),
// so each is bound by the bytes of B: 2 FLOP per element of B against the
// card's ~295 bf16 FLOP per byte.  The tied lm_head alone reads 151936 x 1024
// x 2 B = 311 MB, 93 us at 3.35 TB/s.  skinny_kernel serves that bound:
//
//   * Enough blocks.  A block computes 32 columns (4 warps x 8).  Where the
//     column tiles (times the batch) leave SMs idle, K is split across the
//     blocks of a thread-block cluster (at most 8, the portable size); each
//     block reduces its own K range and the cluster adds the partial tiles
//     through distributed shared memory, every output summed over the ranks
//     in rank order: the same bits on every run, no atomics, no workspace.
//     repro_torch/kernels/runtime.py (skinny_tile) picks the split so that a
//     serving shape whose B exceeds 1 MiB launches at least 132 blocks.
//   * Enough bytes in flight.  B streams through a 4-stage shared-memory ring
//     of cp.async copies (16 bytes each where B's rows are 16-byte aligned, 8
//     or 4 otherwise); a stage is 4 KB, 128 bytes of each of 32 rows, and
//     neighbouring threads copy neighbouring 16-byte runs in both layouts
//     (along N for a row-major B, along K for the column-major lm_head).
//     Three stages are in flight per block while the oldest is consumed, and
//     small blocks let several share an SM.  A (at most 16 x the block's K
//     range) is staged once per block, by cp.async where its rows are 16-byte
//     aligned and by plain loads otherwise, in the same first group.
//   * Arithmetic that keeps up.  At M = 16 bf16 needs 8 FMAs per byte of B,
//     near the CUDA cores' fp32 peak, so bf16 runs on the tensor cores:
//     mma.sync.m16n8k16 with fp32 accumulation, A's missing rows read as
//     zeros, B fragments by ldmatrix (.trans for a row-major B).  Shared
//     memory rows carry 16 bytes of padding, so neither ldmatrix nor the A
//     fragment loads conflict on banks.  wgmma needs 64-row tiles and would
//     waste 75-98 % of them here.  float32 stays IEEE FMA on the CUDA cores
//     (TF32 misses the registry's atol 1e-3), and integers stay on the CUDA
//     cores in unsigned 32-bit arithmetic: each lane owns one column and a
//     quarter of each stage's K, and the four quarters are added by warp
//     shuffles in a fixed order.
//
// gemm_kernel is the first, simple tiled kernel: scalar loads staged through
// shared memory, no tensor cores.  It stays for M > 16 (quickstart's 1024^3,
// the registry's smoke sizes) and for operands the skinny kernel refuses.
//
// Arithmetic.  Float inputs accumulate in fp32 (full IEEE FMA on the CUDA
// cores; fp32 accumulation on the tensor cores for bf16); bf16 operands widen
// exactly to fp32 and the result rounds once (round-to-nearest-even) to the
// output dtype.  Integer inputs (int8, int16, int32) sign-extend to 32 bits
// and accumulate in *unsigned* 32-bit arithmetic: products and sums wrap
// modulo 2^32 with defined behaviour, which is bit-exact with XLA's int32
// wraparound in any order.
//
// Layouts.  A is row-major [batch, M, K]; C is row-major [batch, M, N]; B is
// row-major [batch, K, N] or, with b_col_major, the transpose of a row-major
// [batch, N, K] (the tied lm_head reads the embedding table as its B).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// ---------------------------------------------------------------------------
// skinny_kernel: M <= 16 (see the note at the top)
// ---------------------------------------------------------------------------

// kept equal to the SKINNY_* constants of repro_torch/kernels/runtime.py
constexpr int kSkinnyRows = 16;       // rows of A at most: one m16n8k16 tile
constexpr int kSkinnyBN = 32;         // columns a block computes: 4 warps x 8
constexpr int kSkinnyThreads = 128;
constexpr int kSkinnyStages = 4;      // depth of the B ring
constexpr int kSkinnyRunBytes = 128;  // bytes of K a stage holds (BK * sizeof)
constexpr int kSkinnyMaxCluster = 8;  // the portable cluster size
constexpr int kSkinnyPad = 16;        // bytes padding each shared-memory row
constexpr int kSkinnyMaxSmem = 232448;

template <typename TIn> struct Skinny {
  static constexpr int BK = kSkinnyRunBytes / (int)sizeof(TIn);
  static constexpr int E = 16 / (int)sizeof(TIn);  // elements of a 16-byte run
  // a stage of a row-major B: BK rows of BN columns; of a column-major B: BN
  // rows (columns of B) of BK; every row padded by kSkinnyPad bytes
  static constexpr int kRowPitch = kSkinnyBN * (int)sizeof(TIn) + kSkinnyPad;
  static constexpr int kColPitch = kSkinnyRunBytes + kSkinnyPad;
  static constexpr int kStageBytes =
      BK * kRowPitch > kSkinnyBN * kColPitch ? BK * kRowPitch : kSkinnyBN * kColPitch;
  static constexpr int kChunks = kSkinnyBN * kSkinnyRunBytes / 16;  // 16-byte runs a stage
  static_assert(kChunks % kSkinnyThreads == 0, "a stage does not split over the block");
  static constexpr bool kMma = std::is_same<TIn, __nv_bfloat16>::value;  // tensor cores
  static_assert(kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of BYTES into shared memory; nothing is read and
// zeros are written when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned dst, const void* src, bool valid) {
  const int n = valid ? BYTES : 0;
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(dst), "l"(src),
                 "n"(BYTES), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The 16-byte run of `row` that starts at element `first`, in copies of
// `gran` bytes (16, 8 or 4: what the row's alignment allows); elements at or
// past `limit` are not read and land as zeros.  `safe` is any valid address.
template <typename T>
__device__ __forceinline__ void copy_run(unsigned dst, const T* row, int first, int limit,
                                         int gran, const T* safe) {
  if (gran == 16) {
    const bool ok = first < limit;
    cp_async<16>(dst, ok ? row + first : safe, ok);
  } else if (gran == 8) {
    constexpr int P = 8 / (int)sizeof(T);
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const bool ok = first + p * P < limit;
      cp_async<8>(dst + 8 * p, ok ? row + first + p * P : safe, ok);
    }
  } else {
    constexpr int P = 4 / (int)sizeof(T);
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const bool ok = first + p * P < limit;
      cp_async<4>(dst + 4 * p, ok ? row + first + p * P : safe, ok);
    }
  }
}

// Load stage `kbase` (the K offset of its first row) of the block's column
// tile into the ring slot at shared address `slot`; rows of K at or past K
// land as zeros.  The tensor cores read no row past K rounded up to 16 (the
// depth of one product), so those rows are not copied; the CUDA-core path
// reads whole stages.
template <typename TIn>
__device__ __forceinline__ void load_stage(unsigned slot, const TIn* b, int n, int k, int col0,
                                            int kbase, int b_col_major, int gran, int tid) {
  using S = Skinny<TIn>;
  const int kread = S::kMma ? (k + 15) & ~15 : 0x7fffffff;
#pragma unroll
  for (int q = tid; q < S::kChunks; q += kSkinnyThreads) {
    if (b_col_major) {  // B^T rows: 8 runs of K for each of the 32 columns
      constexpr int kRuns = kSkinnyRunBytes / 16;
      const int r = q / kRuns, run = q % kRuns;
      const int col = col0 + r, first = kbase + run * S::E;
      if (first >= kread) continue;
      const TIn* row = b + (size_t)(col < n ? col : 0) * k;
      copy_run(slot + r * S::kColPitch + run * 16, row, first, col < n ? k : 0, gran, b);
    } else {  // B rows: the tile's 32 columns of each of BK rows of K
      constexpr int kRuns = kSkinnyBN * (int)sizeof(TIn) / 16;
      const int r = q / kRuns, run = q % kRuns;
      const int kk = kbase + r;
      if (kk >= kread) continue;
      const TIn* row = b + (size_t)(kk < k ? kk : 0) * n;
      copy_run(slot + r * S::kRowPitch + run * 16, row, col0 + run * S::E, kk < k ? n : 0, gran,
               b);
    }
  }
}

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

__device__ __forceinline__ uint32_t lds32(const void* p) {
  return *static_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& r0, uint32_t& r1, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Grid: (column tiles x split, 1, batch), clusters of `split` blocks along x.
// Block x reduces K range [rank * kblk, (rank + 1) * kblk) of column tile
// x / split; a_vec says A's rows are 16-byte aligned; b_gran is the copy
// width B's rows allow.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kSkinnyThreads)
skinny_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b, TOut* __restrict__ c, int m,
              int n, int k, int b_col_major, int split, int kblk, int b_gran, int a_vec) {
  using S = Skinny<TIn>;
  using Acc = typename Elem<TIn>::Acc;
  constexpr bool kMma = S::kMma;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % split;
  const int col0 = (blockIdx.x / split) * kSkinnyBN;
  const size_t z = blockIdx.z;
  a += z * (size_t)m * k;
  b += z * (size_t)k * n;
  c += z * (size_t)m * n;
  const int k0 = rank * kblk;
  const int kend = min(k, k0 + kblk);
  const int nstages = (kend - k0 + S::BK - 1) / S::BK;

  // shared memory: A [m][pitch_a], the ring, the partial tile [m][BN]
  const int pitch_a = kblk + S::E;
  TIn* as = reinterpret_cast<TIn*>(smem);
  const int a_bytes = (m * pitch_a * (int)sizeof(TIn) + 15) / 16 * 16;
  unsigned char* ring = smem + a_bytes;
  Acc* part = reinterpret_cast<Acc*>(ring + kSkinnyStages * S::kStageBytes);
  const unsigned ring_addr = smem_addr(ring);

  // A's copies join the first group; plain loads of A run while B's first
  // stages are in flight.  Columns past K are zeros; the tensor cores read
  // none past the block's K range rounded up to 16.
  const int ka = kMma ? min(kblk, (kend - k0 + 15) & ~15) : kblk;
  if (a_vec) {
    for (int j = tid * S::E; j < ka; j += kSkinnyThreads * S::E) {
      const bool ok = k0 + j < k;
      for (int r = 0; r < m; ++r)
        cp_async<16>(smem_addr(as + r * pitch_a + j), ok ? a + (size_t)r * k + k0 + j : a, ok);
    }
  }
#pragma unroll
  for (int s = 0; s < kSkinnyStages - 1; ++s) {
    if (s < nstages)
      load_stage(ring_addr + s * S::kStageBytes, b, n, k, col0, k0 + s * S::BK, b_col_major,
                  b_gran, tid);
    cp_commit();
  }
  if (!a_vec) {  // a column of A a thread: a batch of rows' loads in flight, then their stores
    // (all 16 rows of bf16 at once, which a decode or prompt step needs; 8 of
    // 4-byte values, which keeps the CUDA-core path's registers from spilling)
    constexpr int kBatch = kMma ? kSkinnyRows : 8;
    for (int j = tid; j < ka; j += kSkinnyThreads) {
      const bool ok = k0 + j < k;
      for (int r0 = 0; r0 < m; r0 += kBatch) {
        TIn v[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          v[u] = ok && r0 + u < m ? a[(size_t)(r0 + u) * k + k0 + j] : zero_of<TIn>();
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
          if (r0 + u < m) as[(r0 + u) * pitch_a + j] = v[u];
      }
    }
  }

  float d[4] = {0.f, 0.f, 0.f, 0.f};  // the tensor-core path's C fragment
  Acc acc[kSkinnyRows];                // the CUDA-core path's column sums
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r) acc[r] = Acc(0);

  for (int s = 0; s < nstages; ++s) {
    cp_wait<kSkinnyStages - 2>();
    __syncthreads();
    const int next = s + kSkinnyStages - 1;
    if (next < nstages)
      load_stage(ring_addr + (next % kSkinnyStages) * S::kStageBytes, b, n, k, col0,
                  k0 + next * S::BK, b_col_major, b_gran, tid);
    cp_commit();
    const unsigned char* slot = ring + (s % kSkinnyStages) * S::kStageBytes;
    const TIn* a_s = as + s * S::BK;
    if constexpr (kMma) {
      const int kn = kend - k0 - s * S::BK;  // rows of K in this stage (above BK: all)
      const int g = lane >> 2, cq = 2 * (lane & 3), l = lane & 15;
      const unsigned slot_addr = smem_addr(slot);
#pragma unroll
      for (int kk = 0; kk < S::BK; kk += 16) {
        if (kk >= kn) break;
        const TIn* lo = a_s + g * pitch_a + kk + cq;
        const TIn* hi = lo + 8 * pitch_a;
        const uint32_t a0 = g < m ? lds32(lo) : 0u;
        const uint32_t a1 = g + 8 < m ? lds32(hi) : 0u;
        const uint32_t a2 = g < m ? lds32(lo + 8) : 0u;
        const uint32_t a3 = g + 8 < m ? lds32(hi + 8) : 0u;
        uint32_t b0, b1;
        if (b_col_major)
          ldmatrix_x2(b0, b1, slot_addr + (warp * 8 + (l & 7)) * S::kColPitch +
                                  (kk + (l >> 3) * 8) * (int)sizeof(TIn));
        else
          ldmatrix_x2_trans(b0, b1,
                            slot_addr + (kk + l) * S::kRowPitch + warp * 8 * (int)sizeof(TIn));
        mma_bf16(d, a0, a1, a2, a3, b0, b1);
      }
    } else {
      const int col = warp * 8 + (lane & 7);
#pragma unroll 4
      for (int kk = lane >> 3; kk < S::BK; kk += 4) {
        const TIn* bp = b_col_major
            ? reinterpret_cast<const TIn*>(slot + col * S::kColPitch) + kk
            : reinterpret_cast<const TIn*>(slot + kk * S::kRowPitch) + col;
        const Acc bv = Elem<TIn>::load(bp);
#pragma unroll
        for (int r = 0; r < kSkinnyRows; ++r)
          if (r < m) acc[r] += Elem<TIn>::load(a_s + r * pitch_a + kk) * bv;
      }
    }
  }
  cp_wait<0>();

  if constexpr (!kMma) {
    // lanes c, c + 8, c + 16, c + 24 hold four quarters of column c's K
#pragma unroll
    for (int r = 0; r < kSkinnyRows; ++r) {
      if (r < m) {
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 8);
        acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], 16);
      }
    }
  }
  if (split == 1) {  // the block holds whole sums: flush them from registers
    if constexpr (kMma) {
      const int g = lane >> 2, col = col0 + warp * 8 + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = g + 8 * h;
        if (r >= m) continue;
        if (col < n) c[(size_t)r * n + col] = Flush<Acc, TOut>::cast(d[2 * h]);
        if (col + 1 < n) c[(size_t)r * n + col + 1] = Flush<Acc, TOut>::cast(d[2 * h + 1]);
      }
    } else {
      const int col = col0 + warp * 8 + lane;
      if (lane < 8 && col < n) {
#pragma unroll
        for (int r = 0; r < kSkinnyRows; ++r)
          if (r < m) c[(size_t)r * n + col] = Flush<Acc, TOut>::cast(acc[r]);
      }
    }
    return;
  }

  // a split: this block's partial tile
  if constexpr (kMma) {
    const int g = lane >> 2, col = warp * 8 + 2 * (lane & 3);
    if (g < m) {
      part[g * kSkinnyBN + col] = d[0];
      part[g * kSkinnyBN + col + 1] = d[1];
    }
    if (g + 8 < m) {
      part[(g + 8) * kSkinnyBN + col] = d[2];
      part[(g + 8) * kSkinnyBN + col + 1] = d[3];
    }
  } else if (lane < 8) {
#pragma unroll
    for (int r = 0; r < kSkinnyRows; ++r)
      if (r < m) part[r * kSkinnyBN + warp * 8 + lane] = acc[r];
  }

  // the cluster's partial tiles, each output summed over the ranks in order;
  // the ranks share the outputs out between them
  const int outputs = m * kSkinnyBN;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = tid + rank * kSkinnyThreads; e < outputs; e += kSkinnyThreads * split) {
    const int col = col0 + e % kSkinnyBN;
    if (col >= n) continue;
    Acc sum = *cluster.map_shared_rank(part + e, 0);
    for (int q = 1; q < split; ++q) sum += *cluster.map_shared_rank(part + e, q);
    c[(size_t)(e / kSkinnyBN) * n + col] = Flush<Acc, TOut>::cast(sum);
  }
  cluster.sync();  // keep every partial tile alive until all are read
}

struct SkinnyArgs {
  const void* a;
  const void* b;
  void* c;
  int batch, m, n, k, b_col_major, split, kblk, b_gran, a_vec;
  cudaStream_t stream;
};

template <typename TIn, typename TOut>
int launch_skinny_typed(const SkinnyArgs& x) {
  using S = Skinny<TIn>;
  using Acc = typename Elem<TIn>::Acc;
  auto kernel = skinny_kernel<TIn, TOut>;
  if (x.m < 1 || x.m > kSkinnyRows || x.split < 1 || x.split > kSkinnyMaxCluster ||
      x.kblk < S::BK || x.kblk % S::BK != 0 || (long long)x.split * x.kblk < x.k ||
      (long long)(x.split - 1) * x.kblk >= x.k ||
      (x.b_gran != 16 && x.b_gran != 8 && x.b_gran != 4))
    return (int)cudaErrorInvalidValue;
  const int pitch_a = x.kblk + S::E;
  const size_t smem = (size_t)(x.m * pitch_a * (int)sizeof(TIn) + 15) / 16 * 16 +
                      (size_t)kSkinnyStages * S::kStageBytes +
                      (size_t)kSkinnyRows * kSkinnyBN * sizeof(Acc);
  const long long tiles = (x.n + kSkinnyBN - 1) / kSkinnyBN;
  if (smem > (size_t)kSkinnyMaxSmem || tiles * x.split > 0x7fffffffLL || x.batch > 65535)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {  // dynamic shared memory above 48 KB is opt-in, per device
    const cudaError_t allowed =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (allowed != cudaSuccess) return (int)allowed;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * x.split), 1, (unsigned)x.batch);
  cfg.blockDim = dim3(kSkinnyThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = x.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)x.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = x.split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TIn*>(x.a), static_cast<const TIn*>(x.b),
      static_cast<TOut*>(x.c), x.m, x.n, x.k, x.b_col_major, x.split, x.kblk, x.b_gran, x.a_vec);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

int launch_skinny(int in_dtype, int out_dtype, const SkinnyArgs& x) {
  if (in_dtype == F32 && out_dtype == F32) return launch_skinny_typed<float, float>(x);
  if (in_dtype == BF16 && out_dtype == BF16)
    return launch_skinny_typed<__nv_bfloat16, __nv_bfloat16>(x);
  if (in_dtype == BF16 && out_dtype == F32) return launch_skinny_typed<__nv_bfloat16, float>(x);
  if (in_dtype == I8 && out_dtype == I32) return launch_skinny_typed<int8_t, int32_t>(x);
  if (in_dtype == I16 && out_dtype == I32) return launch_skinny_typed<int16_t, int32_t>(x);
  if (in_dtype == I32 && out_dtype == I32) return launch_skinny_typed<int32_t, int32_t>(x);
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

// C[z] = A[z] @ B[z] for z < batch and M <= 16 on skinny_kernel (mm is
// batch = 1): K split over `split` blocks of a cluster, `kblk` each; B copied
// in runs of b_gran bytes (16, 8 or 4); A by cp.async when a_vec.  Returns a
// cudaError_t.
int widesa_skinny_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                         int b_col_major, int in_dtype, int out_dtype, int split, int kblk,
                         int b_gran, int a_vec, void* stream) {
  const SkinnyArgs x{a, b, c, batch, m, n, k, b_col_major, split, kblk, b_gran, a_vec,
                     static_cast<cudaStream_t>(stream)};
  return launch_skinny(in_dtype, out_dtype, x);
}

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
