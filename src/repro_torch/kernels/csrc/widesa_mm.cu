// Hand-written Hopper (sm_90a) GEMMs for the WideSA mm and bmm recurrences.
//
// Replaces two Pallas TPU kernels of the reference package:
//   * src/repro/kernels/widesa_mm.py:92  mm_kernel   (C[m,n] = A[m,k] @ B[k,n])
//   * src/repro/kernels/bmm.py:74        bmm_kernel  (C[b]   = A[b]   @ B[b])
// Both become one family with a batch grid dimension; mm is the batch = 1
// launch.  Four kernels serve it: skinny_kernel for A of at most 16 rows at
// any K (every decode GEMM, short prompts, products over long contexts),
// gemm_tc_kernel for A of more rows in bf16 and float32 (prefill of real
// prompt lengths, the backward passes, the recurrence path's float GEMMs),
// its ring filled by TMA or, for an operand TMA cannot address, by cp.async,
// gemm_tc_int_kernel for A of more rows in int8, int16 and int32 (the
// recurrence path's integer GEMMs, the paper's MM/BMM table), and
// gemm_kernel (tiled) for the two cases the others cannot take: rows of B
// (or, above 16 rows, of A) that allow no 4-byte copy (an odd row of 2-byte
// elements, a storage offset of one element), and an integer K longer than
// 8 ranks' accumulator sets admit.
//
// Translation.  On the TPU the grid (b, i, j, k) runs in order on one core
// and the k dimension ("arbitrary") carries an fp32/int32 accumulator in VMEM
// scratch between grid steps.  Here blocks run in parallel in no order, so
// the k loop moves inside the block (or, split, into a cluster of blocks that
// reduce in a fixed order), accumulates in registers (fp32 for float inputs,
// 32-bit for integers) and flushes once to the output dtype.  The kernels
// mask the ragged edges of every dimension themselves, so the wrapper makes
// no padding copies (the reference's ops.matmul / ops.bmm pad operands to the
// plan tiles).
//
// skinny_kernel: M <= 16.  Every decode GEMM has M <= 16 (a decode batch, an
// 8-frame audio chunk, one GQA query row), as has the prefill of a prompt of
// at most 16 tokens, so each is bound by the bytes of B: 2 FLOP per element of B against the
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
//     Three stages are in flight per block while the oldest is consumed;
//     four blocks share an SM where B is row-major and the grid takes more
//     than one wave (kSkinnySmemFloor), as many as fit (seven in bf16)
//     otherwise.  A streams through the same ring: a stage carries A's m
//     rows of the same 128 bytes of K (at most 2 KB) beside B's 4 KB, by
//     cp.async at the width A's rows allow (16, 8 or 4 bytes) and by plain
//     loads where they allow none, so no K is too long (qwen3-32b's down
//     projection of a 16-token prompt, K = 25600; decode products over half
//     a million keys).
//   * Arithmetic that keeps up.  At M = 16 bf16 needs 8 FMAs per byte of B,
//     near the CUDA cores' fp32 peak, so bf16 runs on the tensor cores:
//     mma.sync.m16n8k16 with fp32 accumulation, A's missing rows read as
//     zeros, B fragments by ldmatrix (.trans for a row-major B).  The
//     tensor cores' accumulator adds with less precision than fp32 does,
//     which a long K shows where an output cancels (qwen3-32b's down
//     projection, K = 25600), so each stage's products (64 of K) start
//     from a zero fragment and are added to the sums in fp32.  Shared
//     memory rows carry 16 bytes of padding, so neither ldmatrix nor the A
//     fragment loads conflict on banks.  wgmma needs 64-row tiles and would
//     waste 75-98 % of them here.  float32 stays IEEE FMA on the CUDA cores
//     (TF32 misses the registry's atol 1e-3), and integers stay on the CUDA
//     cores in unsigned 32-bit arithmetic: each lane owns one column and a
//     quarter of each stage's K, and the four quarters are added by warp
//     shuffles in a fixed order.
//
// gemm_tc_kernel: A of more than 16 rows.  A prompt of P tokens makes 9
// GEMMs a layer of qwen1.5-0.5b with M = P (q/k/v/o [P,1024]x[1024,1024],
// gate/up [P,1024]x[1024,2816], down [P,2816]x[2816,1024], the scores and the
// values, 16 heads of [P,64]x[64,P] and [P,P]x[P,64]).  At P = 512 a weight
// GEMM does 1.1-3.0 GFLOP over 4-10 MB: 1.1-3.0 us at 989 TFLOP/s bf16 and
// 1.25-2.9 us at 3.35 TB/s, so both bounds are near, and only the tensor
// cores fed from shared memory at the rate wgmma reads it come close (the
// CUDA cores' fp32 FMA peak is 15x lower).  What holds these shapes back on
// an H100 is the grid: 128 x 128 output tiles give 32-88 blocks for 132 SMs,
// and a block then pulls 0.4-1.4 MB of tiles through its own SM's L2 port,
// which takes longer than its products.  The design:
//   * wgmma.  Two consumer warpgroups each own 64 rows of a 128 x BN tile
//     and run m64nBNk16 with fp32 accumulators, both operands from shared
//     memory: A K-major, B K-major when it is the transpose of a row-major
//     tensor (the tied lm_head, the attention scores' keys) and MN-major
//     (the "transposed" descriptor, which 16-bit types allow) when it is
//     row-major (weights, the attention values).
//   * TMA.  A producer thread keeps a ring of up to 4 stages filled with
//     cp.async.bulk.tensor copies, each stage one 128-byte row of K (64 bf16)
//     for every row of A's and B's tiles, completing on an mbarrier; the
//     consumers release a stage through a second mbarrier once the products
//     that read it are done (one wgmma group stays in flight).  The tensor
//     maps are 3-D (the batch is the grid's z) with the 128-byte swizzle the
//     descriptors name, and TMA zero-fills past M, N and K, so ragged edges
//     need no padding copies.  The maps are encoded on the host at each
//     launch (cuTensorMapEncodeTiled, looked up at run time through the
//     runtime's entry-point query, so the library links the CUDA runtime
//     alone).  TMA needs a 16-byte aligned base, pitch and batch stride; an
//     operand without (the bf16 cotangent of whisper's encoder scores,
//     rows of 1500 keys: 3000 bytes) the two producer warps' 64 threads
//     copy instead by cp.async, 8 or 4 bytes a copy as its rows allow, each
//     copy written where TMA's swizzle would put it and zero-filled past M,
//     N and K, completing on the same mbarrier (cp.async.mbarrier.arrive
//     .noinc); the consumers then order those generic-proxy writes before
//     wgmma's reads with a proxy fence.  The other operand keeps TMA.
//   * The grid.  runtime.tc_tile takes BN = 64 but for wide N (gate/up) and
//     splits K over the blocks of a cluster (at most 4) while the grid stays
//     within one block an SM: more blocks, each with fewer bytes to pull.
//     Each block leaves its fp32 partial tile in shared memory (the ring,
//     once consumed); each rank sums its share of the rows over the cluster
//     in rank order through distributed shared memory (the same bits on
//     every run) and stores them 16 bytes at a time.  Unsplit, the same
//     staging makes the stores coalesced (the fp32 attention scores are
//     bound by them).
//   * float32 as 3xTF32, as the tensor-core MTTKRP (widesa_hpc.cu): lo*hi +
//     hi*lo + hi*hi, the small terms first, fp32 accumulation: each stage's
//     products go to a fresh accumulator that is added to the sums on the
//     CUDA cores (round to nearest) once the stage is done: the tensor
//     cores' additions to a large accumulator lose more than fp32 rounding
//     (one accumulator over the 384 products of K = 1024, sums near 100,
//     erred 1.0e-3 on an H100, a fresh one a stage 2.6e-4; bf16 with a
//     float32 output does the same).  TF32 wgmma reads only
//     K-major operands from shared memory, and a row-major B is MN-major, so
//     the kernel computes C^T = B^T A^T: B's tile is the register operand
//     (the warps load it in fragment order from the swizzled stage and split
//     each value as hi = rna_tf32(x), lo = x - hi), A's tile the
//     shared-memory operand, K-major in both layouts of B.  The tensor cores
//     read A's tile itself as trunc_tf32(x); the consumers write lo = x -
//     trunc_tf32(x) (exact) beside it once a stage.  A product keeps about
//     2^-19 |a b| of error (2^-20 from lo of A read truncated, 2^-21 each
//     from lo of B read truncated and from the dropped lo*lo), against 2^-11
//     for one TF32 product, which the registry's atol 1e-3 rejects at K =
//     1024.  Each warpgroup owns 64 columns of C (BN = 128) and BM = 64 or
//     128 rows (m64nBMk8).
//
// gemm_tc_int_kernel: A of more than 16 rows in int8, int16 and int32, the
// paper's MM/BMM table (mm 10240^3 int8, 9600^3 int16, 8192^3 int32; bmm 64
// x 4096^3).  Operations bound it: 2 M N K int8 products at 1979 TOP/s
// (10240^3: 1.09 ms), and int16 and int32 are 4 and 10 of them.  The design:
//   * Limbs.  A value is sum_p 2^(8p) x_p over 1, 2 or 4 int8 limbs, the top
//     one signed (.s8) and the others unsigned (.u8), as in the tensor-core
//     MTTKRP (widesa_hpc.cu); C = sum_{p+q<=3} 2^(8(p+q)) A_p B_q modulo
//     2^32 (a pair of shift 32 or more vanishes): 1, 4 and 10 wgmma products
//     of m64nBNk32 .s32 with the .s8/.u8 types of their limbs, the products
//     of one shift into one s32 accumulator set (1, 3 and 4 sets), folded
//     into uint32 once the block's K is done.  The launcher admits only a K
//     a rank at which no set can leave int32 (kTc*MaxRankK), so no result
//     depends on how wgmma overflows, and the split's partial tiles are
//     added in uint32, where wrapping is exact in any order.
//   * Operands.  8-bit wgmma reads only K-major operands from shared memory,
//     and TMA cannot cut a byte out of a wider value, so a pre-pass kernel
//     (limb_planes_kernel, one launch for both operands, on the same
//     stream; its device time is part of the GEMM's) writes each operand
//     that is not an int8 K-major one as K-major byte rows: each 128-byte
//     k-tile of a row holds 128 / limbs values of K as one plane of bytes a
//     limb.  An int8 A and an int8 column-major B (the tied lm_head layout)
//     are read as they are; a row-major int8 B is transposed (one pass, 2 N
//     K bytes against the M N K products).  This was taken over a
//     transposed product with B's tile as the register operand (float32's
//     route) because the pre-pass also serves the limbs, leaves both
//     operands to TMA and wgmma from shared memory, and costs a few percent
//     of the products' time at the paper's shapes (its launch costs more
//     than that at the pipeline's smoke shapes; PERF.md).
//   * The rest is gemm_tc_kernel's: a producer thread keeps a 4-stage TMA ring
//     full (k-tiles of 128 bytes, 128-byte swizzle, zero fill past M, N and
//     K), two consumer warpgroups of 64 rows, K split over a cluster whose
//     partial tiles meet in shared memory; unsplit, the consumers store C
//     from registers.  Tiles: 128 x 64 or 128 x 256 in int8 (one set: 32 or
//     128 registers a thread), 128 x 64 in int16 and int32 (3 and 4 sets: 96
//     and 128; int16 at 128 x 128, 192 registers of sets, spilled).  The
//     grid walks its tiles in groups of 16 row tiles, down a group's rows
//     before its next column, so that a wave of blocks reuses A through the
//     L2 (10240^2 int8 is twice the L2).
// An operand TMA cannot address (a base, pitch or batch stride not 16-byte
// aligned: int8 rows of 72 bytes) goes through the pre-pass too, which
// reads it a value at a time and writes planes TMA addresses.
//
// gemm_kernel is the first, simple tiled kernel: scalar loads staged through
// shared memory, no tensor cores.  It keeps two cases: a B (or, above 16
// rows, an A a caller did not pad) whose rows allow no 4-byte copy, and an
// integer K past 8 ranks of kTc*MaxRankK; and it stays as the tile sweep's
// subject.
//
// Arithmetic.  Float inputs accumulate in fp32 (full IEEE FMA on the CUDA
// cores; fp32 accumulation on the tensor cores for bf16); bf16 operands widen
// exactly to fp32 and the result rounds once (round-to-nearest-even) to the
// output dtype.  Integer inputs (int8, int16, int32) sign-extend to 32 bits
// and accumulate in *unsigned* 32-bit arithmetic: products and sums wrap
// modulo 2^32 with defined behaviour, which is bit-exact with XLA's int32
// wraparound in any order.
//
// Layouts.  A is row-major [batch, M, K] with rows lda >= K elements apart
// (the attention values' softmax weights come in rows padded to whole
// 16-byte units, so that TMA addresses them at any key count); C is
// row-major [batch, M, N]; B is row-major [batch, K, N] or, with
// b_col_major, the transpose of a row-major [batch, N, K] (the tied lm_head
// reads the embedding table as its B, the attention scores read K so), its
// rows (of N, or of K) ldb >= N (or K) elements apart and its batch
// entries sb elements apart: a slice of a wider B's columns or rows (the
// groups of a hierarchical plan's column and row splits) is read in place.

#include <cooperative_groups.h>
#include <cuda.h>
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
            TOut* __restrict__ c, int m, int n, int k, int lda, int b_col_major,
            int ldb, long long sb) {
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
  a += z * (size_t)m * lda;
  b += z * (size_t)sb;
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
      As[kk][r] = (gr < m && gk < k) ? Elem<TIn>::load(a + (size_t)gr * lda + gk) : Acc(0);
    }
    // B slice [BK, BN]: consecutive threads follow the unit-stride dimension
    if (b_col_major) {
      for (int e = tid; e < BK * BN; e += NT) {
        const int col = e / BK, kk = e % BK;
        const int gc = col0 + col, gk = k0 + kk;
        Bs[kk][col] = (gc < n && gk < k) ? Elem<TIn>::load(b + (size_t)gc * ldb + gk) : Acc(0);
      }
    } else {
      for (int e = tid; e < BK * BN; e += NT) {
        const int kk = e / BN, col = e % BN;
        const int gc = col0 + col, gk = k0 + kk;
        Bs[kk][col] = (gc < n && gk < k) ? Elem<TIn>::load(b + (size_t)gk * ldb + gc) : Acc(0);
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
  int batch, m, n, k, lda, b_col_major, ldb;
  long long sb;
  cudaStream_t stream;
};

template <typename TIn, typename TOut, int BM, int BN, int BK>
int launch_tile(const Args& x) {
  const dim3 grid((x.m + BM - 1) / BM, (x.n + BN - 1) / BN, x.batch);
  gemm_kernel<TIn, TOut, BM, BN, BK><<<grid, Geometry<BM, BN>::kThreads, 0, x.stream>>>(
      static_cast<const TIn*>(x.a), static_cast<const TIn*>(x.b), static_cast<TOut*>(x.c),
      x.m, x.n, x.k, x.lda, x.b_col_major, x.ldb, x.sb);
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
  if (x.lda < x.k || x.ldb < (x.b_col_major ? x.k : x.n) || x.sb < 0)
    return (int)cudaErrorInvalidValue;
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
constexpr int kSkinnyStages = 4;      // depth of the ring (A and B)
constexpr int kSkinnyRunBytes = 128;  // bytes of K a stage holds (BK * sizeof)
constexpr int kSkinnyMaxCluster = 8;  // the portable cluster size
constexpr int kSkinnyPad = 16;        // bytes padding each shared-memory row
constexpr int kSkinnyMaxSmem = 232448;
// The least shared memory a block takes where B is row-major and the grid
// is more than one wave at the block's own size: the SM's 233472 bytes
// over four blocks, less the 1 KB each reserves, so that at most four
// blocks share an SM.  A block needs ~30 KB (its ring and partial tile),
// and seven would fit; on an H100 seven blocks an SM ran a row-major B,
// read 64 bytes a row, slower than four where the grid takes waves anyway
// (the untied heads, 4748 blocks, and the expert stack at decode).  A grid
// that one wave of seven holds keeps it (deepseek's q_up, 768 blocks, would
// take a second wave at four); so does a column-major B, read 128 bytes a
// column of K (the tied lm_head), which ran faster at seven.
constexpr int kSkinnySmemFloor = 233472 / 4 - 1024;

template <typename TIn> struct Skinny {
  static constexpr int BK = kSkinnyRunBytes / (int)sizeof(TIn);
  static constexpr int E = 16 / (int)sizeof(TIn);  // elements of a 16-byte run
  // a stage: A's rows, then B's tile.  A: kSkinnyRows rows of BK (one
  // 128-byte run of K each); B row-major: BK rows of BN columns; B
  // column-major: BN rows (columns of B) of BK; every row padded by
  // kSkinnyPad bytes
  static constexpr int kRowPitch = kSkinnyBN * (int)sizeof(TIn) + kSkinnyPad;
  static constexpr int kColPitch = kSkinnyRunBytes + kSkinnyPad;
  static constexpr int kAPitch = kColPitch / (int)sizeof(TIn);  // elements between A's rows
  static constexpr int kABytes = kSkinnyRows * kColPitch;
  static constexpr int kBBytes =
      BK * kRowPitch > kSkinnyBN * kColPitch ? BK * kRowPitch : kSkinnyBN * kColPitch;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kChunks = kSkinnyBN * kSkinnyRunBytes / 16;  // 16-byte runs of B a stage
  static_assert(kChunks % kSkinnyThreads == 0, "a stage does not split over the block");
  // A's values a thread loads a stage where its rows allow no 4-byte copy
  static constexpr int kAPlain = kSkinnyRows * BK / kSkinnyThreads;
  static constexpr bool kMma = std::is_same<TIn, __nv_bfloat16>::value;  // tensor cores
  static_assert(kABytes % 16 == 0 && kStageBytes % 16 == 0, "stages must stay 16-byte aligned");
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
// tile of B into the ring slot at shared address `slot` (B's part of it);
// rows of K at or past K land as zeros.  The tensor cores read no row past
// K rounded up to 16 (the depth of one product), so those rows are not
// copied; the CUDA-core path reads whole stages.
template <typename TIn>
__device__ __forceinline__ void load_stage(unsigned slot, const TIn* b, int n, int k, int ldb,
                                            int col0, int kbase, int b_col_major, int gran,
                                            int tid) {
  using S = Skinny<TIn>;
  const int kread = S::kMma ? (k + 15) & ~15 : 0x7fffffff;
  slot += S::kABytes;
#pragma unroll
  for (int q = tid; q < S::kChunks; q += kSkinnyThreads) {
    if (b_col_major) {  // B^T rows: 8 runs of K for each of the 32 columns
      constexpr int kRuns = kSkinnyRunBytes / 16;
      const int r = q / kRuns, run = q % kRuns;
      const int col = col0 + r, first = kbase + run * S::E;
      if (first >= kread) continue;
      const TIn* row = b + (size_t)(col < n ? col : 0) * ldb;
      copy_run(slot + r * S::kColPitch + run * 16, row, first, col < n ? k : 0, gran, b);
    } else {  // B rows: the tile's 32 columns of each of BK rows of K
      constexpr int kRuns = kSkinnyBN * (int)sizeof(TIn) / 16;
      const int r = q / kRuns, run = q % kRuns;
      const int kk = kbase + r;
      if (kk >= kread) continue;
      const TIn* row = b + (size_t)(kk < k ? kk : 0) * ldb;
      copy_run(slot + r * S::kRowPitch + run * 16, row, col0 + run * S::E, kk < k ? n : 0, gran,
               b);
    }
  }
}

template <typename T> __device__ __forceinline__ T zero_of() { return T(0); }
template <> __device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.f);
}

// Load A's m rows of stage `kbase` into the slot at `slot` (A's part of it,
// rows kAPitch elements apart): by cp.async in runs of a_gran bytes (16, 8
// or 4) where A's rows allow it, else (a_gran 0) by plain loads, all of a
// thread's issued before any is stored.  Columns at or past K land as
// zeros; as for B, the tensor cores read none past K rounded up to 16.
template <typename TIn>
__device__ __forceinline__ void load_a_stage(unsigned slot, TIn* as, const TIn* a, int m, int k,
                                              int lda, int kbase, int a_gran, int tid) {
  using S = Skinny<TIn>;
  const int kread = S::kMma ? (k + 15) & ~15 : 0x7fffffff;
  if (a_gran) {
    constexpr int kRuns = kSkinnyRunBytes / 16;  // 16-byte runs of a row a stage
    for (int q = tid; q < m * kRuns; q += kSkinnyThreads) {
      const int r = q / kRuns, first = kbase + q % kRuns * S::E;
      if (first >= kread) continue;
      copy_run(slot + r * S::kColPitch + q % kRuns * 16, a + (size_t)r * lda, first, k, a_gran,
               a);
    }
    return;
  }
  TIn v[S::kAPlain];
#pragma unroll
  for (int u = 0; u < S::kAPlain; ++u) {
    const int e = tid + u * kSkinnyThreads, r = e / S::BK, kk = kbase + e % S::BK;
    v[u] = r < m && kk < k ? a[(size_t)r * lda + kk] : zero_of<TIn>();
  }
#pragma unroll
  for (int u = 0; u < S::kAPlain; ++u) {
    const int e = tid + u * kSkinnyThreads;
    if (e / S::BK < m) as[e / S::BK * S::kAPitch + e % S::BK] = v[u];
  }
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
// x / split; a_gran and b_gran are the copy widths A's and B's rows allow
// (a_gran 0: plain loads of A).
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kSkinnyThreads)
skinny_kernel(const TIn* __restrict__ a, const TIn* __restrict__ b, TOut* __restrict__ c, int m,
              int n, int k, int lda, int b_col_major, int ldb, long long sb, int split,
              int kblk, int b_gran, int a_gran) {
  using S = Skinny<TIn>;
  using Acc = typename Elem<TIn>::Acc;
  constexpr bool kMma = S::kMma;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x % split;
  const int col0 = (blockIdx.x / split) * kSkinnyBN;
  const size_t z = blockIdx.z;
  a += z * (size_t)m * lda;
  b += z * (size_t)sb;
  c += z * (size_t)m * n;
  const int k0 = rank * kblk;
  const int kend = min(k, k0 + kblk);
  const int nstages = (kend - k0 + S::BK - 1) / S::BK;

  // shared memory: the ring (each stage A's rows, then B's tile), the
  // partial tile [m][BN]
  unsigned char* ring = smem;
  Acc* part = reinterpret_cast<Acc*>(ring + kSkinnyStages * S::kStageBytes);
  const unsigned ring_addr = smem_addr(ring);
  auto load = [&](int s) {  // stage s of this block's K range into its slot
    const int slot = (s % kSkinnyStages) * S::kStageBytes;
    load_stage(ring_addr + slot, b, n, k, ldb, col0, k0 + s * S::BK, b_col_major, b_gran, tid);
    load_a_stage(ring_addr + slot, reinterpret_cast<TIn*>(ring + slot), a, m, k, lda,
                 k0 + s * S::BK, a_gran, tid);
  };

#pragma unroll
  for (int s = 0; s < kSkinnyStages - 1; ++s) {
    if (s < nstages) load(s);
    cp_commit();
  }

  float d[4] = {0.f, 0.f, 0.f, 0.f};  // the tensor-core path's sums (fp32 adds)
  Acc acc[kSkinnyRows];                // the CUDA-core path's column sums
#pragma unroll
  for (int r = 0; r < kSkinnyRows; ++r) acc[r] = Acc(0);

  for (int s = 0; s < nstages; ++s) {
    cp_wait<kSkinnyStages - 2>();
    __syncthreads();
    const int next = s + kSkinnyStages - 1;
    if (next < nstages) load(next);
    cp_commit();
    const unsigned char* slot = ring + (s % kSkinnyStages) * S::kStageBytes;
    const TIn* a_s = reinterpret_cast<const TIn*>(slot);
    slot += S::kABytes;  // B's tile
    if constexpr (kMma) {
      const int kn = kend - k0 - s * S::BK;  // rows of K in this stage (above BK: all)
      const int g = lane >> 2, cq = 2 * (lane & 3), l = lane & 15;
      const unsigned slot_addr = smem_addr(slot);
      float t[4] = {0.f, 0.f, 0.f, 0.f};  // this stage's products: the C fragment
#pragma unroll
      for (int kk = 0; kk < S::BK; kk += 16) {
        if (kk >= kn) break;
        const TIn* lo = a_s + g * S::kAPitch + kk + cq;
        const TIn* hi = lo + 8 * S::kAPitch;
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
        mma_bf16(t, a0, a1, a2, a3, b0, b1);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) d[i] += t[i];
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
          if (r < m) acc[r] += Elem<TIn>::load(a_s + r * S::kAPitch + kk) * bv;
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
  int batch, m, n, k, lda, b_col_major, ldb;
  long long sb;
  int split, kblk, b_gran, a_gran;
  cudaStream_t stream;
};

template <typename TIn, typename TOut>
int launch_skinny_typed(const SkinnyArgs& x) {
  using S = Skinny<TIn>;
  using Acc = typename Elem<TIn>::Acc;
  auto kernel = skinny_kernel<TIn, TOut>;
  if (x.m < 1 || x.m > kSkinnyRows || x.split < 1 || x.split > kSkinnyMaxCluster ||
      x.lda < x.k || x.ldb < (x.b_col_major ? x.k : x.n) || x.sb < 0 || x.kblk < S::BK ||
      x.kblk % S::BK != 0 || (long long)x.split * x.kblk < x.k ||
      (long long)(x.split - 1) * x.kblk >= x.k ||
      (x.b_gran != 16 && x.b_gran != 8 && x.b_gran != 4) ||
      (x.a_gran != 16 && x.a_gran != 8 && x.a_gran != 4 && x.a_gran != 0) ||
      (x.a_gran && (reinterpret_cast<uintptr_t>(x.a) % x.a_gran != 0 ||
                    (long long)x.lda * (int)sizeof(TIn) % x.a_gran != 0 ||
                    (long long)x.k * (int)sizeof(TIn) % x.a_gran != 0)))
    return (int)cudaErrorInvalidValue;
  const size_t need = (size_t)kSkinnyStages * S::kStageBytes +
                      (size_t)kSkinnyRows * kSkinnyBN * sizeof(Acc);
  const long long tiles = (x.n + kSkinnyBN - 1) / kSkinnyBN;
  if (need > (size_t)kSkinnyMaxSmem || tiles * x.split > 0x7fffffffLL || x.batch > 65535)
    return (int)cudaErrorInvalidValue;
  // dynamic shared memory above 48 KB is opt-in; then the blocks one wave
  // holds at `need` bytes a block: both once a device
  static long long wave[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  long long fit = device < 64 ? wave[device] : 0;
  if (!fit) {
    int sms = 0, per_sm = 0;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kSkinnyMaxSmem)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
            cudaSuccess ||
        (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kSkinnyThreads,
                                                             need)) != cudaSuccess)
      return (int)err;
    fit = (long long)sms * per_sm;
    if (device < 64) wave[device] = fit;
  }
  const bool waves = !x.b_col_major && tiles * x.split * x.batch > fit;
  const size_t smem = waves && need < (size_t)kSkinnySmemFloor ? (size_t)kSkinnySmemFloor : need;

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
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const TIn*>(x.a), static_cast<const TIn*>(x.b),
      static_cast<TOut*>(x.c), x.m, x.n, x.k, x.lda, x.b_col_major, x.ldb, x.sb, x.split,
      x.kblk, x.b_gran, x.a_gran);
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


// ---------------------------------------------------------------------------
// gemm_tc_kernel: M > 16 in bf16 and float32 on wgmma, operands by TMA (see
// the note at the top)
// ---------------------------------------------------------------------------

// kept equal to the TC_* constants of repro_torch/kernels/runtime.py
constexpr int kTcConsumers = 256;                    // two consumer warpgroups
constexpr int kTcProducers = 64;  // two producer warps (gemm_tc_kernel's note says why)
constexpr int kTcThreads = kTcConsumers + kTcProducers;
constexpr int kTcRowBytes = 128;                     // bytes of K a stage holds: one swizzle row
constexpr int kTcMaxStages = 4;                      // depth of the ring at most
constexpr int kTcMaxCluster = 8;                     // the portable cluster size
constexpr int kTcMaxSmem = 232448;
constexpr int kTcAlign = 1024;                       // a 128-byte swizzle pattern repeats each 1 KB

// Geometry of a BM x BN output tile.  bf16: each consumer warpgroup owns 64
// rows of C (BM = 128) and runs m64nBNk16.  float32 runs the transposed
// product C^T = B^T A^T: each warpgroup owns 64 columns of C (BN = 128),
// B's tile is its register operand and A's tile its shared-memory operand,
// m64nBMk8 on TF32 (TF32 wgmma reads only K-major operands from shared
// memory, and A's rows are K-major in either layout of B).
template <typename TIn, int BM, int BN> struct Tc {
  static constexpr bool kF32 = std::is_same<TIn, float>::value;
  static constexpr int kElems = kTcRowBytes / (int)sizeof(TIn);  // K a stage: 64 bf16, 32 fp32
  static constexpr int kABytes = BM * kTcRowBytes;
  static constexpr int kBBytes = BN * kTcRowBytes;
  // a stage: A's tile, B's tile and (float32) the low parts of A's tile
  static constexpr int kStageBytes = kABytes + kBBytes + (kF32 ? kABytes : 0);
  static constexpr int kAcc = (kF32 ? BM : BN) / 2;   // accumulators a thread
  static constexpr int kPartBytes = BM * (BN + 4) * 4;  // the fp32 partial tile, padded rows
  static_assert(kF32 ? BN == 128 && (BM == 64 || BM == 128) : BM == 128 && (BN == 64 || BN == 128),
                "not a compiled tile");
  static_assert(kStageBytes % kTcAlign == 0 && kABytes % kTcAlign == 0 && kBBytes % kTcAlign == 0,
                "tiles must keep the 1 KB alignment of the swizzle");
};

// Shared memory of a block: the ring (or the partial tile, which reuses it,
// if larger), the 1 KB the swizzle's alignment may cost, the barriers.
__host__ __device__ constexpr size_t tc_smem(int stage_bytes, int stages, int part_bytes) {
  return (size_t)(stage_bytes * stages > part_bytes ? stage_bytes * stages : part_bytes) +
         kTcAlign + 2 * kTcMaxStages * sizeof(uint64_t);
}

// The descriptor of a shared-memory operand in the 128-byte swizzled layout
// TMA writes (rows of 128 bytes, 16-byte chunks XORed with the row mod 8):
// `lbo` bytes between 64-element column blocks of an MN-major operand
// (ignored for a K-major one), `sbo` bytes between groups of 8 rows.
__device__ __forceinline__ uint64_t sw128_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers that a wgmma in
// flight reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(unsigned bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}
// Wait for the phase of `parity` to complete.  A phase that has not
// completed after ~2^32 cycles (over 2 s; a stage takes microseconds) is a
// fault of the kernel: trap, so that the launch fails instead of hanging.
__device__ __forceinline__ void mbar_wait(unsigned bar, int parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - start > (1ll << 32)) __trap();
}

// One TMA copy of the box at coordinates (x, y, z) of `map` into shared
// memory at `dst`, completing on the barrier `bar`; out-of-bounds elements
// land as zeros.
__device__ __forceinline__ void tma_load(unsigned dst, const CUtensorMap* map, unsigned bar, int x,
                                         int y, int z) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x), "r"(y), "r"(z)
      : "memory");
}

// The arrival of this thread on the barrier `bar` once every cp.async it
// has issued is complete; the barrier's count includes it (noinc).
__device__ __forceinline__ void cp_arrive_noinc(unsigned bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// One stage of an operand TMA cannot address, copied by the producer
// threads (pt of kTcProducers) in cp.async copies of W bytes (8 or 4) into
// the 128-byte swizzled layout TMA would write at shared address `dst` (1
// KB aligned): `rows` rows of 128 bytes, row r's 16-byte chunk c at chunk
// c ^ (r & 7).  K-major (!MN: A, or B^T): row r holds 128 bytes of K from
// column i0 of the operand's row o0 + r.  MN-major (MN: a row-major B):
// boxes of E columns x E rows of K, row r holding columns i0 + r / E x E..
// of K's row o0 + r % E.  Rows at or past `olim` and columns at or past
// `ilim` land as zeros (src-size 0); a copy never straddles `ilim` (the
// wrapper's copy width keeps the row's length, its pitch and its base
// aligned).  A thread keeps one copy's place in a row and walks the rows
// kTcProducers / P apart.
template <int W, bool MN, typename T>
__device__ __forceinline__ void cp_stage(unsigned dst, const T* src, int rows, long long ld,
                                         int olim, int ilim, int o0, int i0, int pt) {
  constexpr int P = kTcRowBytes / W;     // copies a row
  constexpr int V = W / (int)sizeof(T);  // elements a copy
  constexpr int E = kTcRowBytes / (int)sizeof(T);
  static_assert(kTcProducers % P == 0, "a copy's place in a row must stay a thread's");
  const int p = pt % P, chunk = p * W >> 4, low = p * W & 15;
#pragma unroll 4
  for (int r = pt / P; r < rows; r += kTcProducers / P) {
    const int o = MN ? o0 + r % E : o0 + r;
    const int i = (MN ? i0 + r / E * E : i0) + p * V;
    const bool ok = o < olim && i < ilim;
    cp_async<W>(dst + r * kTcRowBytes + ((chunk ^ (r & 7)) << 4 | low),
                ok ? src + o * ld + i : src, ok);
  }
}

// D (64 x 64 fp32, 32 values a thread) += A (64 x 16 bf16 at desc a) * B (16 x 64 bf16
// at desc b), B MN-major when TRANS_B; D = A * B when !accumulate.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D (64 x 128 fp32, 64 values a thread) += A (64 x 16 bf16 at desc a) * B (16 x 128 bf16
// at desc b), B MN-major when TRANS_B; D = A * B when !accumulate.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D (64 x 64 fp32, 32 values a thread) += A (64 x 8 TF32, this warp's 16 rows in
// registers) * B (8 x 64 TF32, K-major at desc b); D = A * B when !accumulate.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D (64 x 128 fp32, 64 values a thread) += A (64 x 8 TF32, this warp's 16 rows in
// registers) * B (8 x 128 TF32, K-major at desc b); D = A * B when !accumulate.
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The TF32 value nearest to the float32 with these bits, ties away from zero
// (cvt.rna.tf32.f32 for every finite value whose rounding stays finite): add
// half a unit of TF32's last place to the magnitude, clear the 13 bits below.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) { return (bits + 0x1000u) & 0xffffe000u; }

// Four adjacent outputs of C at dst (only the first `left` where fewer
// remain, or where the row is not 16-byte aligned: !vec), from fp32 sums
// (float32, or bf16 rounded to nearest even) or wrapping 32-bit ones (int32).
__device__ __forceinline__ void store4(float* dst, float4 v, bool vec, int left) {
  if (vec && left >= 4) {
    *reinterpret_cast<float4*>(dst) = v;
    return;
  }
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < left) dst[u] = vals[u];
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v, bool vec, int left) {
  if (vec && left >= 4) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 packed;
    packed.x = *reinterpret_cast<uint32_t*>(&lo);
    packed.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(dst) = packed;
    return;
  }
  const float vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < left) dst[u] = __float2bfloat16_rn(vals[u]);
}
__device__ __forceinline__ void store4(int32_t* dst, uint4 v, bool vec, int left) {
  if (vec && left >= 4) {
    *reinterpret_cast<uint4*>(dst) = v;
    return;
  }
  const uint32_t vals[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (u < left) dst[u] = (int32_t)vals[u];
}

__device__ __forceinline__ void add4(float4& s, const float4& v) {
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}
__device__ __forceinline__ void add4(uint4& s, const uint4& v) {  // modulo 2^32
  s.x += v.x;
  s.y += v.y;
  s.z += v.z;
  s.w += v.w;
}

// The end of a tensor-core block once its partial tile (TPart [BM][BN + 4]:
// fp32 sums, or uint32 sums modulo 2^32) is in shared memory: each rank of
// the cluster sums its share of the rows over the ranks in rank order (the
// same bits on every run; the integers' uint32 sums wrap exactly in any
// order) and stores them 16 bytes of fp32 or int32 (8 of bf16) at a time
// where the row allows.
template <int BM, int BN, typename TPart, typename TOut>
__device__ __forceinline__ void tc_store(const TPart* part_tile, TOut* c, int m, int n, int m0,
                                         int n0, int z, int rank, int split, int tid) {
  using V = typename std::conditional<std::is_same<TPart, float>::value, float4, uint4>::type;
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1)
    cluster.sync();
  else
    __syncthreads();
  if (tid < kTcConsumers) {
    constexpr int kPitch = BN + 4;
    constexpr int kChunks = BN / 4;  // 4 columns a chunk
    constexpr int kRowsAPass = kTcConsumers / kChunks;
    const int c4 = tid % kChunks, col = n0 + 4 * c4;
    const bool vec = n % 4 == 0;  // rows start 16 (fp32, int32) or 8 (bf16) bytes aligned
    TOut* cz = c + (size_t)z * m * n;
    for (int r = rank + tid / kChunks * split; r < BM; r += kRowsAPass * split) {
      const int gr = m0 + r;
      if (gr >= m) break;
      if (col >= n) continue;
      const TPart* own = part_tile + r * kPitch + 4 * c4;
      V sum = *reinterpret_cast<const V*>(split > 1 ? cluster.map_shared_rank(own, 0) : own);
      for (int q = 1; q < split; ++q)
        add4(sum, *reinterpret_cast<const V*>(cluster.map_shared_rank(own, q)));
      store4(cz + (size_t)gr * n + col, sum, vec, n - col);
    }
  }
  if (split > 1) cluster.sync();  // keep every partial tile alive until all are read
}

// Grid: (row tiles x split, column tiles, batch), clusters of `split`
// blocks along x: block x reduces k-tiles [rank * ktper, (rank + 1) * ktper)
// of row tile x / split (a k-tile is one 128-byte row of K).  Warps 0-7 are
// the two consumer warpgroups, warps 8 and 9 the producer: they keep the
// ring of `stages` stages filled, each stage one k-tile of every row of A's
// tile and of B's tile.  The first producer thread brings an operand TMA
// can address (a_cp, b_cp 0) by TMA; an operand it cannot address (a_cp,
// b_cp: the copy width, 8 or 4 bytes, its rows allow) all producer threads
// copy by cp.async from `a` (rows lda apart, batch entries m lda apart) or
// `b` (rows ldb apart, entries sb apart) into the same swizzled layout.
// Issuing the copies bounds that route, not the bytes: a stage of B alone
// is 1024-4096 copies, each a few instructions of addressing, and one warp
// issued them slower than whisper's cotangent arrives.  Two warps issue
// them in half the time and keep a 128 x 64 bf16 tile at two blocks an SM
// (96 registers x 320 threads x 2 fit the SM's 65536); four would not, and
// the tile then runs one block an SM.  On an H100 whisper's scores dB with
// B by 8-byte copies ran 0.147 ms with one warp, 0.108 with two and 0.139
// with four; TMA launches ran within 1.5 % of one warp with two.  BCOL: B is the transpose of a row-major [N, K] tensor
// (K-major), else row-major [K, N] (MN-major).
template <typename TIn, typename TOut, int BM, int BN, int BCOL>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_tc_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
               TOut* __restrict__ c, int m, int n, int k, int stages, int split, int ktper,
               const TIn* __restrict__ a, const TIn* __restrict__ b, int lda, int ldb,
               long long sb, int a_cp, int b_cp) {
  using G = Tc<TIn, BM, BN>;
  constexpr int E = G::kElems;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + kTcAlign - 1) & ~(unsigned)(kTcAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const int ring = max(stages * G::kStageBytes, G::kPartBytes);  // the partial tile reuses it
  const unsigned full = base + ring;  // kTcMaxStages barriers each
  const unsigned empty = full + kTcMaxStages * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % split;
  const int m0 = blockIdx.x / split * BM, n0 = blockIdx.y * BN, z = blockIdx.z;
  const int kt0 = rank * ktper;
  const int nkt = max(0, min((k + E - 1) / E, kt0 + ktper) - kt0);  // this rank's k-tiles

  const bool copies = a_cp || b_cp;  // the cp.async producer
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      // the first producer thread's arrival with TMA's bytes, and with
      // copies each producer thread's once its copies are done
      mbar_init(full + 8 * s, copies ? 1 + kTcProducers : 1);
      mbar_init(empty + 8 * s, kTcConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's partial tile, fp32 [BM][BN + 4] (rows 16-byte aligned)
  float* part_tile = reinterpret_cast<float*>(smem);
  constexpr int kPitch = BN + 4;

  if (tid >= kTcConsumers) {  // the producer warps
    const int pt = tid - kTcConsumers;  // this producer thread
    if (copies || pt == 0) {
      if (a_cp) a += (size_t)z * m * lda;
      if (b_cp) b += (size_t)z * sb;
      for (int i = 0; i < nkt; ++i) {
        const int s = i % stages, kx = (kt0 + i) * E;
        if (i >= stages) mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
        const unsigned a_s = base + s * G::kStageBytes, b_s = a_s + G::kABytes;
        if (pt == 0) {
          mbar_expect_tx(full + 8 * s, (a_cp ? 0 : G::kABytes) + (b_cp ? 0 : G::kBBytes));
          if (!a_cp) tma_load(a_s, &ta, full + 8 * s, kx, m0, z);
          if (!b_cp && BCOL) {
            tma_load(b_s, &tb, full + 8 * s, kx, n0, z);
          } else if (!b_cp) {  // boxes of E columns x E rows of K, one after another
#pragma unroll
            for (int j = 0; j < BN / E; ++j)
              tma_load(b_s + j * E * kTcRowBytes, &tb, full + 8 * s, n0 + j * E, kx, z);
          }
        }
        if (!copies) continue;
        if (a_cp == 8) cp_stage<8, false>(a_s, a, BM, lda, m, k, m0, kx, pt);
        if (a_cp == 4) cp_stage<4, false>(a_s, a, BM, lda, m, k, m0, kx, pt);
        if (b_cp == 8) cp_stage<8, !BCOL>(b_s, b, BN, ldb, BCOL ? n : k, BCOL ? k : n,
                                          BCOL ? n0 : kx, BCOL ? kx : n0, pt);
        if (b_cp == 4) cp_stage<4, !BCOL>(b_s, b, BN, ldb, BCOL ? n : k, BCOL ? k : n,
                                          BCOL ? n0 : kx, BCOL ? kx : n0, pt);
        cp_arrive_noinc(full + 8 * s);
      }
      if (copies) cp_wait<0>();
    }
    __syncwarp();
  } else {
    const int wg = tid >> 7, wq = warp & 3, g = lane >> 2, t = lane & 3;
    // acc: the sums; part: one stage's products, where they are added to the
    // sums in fp32 after each stage (every float32 output; see the note at
    // the top)
    float acc[G::kAcc], part[G::kAcc];
#pragma unroll
    for (int i = 0; i < G::kAcc; ++i) acc[i] = 0.f;

    if constexpr (!G::kF32) {
      constexpr bool kPromote = std::is_same<TOut, float>::value;
      for (int i = 0; i < nkt; ++i) {
        const int s = i % stages;
        mbar_wait(full + 8 * s, (i / stages) & 1);
        // what cp.async wrote (the generic proxy) is read by wgmma (the
        // async proxy)
        if (copies) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        const unsigned a_s = base + s * G::kStageBytes + wg * 64 * kTcRowBytes;
        const unsigned b_s = base + s * G::kStageBytes + G::kABytes;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < E / 16; ++kk) {  // 16 of K a product: 32 bytes along a row of A
          const uint64_t da = sw128_desc(a_s + kk * 32, 16, 1024);
          const uint64_t db =
              BCOL ? sw128_desc(b_s + kk * 32, 16, 1024)
                   : sw128_desc(b_s + kk * 16 * kTcRowBytes, E * kTcRowBytes, 1024);
          if constexpr (kPromote)
            wgmma_bf16<BCOL ? 0 : 1>(part, da, db, kk > 0);
          else
            wgmma_bf16<BCOL ? 0 : 1>(acc, da, db, 1);
        }
        wgmma_commit();
        if constexpr (kPromote) {
          wgmma_wait<0>();
          fence_regs(part);
#pragma unroll
          for (int q = 0; q < G::kAcc; ++q) acc[q] += part[q];
          if (lane == 0) mbar_arrive(empty + 8 * s);
        } else {
          wgmma_wait<1>();  // the previous stage's products are done: release it
          if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
    } else {
      // this thread's rows of B^T (columns of C): nrow and nrow + 8
      const int nrow = wg * 64 + wq * 16 + g;
      for (int i = 0; i < nkt; ++i) {
        const int s = i % stages;
        mbar_wait(full + 8 * s, (i / stages) & 1);
        if (copies) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        unsigned char* st = smem + s * G::kStageBytes;
        const unsigned a_s = base + s * G::kStageBytes;
        const unsigned lo_s = a_s + G::kABytes + G::kBBytes;
        // the low parts of A's tile, x - trunc_tf32(x) (exact), elementwise
        // in its swizzled layout; the tensor cores read A itself as
        // trunc_tf32(x)
        {
          const float4* src = reinterpret_cast<const float4*>(st);
          float4* dst = reinterpret_cast<float4*>(st + G::kABytes + G::kBBytes);
#pragma unroll
          for (int q = tid; q < G::kABytes / 16; q += kTcConsumers) {
            float4 v = src[q];
            v.x -= __uint_as_float(__float_as_uint(v.x) & 0xffffe000u);
            v.y -= __uint_as_float(__float_as_uint(v.y) & 0xffffe000u);
            v.z -= __uint_as_float(__float_as_uint(v.z) & 0xffffe000u);
            v.w -= __uint_as_float(__float_as_uint(v.w) & 0xffffe000u);
            dst[q] = v;
          }
        }
        // B^T fragments, split hi = rna_tf32(x), lo = x - hi: a0 (row g, k
        // t), a1 (row g + 8, k t), a2 (row g, k t + 4), a3 (row g + 8, k t + 4)
        uint32_t bh[E / 8][4], bl[E / 8][4];
        const unsigned char* bs = st + G::kABytes;
#pragma unroll
        for (int kk = 0; kk < E / 8; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = 8 * kk + t + (e >> 1) * 4, nl = nrow + (e & 1) * 8;
            int off;
            if (BCOL) {  // row nl of 128 bytes, K along it
              off = nl * kTcRowBytes + ((((kl * 4) >> 4) ^ (nl & 7)) << 4) + ((kl * 4) & 15);
            } else {  // boxes of 32 columns x 32 rows of K, N along a row
              const int byte = (nl & 31) * 4;
              off = (nl >> 5) * E * kTcRowBytes + kl * kTcRowBytes +
                    (((byte >> 4) ^ (kl & 7)) << 4) + (byte & 15);
            }
            const uint32_t x = *reinterpret_cast<const uint32_t*>(bs + off);
            bh[kk][e] = tf32_rna(x);
            bl[kk][e] = __float_as_uint(__uint_as_float(x) - __uint_as_float(bh[kk][e]));
          }
        // A's low parts are read by wgmma (the async proxy) once both
        // warpgroups have written them
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
#pragma unroll
        for (int kk = 0; kk < E / 8; ++kk) {
          fence_regs(bh[kk]);
          fence_regs(bl[kk]);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < E / 8; ++kk) {  // 8 of K a product: 32 bytes along a row of A
          const uint64_t dh = sw128_desc(a_s + kk * 32, 16, 1024);
          const uint64_t dl = sw128_desc(lo_s + kk * 32, 16, 1024);
          wgmma_tf32(part, bl[kk], dh, kk > 0);  // the small terms first
          wgmma_tf32(part, bh[kk], dl, 1);
          wgmma_tf32(part, bh[kk], dh, 1);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(part);
#pragma unroll
        for (int q = 0; q < G::kAcc; ++q) acc[q] += part[q];
#pragma unroll
        for (int kk = 0; kk < E / 8; ++kk) {
          fence_regs(bh[kk]);
          fence_regs(bl[kk]);
        }
        if (lane == 0) mbar_arrive(empty + 8 * s);
      }
    }

    // the partial tile into shared memory once both warpgroups are done with
    // the ring: value 4 j + e of the bf16 products is row 16 wq + g + 8 (e /
    // 2) of the warpgroup's 64, column 8 j + 2 t + e % 2; of the float32
    // products (C^T) column nrow + 8 (e / 2), row 8 j + 2 t + e % 2
    asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
#pragma unroll
    for (int j = 0; j < G::kAcc / 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int r, col;
        if constexpr (G::kF32) {
          r = 8 * j + 2 * t + (e & 1);
          col = wg * 64 + wq * 16 + g + (e >> 1) * 8;
        } else {
          r = wg * 64 + wq * 16 + g + (e >> 1) * 8;
          col = 8 * j + 2 * t + (e & 1);
        }
        part_tile[r * kPitch + col] = acc[4 * j + e];
      }
  }

  tc_store<BM, BN>(part_tile, c, m, n, m0, n0, z, rank, split, tid);
}

// ---------------------------------------------------------------------------
// gemm_tc_int_kernel: M > 16 in int8, int16 and int32 on wgmma as int8 limbs,
// operands by TMA from K-major byte planes (see the note at the top)
// ---------------------------------------------------------------------------

// The most K a rank of a split reduces, by limbs a value (kept equal to
// TC_INT_MAX_RANK_K in repro_torch/kernels/runtime.py): an element of K adds
// at most 2^14 to int8's one s32 set (-128 x -128), 2 x 255 x 128 = 65280 to
// int16's shift-8 set (two .u8 x .s8 products) and 2 x 255^2 + 2 x 255 x 128
// = 195330 to int32's shift-24 set, so no set can leave int32 up to
// (2^31 - 1) / that many k, and no result depends on how wgmma overflows.
constexpr int kTcI8MaxRankK = 131071;
constexpr int kTcI16MaxRankK = 32896;
constexpr int kTcI32MaxRankK = 10994;
constexpr int kTcIntGroup = 16;  // row tiles of a group of the grid's raster
constexpr int kLimbRows = 32;    // rows of a plane a limb_planes_kernel block writes

// One operand's limb planes for gemm_tc_int_kernel: dst is [batch][rows]
// [units x 128] bytes, and the 128 bytes of unit u of a row hold its values
// of K from kE u to kE u + kE - 1 (kE = 128 / sizeof(T)) as one plane of kE
// bytes a limb: byte p of value j (the limb of weight 2^(8p), unsigned but
// for the top one, read as signed) at p kE + j; values past K are zeros.
// The source is K-major (element (z, r, kk) at src[z stride + r pitch +
// kk]: A, or a column-major B) or, when trans, row-major [K, rows] (a
// row-major B); where its base, pitch and stride are 16-byte aligned (vec)
// it is read 16 bytes at a time, else a value at a time.
struct LimbJob {
  const void* src;
  unsigned char* dst;
  int rows, pitch, trans;
  int blocks;        // of the grid's y: ceil(rows / kLimbRows), 0 for no job
  long long stride;  // elements between the operand's batch entries
  int vec;
};

// A block of 256 threads moves one unit of 32 rows (4 KB): one 16-byte load
// a thread (along K, or along the rows for TRANS), the values staged row by
// row in shared memory, then each row's 128 bytes written plane by plane, 16
// bytes a thread.
constexpr int kLimbPitch = kTcRowBytes + 16;  // a staged row, padded against bank conflicts

template <typename T, bool TRANS>
__device__ __forceinline__ void limb_tile(unsigned char* tile, const T* src, unsigned char* dst,
                                          int rows, int pitch, long long stride, int vec, int k,
                                          int units, int yblock) {
  constexpr int S = (int)sizeof(T), E = kTcRowBytes / S, V = 16 / S;  // V values a load
  constexpr int kPitch = kLimbPitch;
  const int u = blockIdx.x, r0 = yblock * kLimbRows, tid = threadIdx.x;
  const size_t z = blockIdx.z;
  // this thread's V values: along K from (r, j), or along the rows for TRANS
  const int r = TRANS ? tid % (kLimbRows / V) * V : tid / (E / V);
  const int j = TRANS ? tid / (kLimbRows / V) : tid % (E / V) * V;
  const int gr = r0 + r, gk = u * E + j;
  union {
    uint4 w;
    T x[V];
  } in;
  in.w = make_uint4(0u, 0u, 0u, 0u);
  const T* at = TRANS ? src + z * stride + (size_t)gk * pitch + gr
                      : src + z * stride + (size_t)gr * pitch + gk;
  if (vec && gr < rows && gk < k) {
    in.w = *reinterpret_cast<const uint4*>(at);
  } else if (!vec) {  // a value at a time, none past the rows or K
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (TRANS ? gr + i < rows && gk < k : gr < rows && gk + i < k) in.x[i] = at[i];
  }
  if (TRANS) {
#pragma unroll
    for (int i = 0; i < V; ++i) *reinterpret_cast<T*>(tile + (r + i) * kPitch + j * S) = in.x[i];
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)  // a padded row's tail past K is not zeros
      if (gk + i >= k) in.x[i] = T(0);
    *reinterpret_cast<uint4*>(tile + r * kPitch + j * S) = in.w;
  }
  __syncthreads();
  const int row = tid >> 3, q16 = tid & 7;  // 16 bytes of one plane of a row
  if (r0 + row >= rows) return;
  const int p = 16 * q16 / E, j0 = 16 * q16 % E;
  const unsigned char* vals = tile + row * kPitch + j0 * S + p;
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) word |= (uint32_t)vals[(4 * q + i) * S] << (8 * i);
    w[q] = word;
  }
  *reinterpret_cast<uint4*>(dst + ((z * rows + r0 + row) * units + u) * kTcRowBytes +
                            16 * q16) = make_uint4(w[0], w[1], w[2], w[3]);
}

// The limb planes of A and of B in one launch: grid (units, a.blocks +
// b.blocks, batch), A's row blocks first.  Bytes bound it: each operand
// read once and its planes written once.
template <typename T>
__global__ void __launch_bounds__(256)
limb_planes_kernel(LimbJob a, LimbJob b, int k, int units) {
  __shared__ __align__(16) unsigned char tile[kLimbRows * kLimbPitch];
  const int y = blockIdx.y;
  if (y < a.blocks)  // A is K-major
    limb_tile<T, false>(tile, static_cast<const T*>(a.src), a.dst, a.rows, a.pitch, a.stride,
                        a.vec, k, units, y);
  else if (b.trans)
    limb_tile<T, true>(tile, static_cast<const T*>(b.src), b.dst, b.rows, b.pitch, b.stride,
                       b.vec, k, units, y - a.blocks);
  else
    limb_tile<T, false>(tile, static_cast<const T*>(b.src), b.dst, b.rows, b.pitch, b.stride,
                        b.vec, k, units, y - a.blocks);
}

// Geometry of an integer output tile: LIMBS int8 limbs a value (int8 1,
// int16 2, int32 4).  A k-tile, one 128-byte row of a plane operand, holds
// kE = 128 / LIMBS values of K (128 int8, 64 int16, 32 int32), limb p's
// bytes at [p kE, (p + 1) kE).  Each consumer warpgroup owns 64 rows of C
// (BM = 128) and keeps one s32 accumulator set (64 x BN) for each shift 8 (p
// + q) of the limb products: 1 in int8, 3 in int16, 4 in int32.
template <int LIMBS, int BM, int BN> struct TcInt {
  static constexpr int kE = kTcRowBytes / LIMBS;
  static constexpr int kABytes = BM * kTcRowBytes;
  static constexpr int kBBytes = BN * kTcRowBytes;
  static constexpr int kStageBytes = kABytes + kBBytes;  // what TMA brings a stage
  static constexpr int kSets = LIMBS == 1 ? 1 : (LIMBS == 2 ? 3 : 4);
  static constexpr int kAcc = BN / 2;                    // accumulators a thread a set
  static constexpr int kPartBytes = BM * (BN + 4) * 4;   // the uint32 partial tile, padded rows
  static_assert(BM == 128 && (BN == 64 || (LIMBS == 1 && BN == 256)), "not a compiled tile");
  static_assert(kStageBytes % kTcAlign == 0 && kABytes % kTcAlign == 0,
                "tiles must keep the 1 KB alignment of the swizzle");
};

// D (64 x N s32, N / 2 values a thread) += A (64 x 32 bytes at desc a) * B
// (32 x N bytes at desc b), both K-major in shared memory; TYPES names each
// operand's bytes signed (s8) or unsigned (u8).
#define WIDESA_WGMMA_S8_N64(TYPES)                                                    \
  asm volatile(                                                                       \
      "{\n"                                                                           \
      ".reg .pred p;\n"                                                                \
      "setp.ne.b32 p, %34, 0;\n"                                                     \
      "wgmma.mma_async.sync.aligned.m64n64k32.s32." TYPES " "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "  \
      "%32, %33, p;\n"                                                             \
      "}\n"                                                                           \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),  \
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),  \
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])  \
      : "l"(a), "l"(b), "r"(1))

#define WIDESA_WGMMA_S8_N128(TYPES)                                                    \
  asm volatile(                                                                       \
      "{\n"                                                                           \
      ".reg .pred p;\n"                                                                \
      "setp.ne.b32 p, %66, 0;\n"                                                     \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32." TYPES " "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "  \
      "%64, %65, p;\n"                                                             \
      "}\n"                                                                           \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),  \
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),  \
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),  \
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),  \
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),  \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),  \
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])  \
      : "l"(a), "l"(b), "r"(1))

#define WIDESA_WGMMA_S8_N256(TYPES)                                                    \
  asm volatile(                                                                       \
      "{\n"                                                                           \
      ".reg .pred p;\n"                                                                \
      "setp.ne.b32 p, %130, 0;\n"                                                     \
      "wgmma.mma_async.sync.aligned.m64n256k32.s32." TYPES " "                          \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "  \
      "%128, %129, p;\n"                                                             \
      "}\n"                                                                           \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),  \
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),  \
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),  \
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),  \
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),  \
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),  \
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),  \
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]),  \
        "+r"(d[64]), "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]), "+r"(d[70]), "+r"(d[71]),  \
        "+r"(d[72]), "+r"(d[73]), "+r"(d[74]), "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),  \
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]), "+r"(d[85]), "+r"(d[86]), "+r"(d[87]),  \
        "+r"(d[88]), "+r"(d[89]), "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]), "+r"(d[95]),  \
        "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]), "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),  \
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),  \
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),  \
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])  \
      : "l"(a), "l"(b), "r"(1))


template <bool SA, bool SB>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[32], uint64_t a, uint64_t b) {
  if constexpr (SA && SB)
    WIDESA_WGMMA_S8_N64("s8.s8");
  else if constexpr (SA)
    WIDESA_WGMMA_S8_N64("s8.u8");
  else if constexpr (SB)
    WIDESA_WGMMA_S8_N64("u8.s8");
  else
    WIDESA_WGMMA_S8_N64("u8.u8");
}
template <bool SA, bool SB>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[64], uint64_t a, uint64_t b) {
  if constexpr (SA && SB)
    WIDESA_WGMMA_S8_N128("s8.s8");
  else if constexpr (SA)
    WIDESA_WGMMA_S8_N128("s8.u8");
  else if constexpr (SB)
    WIDESA_WGMMA_S8_N128("u8.s8");
  else
    WIDESA_WGMMA_S8_N128("u8.u8");
}
template <bool SA, bool SB>
__device__ __forceinline__ void wgmma_s8(uint32_t (&d)[128], uint64_t a, uint64_t b) {
  static_assert(SA && SB, "only int8 runs 256 columns");
  WIDESA_WGMMA_S8_N256("s8.s8");
}
#undef WIDESA_WGMMA_S8_N64
#undef WIDESA_WGMMA_S8_N128
#undef WIDESA_WGMMA_S8_N256

// The limb products of one 32-byte step of K: limb P of A's tile (desc a) by
// limb Q of B's (desc b) for every P + Q <= 3 (a product of shift 2^32 or
// more vanishes modulo 2^32: 4 products in int16, 10 in int32), each into the
// set of its shift P + Q, the top limb (LIMBS - 1) signed.  Limb p's plane
// lies p kE bytes along the k-tile's row: kE / 16 descriptor units.
template <int LIMBS, int P, int Q, int S, int N>
__device__ __forceinline__ void limb_products(uint32_t (&acc)[S][N], uint64_t a, uint64_t b) {
  if constexpr (P < LIMBS) {
    if constexpr (P + Q < 4) {
      constexpr uint64_t kPlane = kTcRowBytes / LIMBS / 16;
      wgmma_s8<P == LIMBS - 1, Q == LIMBS - 1>(acc[P + Q], a + P * kPlane, b + Q * kPlane);
    }
    if constexpr (Q + 1 < LIMBS)
      limb_products<LIMBS, P, Q + 1>(acc, a, b);
    else
      limb_products<LIMBS, P + 1, 0>(acc, a, b);
  }
}

// Grid: (output tiles x split, 1, batch), clusters of `split` blocks along
// x: block x reduces k-tiles [rank ktper, (rank + 1) ktper) of output tile x
// / split.  The tiles run in groups of kTcIntGroup row tiles, down the rows
// of a group before its next column, so that a wave of 132 blocks reads a
// band of A and a few columns of B, which stay in the L2, instead of all of A
// (10240^2 int8 is twice the L2) once a column tile.  Warps 0-7 are the two
// consumer warpgroups, warps 8-9 the producer: its first thread keeps the
// ring of `stages` stages filled by TMA (the other threads idle: the planes
// are always TMA's), each stage one k-tile of the 128 rows of A's tile and
// the BN rows of B^T's, both K-major byte rows.
template <int LIMBS, int BM, int BN>
__global__ void __launch_bounds__(kTcThreads, 1)
gemm_tc_int_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                   int32_t* __restrict__ c, int m, int n, int k, int stages, int split,
                   int ktper) {
  using G = TcInt<LIMBS, BM, BN>;
  constexpr int E = G::kE;
  extern __shared__ unsigned char smem_raw[];
  const unsigned raw = smem_addr(smem_raw);
  const unsigned base = (raw + kTcAlign - 1) & ~(unsigned)(kTcAlign - 1);
  unsigned char* smem = smem_raw + (base - raw);
  const int ring = max(stages * G::kStageBytes, G::kPartBytes);  // the partial tile reuses it
  const unsigned full = base + ring;  // kTcMaxStages barriers each
  const unsigned empty = full + kTcMaxStages * 8;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rank = blockIdx.x % split, tile = blockIdx.x / split;
  const int nt = (n + BN - 1) / BN;
  const int first = tile / (kTcIntGroup * nt) * kTcIntGroup;  // the group's first row tile
  const int rows = min((m + BM - 1) / BM - first, kTcIntGroup);
  const int t = tile % (kTcIntGroup * nt);
  const int m0 = (first + t % rows) * BM, n0 = t / rows * BN, z = blockIdx.z;
  const int kt0 = rank * ktper;
  const int nkt = max(0, min((k + E - 1) / E, kt0 + ktper) - kt0);  // this rank's k-tiles

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + 8 * s, 1);                   // the producer's arrival, and TMA's bytes
      mbar_init(empty + 8 * s, kTcConsumers / 32);  // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the block's partial tile of a split, uint32 [BM][BN + 4] (rows 16-byte
  // aligned)
  uint32_t* part_tile = reinterpret_cast<uint32_t*>(smem);
  constexpr int kPitch = BN + 4;

  if (tid >= kTcConsumers) {  // the producer: its first thread
    if (tid == kTcConsumers) {
      for (int i = 0; i < nkt; ++i) {
        const int s = i % stages, kx = (kt0 + i) * kTcRowBytes;
        if (i >= stages) mbar_wait(empty + 8 * s, (i / stages - 1) & 1);
        const unsigned a_s = base + s * G::kStageBytes;
        mbar_expect_tx(full + 8 * s, G::kStageBytes);
        tma_load(a_s, &ta, full + 8 * s, kx, m0, z);
        tma_load(a_s + G::kABytes, &tb, full + 8 * s, kx, n0, z);
      }
    }
    __syncwarp();
  } else {
    const int wg = tid >> 7, wq = warp & 3, g = lane >> 2, t4 = lane & 3;
    uint32_t acc[G::kSets][G::kAcc];  // a set a shift, each an exact s32 sum
#pragma unroll
    for (int q = 0; q < G::kSets; ++q)
#pragma unroll
      for (int e = 0; e < G::kAcc; ++e) acc[q][e] = 0u;
    for (int i = 0; i < nkt; ++i) {
      const int s = i % stages;
      mbar_wait(full + 8 * s, (i / stages) & 1);
      const unsigned a_s = base + s * G::kStageBytes + wg * 64 * kTcRowBytes;
      const unsigned b_s = base + s * G::kStageBytes + G::kABytes;
      wgmma_fence();
#pragma unroll
      for (int h = 0; h < E / 32; ++h)  // 32 bytes of each limb's plane a product
        limb_products<LIMBS, 0, 0>(acc, sw128_desc(a_s + 32 * h, 16, 1024),
                                   sw128_desc(b_s + 32 * h, 16, 1024));
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release it
      if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % stages));
    }
    wgmma_wait<0>();
#pragma unroll
    for (int q = 0; q < G::kSets; ++q) fence_regs(acc[q]);

    // the sets folded modulo 2^32 (set q has weight 2^(8q)): value 4 j + e
    // is row 16 wq + g + 8 (e / 2) of the warpgroup's 64, column 8 j + 2 t4
    // + e % 2.  Unsplit, straight to C, two adjacent columns a store (each
    // warp's store fills whole 32-byte sectors of 8 rows); split, into the
    // partial tile once both warpgroups are done with the ring.
    const int row0 = wg * 64 + wq * 16 + g;
    if (split > 1) asm volatile("bar.sync 1, %0;\n" ::"n"(kTcConsumers) : "memory");
    int32_t* cz = c + (size_t)z * m * n;
#pragma unroll
    for (int j = 0; j < G::kAcc / 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t sum[2] = {0u, 0u};
#pragma unroll
        for (int q = 0; q < G::kSets; ++q) {
          sum[0] += acc[q][4 * j + 2 * h] << (8 * q);
          sum[1] += acc[q][4 * j + 2 * h + 1] << (8 * q);
        }
        const int r = row0 + 8 * h, col = 8 * j + 2 * t4;
        if (split > 1) {
          part_tile[r * kPitch + col] = sum[0];
          part_tile[r * kPitch + col + 1] = sum[1];
        } else if (m0 + r < m && n0 + col < n) {
          int32_t* dst = cz + (size_t)(m0 + r) * n + n0 + col;
          if (n % 2 == 0) {  // n0 + col is even: 8-byte aligned
            *reinterpret_cast<int2*>(dst) = make_int2((int32_t)sum[0], (int32_t)sum[1]);
          } else {
            dst[0] = (int32_t)sum[0];
            if (n0 + col + 1 < n) dst[1] = (int32_t)sum[1];
          }
        }
      }
  }
  if (split > 1) tc_store<BM, BN>(part_tile, c, m, n, m0, n0, z, rank, split, tid);
}

// cuTensorMapEncodeTiled, looked up at first use through the runtime's
// entry-point query, so that the library links the CUDA runtime alone
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [batch, outer, inner] tensor of `size`-byte elements of `type` whose
// rows are `pitch` elements apart (batch entries outer rows apart) as a TMA
// map with boxes of box_inner x box_outer x 1 in the 128-byte swizzle.
bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, long long inner,
                long long outer, long long batch, long long pitch, long long batch_pitch, int size,
                int box_inner, int box_outer) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)inner, (cuuint64_t)outer, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)(pitch * size), (cuuint64_t)(batch_pitch * size)};
  const cuuint32_t box[3] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct TcArgs {
  const void* a;
  const void* b;
  void* c;
  int batch, m, n, k, lda, b_col_major, ldb;
  long long sb;
  int stages, split;
  int a_cp, b_cp;  // 0: the operand by TMA; 8 or 4: by cp.async copies of that many bytes
  cudaStream_t stream;
};

// Whether an operand at `ptr` whose rows hold `inner` elements of `size`
// bytes, `pitch` elements apart and batch entries `stride` apart, can be
// read as `cp` says: TMA (0) needs a 16-byte aligned base, pitch and
// stride (the rows' length is free: TMA zero-fills past it); cp.async
// copies of cp bytes need the base, the pitch, the stride and the rows'
// length aligned to cp, so that no copy straddles the row's end.
bool operand_ok(const void* ptr, long long inner, long long pitch, long long stride, int size,
                int cp) {
  const int align = cp ? cp : 16;
  if (cp != 0 && cp != 4 && cp != 8) return false;
  return reinterpret_cast<uintptr_t>(ptr) % align == 0 && pitch * size % align == 0 &&
         stride * size % align == 0 && (cp == 0 || inner * size % align == 0);
}

template <typename TIn, typename TOut, int BM, int BN, int BCOL>
int launch_tc_typed(const TcArgs& x) {
  using G = Tc<TIn, BM, BN>;
  constexpr int E = G::kElems;
  constexpr int size = (int)sizeof(TIn);
  auto kernel = gemm_tc_kernel<TIn, TOut, BM, BN, BCOL>;
  // each operand by TMA or by copies it allows (operand_ok); every rank of
  // a split reduces at least one k-tile
  const long long b_inner = BCOL ? x.k : x.n;
  const int ktiles = (x.k + E - 1) / E;
  const int ktper = (ktiles + x.split - 1) / max(x.split, 1);
  if (x.batch < 1 || x.batch > 65535 || x.m < 1 || x.n < 1 || x.k < 1 || x.stages < 2 ||
      x.stages > kTcMaxStages || x.split < 1 || x.split > kTcMaxCluster ||
      (long long)(x.split - 1) * ktper >= ktiles || reinterpret_cast<uintptr_t>(x.c) % 16 != 0 ||
      x.lda < x.k || !operand_ok(x.a, x.k, x.lda, (long long)x.lda * x.m, size, x.a_cp) ||
      x.ldb < b_inner || !operand_ok(x.b, b_inner, x.ldb, x.sb, size, x.b_cp) ||
      (x.n + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem(G::kStageBytes, x.stages, G::kPartBytes);
  const long long xblocks = (long long)((x.m + BM - 1) / BM) * x.split;
  if (smem > (size_t)kTcMaxSmem || xblocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const CUtensorMapDataType type =
      G::kF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  CUtensorMap ta = {}, tb = {};  // an operand copied by cp.async has no map
  if ((!x.a_cp && !encode_map(&ta, type, x.a, x.k, x.m, x.batch, x.lda,
                              (long long)x.lda * x.m, size, E, BM)) ||
      (!x.b_cp && !(BCOL ? encode_map(&tb, type, x.b, x.k, x.n, x.batch, x.ldb, x.sb, size, E, BN)
                         : encode_map(&tb, type, x.b, x.n, x.k, x.batch, x.ldb, x.sb, size, E, E))))
    return (int)cudaErrorInvalidValue;
  const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (allowed != cudaSuccess) return (int)allowed;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)xblocks, (unsigned)((x.n + BN - 1) / BN), (unsigned)x.batch);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
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
      &cfg, kernel, ta, tb, static_cast<TOut*>(x.c), x.m, x.n, x.k, x.stages, x.split, ktper,
      static_cast<const TIn*>(x.a), static_cast<const TIn*>(x.b), x.lda, x.ldb, x.sb, x.a_cp,
      x.b_cp);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut, int BM, int BN>
int launch_tc_layout(const TcArgs& x) {
  return x.b_col_major ? launch_tc_typed<TIn, TOut, BM, BN, 1>(x)
                       : launch_tc_typed<TIn, TOut, BM, BN, 0>(x);
}

// The compiled tiles (kept equal to TC_TILES in repro_torch/kernels/runtime.py).
template <typename TOut>
int launch_tc_bf16(int bm, int bn, const TcArgs& x) {
  if (bm == 128 && bn == 64) return launch_tc_layout<__nv_bfloat16, TOut, 128, 64>(x);
  if (bm == 128 && bn == 128) return launch_tc_layout<__nv_bfloat16, TOut, 128, 128>(x);
  return (int)cudaErrorInvalidValue;
}

int launch_tc_f32(int bm, int bn, const TcArgs& x) {
  if (bm == 64 && bn == 128) return launch_tc_layout<float, float, 64, 128>(x);
  if (bm == 128 && bn == 128) return launch_tc_layout<float, float, 128, 128>(x);
  return (int)cudaErrorInvalidValue;
}

int launch_tc(int in_dtype, int out_dtype, int bm, int bn, const TcArgs& x) {
  if (in_dtype == BF16 && out_dtype == BF16) return launch_tc_bf16<__nv_bfloat16>(bm, bn, x);
  if (in_dtype == BF16 && out_dtype == F32) return launch_tc_bf16<float>(bm, bn, x);
  if (in_dtype == F32 && out_dtype == F32) return launch_tc_f32(bm, bn, x);
  return (int)cudaErrorInvalidValue;
}

struct TcIntArgs {
  const void* a;
  const void* b;
  void* c;
  // [batch, rows, ktiles x 128] bytes each, null where the launch reads the
  // operand itself (an int8 A; an int8 column-major B)
  void* a_planes;
  void* b_planes;
  int batch, m, n, k, lda, b_col_major, ldb;
  long long sb;
  int stages, split;
  cudaStream_t stream;
};

// The integer GEMM: the limb planes the tiles read (none for an int8 A or a
// column-major int8 B, whose rows TMA reads as they are), then
// gemm_tc_int_kernel, on one stream.
template <typename T, int BM, int BN>
int launch_tc_int_typed(const TcIntArgs& x) {
  constexpr int L = (int)sizeof(T);
  using G = TcInt<L, BM, BN>;
  constexpr int E = G::kE;
  constexpr int kMaxRankK = L == 1 ? kTcI8MaxRankK : L == 2 ? kTcI16MaxRankK : kTcI32MaxRankK;
  const int ktiles = (x.k + E - 1) / E;
  const int ktper = (ktiles + x.split - 1) / max(x.split, 1);
  auto kernel = gemm_tc_int_kernel<L, BM, BN>;
  // an operand without planes is read as it is: an int8 K-major one that
  // TMA can address
  const bool a_direct = x.a_planes == nullptr, b_direct = x.b_planes == nullptr;
  const void* a = a_direct ? x.a : x.a_planes;
  const void* b = b_direct ? x.b : x.b_planes;
  const long long tiles = (long long)((x.m + BM - 1) / BM) * ((x.n + BN - 1) / BN);
  const long long plane = (long long)ktiles * kTcRowBytes;  // bytes a row of a plane
  const long long b_inner = x.b_col_major ? x.k : x.n;
  // TMA: 16-byte aligned bases and pitches (operand_ok); every rank of a
  // split reduces at least one k-tile and at most kMaxRankK of K
  if (x.batch < 1 || x.batch > 65535 || x.m < 1 || x.n < 1 || x.k < 1 || x.stages < 2 ||
      x.stages > kTcMaxStages || x.split < 1 || x.split > kTcMaxCluster ||
      (long long)(x.split - 1) * ktper >= ktiles || (long long)ktper * E > kMaxRankK ||
      x.lda < x.k || x.ldb < b_inner || reinterpret_cast<uintptr_t>(x.c) % 16 != 0 ||
      (a_direct && !(L == 1 && operand_ok(x.a, x.k, x.lda, (long long)x.lda * x.m, 1, 0))) ||
      (b_direct && !(L == 1 && x.b_col_major && operand_ok(x.b, x.k, x.ldb, x.sb, 1, 0))) ||
      reinterpret_cast<uintptr_t>(a) % 16 != 0 || reinterpret_cast<uintptr_t>(b) % 16 != 0 ||
      (x.m + kLimbRows - 1) / kLimbRows > 65535 || (x.n + kLimbRows - 1) / kLimbRows > 65535 ||
      tiles * x.split > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc_smem(G::kStageBytes, x.stages, G::kPartBytes);
  if (smem > (size_t)kTcMaxSmem) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!encode_map(&ta, CU_TENSOR_MAP_DATA_TYPE_UINT8, a, a_direct ? x.k : plane, x.m, x.batch,
                  a_direct ? x.lda : plane, (a_direct ? x.lda : plane) * x.m, 1, kTcRowBytes,
                  BM) ||
      !encode_map(&tb, CU_TENSOR_MAP_DATA_TYPE_UINT8, b, b_direct ? x.k : plane, x.n, x.batch,
                  b_direct ? x.ldb : plane, b_direct ? x.sb : plane * x.n, 1, kTcRowBytes, BN))
    return (int)cudaErrorInvalidValue;
  const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (allowed != cudaSuccess) return (int)allowed;

  if (!a_direct || !b_direct) {
    const LimbJob ja{x.a, static_cast<unsigned char*>(x.a_planes), x.m, x.lda, 0,
                     a_direct ? 0 : (x.m + kLimbRows - 1) / kLimbRows,
                     (long long)x.lda * x.m,
                     operand_ok(x.a, x.k, x.lda, (long long)x.lda * x.m, L, 0)};
    const LimbJob jb{x.b, static_cast<unsigned char*>(x.b_planes), x.n, x.ldb, !x.b_col_major,
                     b_direct ? 0 : (x.n + kLimbRows - 1) / kLimbRows, x.sb,
                     operand_ok(x.b, b_inner, x.ldb, x.sb, L, 0)};
    const dim3 grid((unsigned)ktiles, (unsigned)(ja.blocks + jb.blocks), (unsigned)x.batch);
    limb_planes_kernel<T><<<grid, 256, 0, x.stream>>>(ja, jb, x.k, ktiles);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * x.split), 1, (unsigned)x.batch);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = x.stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)x.split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = x.split > 1 ? 1 : 0;
  const cudaError_t launched = cudaLaunchKernelEx(&cfg, kernel, ta, tb, static_cast<int32_t*>(x.c),
                                                  x.m, x.n, x.k, x.stages, x.split, ktper);
  if (launched != cudaSuccess) return (int)launched;
  return (int)cudaGetLastError();
}

// The compiled integer tiles (kept equal to TC_TILES in
// repro_torch/kernels/runtime.py).
int launch_tc_int(int in_dtype, int bm, int bn, const TcIntArgs& x) {
  if (in_dtype == I8 && bm == 128 && bn == 64) return launch_tc_int_typed<int8_t, 128, 64>(x);
  if (in_dtype == I8 && bm == 128 && bn == 256) return launch_tc_int_typed<int8_t, 128, 256>(x);
  if (in_dtype == I16 && bm == 128 && bn == 64) return launch_tc_int_typed<int16_t, 128, 64>(x);
  if (in_dtype == I32 && bm == 128 && bn == 64) return launch_tc_int_typed<int32_t, 128, 64>(x);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// C[m, n] = A[m, k] @ B[k, n] (the mm recurrence); A's rows are lda elements
// apart in every entry point, B's rows (of N, or of K with b_col_major) ldb
// apart and, batched, its entries sb apart.  Returns a cudaError_t.
int widesa_mm_launch(const void* a, const void* b, void* c, int m, int n, int k, int lda,
                     int b_col_major, int ldb, int in_dtype, int out_dtype, int bm, int bn,
                     int bk, void* stream) {
  const Args x{a,   b,           c,   1,  m, n, k, lda,
               b_col_major, ldb, 0LL, static_cast<cudaStream_t>(stream)};
  return launch(in_dtype, out_dtype, bm, bn, bk, x);
}

// C[z] = A[z] @ B[z] for z < batch (the bmm recurrence).  Returns a cudaError_t.
int widesa_bmm_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                      int lda, int b_col_major, int ldb, long long sb, int in_dtype,
                      int out_dtype, int bm, int bn, int bk, void* stream) {
  const Args x{a,   b,           c,   batch, m, n, k, lda,
               b_col_major, ldb, sb, static_cast<cudaStream_t>(stream)};
  return launch(in_dtype, out_dtype, bm, bn, bk, x);
}

// C[z] = A[z] @ B[z] for z < batch and M <= 16 on skinny_kernel (mm is
// batch = 1): K split over `split` blocks of a cluster, `kblk` each; B copied
// in runs of b_gran bytes (16, 8 or 4), A in runs of a_gran bytes (16, 8 or
// 4; 0: by plain loads).  Returns a cudaError_t.
int widesa_skinny_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                         int lda, int b_col_major, int ldb, long long sb, int in_dtype,
                         int out_dtype, int split, int kblk, int b_gran, int a_gran,
                         void* stream) {
  const SkinnyArgs x{a,   b,           c,   batch, m,     n,    k,
                     lda, b_col_major, ldb, sb,    split, kblk, b_gran,
                     a_gran, static_cast<cudaStream_t>(stream)};
  return launch_skinny(in_dtype, out_dtype, x);
}

// C[z] = A[z] @ B[z] for z < batch on gemm_tc_kernel (bf16 -> bf16 or fp32,
// float32 as 3xTF32; mm is batch = 1): a bm x bn output tile, a ring of
// `stages` stages, K split over `split` blocks of a cluster.  a_cp and b_cp
// name each operand's producer: 0, TMA (a 16-byte aligned base, pitch and
// batch stride); 8 or 4, cp.async copies of that many bytes (base, pitch,
// stride and the rows' length aligned to them).  Returns a cudaError_t.
int widesa_tc_launch(const void* a, const void* b, void* c, int batch, int m, int n, int k,
                     int lda, int b_col_major, int ldb, long long sb, int in_dtype,
                     int out_dtype, int bm, int bn, int stages, int split, int a_cp, int b_cp,
                     void* stream) {
  const TcArgs x{a,      b,     c,    batch, m,    n,  k,   lda, b_col_major, ldb, sb,
                 stages, split, a_cp, b_cp,  static_cast<cudaStream_t>(stream)};
  return launch_tc(in_dtype, out_dtype, bm, bn, x);
}

// C[z] = A[z] @ B[z] for z < batch in int8, int16 or int32 -> int32 on
// gemm_tc_int_kernel (mm is batch = 1): a bm x bn output tile, a ring of
// `stages` stages, K split over `split` blocks of a cluster; a_planes and
// b_planes are the [batch, rows, ktiles x 128]-byte scratch of the limb
// planes (ktiles = ceil(k x size / 128)), null where the launch reads the
// operand itself (an int8 A; an int8 column-major B).  Returns a
// cudaError_t.
int widesa_tc_int_launch(const void* a, const void* b, void* c, void* a_planes, void* b_planes,
                         int batch, int m, int n, int k, int lda, int b_col_major, int ldb,
                         long long sb, int in_dtype, int bm, int bn, int stages, int split,
                         void* stream) {
  const TcIntArgs x{a,   b,           c,   a_planes, b_planes, batch,
                    m,   n,           k,   lda,      b_col_major, ldb,
                    sb,  stages,      split, static_cast<cudaStream_t>(stream)};
  return launch_tc_int(in_dtype, bm, bn, x);
}

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
