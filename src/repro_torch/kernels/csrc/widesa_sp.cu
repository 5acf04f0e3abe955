// Hand-written Hopper (sm_90a) kernels for the WideSA signal-processing
// recurrences: the FIR filter bank and the VALID 2-D cross-correlation
// (conv2d) of the audio frontend, and the 2-D DFT (fft2d).
//
// Both read their input directly and mask ragged edges themselves: the
// reference's staging layer (src/repro/kernels/ops.py: the shifted stacks
// S[t, n] = x[n + t] and S[p*Q + q, h, w] = I[h + p, w + q], and the padding
// to the plan tiles) is not copied, so no stack of T or P*Q shifted copies is
// ever written to device memory.
//
// Arithmetic, as in csrc/widesa_mm.cu.  Float32 inputs accumulate in fp32
// (fused multiply-add, in the reduction order of the plain version: t for
// FIR, p then q for conv2d).  Integer inputs (int8, int16, int32)
// sign-extend to 32 bits and accumulate in *unsigned* 32-bit arithmetic, so
// products and sums wrap modulo 2^32 with defined behaviour: bit-exact with
// XLA's int32 wraparound.  Integer inputs give int32 output, float32 gives
// float32 (repro_torch/kernels/runtime.py: out_dtype).

#include <cooperative_groups.h>
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
template <> struct Flush<uint32_t, int32_t> {
  __device__ static int32_t cast(uint32_t v) { return (int32_t)v; }
};

constexpr int kThreads = 256;

// ---------------------------------------------------------------------------
// FIR: y[n] = sum_t x[n + t] * h[t], n < n_out, t < taps (VALID).
//
// Replaces src/repro/kernels/fir.py fir_kernel (pallas_call at :59 in
// fir_stacked), which contracts the (T, bn) block of the shifted stack that
// ops.fir writes to HBM with the taps: T x n_out elements stored and read
// back for every call.
//
// What bounds it on an H100: bytes.  The work is 2 * taps operations per
// output against 4-6 bytes moved per output (x read once, y written once):
// at taps = 15 about 5 operations per byte, far below the ~20 the CUDA cores
// need at 3.35 TB/s.  The design reads each x element from device memory
// once per block: a block of 256 threads owns BN = 256 * PER_THREAD
// consecutive outputs, stages x[n0 : n0 + BN + taps - 1] (the tile and its
// taps - 1 halo) and the taps in shared memory with coalesced loads, then
// each thread sums its outputs (n0 + tid + i * 256: neighbouring threads
// write neighbouring addresses) in t order from shared memory.  Only the
// halo, taps - 1 elements a block, is read twice.  The plan's tile
// ({n: 103} on the TPU) is not a CUDA tile: the wrapper picks BN for the
// card (repro_torch/kernels/runtime.py: fir_tile).
// ---------------------------------------------------------------------------
template <typename TIn, typename TOut, int PER_THREAD>
__global__ void __launch_bounds__(kThreads)
fir_kernel(const TIn* __restrict__ x, const TIn* __restrict__ h,
           TOut* __restrict__ y, int n_out, int taps) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int BN = kThreads * PER_THREAD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hs = reinterpret_cast<Acc*>(smem_raw);
  Acc* xs = hs + taps;

  const long long n0 = (long long)blockIdx.x * BN;
  const long long n_in = (long long)n_out + taps - 1;
  const int span = BN + taps - 1;
  for (int t = threadIdx.x; t < taps; t += kThreads) hs[t] = Elem<TIn>::load(h + t);
  for (int e = threadIdx.x; e < span; e += kThreads) {
    const long long g = n0 + e;
    xs[e] = g < n_in ? Elem<TIn>::load(x + g) : Acc(0);
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int local = threadIdx.x + i * kThreads;
    const long long n = n0 + local;
    if (n < n_out) {
      Acc acc = Acc(0);
      for (int t = 0; t < taps; ++t) acc += xs[local + t] * hs[t];
      y[n] = Flush<Acc, TOut>::cast(acc);
    }
  }
}

template <typename TIn, typename TOut, int PER_THREAD>
int fir_tile(const void* x, const void* h, void* y, int n_out, int taps,
             cudaStream_t stream) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int BN = kThreads * PER_THREAD;
  const size_t smem = (size_t)(BN + 2 * taps - 1) * sizeof(Acc);
  const dim3 grid((unsigned)((n_out + BN - 1) / BN));
  fir_kernel<TIn, TOut, PER_THREAD><<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(x), static_cast<const TIn*>(h), static_cast<TOut*>(y),
      n_out, taps);
  return (int)cudaGetLastError();
}

// The compiled FIR tiles: BN = 256 or 1024 outputs a block (kept equal to
// FIR_TILES in repro_torch/kernels/build.py).
template <typename TIn, typename TOut>
int launch_fir(int bn, const void* x, const void* h, void* y, int n_out, int taps,
               cudaStream_t stream) {
  if (bn == kThreads) return fir_tile<TIn, TOut, 1>(x, h, y, n_out, taps, stream);
  if (bn == 4 * kThreads) return fir_tile<TIn, TOut, 4>(x, h, y, n_out, taps, stream);
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// conv2d: O[r, c] = sum_{p, q} I[r + p, c + q] * F[p, q] (VALID), with
// I of (oh + P - 1) x (ow + Q - 1) and O of oh x ow, all row-major.
//
// Replaces src/repro/kernels/conv2d.py conv_kernel (pallas_call at :88 in
// conv2d_stacked), which reads the (P*Q, oh, ow) shifted-window stack that
// ops.conv2d writes to HBM (ops.py:239-261) and carries the s-axis sum in a
// VMEM accumulator from one grid step to the next.
//
// What bounds it on an H100: bytes.  2 * P * Q operations per output
// (32 at 4 x 4, 40 at the frontend's 5 x 4) against 6-8 bytes moved per
// output: at most ~6 operations per byte.  Blocks here run in parallel in no
// order, so nothing carries over between them: each block owns a BH x BW
// output tile (BW = 64 columns, BH = 4 or 16 rows), stages the input tile
// with its (P - 1, Q - 1) halo and the whole filter in shared memory
// (coalesced: consecutive threads read consecutive columns), and each thread
// loops over p and q in registers for its column of BH / 4 outputs.  No sum
// crosses a block.  The halo is the only input read twice:
// (BH + P - 1)(BW + Q - 1) / (BH BW) = 1.27 reads an element at 16 x 64 and
// 4 x 4.  Edges are masked, so the wrapper makes no padding copy.
// ---------------------------------------------------------------------------
constexpr int kConvCols = 64;
constexpr int kConvRowThreads = kThreads / kConvCols;  // 4

template <typename TIn, typename TOut, int ROWS>
__global__ void __launch_bounds__(kThreads)
conv2d_kernel(const TIn* __restrict__ img, const TIn* __restrict__ filt,
              TOut* __restrict__ out, int oh, int ow, int p, int q) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int BH = kConvRowThreads * ROWS;
  constexpr int BW = kConvCols;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* fs = reinterpret_cast<Acc*>(smem_raw);
  Acc* tile = fs + p * q;

  const int tile_h = BH + p - 1;
  const int tile_w = BW + q - 1;
  const int in_h = oh + p - 1;
  const int in_w = ow + q - 1;
  const int r0 = blockIdx.y * BH;
  const int c0 = blockIdx.x * BW;
  const int tid = threadIdx.x;

  for (int e = tid; e < p * q; e += kThreads) fs[e] = Elem<TIn>::load(filt + e);
  for (int e = tid; e < tile_h * tile_w; e += kThreads) {
    const int rr = e / tile_w, cc = e % tile_w;
    const int gr = r0 + rr, gc = c0 + cc;
    tile[e] = (gr < in_h && gc < in_w) ? Elem<TIn>::load(img + (size_t)gr * in_w + gc)
                                       : Acc(0);
  }
  __syncthreads();

  const int tx = tid % kConvCols;
  const int ty = tid / kConvCols;
  const int gc = c0 + tx;
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int r = ty + i * kConvRowThreads;
    const int gr = r0 + r;
    if (gr < oh && gc < ow) {
      Acc acc = Acc(0);
      for (int pp = 0; pp < p; ++pp) {
        const Acc* row = tile + (r + pp) * tile_w + tx;
        const Acc* frow = fs + pp * q;
        for (int qq = 0; qq < q; ++qq) acc += row[qq] * frow[qq];
      }
      out[(size_t)gr * ow + gc] = Flush<Acc, TOut>::cast(acc);
    }
  }
}

template <typename TIn, typename TOut, int ROWS>
int conv2d_tile(const void* img, const void* filt, void* out, int oh, int ow, int p, int q,
                cudaStream_t stream) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int BH = kConvRowThreads * ROWS;
  const size_t smem =
      ((size_t)p * q + (size_t)(BH + p - 1) * (kConvCols + q - 1)) * sizeof(Acc);
  const dim3 grid((unsigned)((ow + kConvCols - 1) / kConvCols), (unsigned)((oh + BH - 1) / BH));
  conv2d_kernel<TIn, TOut, ROWS><<<grid, kThreads, smem, stream>>>(
      static_cast<const TIn*>(img), static_cast<const TIn*>(filt), static_cast<TOut*>(out),
      oh, ow, p, q);
  return (int)cudaGetLastError();
}

// The compiled conv2d tiles: (BH, BW) = (4, 64) or (16, 64) (kept equal to
// CONV2D_TILES in repro_torch/kernels/build.py).
template <typename TIn, typename TOut>
int launch_conv2d(int bh, int bw, const void* img, const void* filt, void* out, int oh,
                  int ow, int p, int q, cudaStream_t stream) {
  if (bw != kConvCols) return (int)cudaErrorInvalidValue;
  if (bh == kConvRowThreads) return conv2d_tile<TIn, TOut, 1>(img, filt, out, oh, ow, p, q, stream);
  if (bh == 4 * kConvRowThreads)
    return conv2d_tile<TIn, TOut, 4>(img, filt, out, oh, ow, p, q, stream);
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// fft2d: Z = F_R X F_C, the 2-D DFT of an R x C complex grid held as float32
// real and imaginary planes, F_n the n-point DFT matrix.
//
// Replaces src/repro/kernels/fft2d.py fft2d / _cmul_mm (:34, :53), which has
// no pallas_call of its own: it lowers each of the two complex products to
// three real products on the mm kernel (widesa_mm.py, pallas_call at :92),
// k1 = Br (Ar + Ai), k2 = Ar (Bi - Br), k3 = Ai (Br + Bi), Re = k1 - k3,
// Im = k1 + k2, with the operand sums and the combinations as separate
// array operations: 6 GEMMs and ~10 elementwise passes a transform.
//
// What bounds it on an H100: bytes, of F_C.  At the frontend's 12 x 515
// (whisper-base) the work is 3 R C^2 + 3 R^2 C fp32 multiply-adds (9.8e6,
// 0.29 us at the CUDA cores' 67 TFLOP/s) against F_C's two planes, 2.12 MB,
// read once: 0.63 us at 3.35 TB/s.  At R <= 16 a 64-row wgmma would leave
// three quarters of its rows empty, so the products run as IEEE fp32 FMA on
// the CUDA cores, in the reference's three-product form.  The work is too
// small for either bound to show: a block's phases (copies, stage 1, stage
// 2, the cluster's sums) each wait out their latency, and the launch stays
// several times its bound (PERF.md).
//
// The design: one launch, nothing but Z written to device memory.
//   * A block owns a 16 x 32 tile of Z (rows m0.., columns n0..) and a range
//     of the contraction index k (the columns of Y = F_R X, the rows of F_C),
//     K split over the blocks of a cluster (at most 8) so that the small grid
//     of column tiles spreads over the card (runtime.fft2d_split: 17 tiles x
//     6 at 12 x 515, the fastest split there).  The cluster adds its partial
//     tiles through distributed shared memory in rank order, so the bits
//     repeat from run to run.
//   * Stage 1 needs no other block: the block computes the columns k of
//     Y = F_R X that its range needs, for its 16 rows, from X's columns and
//     F_R's rows in shared memory, and keeps Y there (Y, Yr + Yi beside it);
//     X is read by every column tile (0.8 MB from L2 at 12 x 515).
//   * Each pass of up to kFftChunk k issues every copy at once (cp.async:
//     F_C's rows k, 32 columns, and F_R's rows, 16 bytes a copy; X's columns,
//     4 bytes a copy, since C need not be a multiple of 4), so a block waits
//     for one round trip to device memory, not one per k.
//     The wrapper hands F_C (and F_R) in rows padded to whole 16-byte units
//     (fft2d.py: _dft_planes), which keeps the 16-byte copies legal at any C.
//     Stage 1 waits only for X and F_R; F_C's rows arrive meanwhile.
//   * The operand sums are formed on load: Br + Bi and Bi - Br of F_C as each
//     thread reads its column, Ar + Ai of F_R as stage 1 reads it, Yr + Yi
//     as Y is stored.
//   * Stage 2: a warp owns every 8th k of the pass, so a thread's chain of
//     dependent steps is 11 k long at 12 x 515, not 86; a lane owns 4 rows x
//     4 columns of the tile (48 sums in registers), so each 16-byte load of
//     Y or F_C from shared memory feeds 12 multiply-adds.  The 8 warps' sums are
//     added in warp order in shared memory.  Row groups that hold only rows
//     past R are skipped (R = 12 leaves 4 of the 16 rows empty).
//   * A split's ranks each own 1 / split of the tile: every rank writes its
//     partial of those outputs into the owner's shared memory, one cluster
//     barrier follows, and each owner adds what it holds in rank order, so
//     no block reads another's memory and none waits on a second barrier.
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

constexpr int kFftThreads = 256;                          // 8 warps
constexpr int kFftCols = 32;                              // columns of Z a block
constexpr int kFftRows = 16;                              // rows of Z a block
constexpr int kFftKGroups = kFftThreads / kFftCols;       // 8: a warp's k, in turn
constexpr int kFftChunk = 128;                            // k a pass stages
constexpr int kFftMaxRows = 64;                           // R whose X columns fit a pass
constexpr int kFftMaxCluster = 8;                         // the portable cluster size
constexpr int kFftMaxSmem = 232448;

// Floats of shared memory a block uses for R rows and passes of kc k, kc a
// multiple of 4 (the kernel's layout below; runtime.fft2d_smem counts the
// same): a pass's operands, or after the passes the k groups' sums; then
// the partial tiles the cluster's ranks send this block.
__host__ __device__ constexpr int fft_pass_floats(int nr, int kc) {
  return 2 * kc * kFftCols + 2 * nr * kc + 2 * nr * kFftRows + 3 * kc * kFftRows;
}
__host__ __device__ constexpr int fft_smem_floats(int nr, int kc) {
  return (fft_pass_floats(nr, kc) > kFftKGroups * 2 * kFftRows * kFftCols
              ? fft_pass_floats(nr, kc)
              : kFftKGroups * 2 * kFftRows * kFftCols) +
         2 * kFftRows * kFftCols + kFftMaxCluster;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Grid: (column tiles x split, row tiles), clusters of `split` blocks along x;
// block x reduces k in [rank * kblk, (rank + 1) * kblk) and owns the
// outputs [rank * chunk, (rank + 1) * chunk) of the tile's 1024.  F_R and F_C come in
// rows of pr and pc floats (whole 16-byte units, zeros past R and C).
__global__ void __launch_bounds__(kFftThreads)
fft2d_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
             const float* __restrict__ frr, const float* __restrict__ fri,
             const float* __restrict__ fcr, const float* __restrict__ fci, float* __restrict__ zr,
             float* __restrict__ zi, int nr, int nc, int pr, int pc, int split, int kblk, int kc_max) {
  extern __shared__ __align__(16) float fsm[];
  float* fs_r = fsm;                                   // [kc][32]: F_C rows k, this tile's columns
  float* fs_i = fs_r + kc_max * kFftCols;
  float* xs_r = fs_i + kc_max * kFftCols;              // [R][kc]: X's columns k
  float* xs_i = xs_r + nr * kc_max;
  float* fr_r = xs_i + nr * kc_max;                    // [R][16]: F_R^T, this tile's rows
  float* fr_i = fr_r + nr * kFftRows;
  float* y_s = fr_i + nr * kFftRows;                   // [kc][16]: Y^T, Yr + Yi
  float* y_r = y_s + kc_max * kFftRows;                //   Yr
  float* y_i = y_r + kc_max * kFftRows;                //   Yi
  // after the passes: [k group][2][16][32], each warp's sums of the tile
  float* red = fsm;
  constexpr int kTile = 2 * kFftRows * kFftCols;
  // [rank][chunk]: the outputs this block owns in a split, from each rank
  float* recv = fsm + fft_smem_floats(nr, kc_max) - kTile - kFftMaxCluster;

  const int tid = threadIdx.x;
  const int lane = tid & 31, kg = tid >> 5;  // a warp's k group
  // stage 2: a lane's 4 columns (cg) and 4 rows (rq) of the tile
  const int cg = lane & 7, rq = lane >> 3;
  const int rank = blockIdx.x % split;
  const int n0 = blockIdx.x / split * kFftCols;
  const int m0 = blockIdx.y * kFftRows;
  const int kbeg = rank * kblk, kend = min(nc, kbeg + kblk);
  const int groups = min(kFftRows, nr - m0 + 3) / 4;  // groups of 4 rows with a row < R
  // a split's blocks write into each other's shared memory only once all
  // have started: arrive here, wait before the first write
  if (split > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");

  // F_R's rows m0 .. m0 + 15, transposed: F_R is symmetric, so row r of the
  // transpose is row r of F_R, 16 bytes a copy (zeros past R)
  for (int e = tid; e < nr * (kFftRows / 4); e += kFftThreads) {
    const int r = e >> 2, m = m0 + 4 * (e & 3);
    const size_t off = m < pr ? (size_t)r * pr + m : 0;
    cp_async16(fr_r + 4 * e, frr + off, m < pr);
    cp_async16(fr_i + 4 * e, fri + off, m < pr);
  }
  float z1[4][4] = {}, z2[4][4] = {}, z3[4][4] = {};  // the lane's [row][column]
  for (int k0 = kbeg; k0 < kend; k0 += kc_max) {
    const int kc = min(kc_max, kend - k0);
    // X's columns k (4 bytes a copy) in one group, F_C's rows k (8 copies of
    // 16 bytes a plane, zeros past C) in the next: stage 1 waits only for X
    for (int r = kg; r < nr; r += kFftKGroups)
      for (int kk = lane; kk < kc; kk += 32) {
        const size_t off = (size_t)r * nc + k0 + kk;
        cp_async4(xs_r + r * kc_max + kk, xr + off, true);
        cp_async4(xs_i + r * kc_max + kk, xi + off, true);
      }
    cp_commit();
    for (int e = tid; e < kc * (kFftCols / 4); e += kFftThreads) {
      const int kk = e >> 3, seg = e & 7;
      const int n = n0 + 4 * seg;
      const size_t off = n < nc ? (size_t)(k0 + kk) * pc + n : 0;
      cp_async16(fs_r + kk * kFftCols + 4 * seg, fcr + off, n < nc);
      cp_async16(fs_i + kk * kFftCols + 4 * seg, fci + off, n < nc);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();

    // stage 1: Y[m, k] = sum_r F_R[m, r] X[r, k] for this block's rows and
    // the pass's k, a group of 4 rows and one k an item
    for (int e = tid; e < groups * kc; e += kFftThreads) {
      const int g = e / kc, kk = e - g * kc;
      float k1[4] = {}, k2[4] = {}, k3[4] = {};
#pragma unroll 4
      for (int r = 0; r < nr; ++r) {
        const float br = xs_r[r * kc_max + kk], bi = xs_i[r * kc_max + kk];
        const float d = bi - br, s = br + bi;
        const float4 a_r = *reinterpret_cast<const float4*>(fr_r + r * kFftRows + 4 * g);
        const float4 a_i = *reinterpret_cast<const float4*>(fr_i + r * kFftRows + 4 * g);
        const float vr[4] = {a_r.x, a_r.y, a_r.z, a_r.w}, vi[4] = {a_i.x, a_i.y, a_i.z, a_i.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          k1[q] = fmaf(vr[q] + vi[q], br, k1[q]);
          k2[q] = fmaf(vr[q], d, k2[q]);
          k3[q] = fmaf(vi[q], s, k3[q]);
        }
      }
      float4 yr, yi, ys;
      yr.x = k1[0] - k3[0]; yr.y = k1[1] - k3[1]; yr.z = k1[2] - k3[2]; yr.w = k1[3] - k3[3];
      yi.x = k1[0] + k2[0]; yi.y = k1[1] + k2[1]; yi.z = k1[2] + k2[2]; yi.w = k1[3] + k2[3];
      ys.x = yr.x + yi.x; ys.y = yr.y + yi.y; ys.z = yr.z + yi.z; ys.w = yr.w + yi.w;
      *reinterpret_cast<float4*>(y_r + kk * kFftRows + 4 * g) = yr;
      *reinterpret_cast<float4*>(y_i + kk * kFftRows + 4 * g) = yi;
      *reinterpret_cast<float4*>(y_s + kk * kFftRows + 4 * g) = ys;
    }
    cp_wait<0>();
    __syncthreads();

    // stage 2: Z[m, n] += sum_k Y[m, k] F_C[k, n] for the lane's 4 rows and
    // 4 columns and the warp's k (kg, kg + 8, ...)
    if (rq < groups) {
      for (int kk = kg; kk < kc; kk += kFftKGroups) {
        const float4 fr4 = *reinterpret_cast<const float4*>(fs_r + kk * kFftCols + 4 * cg);
        const float4 fi4 = *reinterpret_cast<const float4*>(fs_i + kk * kFftCols + 4 * cg);
        const float4 as = *reinterpret_cast<const float4*>(y_s + kk * kFftRows + 4 * rq);
        const float4 a_r = *reinterpret_cast<const float4*>(y_r + kk * kFftRows + 4 * rq);
        const float4 a_i = *reinterpret_cast<const float4*>(y_i + kk * kFftRows + 4 * rq);
        const float br[4] = {fr4.x, fr4.y, fr4.z, fr4.w}, bi[4] = {fi4.x, fi4.y, fi4.z, fi4.w};
        const float vs[4] = {as.x, as.y, as.z, as.w}, vr[4] = {a_r.x, a_r.y, a_r.z, a_r.w},
                    vi[4] = {a_i.x, a_i.y, a_i.z, a_i.w};
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const float d = bi[v] - br[v], s = br[v] + bi[v];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            z1[u][v] = fmaf(vs[u], br[v], z1[u][v]);
            z2[u][v] = fmaf(vr[u], d, z2[u][v]);
            z3[u][v] = fmaf(vi[u], s, z3[u][v]);
          }
        }
      }
    }
    __syncthreads();  // the next pass overwrites what this one read
  }

  // the k groups' sums, added in group order; each output then written or,
  // in a split, sent to the rank that owns it
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int at = kg * kTile + (4 * rq + u) * kFftCols + 4 * cg;
    *reinterpret_cast<float4*>(red + at) = make_float4(
        z1[u][0] - z3[u][0], z1[u][1] - z3[u][1], z1[u][2] - z3[u][2], z1[u][3] - z3[u][3]);
    *reinterpret_cast<float4*>(red + at + kFftRows * kFftCols) = make_float4(
        z1[u][0] + z2[u][0], z1[u][1] + z2[u][1], z1[u][2] + z2[u][2], z1[u][3] + z2[u][3]);
  }
  __syncthreads();
  const int chunk = (kTile + split - 1) / split;  // outputs a rank owns
  cg::cluster_group cluster = cg::this_cluster();
  if (split > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = tid; e < kTile; e += kFftThreads) {
    float sum = red[e];
#pragma unroll
    for (int q = 1; q < kFftKGroups; ++q) sum += red[q * kTile + e];
    const int plane = e / (kFftRows * kFftCols), rest = e - plane * kFftRows * kFftCols;
    const int m = m0 + rest / kFftCols, n = n0 + rest % kFftCols;
    if (split > 1) {
      const int owner = e / chunk;
      *cluster.map_shared_rank(recv + rank * chunk + e - owner * chunk, owner) = sum;
    } else if (m < nr && n < nc) {
      (plane ? zi : zr)[(size_t)m * nc + n] = sum;
    }
  }
  if (split == 1) return;
  // every rank's partial of this block's outputs has arrived: add them in
  // rank order
  cluster.sync();
  for (int slot = tid; slot < chunk; slot += kFftThreads) {
    const int e = rank * chunk + slot;
    if (e >= kTile) break;
    const int plane = e / (kFftRows * kFftCols), rest = e - plane * kFftRows * kFftCols;
    const int m = m0 + rest / kFftCols, n = n0 + rest % kFftCols;
    if (m >= nr || n >= nc) continue;
    float sum = recv[slot];
    for (int q = 1; q < split; ++q) sum += recv[q * chunk + slot];
    (plane ? zi : zr)[(size_t)m * nc + n] = sum;
  }
}

int launch_fft2d(const float* xr, const float* xi, const float* frr, const float* fri,
                 const float* fcr, const float* fci, float* zr, float* zi, int nr, int nc,
                 int split, cudaStream_t stream) {
  const int pr = (nr + 3) & ~3, pc = (nc + 3) & ~3;
  if (nr < 1 || nc < 1 || nr > kFftMaxRows || split < 1 || split > kFftMaxCluster ||
      split > nc || (reinterpret_cast<uintptr_t>(frr) | reinterpret_cast<uintptr_t>(fri) |
                     reinterpret_cast<uintptr_t>(fcr) | reinterpret_cast<uintptr_t>(fci)) % 16 != 0 ||
      (long long)nc * pc >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int kblk = (nc + split - 1) / split;
  if ((split - 1) * kblk >= nc) return (int)cudaErrorInvalidValue;  // an empty rank
  // k a pass stages, a whole number of 16-byte units (keeps every plane aligned)
  const int kc = ((kblk < kFftChunk ? kblk : kFftChunk) + 3) & ~3;
  const int smem = fft_smem_floats(nr, kc) * (int)sizeof(float);
  if (smem > kFftMaxSmem) return (int)cudaErrorInvalidValue;
  const cudaError_t allowed =
      cudaFuncSetAttribute(fft2d_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return (int)allowed;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((nc + kFftCols - 1) / kFftCols * split),
                     (unsigned)((nr + kFftRows - 1) / kFftRows), 1);
  cfg.blockDim = dim3(kFftThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fft2d_kernel, xr, xi, frr, fri, fcr, fci, zr,
                                             zi, nr, nc, pr, pc, split, kblk, kc);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// y[n] = sum_t x[n + t] h[t] for n < n_out (the fir recurrence).  Returns a
// cudaError_t.
int widesa_fir_launch(const void* x, const void* h, void* y, int n_out, int taps,
                      int in_dtype, int out_dtype, int bn, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32) return launch_fir<float, float>(bn, x, h, y, n_out, taps, s);
  if (in_dtype == I8 && out_dtype == I32) return launch_fir<int8_t, int32_t>(bn, x, h, y, n_out, taps, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_fir<int16_t, int32_t>(bn, x, h, y, n_out, taps, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_fir<int32_t, int32_t>(bn, x, h, y, n_out, taps, s);
  return (int)cudaErrorInvalidValue;
}

// O[r, c] = sum_{p,q} I[r + p, c + q] F[p, q] over an oh x ow output (the
// conv2d recurrence).  Returns a cudaError_t.
int widesa_conv2d_launch(const void* img, const void* filt, void* out, int oh, int ow, int p,
                         int q, int in_dtype, int out_dtype, int bh, int bw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32)
    return launch_conv2d<float, float>(bh, bw, img, filt, out, oh, ow, p, q, s);
  if (in_dtype == I8 && out_dtype == I32)
    return launch_conv2d<int8_t, int32_t>(bh, bw, img, filt, out, oh, ow, p, q, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_conv2d<int16_t, int32_t>(bh, bw, img, filt, out, oh, ow, p, q, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_conv2d<int32_t, int32_t>(bh, bw, img, filt, out, oh, ow, p, q, s);
  return (int)cudaErrorInvalidValue;
}

// Z = F_R X F_C (the fft2d_stage chain) on float32 planes: X (R x C, rows
// of C), F_R and F_C in rows padded to whole 16-byte units, Z (R x C); K
// split over `split` blocks of a cluster.  Returns a cudaError_t.
int widesa_fft2d_launch(const void* x_re, const void* x_im, const void* fr_re,
                        const void* fr_im, const void* fc_re, const void* fc_im, void* z_re,
                        void* z_im, int nr, int nc, int split, void* stream) {
  return launch_fft2d(static_cast<const float*>(x_re), static_cast<const float*>(x_im),
                      static_cast<const float*>(fr_re), static_cast<const float*>(fr_im),
                      static_cast<const float*>(fc_re), static_cast<const float*>(fc_im),
                      static_cast<float*>(z_re), static_cast<float*>(z_im), nr, nc, split,
                      static_cast<cudaStream_t>(stream));
}

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
