// Hand-written Hopper (sm_90a) kernels for the WideSA HPC recurrences: the
// weighted star stencils, as star_kernel (one sweep of jacobi2d or
// jacobi2d_9pt) and sweeps_kernel (several sweeps of jacobi2d_ms a launch),
// and MTTKRP, the latter as two kernels: mttkrp_tc_kernel on
// the tensor cores (float32 as 3xTF32, int8) and mttkrp_kernel on the CUDA
// cores (int16, int32, and int8 rows that allow no 4-byte copies).
//
// Arithmetic, as in csrc/widesa_mm.cu and csrc/widesa_sp.cu.  Float32
// inputs accumulate in fp32 (fused multiply-add on the CUDA cores; three
// TF32 products a product, fp32 accumulation, on the tensor cores).  Integer
// inputs (int8, int16, int32) sign-extend to 32 bits and accumulate in
// *unsigned* 32-bit arithmetic, so products and sums wrap modulo 2^32 with
// defined behaviour: arithmetic modulo 2^32 is a ring, so any order of
// summation is bit-exact with XLA's int32 einsum (the int8 tensor-core
// products are exact in s32).  Integer inputs give int32 output, float32
// gives float32 (repro_torch/kernels/runtime.py: out_dtype).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "window.cuh"

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
// Star stencils: O[r, c] = sum_s w[s] * G[r + di_s, c + dj_s] over the
// interior of a padded grid G, for the two stars of the repository, each a
// compile-time case (Star<5>: JACOBI2D_OFFSETS, radius 1; Star<9>:
// JACOBI2D_9PT_OFFSETS, radius 2), with the weights in registers.
//
// Replaces src/repro/kernels/jacobi2d.py jacobi_kernel (pallas_call at :74
// in jacobi2d_stacked), which contracts a (S, bh, bw) block of the
// shifted-point stack that ops._star2d writes to HBM (ops.py:122-126: S full
// copies of the interior, padded to the tile) with the S weights, one grid
// visit per output tile; and the host loop of ops.jacobi2d_ms (ops.py:
// 175-205), which runs one such sweep per weight row and re-embeds each
// interior into the fixed boundary ring.
//
// What bounds them on an H100: bytes.  2 * S operations per output (10 for
// the 5-point star, 18 for the 9-point one) against 5-8 bytes moved per
// output (G read once, O written once): at most ~4 operations per byte, far
// below the ~20 the CUDA cores need at 3.35 TB/s.
//
// Every point is summed in s order with one fused multiply-add a point in
// float32 (star_point), in both kernels, so a multi-sweep launch gives the
// bits of one launch a sweep.
// ---------------------------------------------------------------------------
template <int POINTS> struct Star;
template <> struct Star<5> {  // centre, N, S, W, E
  static constexpr int R = 1;
  __host__ __device__ static constexpr int di(int s) { return s == 1 ? 0 : s == 2 ? 2 : 1; }
  __host__ __device__ static constexpr int dj(int s) { return s == 3 ? 0 : s == 4 ? 2 : 1; }
};
template <> struct Star<9> {  // centre, N1, N2, S1, S2 (column 2), W1, W2, E1, E2 (row 2)
  static constexpr int R = 2;
  __host__ __device__ static constexpr int di(int s) {
    return s == 1 ? 1 : s == 2 ? 0 : s == 3 ? 3 : s == 4 ? 4 : 2;
  }
  __host__ __device__ static constexpr int dj(int s) {
    return s == 5 ? 1 : s == 6 ? 0 : s == 7 ? 3 : s == 8 ? 4 : 2;
  }
};

// Every point off the centre column lies on the middle row: the kernels keep
// the centre column in registers and read the middle row from shared memory.
template <int POINTS>
__host__ __device__ constexpr bool star_is_a_cross() {
  for (int s = 0; s < POINTS; ++s)
    if (Star<POINTS>::dj(s) != Star<POINTS>::R && Star<POINTS>::di(s) != Star<POINTS>::R)
      return false;
  return true;
}
static_assert(star_is_a_cross<5>() && star_is_a_cross<9>(), "a star off the cross");

// One output of the star, in s order: the points of the centre column come
// from col(di), rows 0 .. 2R of the window, the others from mid(dj), the
// middle row at column dj of the window.
template <int POINTS, typename Acc, typename Col, typename Mid>
__device__ __forceinline__ Acc star_point(const Acc (&w)[POINTS], Col col, Mid mid) {
  using S = Star<POINTS>;
  Acc acc = Acc(0);
#pragma unroll
  for (int s = 0; s < POINTS; ++s)
    acc = window::mac(acc, w[s], S::dj(s) == S::R ? col(S::di(s)) : mid(S::dj(s)));
  return acc;
}

// -- one sweep: star_kernel ---------------------------------------------------
//
// jacobi2d and jacobi2d_9pt.  The row streaming of csrc/window.cuh: a block
// of 4 warps owns 512 output columns (a warp 128, a lane 4 of them 32
// apart) and walks a band of `rows` output rows (runtime.star_tile picks it
// so that the grid fills the card); each input row of a warp's strip and
// its 2R halo columns lands in the warp's ring once, by 16-byte cp.async
// copies kept 16 rows ahead.  A lane keeps the centre column of the star's
// 2R + 1 rows in registers, reading each row there once as it lands, and
// reads the middle row's 2R other points from the ring.  Outputs are written as they complete, consecutive lanes to
// consecutive addresses; ragged edges are masked and no padding copy is
// made.  Device memory reads each grid row once a band plus the 2R rows the
// band below reads again (2R / rows), and each column once plus the 2R halo
// columns of a strip (1.6 % at R = 2).
// ---------------------------------------------------------------------------
constexpr int kStripCols = 128;                          // output columns a warp
constexpr int kLaneCols = kStripCols / window::kLanes;   // 4, 32 apart
constexpr int kStarBlockCols = window::kWarps * kStripCols;  // 512

template <typename TIn, typename TOut, int POINTS>
__global__ void __launch_bounds__(window::kThreads)
star_kernel(const TIn* __restrict__ grid, const typename Elem<TIn>::Acc* __restrict__ weights,
            TOut* __restrict__ out, int oh, int ow, int rows) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int R = Star<POINTS>::R;
  constexpr int H = 2 * R + 1;
  constexpr int D = window::kPrefetchRows;
  constexpr int NSLOT = R + D + 1;  // the middle row, the row landing, D in flight
  constexpr int SLOT = window::slot_bytes<TIn, kStripCols + 2 * R>();
  __shared__ __align__(16) unsigned char ring[window::kWarps][NSLOT][SLOT];

  const int warp = threadIdx.x / window::kLanes;
  const int lane = threadIdx.x % window::kLanes;
  const int c0 = (blockIdx.x * window::kWarps + warp) * kStripCols;
  if (c0 >= ow) return;
  const int in_w = ow + 2 * R;
  const int r0 = blockIdx.y * rows;
  const int n_in = min(rows, oh - r0) + 2 * R;
  const int seg = min(kStripCols + 2 * R, in_w - c0);
  const window::Ring<TIn, NSLOT, SLOT> rows_in{ring[warp], grid + (size_t)r0 * in_w + c0, in_w,
                                                seg, n_in, lane};

  Acc w[POINTS];
#pragma unroll
  for (int s = 0; s < POINTS; ++s) w[s] = weights[s];
#pragma unroll
  for (int i = 0; i < D; ++i) rows_in.fetch(i);
  Acc col[H][kLaneCols];
#pragma unroll
  for (int k = 0; k < H; ++k)
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) col[k][j] = Acc(0);

  for (int i = 0; i < n_in; ++i) {
    // the slot of row i + D last held row i - R - 1, read before the
    // __syncwarp() that ended the previous row
    rows_in.fetch(i + D);
    rows_in.template land<D>();
    const TIn* row = rows_in.row(i);
#pragma unroll
    for (int j = 0; j < kLaneCols; ++j) {
#pragma unroll
      for (int k = 0; k + 1 < H; ++k) col[k][j] = col[k + 1][j];
      col[H - 1][j] = Elem<TIn>::load(row + lane + window::kLanes * j + R);
    }
    if (i >= 2 * R) {
      const TIn* mid = rows_in.row(i - R);
      TOut* o = out + (size_t)(r0 + i - 2 * R) * ow + c0;
#pragma unroll
      for (int j = 0; j < kLaneCols; ++j) {
        const int c = lane + window::kLanes * j;
        if (c0 + c < ow)
          o[c] = Flush<Acc, TOut>::cast(star_point<POINTS>(
              w, [&](int di) { return col[di][j]; },
              [&](int dj) { return Elem<TIn>::load(mid + c + dj); }));
      }
    }
    __syncwarp();
  }
}

template <typename TIn, typename TOut, int POINTS>
int star_points(const void* grid, const void* weights, void* out, int oh, int ow, int rows,
                cudaStream_t stream) {
  using Acc = typename Elem<TIn>::Acc;
  const dim3 grid_dim((unsigned)((ow + kStarBlockCols - 1) / kStarBlockCols),
                      (unsigned)((oh + rows - 1) / rows));
  star_kernel<TIn, TOut, POINTS><<<grid_dim, window::kThreads, 0, stream>>>(
      static_cast<const TIn*>(grid), static_cast<const Acc*>(weights), static_cast<TOut*>(out),
      oh, ow, rows);
  return (int)cudaGetLastError();
}

// The compiled stars: 5 and 9 points (kept equal to STAR_POINTS in
// repro_torch/kernels/build.py).
template <typename TIn, typename TOut>
int launch_star(int points, const void* grid, const void* weights, void* out, int oh, int ow,
                int rows, cudaStream_t stream) {
  if (rows < 1 || oh < 1 || ow < 1) return (int)cudaErrorInvalidValue;
  if (points == 5)
    return star_points<TIn, TOut, 5>(grid, weights, out, oh, ow, rows, stream);
  if (points == 9)
    return star_points<TIn, TOut, 9>(grid, weights, out, oh, ow, rows, stream);
  return (int)cudaErrorInvalidValue;
}

// -- several sweeps a launch: sweeps_kernel -----------------------------------
//
// jacobi2d_ms: `sweeps` (T_b) weighted 5-point sweeps of an h x w state in
// one launch, sweep k with weight row k, inside the fixed boundary ring.  A
// block of 512 threads owns a 64 x 128 tile of the state and loads it with
// a T_b-wide halo into shared memory (the grid's own dtype, promoted as it
// loads; zeros past the grid), then runs the T_b sweeps there, ping-pong
// between two buffers: sweep k computes the tile grown by T_b - k on each
// side, which reads only what sweep k - 1 computed.  A point on the grid's
// outer ring keeps its value in every sweep (the Dirichlet ring of
// ops.jacobi2d_ms), so the ring is exact wherever a tile meets it, and no
// interior point reads past the grid; a tile whose halo lies inside the
// ring (all but the grid's edge tiles) tests no point.  After the last
// sweep the block writes its tile, consecutive threads to consecutive
// addresses: the interior of the state into `dst` (oh x ow) on the last
// launch of a call, else the whole state, ring included, into a buffer of
// the state's shape that the next launch reads.
//
// Device memory moves the grid in and the result out once a launch (plus
// the halos, read again from L2) instead of once a sweep.  What bounds the
// launch is the sweeps in shared memory: each thread owns 4 consecutive
// columns (a quad) of a band of rows, reads a row's quad as one 16-byte
// load and its two outer neighbours as two 4-byte ones, keeps the star's
// centre column for three rows in registers as the band slides down, and
// stores the quad's 4 new points as one 16-byte store: 2.5 words of shared
// memory a point a sweep, 5 fused multiply-adds.  The halo's sweeps cost
// (64 + T_b)(128 + T_b) / (64 x 128) - 1 more points, 17 % at T_b = 8
// (runtime.sweep_tile picks T_b).
// ---------------------------------------------------------------------------
constexpr int kSweepRows = 64;     // BH
constexpr int kSweepCols = 128;    // BW
constexpr int kMaxSweeps = 8;      // T_b at most
constexpr int kSweepThreads = 512;
constexpr int kSweepQuads = (kSweepCols + 2 * kMaxSweeps) / 4;  // 36: quads of the widest row
constexpr int kSweepBands = kSweepThreads / kSweepQuads;        // 14 bands of rows
static_assert(kSweepCols % 4 == 0 && kSweepBands >= 1, "sweep tile");

// A row of the tile in shared memory: 4 columns of padding, the tile's
// columns rounded up to whole quads, and 4 more, so that a quad's outer
// neighbours (columns -1 and +4) never leave the row.
__host__ __device__ constexpr int sweep_pitch(int sweeps) {
  return (kSweepCols + 2 * sweeps + 3) / 4 * 4 + 8;
}
__host__ __device__ constexpr int sweep_smem(int sweeps) {
  return 2 * (kSweepRows + 2 * sweeps) * sweep_pitch(sweeps) * 4;
}

template <typename Acc>
__device__ __forceinline__ void lds4(const Acc* p, Acc (&v)[4]) {
  using Acc4 = std::conditional_t<std::is_same<Acc, float>::value, float4, uint4>;
  const Acc4 q = *reinterpret_cast<const Acc4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

template <typename Acc>
__device__ __forceinline__ void sts4(Acc* p, const Acc (&v)[4]) {
  using Acc4 = std::conditional_t<std::is_same<Acc, float>::value, float4, uint4>;
  *reinterpret_cast<Acc4*>(p) = Acc4{v[0], v[1], v[2], v[3]};
}

// One sweep of the quad at column c (tile coordinates) of row r, from `in`
// into `out` (rows of `pitch`, column 0 at element 4): up, mid and down
// hold the quad at rows r - 1, r and r + 1, and down is loaded here.
// EDGE: the tile meets the grid's ring or edge, so each point tests
// whether it is interior (grid row gr0 + r, column gc0 + c + e).
template <bool EDGE, typename Acc>
__device__ __forceinline__ void sweep_row(const Acc* __restrict__ in, Acc* __restrict__ out,
                                          int pitch, int r, int c, const Acc (&wk)[5],
                                          const Acc (&up)[4], const Acc (&mid)[4],
                                          Acc (&down)[4], int gr0, int gc0, int h, int w) {
  const Acc* row = in + r * pitch + 4 + c;
  lds4(row + pitch, down);
  const Acc west = row[-1], east = row[4];
  Acc v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    v[e] = star_point<5>(
        wk, [&](int di) { return di == 0 ? up[e] : di == 1 ? mid[e] : down[e]; },
        [&](int dj) {
          const int x = e + dj - 1;  // the middle row's column in the quad
          return x < 0 ? west : x > 3 ? east : mid[x & 3];
        });
    if (EDGE) {
      const int gr = gr0 + r, gc = gc0 + c + e;
      if (gr < 1 || gr > h - 2 || gc < 1 || gc > w - 2) v[e] = mid[e];
    }
  }
  sts4(out + r * pitch + 4 + c, v);
}

// One sweep over the rows [r_lo, r_hi) of the quad at column c: the star's
// centre column slides down through three register quads, which take
// turns as the row above, the row and the row below.
template <bool EDGE, typename Acc>
__device__ __forceinline__ void sweep_band(const Acc* __restrict__ in, Acc* __restrict__ out,
                                           int pitch, int r_lo, int r_hi, int c,
                                           const Acc (&wk)[5], int gr0, int gc0, int h, int w) {
  Acc q0[4], q1[4], q2[4];
  lds4(in + (r_lo - 1) * pitch + 4 + c, q0);
  lds4(in + r_lo * pitch + 4 + c, q1);
  int r = r_lo;
  for (; r + 3 <= r_hi; r += 3) {
    sweep_row<EDGE>(in, out, pitch, r, c, wk, q0, q1, q2, gr0, gc0, h, w);
    sweep_row<EDGE>(in, out, pitch, r + 1, c, wk, q1, q2, q0, gr0, gc0, h, w);
    sweep_row<EDGE>(in, out, pitch, r + 2, c, wk, q2, q0, q1, gr0, gc0, h, w);
  }
  if (r < r_hi) sweep_row<EDGE>(in, out, pitch, r, c, wk, q0, q1, q2, gr0, gc0, h, w);
  if (r + 1 < r_hi) sweep_row<EDGE>(in, out, pitch, r + 1, c, wk, q1, q2, q0, gr0, gc0, h, w);
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(kSweepThreads)
sweeps_kernel(const TIn* __restrict__ src, const typename Elem<TIn>::Acc* __restrict__ weights,
              TOut* __restrict__ dst, int h, int w, int sweeps, int last) {
  using Acc = typename Elem<TIn>::Acc;
  extern __shared__ __align__(16) unsigned char sweep_raw[];
  const int th = kSweepRows + 2 * sweeps;  // the tile and its halo
  const int tw = kSweepCols + 2 * sweeps;
  const int pitch = sweep_pitch(sweeps);
  Acc* const buf0 = reinterpret_cast<Acc*>(sweep_raw);
  Acc* const buf1 = buf0 + th * pitch;
  const int gr0 = blockIdx.y * kSweepRows - sweeps;  // the tile's corner on the grid
  const int gc0 = blockIdx.x * kSweepCols - sweeps;
  const int warp = threadIdx.x / window::kLanes;
  const int lane = threadIdx.x % window::kLanes;
  constexpr int kWarps = kSweepThreads / window::kLanes;

  // the tile and its halo, every load of a thread in flight at once
  constexpr int kLoadRows = (kSweepRows + 2 * kMaxSweeps + kWarps - 1) / kWarps;        // 5
  constexpr int kLoadCols = (kSweepCols + 2 * kMaxSweeps + window::kLanes - 1) / window::kLanes;  // 5
  Acc staged[kLoadRows][kLoadCols];
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) {
    const int r = warp + kWarps * i, gr = gr0 + r;
#pragma unroll
    for (int j = 0; j < kLoadCols; ++j) {
      const int c = lane + window::kLanes * j, gc = gc0 + c;
      staged[i][j] = r < th && c < tw && gr >= 0 && gr < h && gc >= 0 && gc < w
                         ? Elem<TIn>::load(src + (size_t)gr * w + gc)
                         : Acc(0);
    }
  }
#pragma unroll
  for (int i = 0; i < kLoadRows; ++i) {
    const int r = warp + kWarps * i;
#pragma unroll
    for (int j = 0; j < kLoadCols; ++j) {
      const int c = lane + window::kLanes * j;
      if (r < th && c < tw) buf0[r * pitch + 4 + c] = staged[i][j];
    }
  }
  __syncthreads();

  // this thread's quad (columns 4 q .. 4 q + 3 of the tile) and band
  const int quad = threadIdx.x % kSweepQuads;
  const int band = threadIdx.x / kSweepQuads;
  const bool edge = gr0 < 1 || gc0 < 1 || gr0 + th > h - 1 || gc0 + tw > w - 1;
  for (int k = 1; k <= sweeps; ++k) {
    const Acc* in = k & 1 ? buf0 : buf1;  // sweep k reads sweep k - 1's buffer
    Acc* next = k & 1 ? buf1 : buf0;
    Acc wk[5];
#pragma unroll
    for (int s = 0; s < 5; ++s) wk[s] = weights[(k - 1) * 5 + s];
    // sweep k's region: rows [k, th - k) and the quads over columns
    // [k, tw - k); a quad's columns outside it are computed too, from
    // values no later sweep reads
    const int rows = (th - 2 * k + kSweepBands - 1) / kSweepBands;
    const int r_lo = k + band * rows;
    const int r_hi = min(r_lo + rows, th - k);
    const int c = 4 * quad;
    if (band < kSweepBands && r_lo < r_hi && c + 4 > k && c < tw - k) {
      if (edge)
        sweep_band<true>(in, next, pitch, r_lo, r_hi, c, wk, gr0, gc0, h, w);
      else
        sweep_band<false>(in, next, pitch, r_lo, r_hi, c, wk, gr0, gc0, h, w);
    }
    __syncthreads();
  }

  // the tile, rows and columns [sweeps, sweeps + 64 / 128), to device memory
  const Acc* fin = sweeps & 1 ? buf1 : buf0;
  for (int r = sweeps + warp; r < sweeps + kSweepRows; r += kWarps) {
    const int gr = gr0 + r;
    if (gr >= h) break;
    for (int c = sweeps + lane; c < sweeps + kSweepCols; c += window::kLanes) {
      const int gc = gc0 + c;
      if (gc >= w) break;
      const TOut v = Flush<Acc, TOut>::cast(fin[r * pitch + 4 + c]);
      if (!last)
        dst[(size_t)gr * w + gc] = v;
      else if (gr >= 1 && gr <= h - 2 && gc >= 1 && gc <= w - 2)
        dst[(size_t)(gr - 1) * (w - 2) + gc - 1] = v;
    }
  }
}

template <typename TIn, typename TOut>
int launch_sweeps(const void* src, const void* weights, void* dst, int h, int w, int sweeps,
                  int last, cudaStream_t stream) {
  using Acc = typename Elem<TIn>::Acc;
  if (sweeps < 1 || sweeps > kMaxSweeps || h < 3 || w < 3) return (int)cudaErrorInvalidValue;
  const int smem = sweep_smem(sweeps);
  const cudaError_t allowed = cudaFuncSetAttribute(
      sweeps_kernel<TIn, TOut>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return (int)allowed;
  const dim3 grid_dim((unsigned)((w + kSweepCols - 1) / kSweepCols),
                      (unsigned)((h + kSweepRows - 1) / kSweepRows));
  sweeps_kernel<TIn, TOut><<<grid_dim, kSweepThreads, smem, stream>>>(
      static_cast<const TIn*>(src), static_cast<const Acc*>(weights), static_cast<TOut*>(dst), h,
      w, sweeps, last);
  return (int)cudaGetLastError();
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

// ---------------------------------------------------------------------------
// MTTKRP on the tensor cores: M[i, j] = sum_{k, l} X[i, k, l] * B[k, j] *
// C[l, j] for float32 (3xTF32) and integer operands (int8, and int16 / int32
// as int8 limbs) (mttkrp_tc_kernel).
//
// Replaces src/repro/kernels/mttkrp.py mttkrp_kernel (pallas_call at :94);
// rows of X or B that allow no 4-byte copies (int8 L % 4 != 0, int16 L odd)
// and C tiles past the shared memory keep mttkrp_kernel above.
// repro_torch/kernels/runtime.py (mttkrp_tile) picks the kernel from the
// dtype and the shape before the launch.
//
// What bounds it on an H100: operations.  2 I J K L of them (2.147e11 at
// 4096 x 400 x 256 x 256) against X's I K L elements read once (1.07 GB in
// float32, 0.32 ms at 3.35 TB/s; 0.27 GB in int8, 0.08 ms).  In float32 each
// product is three TF32 products on the tensor cores (3 x 2.147e11 at 495
// TFLOP/s: 1.30 ms; IEEE FMA on the CUDA cores would take 3.2 ms at the
// least), in int8 one int8 product (0.11 ms at 1979 TOP/s), in int16 four
// and in int32 ten (0.43 and 1.09 ms; X's 0.54 and 1.07 GB read once: 0.16
// and 0.32 ms).
//
// The design.
//   * The two-step form, fused.  For each k the block computes T_k =
//     X[i-tile, k, :] @ C[:, j-tile] on the tensor cores, then adds B[k, j]
//     T_k[i, j] to its accumulators in registers, each column scaled by its
//     B value.  X's rows along l are contiguous, so X is a row-major A
//     operand; C's tile is the same for every k, so the block stages it once
//     and keeps it in shared memory for its lifetime.  No Khatri-Rao operand
//     is built; nothing but M is written to device memory.
//   * wgmma.  Each warpgroup (4 warps) owns 64 rows of the tile and runs
//     wgmma.m64n80: A (X) from registers, loaded from the ring by the warps
//     themselves, B (C's tile) from shared memory, where the block stores it
//     transposed as the K-major core matrices (8 columns x 16 bytes of l)
//     that a descriptor without swizzle names.
//   * Arithmetic.  int8 runs m64n80k32 s8 x s8 -> s32, exact: |T_k| <= L 2^14
//     < 2^31 (the launcher keeps L < 2^17); the scale-and-add wraps in
//     unsigned 32-bit arithmetic, so M is bit-exact with the int32 reference
//     at every shape.  float32 runs m64n80k8 on TF32 operands with fp32
//     accumulation as hi*hi + hi*lo + lo*hi, the small terms first: each
//     operand x is split as hi = rna_tf32(x) (tf32_rna below, the rounding
//     of cvt.rna.tf32.f32 in two integer operations) and lo = x - hi, exact
//     in fp32, which the tensor cores read truncated to TF32; a product keeps
//     about 2^-21 |x c| of error.  C's tile is held as hi and lo, X is split
//     in registers.
//   * int16 and int32 as int8 limbs.  x = sum_p 2^(8p) x_p with the top limb
//     signed (.s8) and the lower ones unsigned (.u8): 2 limbs in int16, 4 in
//     int32.  T_k = sum_{p+q<4} 2^(8(p+q)) X_p C_q modulo 2^32: 4 products in
//     int16 (shifts 0, 8, 8, 16) and 10 in int32 (each pair with p + q >= 4
//     vanishes modulo 2^32), each a wgmma m64n80k32 with the .s8/.u8 types
//     its limbs need.  The products of one shift share one accumulator set,
//     folded into T_k in wrapping uint32 (int16: 3 sets, folded once T_k is
//     whole; int32 below); the scale-and-add then runs with B whole, as in
//     int8, so M is bit-exact.  A set's s32 sum stays inside int32 at every L the
//     launcher admits (L < 2^15 in int16, 2^13 in int32: at most 4 terms of
//     255^2 an l), so nothing depends on how wgmma overflows.  The warps cut
//     the limbs out of the ring's values with byte permutes (prmt): a thread's
//     8 values of a row for one product sit in one 16- or 32-byte run.  C's
//     tile is staged once as one plane a limb, each laid out as int8's.
//     int32 runs its four shift groups one after another into two sets in
//     turn, each folded into T_k as it completes, so every product of a
//     step is done before the next step's limbs are cut: a set a shift (160
//     registers besides M's 40) spilled and measured slower (PERF.md).
//   * X streams through a 3-stage ring of cp.async copies: a stage holds
//     128 bytes of l (32 float32 or 128 int8 values) of each of the tile's
//     128 rows at one k, copied 16 bytes at a time where X's rows allow it
//     (4 otherwise), neighbouring threads on neighbouring runs, with zero
//     fill past I and past L.  A product consumes 32 bytes of l; the A
//     fragments' k slots are permuted so that a thread's two values of a
//     row are adjacent (one 8-byte shared load, rows padded by 32 bytes
//     against bank conflicts), and C's tile is stored in the same order.
//     Each product's A registers stay untouched until its wgmma group has
//     completed: two register sets alternate, one group in flight.  B's row
//     k comes with k's first stage, by cp.async into one of 4 slots, so the
//     scale at k's end waits on no load (in int8 a k is only 2 stages).
//   * Tile and grid.  A block of 2 warpgroups owns a 128 x 80 output tile;
//     BJ = 80 divides J = 400, and the 5 column tiles of a row tile are
//     consecutive blocks, which share X through L2.  One block fills an SM
//     (C's tile is 160 KB of shared memory in float32, T_k and the
//     accumulators 80 registers a thread), so the 160 tiles at 4096 x 400
//     would be 1.2 waves of 132: K is split over the blocks of a
//     thread-block cluster (8 there; runtime.mttkrp_split), and the cluster
//     adds its partial tiles through distributed shared memory in rank
//     order, so the bits repeat from run to run.
//
// What holds it back on an H100 (chip_smoke.py --mttkrp-sweep; PERF.md): in
// float32 the three products a product, in int16 and int32 the limb
// products, and in every dtype X's five reads through L2, one a column
// tile.
// ---------------------------------------------------------------------------
namespace cg = cooperative_groups;

constexpr int kTcThreads = 256;                       // 2 warpgroups
constexpr int kTcRows = 128;                          // BI: 64 rows a warpgroup
constexpr int kTcCols = 80;                           // BJ: the wgmma's N
constexpr int kTcChunk = 128;                         // bytes of l a ring stage holds
constexpr int kTcStep = 32;                           // bytes of l a float32 or int8 product consumes
constexpr int kTcPad = 32;                            // bytes padding an X row of a stage
constexpr int kTcPitch = kTcChunk + kTcPad;           // 160
constexpr int kTcStages = 3;
constexpr int kTcStageBytes = kTcRows * kTcPitch;     // 20480
constexpr int kTcBSlots = 4;                          // rows of B the block holds, k by k
constexpr int kTcMaxCluster = 8;                      // the portable cluster size
constexpr int kTcMaxSmem = 232448;
static_assert(kTcRows * kTcCols * 4 <= kTcStages * kTcStageBytes,
              "the partial tile reuses the ring");

// Bytes of C's tile in shared memory: 80 columns of L rounded up to whole
// stages, as two float32 planes (hi and lo) or, for an integer, one plane of
// bytes a limb, which together hold as many bytes as the values
// (runtime.mttkrp_smem counts the same, with the ring and B's slots).
__host__ __device__ constexpr long long tc_cbytes(long long row_bytes, bool f32) {
  return (f32 ? 2 : 1) * kTcCols * ((row_bytes + kTcChunk - 1) / kTcChunk * kTcChunk);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One asynchronous copy of BYTES (16 or 4) into shared memory; nothing is
// read and zeros are written when !valid.
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

__device__ __forceinline__ uint2 lds64(const unsigned char* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// The TF32 value nearest to the float32 with these bits, ties away from zero
// (cvt.rna.tf32.f32 for every finite value whose rounding stays finite): add
// half a unit of TF32's last place to the magnitude, clear the 13 bits below.
__device__ __forceinline__ uint32_t tf32_rna(uint32_t bits) {
  return (bits + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi the TF32 value nearest x, lo = x - hi exactly (at most
// 2^-11 |x|).  A .tf32 operand's low 13 bits are ignored by the tensor
// cores, so lo enters its product truncated to TF32, within 2^-21 |x|.
__device__ __forceinline__ void split_tf32(uint32_t x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = __float_as_uint(__uint_as_float(x) - __uint_as_float(hi));
}

// The descriptor of a K-major shared-memory operand without swizzle: core
// matrices of 8 rows x 16 bytes, `lbo` bytes apart along K and `sbo` bytes
// apart along the rows.
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, unsigned lbo, unsigned sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
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

// Keep the compiler from moving reads or writes of registers that a wgmma
// in flight reads or writes across this point.
template <typename T, int N>
__device__ __forceinline__ void fence_regs(T (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if constexpr (std::is_same<T, float>::value)
      asm volatile("" : "+f"(r[i])::"memory");
    else
      asm volatile("" : "+r"(r[i])::"memory");
  }
}

// D (64 x 80, 40 values a thread) += A (64 x 8 TF32, this warp's 16 rows in
// registers) * B (8 x 80 TF32 at desc), or D = A * B when !accumulate.
__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// The same for int8 operands: A 64 x 32, B 32 x 80, s32 sums; A and B each
// signed (.s8) or unsigned (.u8) bytes, as SA and SB say.
#define WIDESA_WGMMA_I8(TYPES)                                                                   \
  asm volatile(                                                                                  \
      "{\n"                                                                                      \
      ".reg .pred p;\n"                                                                          \
      "setp.ne.b32 p, %45, 0;\n"                                                                 \
      "wgmma.mma_async.sync.aligned.m64n80k32.s32." TYPES " "                                    \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "   \
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "    \
      "%36, %37, %38, %39}, "                                                                    \
      "{%40, %41, %42, %43}, %44, p;\n"                                                          \
      "}\n"                                                                                      \
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),      \
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), \
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),           \
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),           \
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),           \
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]),           \
        "+r"(d[38]), "+r"(d[39])                                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate))

template <bool SA, bool SB>
__device__ __forceinline__ void wgmma_i8(int (&d)[40], const uint32_t (&a)[4], uint64_t desc,
                                         int accumulate) {
  if constexpr (SA && SB)
    WIDESA_WGMMA_I8("s8.s8");
  else if constexpr (SA)
    WIDESA_WGMMA_I8("s8.u8");
  else if constexpr (SB)
    WIDESA_WGMMA_I8("u8.s8");
  else
    WIDESA_WGMMA_I8("u8.u8");
}
#undef WIDESA_WGMMA_I8

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// Register e of a thread's A fragment for one product, in each limb (module
// note): v holds the fragment's 4 values (row g + 8 (e & 1), l = 8 t + 4 (e
// >> 1) .. + 3 of the product's 32), kSize bytes each; limb p's register e
// is a[4 p + e], byte p of each value.
template <int kSize>
__device__ __forceinline__ void cut_limbs(const uint32_t (&v)[kSize], uint32_t (&a)[4 * kSize],
                                          int e) {
  if constexpr (kSize == 1) {
    a[e] = v[0];
  } else if constexpr (kSize == 2) {
    a[e] = prmt(v[0], v[1], 0x6420);      // low bytes
    a[4 + e] = prmt(v[0], v[1], 0x7531);  // high bytes
  } else {
    // a 4 x 4 byte transpose: limb p gets byte p of each of the 4 values
    const uint32_t x = prmt(v[0], v[1], 0x5140), y = prmt(v[0], v[1], 0x7362);
    const uint32_t z = prmt(v[2], v[3], 0x5140), w = prmt(v[2], v[3], 0x7362);
    a[e] = prmt(x, z, 0x5410);
    a[4 + e] = prmt(x, z, 0x7632);
    a[8 + e] = prmt(y, w, 0x5410);
    a[12 + e] = prmt(y, w, 0x7632);
  }
}

// N 32-bit words from shared memory in one load (N = 1, 2 or 4).
template <int N>
__device__ __forceinline__ void lds_words(const unsigned char* p, uint32_t (&v)[N]) {
  if constexpr (N == 1) {
    v[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (N == 2) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    v[0] = w.x;
    v[1] = w.y;
  } else {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    v[0] = w.x;
    v[1] = w.y;
    v[2] = w.z;
    v[3] = w.w;
  }
}

// One product of limb P of X (A) by limb Q of C's tile (the plane at desc),
// into the accumulator set of its shift P + Q; the top limb (LIMBS - 1) is
// signed.  The first product of a set in T_k's first step starts it afresh.
template <int LIMBS, int P, int Q>
__device__ __forceinline__ void limb_product(int (&part)[LIMBS == 1 ? 1 : (LIMBS == 2 ? 3 : 4)][40],
                                             const uint32_t (&a)[4 * LIMBS], uint64_t desc,
                                             unsigned plane_units, int accumulate) {
  if constexpr (P + Q < 4) {
    constexpr int kFirst = P + Q > LIMBS - 1 ? P + Q - (LIMBS - 1) : 0;  // the set's first P
    const uint32_t ap[4] = {a[4 * P], a[4 * P + 1], a[4 * P + 2], a[4 * P + 3]};
    wgmma_i8<P == LIMBS - 1, Q == LIMBS - 1>(part[P + Q], ap, desc + (uint64_t)Q * plane_units,
                                             P == kFirst ? accumulate : 1);
  }
}

template <int LIMBS, int P = 0, int Q = 0>
__device__ __forceinline__ void limb_products(
    int (&part)[LIMBS == 1 ? 1 : (LIMBS == 2 ? 3 : 4)][40], const uint32_t (&a)[4 * LIMBS],
    uint64_t desc, unsigned plane_units, int accumulate) {
  if constexpr (P < LIMBS) {
    limb_product<LIMBS, P, Q>(part, a, desc, plane_units, accumulate);
    if constexpr (Q + 1 < LIMBS)
      limb_products<LIMBS, P, Q + 1>(part, a, desc, plane_units, accumulate);
    else
      limb_products<LIMBS, P + 1, 0>(part, a, desc, plane_units, accumulate);
  }
}

// The products of one shift G (limbs P and G - P) into the accumulator set
// d, started afresh: int32's groups run one after another (module note).
template <int LIMBS, int G, int P = 0>
__device__ __forceinline__ void limb_group(int (&d)[40], const uint32_t (&a)[4 * LIMBS],
                                           uint64_t desc, unsigned plane_units) {
  if constexpr (P < LIMBS && P <= G) {
    if constexpr (G - P < LIMBS) {
      constexpr int kFirst = G > LIMBS - 1 ? G - (LIMBS - 1) : 0;
      const uint32_t ap[4] = {a[4 * P], a[4 * P + 1], a[4 * P + 2], a[4 * P + 3]};
      wgmma_i8<P == LIMBS - 1, G - P == LIMBS - 1>(d, ap, desc + (uint64_t)(G - P) * plane_units,
                                                   P == kFirst ? 0 : 1);
    }
    limb_group<LIMBS, G, P + 1>(d, a, desc, plane_units);
  }
}

// t += d << shift, modulo 2^32.
__device__ __forceinline__ void fold_set(uint32_t (&t)[40], const int (&d)[40], int shift) {
#pragma unroll
  for (int e = 0; e < 40; ++e) t[e] += (uint32_t)d[e] << shift;
}

// Grid: (row tiles x column tiles x split), clusters of `split` blocks along
// x; block x reduces k in [rank * kblk, (rank + 1) * kblk) of tile x / split,
// the column tiles of a row tile consecutive.  CP is the copy width of X.
template <typename TIn, typename TOut, int CP>
__global__ void __launch_bounds__(kTcThreads, 1)
mttkrp_tc_kernel(const TIn* __restrict__ x, const TIn* __restrict__ b, const TIn* __restrict__ c,
                 TOut* __restrict__ m, int ni, int nj, int nk, int nl, int split, int kblk) {
  constexpr bool kF32 = std::is_same<TIn, float>::value;
  using Acc = typename Elem<TIn>::Acc;                             // float, or uint32_t
  constexpr int kSize = (int)sizeof(TIn);
  constexpr int kLimbs = kF32 ? 1 : kSize;                         // int8 limbs of a value
  constexpr int kPlanes = kF32 ? 2 : kLimbs;                       // of C's tile: hi, lo / a limb
  // int32 runs its four shift groups one after another into two sets in
  // turn, each folded into T_k as it completes; int16 keeps a set a shift
  constexpr bool kFoldEach = kLimbs == 4;
  constexpr int kSets = kF32 || kLimbs == 1 ? 1 : (kLimbs == 2 ? 3 : 2);  // of T_k's sums
  constexpr int kStep = kF32 ? kTcStep : kTcStep * kSize;          // bytes of l a product
  constexpr int kARegs = kF32 ? 4 : 4 * kLimbs;                    // A registers a product
  constexpr int kASets = kFoldEach ? 1 : 2;                        // A register sets in turn
  constexpr int kSegs = kTcChunk / CP;                             // copies a row of a stage
  static_assert(kTcRows * kSegs % kTcThreads == 0, "a stage does not split over the block");
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x % split;
  const int tile = blockIdx.x / split;
  const int ncols = (nj + kTcCols - 1) / kTcCols;
  const int i0 = tile / ncols * kTcRows;
  const int j0 = tile % ncols * kTcCols;
  const int kbeg = rank * kblk;
  const int kend = min(nk, kbeg + kblk);
  const int row_bytes = nl * kSize;
  const int nchunks = (row_bytes + kTcChunk - 1) / kTcChunk;
  const int nstages = (kend - kbeg) * nchunks;
  // C's tile: columns j of lbytes bytes (l values past L are zeros) a plane,
  // as core matrices (8 columns x 16 bytes) running along l, sbo bytes a
  // group of 8 columns; float32 as hi, then lo, an integer a plane a limb
  const int lvals = nchunks * kTcChunk / kSize;
  const int lbytes = kF32 ? lvals * 4 : lvals;
  const int sbo = lbytes * 8;
  const int cbytes = kTcCols * lbytes;

  unsigned char* ct = smem;
  unsigned char* ring = smem + kPlanes * cbytes;
  // B[k, j0 .. j0 + 79], slot (k - kbeg) % kTcBSlots, for the scale at k's end
  TIn* bs = reinterpret_cast<TIn*>(ring + kTcStages * kTcStageBytes);
  const unsigned ring_addr = smem_addr(ring);
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  // stage s: X[i0 .. i0 + 127, k, chunk bytes] with k = kbeg + s / nchunks;
  // the first stage of a k also brings B's row k, 4 bytes a copy (the
  // launcher checks that B's rows are 4-byte aligned)
  auto load_stage = [&](int s) {
    const int k = kbeg + s / nchunks;
    const int off = s % nchunks * kTcChunk;
    const unsigned slot = ring_addr + s % kTcStages * kTcStageBytes;
#pragma unroll
    for (int p = 0; p < kTcRows * kSegs / kTcThreads; ++p) {
      const int q = tid + p * kTcThreads;
      const int r = q / kSegs, seg = q % kSegs;
      const int gi = i0 + r, byte = off + seg * CP;
      const bool ok = gi < ni && byte < row_bytes;
      const unsigned char* src = ok ? xb + ((size_t)gi * nk + k) * row_bytes + byte : xb;
      cp_async<CP>(slot + r * kTcPitch + seg * CP, src, ok);
    }
    constexpr int kPer = 4 / kSize;  // B values a copy
    if (off == 0 && tid < kTcCols / kPer) {
      const int gj = j0 + tid * kPer;
      const int n = max(0, min(kPer, nj - gj)) * kSize;  // bytes past J land as zeros
      const TIn* src = n > 0 ? b + (size_t)k * nj + gj : b;
      const unsigned dst = smem_addr(bs + (k - kbeg) % kTcBSlots * kTcCols + tid * kPer);
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                   : "memory");
    }
  };

#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) {
    if (s < nstages) load_stage(s);
    cp_commit();
  }
  // C's tile while the first stages are in flight: reads along j, zeros past
  // L and past J; byte w of each 8-byte run of a product's 32 bytes of a
  // plane goes to k slot byte 4 (run) + w, or 16 + 4 (run) + w - 4, as in the
  // A fragments; eight loads in flight a thread
  {
    constexpr int kBatch = 8;
    for (int e0 = tid; e0 < lvals * kTcCols; e0 += kTcThreads * kBatch) {
      TIn v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kTcThreads;
        const int l = e / kTcCols, gj = j0 + e - l * kTcCols;
        v[u] = l < nl && gj < nj ? c[(size_t)l * nj + gj] : TIn(0);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int e = e0 + u * kTcThreads;
        const int l = e / kTcCols, j = e - l * kTcCols;
        if (l >= lvals) continue;
        const int byte = kF32 ? l * 4 : l, w = byte & 7, run = (byte >> 3) & 3;
        const int slot = (byte & ~31) | (w < 4 ? 4 * run + w : 16 + 4 * run + w - 4);
        const int off = (j >> 3) * sbo + (slot >> 4) * 128 + (j & 7) * 16 + (slot & 15);
        if constexpr (kF32) {
          uint32_t hi, lo;
          split_tf32(__float_as_uint(v[u]), hi, lo);
          *reinterpret_cast<uint32_t*>(ct + off) = hi;
          *reinterpret_cast<uint32_t*>(ct + cbytes + off) = lo;
        } else {
#pragma unroll
          for (int q = 0; q < kLimbs; ++q)
            ct[q * cbytes + off] = static_cast<unsigned char>((uint32_t)v[u] >> (8 * q));
        }
      }
    }
  }
  // C's tile is read by wgmma (the async proxy): order these stores before it
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");

  using Part = typename std::conditional<kF32, float, int>::type;  // T_k's sums
  Part part[kSets][40];  // T_k: 64 x 80 a warpgroup, a set a shift of the limbs
  uint32_t tk_sum[kFoldEach ? 40 : 1] = {};  // int32: T_k folded as its groups complete
  Acc acc[40];
#pragma unroll
  for (int e = 0; e < 40; ++e) {
#pragma unroll
    for (int q = 0; q < kSets; ++q) part[q][e] = Part(0);
    acc[e] = Acc(0);
  }
  // this thread's rows (g, g + 8 of its warp's 16) and columns (2 t, 2 t + 1
  // of each 8): value 4 n + e is row g + 8 (e / 2), column 8 n + 2 t + e % 2
  const int row = (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const int a_off = row * kTcPitch + (kStep / 4) * t;  // 8 values of a product's 32
  const int col = j0 + 2 * t;
  const uint64_t desc_c = smem_desc(smem_addr(ct), 128, sbo);
  const unsigned plane_units = (unsigned)cbytes >> 4;  // a plane, in descriptor units

  uint32_t ah[kASets][kARegs], al[kASets][4];  // with two sets, one wgmma group in flight
  int k = kbeg, chunk = 0;
  for (int s = 0; s < nstages; ++s) {
    cp_wait<kTcStages - 2>();
    __syncthreads();
    if (s + kTcStages - 1 < nstages) load_stage(s + kTcStages - 1);
    cp_commit();
    const unsigned char* xs = ring + s % kTcStages * kTcStageBytes + a_off;
    // products with any l < L in them (the rest of the stage is zeros)
    const int steps = min(kTcChunk / kStep, (row_bytes - chunk * kTcChunk + kStep - 1) / kStep);
#pragma unroll
    for (int st = 0; st < kTcChunk / kStep; ++st) {
      if (st >= steps) break;
      const int set = kASets == 1 ? 0 : st & 1;
      // two core matrices of C's tile along l a product
      const int kb = (chunk * kTcChunk + st * kStep) / (kF32 ? 1 : kSize);
      const uint64_t adv = (uint64_t)(kb * 8 >> 4);
      const int accumulate = chunk == 0 && st == 0 ? 0 : 1;
      if constexpr (kF32) {
        // a0 a2 / a1 a3: rows g / g + 8, bytes 8 t .. 8 t + 7 of the 32
        const uint2 lo = lds64(xs + st * kStep);
        const uint2 hi = lds64(xs + 8 * kTcPitch + st * kStep);
        const uint32_t a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], ah[set][e], al[set][e]);
        fence_regs(al[set]);
      } else {
        // register e: the 4 values of row g + 8 (e & 1) at l 4 (e >> 1) of
        // this thread's 8
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          uint32_t v[kSize];
          lds_words<kSize>(xs + (e & 1) * 8 * kTcPitch + st * kStep + (e >> 1) * 4 * kSize, v);
          cut_limbs<kSize>(v, ah[set], e);
        }
      }
      // the A registers are written before the fence, as wgmma requires
      fence_regs(ah[set]);
      wgmma_fence();
      if constexpr (kF32) {
        const uint32_t(&hi)[4] = ah[set];
        wgmma_tf32(part[0], al[set], desc_c + adv, accumulate);
        wgmma_tf32(part[0], hi, desc_c + plane_units + adv, 1);
        wgmma_tf32(part[0], hi, desc_c + adv, 1);
      } else if constexpr (!kFoldEach) {
        limb_products<kLimbs>(part, ah[set], desc_c + adv, plane_units, accumulate);
      }
      if constexpr (kFoldEach) {
        // shift 0 into one set, 8 into the other; each set is folded as its
        // group completes and takes the next group but one, the last wait
        // leaving no group in flight before the next A registers are written
        int(&s0)[40] = part[0];
        int(&s1)[40] = part[1];
        const uint64_t desc = desc_c + adv;
        limb_group<kLimbs, 0>(s0, ah[0], desc, plane_units);
        wgmma_commit();
        limb_group<kLimbs, 1>(s1, ah[0], desc, plane_units);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s0);
        fold_set(tk_sum, s0, 0);
        wgmma_fence();
        limb_group<kLimbs, 2>(s0, ah[0], desc, plane_units);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s1);
        fold_set(tk_sum, s1, 8);
        wgmma_fence();
        limb_group<kLimbs, 3>(s1, ah[0], desc, plane_units);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(s0);
        fold_set(tk_sum, s0, 16);
        wgmma_wait<0>();
        fence_regs(s1);
        fold_set(tk_sum, s1, 24);
        fence_regs(ah[0]);
      } else {
        wgmma_commit();
      }
      if constexpr (kASets == 2) {
        wgmma_wait<1>();  // the other set's group is done: its registers are free
        fence_regs(ah[set ^ 1]);
        if constexpr (kF32) fence_regs(al[set ^ 1]);
      }
    }
    if (++chunk == nchunks) {  // T_k is whole: acc += B[k, j] T_k[i, j]
      wgmma_wait<0>();
#pragma unroll
      for (int q = 0; q < kSets; ++q) fence_regs(part[q]);
      // B's row k arrived with k's first stage; its slot is written again
      // (for k + 4) only after a barrier that follows this read
      const TIn* bk = bs + (k - kbeg) % kTcBSlots * kTcCols + 2 * t;
#pragma unroll
      for (int n = 0; n < 10; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Acc bkj = Elem<TIn>::load(bk + 8 * n + (e & 1));
          if constexpr (kF32) {
            acc[4 * n + e] = fmaf(part[0][4 * n + e], bkj, acc[4 * n + e]);
          } else {
            // T_k modulo 2^32 from its sets, each at its shift
            uint32_t tk;
            if constexpr (kFoldEach) {
              tk = tk_sum[4 * n + e];
              tk_sum[4 * n + e] = 0;
            } else {
              tk = (uint32_t)part[0][4 * n + e];
#pragma unroll
              for (int q = 1; q < kSets; ++q) tk += (uint32_t)part[q][4 * n + e] << (8 * q);
            }
            acc[4 * n + e] += tk * bkj;
          }
        }
      chunk = 0;
      ++k;
    }
  }
  cp_wait<0>();

  if (split == 1) {
#pragma unroll
    for (int n = 0; n < 10; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gi = i0 + row + (e >> 1) * 8, gj = col + 8 * n + (e & 1);
        if (gi < ni && gj < nj) m[(size_t)gi * nj + gj] = Flush<Acc, TOut>::cast(acc[4 * n + e]);
      }
    return;
  }

  // a split: this block's partial tile, in the ring once every warp is done
  // with it, then the cluster's partial tiles, each output summed over the
  // ranks in order; the ranks share the outputs out between them
  __syncthreads();
  Acc* tile_sum = reinterpret_cast<Acc*>(ring);
#pragma unroll
  for (int n = 0; n < 10; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tile_sum[(row + (e >> 1) * 8) * kTcCols + 8 * n + 2 * t + (e & 1)] = acc[4 * n + e];
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  for (int e = tid + rank * kTcThreads; e < kTcRows * kTcCols; e += kTcThreads * split) {
    const int r = e / kTcCols, cc = e - r * kTcCols;
    const int gi = i0 + r, gj = j0 + cc;
    if (gi >= ni || gj >= nj) continue;
    Acc sum = *cluster.map_shared_rank(tile_sum + e, 0);
    for (int q = 1; q < split; ++q) sum += *cluster.map_shared_rank(tile_sum + e, q);
    m[(size_t)gi * nj + gj] = Flush<Acc, TOut>::cast(sum);
  }
  cluster.sync();  // keep every partial tile alive until all are read
}

// The L below which every s32 sum of T_k stays inside int32: |T_k| < L 2^14
// in int8; a set of limb products adds at most 2 (int16) or 4 (int32) terms
// of at most 255^2 an l.  float32 has no such limit.
template <typename TIn>
constexpr int tc_max_l() {
  return std::is_same<TIn, float>::value ? 0x7fffffff
                                         : (sizeof(TIn) == 1 ? 1 << 17
                                                             : (sizeof(TIn) == 2 ? 1 << 15 : 1 << 13));
}

// The tensor-core MTTKRP: K split over `split` blocks of a cluster, X copied
// `copy` bytes at a time (16 or 4).
template <typename TIn, typename TOut, int CP>
int launch_mttkrp_tc_cp(const void* x, const void* b, const void* c, void* m, int ni, int nj,
                        int nk, int nl, int split, cudaStream_t stream) {
  auto kernel = mttkrp_tc_kernel<TIn, TOut, CP>;
  constexpr bool f32 = std::is_same<TIn, float>::value;
  const long long row_bytes = (long long)nl * (long long)sizeof(TIn);
  if (ni < 1 || nj < 1 || nk < 1 || nl < 1 || split < 1 || split > kTcMaxCluster || split > nk ||
      row_bytes % CP != 0 || reinterpret_cast<uintptr_t>(x) % CP != 0 ||
      (long long)nj * sizeof(TIn) % 4 != 0 || reinterpret_cast<uintptr_t>(b) % 4 != 0 ||
      (long long)nk * nl >= 0x7fffffffLL || nl >= tc_max_l<TIn>())
    return (int)cudaErrorInvalidValue;
  const int kblk = (nk + split - 1) / split;
  if ((long long)(split - 1) * kblk >= nk) return (int)cudaErrorInvalidValue;  // an empty rank
  const long long smem = tc_cbytes(row_bytes, f32) + (long long)kTcStages * kTcStageBytes +
                         kTcBSlots * kTcCols * (long long)sizeof(TIn);
  const long long tiles =
      (long long)((ni + kTcRows - 1) / kTcRows) * ((nj + kTcCols - 1) / kTcCols);
  if (smem > kTcMaxSmem || tiles * split > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const cudaError_t allowed =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (allowed != cudaSuccess) return (int)allowed;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(tiles * split), 1, 1);
  cfg.blockDim = dim3(kTcThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = (unsigned)split;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = split > 1 ? 1 : 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, kernel, static_cast<const TIn*>(x), static_cast<const TIn*>(b),
                         static_cast<const TIn*>(c), static_cast<TOut*>(m), ni, nj, nk, nl,
                         split, kblk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename TIn, typename TOut>
int launch_mttkrp_tc(int copy, const void* x, const void* b, const void* c, void* m, int ni,
                     int nj, int nk, int nl, int split, cudaStream_t stream) {
  if (copy == 16)
    return launch_mttkrp_tc_cp<TIn, TOut, 16>(x, b, c, m, ni, nj, nk, nl, split, stream);
  if (copy == 4)
    return launch_mttkrp_tc_cp<TIn, TOut, 4>(x, b, c, m, ni, nj, nk, nl, split, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// O[r, c] = sum_s w[s] G[r + di_s, c + dj_s] over an oh x ow output (rows
// of ow), for the star of `points` points (5: JACOBI2D_OFFSETS,
// 9: JACOBI2D_9PT_OFFSETS); `weights` are device values of the accumulator
// type (float32, or int32 for integer grids); each warp walks `rows` output
// rows.  Returns a cudaError_t.
int widesa_star_launch(const void* grid, const void* weights, void* out, int oh, int ow,
                       int points, int in_dtype, int out_dtype, int rows,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32)
    return launch_star<float, float>(points, grid, weights, out, oh, ow, rows, s);
  if (in_dtype == I8 && out_dtype == I32)
    return launch_star<int8_t, int32_t>(points, grid, weights, out, oh, ow, rows, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_star<int16_t, int32_t>(points, grid, weights, out, oh, ow, rows, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_star<int32_t, int32_t>(points, grid, weights, out, oh, ow, rows, s);
  return (int)cudaErrorInvalidValue;
}

// `sweeps` (at most 8) weighted 5-point sweeps of the h x w state `src`
// inside its fixed boundary ring, sweep k with the weights (sweeps, 5) row
// k (device values of the accumulator type); into `dst`: the (h - 2) x
// (w - 2) interior when `last`, else the whole h x w state of the
// accumulator type, ring included.  Returns a cudaError_t.
int widesa_sweeps_launch(const void* src, const void* weights, void* dst, int h, int w,
                         int sweeps, int last, int in_dtype, int out_dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32)
    return launch_sweeps<float, float>(src, weights, dst, h, w, sweeps, last, s);
  if (in_dtype == I8 && out_dtype == I32)
    return launch_sweeps<int8_t, int32_t>(src, weights, dst, h, w, sweeps, last, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_sweeps<int16_t, int32_t>(src, weights, dst, h, w, sweeps, last, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_sweeps<int32_t, int32_t>(src, weights, dst, h, w, sweeps, last, s);
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

// M[i, j] = sum_{k,l} X[i, k, l] B[k, j] C[l, j] on the tensor cores
// (float32 -> float32 as 3xTF32; int8, int16 and int32 -> int32, the wider
// integers as int8 limbs): K split over `split` blocks
// of a cluster, X copied `copy` bytes at a time (16 or 4).  Returns a
// cudaError_t.
int widesa_mttkrp_tc_launch(const void* x, const void* b, const void* c, void* m, int ni,
                            int nj, int nk, int nl, int in_dtype, int out_dtype, int split,
                            int copy, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32)
    return launch_mttkrp_tc<float, float>(copy, x, b, c, m, ni, nj, nk, nl, split, s);
  if (in_dtype == I8 && out_dtype == I32)
    return launch_mttkrp_tc<int8_t, int32_t>(copy, x, b, c, m, ni, nj, nk, nl, split, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_mttkrp_tc<int16_t, int32_t>(copy, x, b, c, m, ni, nj, nk, nl, split, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_mttkrp_tc<int32_t, int32_t>(copy, x, b, c, m, ni, nj, nk, nl, split, s);
  return (int)cudaErrorInvalidValue;
}

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
