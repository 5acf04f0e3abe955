// Hand-written Hopper (sm_90a) kernel for the 2-D DFT of large grids:
// Z = F_R X F_C, X an R x C complex grid held as float32 real and imaginary
// planes, computed as a row pass and a column pass of radix-2^k Stockham
// FFTs (O(R C log(R C)) work) in place of the DFT matrices' products.
//
// Replaces src/repro/kernels/fft2d.py fft2d / _cmul_mm (:34, :53) above the
// fused kernel's 64 rows (csrc/widesa_sp.cu: fft2d_kernel), where the port
// ran the reference's matrix form as six 3xTF32 GEMMs a transform.  The
// reference's docstring (:3-8) says the paper streams complex butterflies
// through the AIE array and that the matrix form was the TPU's adaptation
// to the MXU; on Hopper the butterflies are the cheaper form again.
//
// What bounds it on an H100: bytes.  At 8192^2 an FFT is 5 N log2 N = 8.7
// GFLOP (0.13 ms at the CUDA cores' 67 TFLOP/s) against 1 GiB of planes in
// and out a pass: two passes, each one read and one write of the grid, take
// 0.64 ms at 3.35 TB/s.  The design keeps every point in registers and
// shared memory between the read and the write of its pass:
//   * Row pass: a block holds `rows` whole rows (one row of 8192 points, 64
//     KB of both planes; short rows grouped to 4096 points a block).  Column
//     pass: a block holds a strip of `strip` columns over R / cluster rows,
//     at most 8192 points; a column longer than a block (8192 rows of a
//     16-column strip) is split over a cluster of up to 16 blocks (past the
//     portable 8, which Hopper allows on request), block k holding rows k,
//     k + cluster, ...: each does the local FFTs of its rows, and a last
//     radix-`cluster` stage, twiddled by w_R^(k k1), reads the other blocks'
//     shared memory (distributed shared memory) and writes Z.  So each pass
//     reads and writes the grid once: the row pass X -> Z, the column pass
//     Z -> Z in place (a block, or a cluster, owns its columns; everything
//     is read before the first write).
//   * A thread holds 16 complex points through a stage as kStockPoints / R
//     butterflies of radix R (2, 4, 8 or 16; `fft_radices` in
//     kernels/runtime.py spreads log2 n over as few stages as radix 16
//     allows): it reads its points, the block synchronizes, then it
//     twiddles, butterflies in registers and writes the stage's output in
//     Stockham order (natural order after the last stage), so one buffer
//     serves every stage and no digit reversal is left for the end.  The
//     first stage reads device memory and the last writes it, each a lane a
//     consecutive point (or column), so every warp's access is whole
//     sectors.  Blocks of 512 threads at 64 registers: two an SM, so one
//     block's device-memory phases overlap the other's stages.
//   * Shared memory holds one pad word per 32 (`pad`): the first stage's
//     stride-R writes (R consecutive points a thread) then fall in distinct
//     banks.
//   * Twiddles come from one table a side, (cos, -sin)(2 pi j / n), j < n,
//     computed in float64 on the host and cast to float32 (64 KB at 8192;
//     kernels/fft2d.py: twiddles), read through the read-only cache, the
//     powers of two of a butterfly only (`twiddle`); the butterflies' own
//     roots of unity are the same values as literals.
//   * The complex products and sums are rounded one operation at a time
//     (no fused multiply-add), in the plain version's order
//     (kernels/fft2d.py: fft_plain), so the two agree to the last bit up
//     to the sign of a zero.
// ---------------------------------------------------------------------------

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kStockPoints = 16;        // complex points a thread holds through a stage
constexpr int kStockMaxRadix = 16;      // the largest butterfly
constexpr int kStockBlockPoints = 8192;  // points a block holds at most
constexpr int kStockMaxThreads = kStockBlockPoints / kStockPoints;  // 512
constexpr int kStockMaxCluster = 16;    // past the portable 8: Hopper allows 16 on request
constexpr int kStockMaxSide = 8192;     // the longest side either pass takes
constexpr int kStockMaxStages = 8;      // 4 bits a stage's log2 radix in one int

// floats of one plane in shared memory for f points: a pad word every 32
__host__ __device__ constexpr int stock_plane_floats(int f) { return f + (f >> 5); }
__device__ __forceinline__ int pad(int f) { return f + (f >> 5); }

// w_16^m = (cos, -sin)(2 pi m / 16), m < 8: the float32 values of the
// twiddle tables at j = m n / 16 (kernels/fft2d.py: twiddle_table)
__device__ __forceinline__ float w16_re(int m) {
  switch (m) {
    case 1: return 0.923879533f;
    case 2: return 0.707106781f;
    case 3: return 0.382683432f;
    case 5: return -0.382683432f;
    case 6: return -0.707106781f;
    case 7: return -0.923879533f;
    default: return 1.0f;
  }
}
__device__ __forceinline__ float w16_im(int m) {
  switch (m) {
    case 1: return -0.382683432f;
    case 2: return -0.707106781f;
    case 3: return -0.923879533f;
    case 5: return -0.923879533f;
    case 6: return -0.707106781f;
    case 7: return -0.382683432f;
    default: return 0.0f;
  }
}

// (re + i im) *= (c + i s), each operation rounded on its own
__device__ __forceinline__ void cmul(float& re, float& im, float c, float s) {
  const float r = __fsub_rn(__fmul_rn(re, c), __fmul_rn(im, s));
  const float i = __fadd_rn(__fmul_rn(re, s), __fmul_rn(im, c));
  re = r;
  im = i;
}

__host__ __device__ constexpr int log2i(int n) { return n <= 1 ? 0 : 1 + log2i(n / 2); }

// One radix-2 level of the R-point DFT (decimation in frequency), butterflies
// h apart, then the levels below it: every bound a template constant, so the
// loops unroll and the points stay in registers.
template <int R, int H>
__device__ __forceinline__ void dif_levels(float* re, float* im) {
  if constexpr (H >= 1) {
#pragma unroll
    for (int b = 0; b < R; b += 2 * H) {
#pragma unroll
      for (int j = 0; j < H; ++j) {
        const int m = j * (8 / H);  // w_{2h}^j = w_16^m
        const float ar = re[b + j], ai = im[b + j];
        const float br = re[b + j + H], bi = im[b + j + H];
        re[b + j] = __fadd_rn(ar, br);
        im[b + j] = __fadd_rn(ai, bi);
        float dr = __fsub_rn(ar, br), di = __fsub_rn(ai, bi);
        if (m == 4) {  // times -i: exact
          const float t = dr;
          dr = di;
          di = -t;
        } else if (m != 0) {
          cmul(dr, di, w16_re(m), w16_im(m));
        }
        re[b + j + H] = dr;
        im[b + j + H] = di;
      }
    }
    dif_levels<R, H / 2>(re, im);
  }
}

// The R-point DFT of re/im[0, R) in registers, in natural order: the
// radix-2 levels leave X[q] at q's bit reversal, which the copies undo
// (register renaming once unrolled).
template <int R>
__device__ __forceinline__ void dft(float* re, float* im) {
  static_assert(R >= 2 && R <= kStockMaxRadix && (R & (R - 1)) == 0, "radix");
  constexpr int kLog = log2i(R);
  dif_levels<R, R / 2>(re, im);
  float tr[R], ti[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int rq = ((q & 1) << 3 | (q & 2) << 1 | (q & 4) >> 1 | (q & 8) >> 3) >> (4 - kLog);
    tr[q] = re[rq];
    ti[q] = im[rq];
  }
#pragma unroll
  for (int q = 0; q < R; ++q) {
    re[q] = tr[q];
    im[q] = ti[q];
  }
}

// Twiddles point t of a butterfly by w^(t k) for t in [1, R), w^j = tw[j <<
// shift]: the powers of two t from the table, each other power as the
// product of the highest power of two below it and the rest (w^3 = w^2 w^1,
// w^7 = w^4 w^3, ...), so a radix-16 butterfly reads 4 entries, not 15.
template <int R>
__device__ __forceinline__ void twiddle(float* re, float* im, const float2* tw, int k,
                                        int shift) {
  float wr[R], wi[R];
#pragma unroll
  for (int t = 1; t < R; ++t) {
    const int h = t >= 8 ? 8 : t >= 4 ? 4 : t >= 2 ? 2 : 1;  // R <= 16
    if (h == t) {
      const float2 w = __ldg(tw + ((t * k) << shift));
      wr[t] = w.x;
      wi[t] = w.y;
    } else {
      wr[t] = wr[h];
      wi[t] = wi[h];
      cmul(wr[t], wi[t], wr[t - h], wi[t - h]);
    }
  }
#pragma unroll
  for (int t = 1; t < R; ++t) cmul(re[t], im[t], wr[t], wi[t]);
}

// threadIdx.x and blockDim.x, read anew where called: the stages' addresses
// depend on them, so the compiler cannot hoist every radix's addresses out of
// the stage loop, where they would stay live together and spill.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}
__device__ __forceinline__ int fresh_threads() {
  int t;
  asm volatile("mov.u32 %0, %%ntid.x;" : "=r"(t));
  return t;
}

// One pass's geometry.  Row pass: a block holds `1 << log_seq` rows of n
// points, rows [blockIdx.x << log_seq, ...), reading x and writing z (pitch
// n).  Column pass: a block holds columns [strip * W, strip * W + W), W = 1
// << log_seq, of rows rank, rank + cluster, ... (n = R / cluster of them), in
// place (x == z).
struct StockPass {
  const float* xr;
  const float* xi;
  float* zr;
  float* zi;
  const float2* tw;  // (cos, -sin)(2 pi j / n), j < n = 1 << log_tw
  int log_tw;        // log2 of the transform's length (R for the column pass)
  int log_n;         // log2 of the points of a block's sequences
  int radix_logs;    // the block's stages, log2 radix 4 bits each, first lowest
  int stages;
  int log_seq;       // log2 rows (row pass) or columns (column pass) a block
  int pitch;         // floats a row of the grid
  int log_cluster;   // blocks a column (column pass)
};

struct Place {
  size_t base;  // row pass: the block's first point in the grid
  int c0;       // column pass: the strip's first column
  int rank;     // column pass: the block's rank in its cluster
};

// Flat index in the block of point idx of sequence s: rows hold their
// points contiguously, a strip its columns side by side.
template <bool kCols>
__device__ __forceinline__ int flat(const StockPass& ps, int s, int idx) {
  return kCols ? (idx << ps.log_seq) + s : (s << ps.log_n) + idx;
}

// One Stockham stage of radix R over every sequence of the block, p the
// product of the radices before it: butterfly i (i < n / R, k = i mod p)
// reads points i + t n / R, twiddles point t by w_{pR}^(t k), and writes
// output q to (i - k) R + k + q p.  The first stage reads the grid (the
// column pass: row idx of the rank's rows) and, where no cluster stage
// follows, the last writes it; the others read and write shared memory.
template <int R, bool kCols>
__device__ __forceinline__ void stage(const StockPass& ps, const Place& pl, float* sr, float* si,
                                      int log_p, bool first, bool last) {
  constexpr int kLogR = log2i(R);
  constexpr int kB = kStockPoints / R;  // butterflies a thread
  const int threads = fresh_threads(), tid = fresh_tid();
  const int log_span = ps.log_n - kLogR;
  const int seq_mask = (1 << ps.log_seq) - 1;
  float re[kStockPoints], im[kStockPoints];
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int bf = tid + u * threads;
    const int s = kCols ? bf & seq_mask : bf >> log_span;
    const int i = kCols ? bf >> ps.log_seq : bf & ((1 << log_span) - 1);
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const int idx = i + (t << log_span);
      if (first) {
        const size_t g = kCols ? (size_t)((idx << ps.log_cluster) + pl.rank) * ps.pitch + pl.c0 + s
                               : pl.base + flat<kCols>(ps, s, idx);
        re[u * R + t] = ps.xr[g];
        im[u * R + t] = ps.xi[g];
      } else {
        const int a = pad(flat<kCols>(ps, s, idx));
        re[u * R + t] = sr[a];
        im[u * R + t] = si[a];
      }
    }
  }
  // every point of the stage is read before any is overwritten (the column
  // pass's grid too, in place)
  __syncthreads();
  const int tw_log = ps.log_tw - log_p - kLogR;  // w_{pR} = w_n^(n / (pR))
  const int p = 1 << log_p;
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int bf = tid + u * threads;
    const int s = kCols ? bf & seq_mask : bf >> log_span;
    const int i = kCols ? bf >> ps.log_seq : bf & ((1 << log_span) - 1);
    const int k = i & (p - 1);
    if (k != 0) twiddle<R>(re + u * R, im + u * R, ps.tw, k, tw_log);
    dft<R>(re + u * R, im + u * R);
    const int out0 = ((i - k) << kLogR) + k;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int idx = out0 + (q << log_p);
      if (last) {
        const size_t g = kCols ? (size_t)idx * ps.pitch + pl.c0 + s : pl.base + flat<kCols>(ps, s, idx);
        ps.zr[g] = re[u * R + q];
        ps.zi[g] = im[u * R + q];
      } else {
        const int a = pad(flat<kCols>(ps, s, idx));
        sr[a] = re[u * R + q];
        si[a] = im[u * R + q];
      }
    }
  }
  __syncthreads();
}

// The float at shared address `addr` of the cluster's block `rank`
// (distributed shared memory, 32-bit addresses)
__device__ __forceinline__ float ld_cluster(uint32_t addr, int rank) {
  uint32_t remote;
  float v;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(remote));
  return v;
}

// The column pass's last stage over a cluster of P blocks: point k1 of
// every rank's transform (block `rank` takes k1 in [rank n / P, ...)), read
// from that rank's shared memory, twiddled by w_R^(t k1) for rank t, then
// the P-point DFT gives rows k1 + q n of Z.
template <int P>
__device__ __forceinline__ void cross(const StockPass& ps, const Place& pl, float* sr, float* si) {
  constexpr int kB = kStockPoints / P;
  cg::cluster_group cluster = cg::this_cluster();
  const int threads = fresh_threads(), tid = fresh_tid();
  const int n = 1 << ps.log_n;
  const int seq_mask = (1 << ps.log_seq) - 1;
  float re[kStockPoints], im[kStockPoints];
  // every rank's local transform is in its shared memory
  cluster.sync();
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int bf = tid + u * threads;
    const int s = bf & seq_mask;
    const int k1 = pl.rank * (n / P) + (bf >> ps.log_seq);
    const int a = pad(flat<true>(ps, s, k1));
    const uint32_t ar = static_cast<uint32_t>(__cvta_generic_to_shared(sr + a));
    const uint32_t ai = static_cast<uint32_t>(__cvta_generic_to_shared(si + a));
#pragma unroll
    for (int t = 0; t < P; ++t) {
      re[u * P + t] = ld_cluster(ar, t);
      im[u * P + t] = ld_cluster(ai, t);
    }
  }
#pragma unroll
  for (int u = 0; u < kB; ++u) {
    const int bf = tid + u * threads;
    const int s = bf & seq_mask;
    const int k1 = pl.rank * (n / P) + (bf >> ps.log_seq);
    if (k1 != 0) twiddle<P>(re + u * P, im + u * P, ps.tw, k1, 0);
    dft<P>(re + u * P, im + u * P);
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const size_t g = (size_t)(k1 + q * n) * ps.pitch + pl.c0 + s;
      ps.zr[g] = re[u * P + q];
      ps.zi[g] = im[u * P + q];
    }
  }
  // no rank leaves while another still reads its shared memory
  cluster.sync();
}

// Grid: row pass, R / rows blocks of rows * C / 32 threads; column pass,
// (C / strip) * cluster blocks of (R / cluster) * strip / 32 threads in
// clusters of `cluster` along x.
// Two blocks an SM (at most 64 registers a thread): one block's loads and
// stores overlap the other's stages.  Left to itself the compiler gives each
// pass more registers and one block an SM.
template <bool kCols>
__global__ void __launch_bounds__(kStockMaxThreads, 2) fft_pass_kernel(const StockPass ps) {
  extern __shared__ float fsm[];
  const int points = blockDim.x * kStockPoints;
  float* sr = fsm;
  float* si = fsm + stock_plane_floats(points);
  Place pl;
  if (kCols) {
    pl.base = 0;
    pl.rank = (int)(blockIdx.x & ((1u << ps.log_cluster) - 1));
    pl.c0 = (int)(blockIdx.x >> ps.log_cluster) << ps.log_seq;
  } else {
    pl.base = (size_t)blockIdx.x * points;
    pl.rank = 0;
    pl.c0 = 0;
  }
  const bool cluster_stage = kCols && ps.log_cluster > 0;
  int log_p = 0;
  for (int s = 0; s < ps.stages; ++s) {
    const int lr = (ps.radix_logs >> (4 * s)) & 15;
    const bool first = s == 0, last = s == ps.stages - 1 && !cluster_stage;
    switch (lr) {
      case 1: stage<2, kCols>(ps, pl, sr, si, log_p, first, last); break;
      case 2: stage<4, kCols>(ps, pl, sr, si, log_p, first, last); break;
      case 3: stage<8, kCols>(ps, pl, sr, si, log_p, first, last); break;
      default: stage<16, kCols>(ps, pl, sr, si, log_p, first, last); break;
    }
    log_p += lr;
  }
  if (cluster_stage) {
    switch (ps.log_cluster) {
      case 1: cross<2>(ps, pl, sr, si); break;
      case 2: cross<4>(ps, pl, sr, si); break;
      case 3: cross<8>(ps, pl, sr, si); break;
      default: cross<16>(ps, pl, sr, si); break;
    }
  }
}

bool pow2(int n) { return n > 0 && (n & (n - 1)) == 0; }

// Whether a radix plan (log2 radices, 4 bits each) covers 2^log_n points
// in `stages` stages of radix 2 to kStockMaxRadix.
bool plan_ok(int logs, int stages, int log_n) {
  if (stages < 1 || stages > kStockMaxStages) return false;
  int sum = 0;
  for (int s = 0; s < stages; ++s) {
    const int lr = (logs >> (4 * s)) & 15;
    if (lr < 1 || (1 << lr) > kStockMaxRadix) return false;
    sum += lr;
  }
  return sum == log_n && (stages == kStockMaxStages || (logs >> (4 * stages)) == 0);
}

template <bool kCols>
cudaError_t launch_pass(const StockPass& ps, int blocks, int points, int cluster,
                        cudaStream_t stream) {
  const int smem = 2 * stock_plane_floats(points) * (int)sizeof(float);
  const cudaError_t allowed = cudaFuncSetAttribute(
      fft_pass_kernel<kCols>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (allowed != cudaSuccess) return allowed;
  if (cluster > 8) {
    const cudaError_t wide = cudaFuncSetAttribute(
        fft_pass_kernel<kCols>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (wide != cudaSuccess) return wide;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)(points / kStockPoints), 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, fft_pass_kernel<kCols>, ps);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

int launch_fft(const float* xr, const float* xi, const float2* tw_rows, const float2* tw_cols,
               float* zr, float* zi, int nr, int nc, int row_logs, int row_stages, int col_logs,
               int col_stages, int rows, int strip, int cluster, cudaStream_t stream) {
  if (!pow2(nr) || !pow2(nc) || nr < 2 || nc < 2 || nr > kStockMaxSide || nc > kStockMaxSide ||
      !pow2(rows) || rows > nr || !pow2(strip) || strip > nc || !pow2(cluster) ||
      cluster > kStockMaxCluster || cluster >= nr)
    return (int)cudaErrorInvalidValue;
  const int row_points = rows * nc, col_n = nr / cluster, col_points = col_n * strip;
  if (row_points < kStockPoints || row_points > kStockBlockPoints || col_points < kStockPoints ||
      col_points > kStockBlockPoints || !plan_ok(row_logs, row_stages, log2i(nc)) ||
      !plan_ok(col_logs, col_stages, log2i(col_n)))
    return (int)cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(tw_rows) | reinterpret_cast<uintptr_t>(tw_cols)) % 8 != 0)
    return (int)cudaErrorInvalidValue;

  StockPass rp = {xr, xi, zr, zi, tw_rows, log2i(nc), log2i(nc), row_logs, row_stages,
                  log2i(rows), nc, 0};
  cudaError_t err = launch_pass<false>(rp, nr / rows, row_points, 1, stream);
  if (err != cudaSuccess) return (int)err;
  StockPass cp = {zr, zi, zr, zi, tw_cols, log2i(nr), log2i(col_n), col_logs, col_stages,
                  log2i(strip), nc, log2i(cluster)};
  err = launch_pass<true>(cp, nc / strip * cluster, col_points, cluster, stream);
  return (int)err;
}

}  // namespace

extern "C" {

// Z = F_R X F_C (the fft2d_stage chain) on float32 planes of an R x C grid,
// R and C powers of two up to 8192: the row pass (X -> Z, `rows` rows a
// block, radix plan row_logs over row_stages stages) and the column pass (Z
// in place, `strip` columns a block, R / cluster rows a block over a
// cluster, radix plan col_logs, then the cluster's stage).  tw_rows and
// tw_cols hold (cos, -sin)(2 pi j / n) for n = C and R.  Returns a
// cudaError_t.
int widesa_fft_launch(const void* x_re, const void* x_im, const void* tw_rows,
                      const void* tw_cols, void* z_re, void* z_im, int nr, int nc, int row_logs,
                      int row_stages, int col_logs, int col_stages, int rows, int strip,
                      int cluster, void* stream) {
  return launch_fft(static_cast<const float*>(x_re), static_cast<const float*>(x_im),
                    static_cast<const float2*>(tw_rows), static_cast<const float2*>(tw_cols),
                    static_cast<float*>(z_re), static_cast<float*>(z_im), nr, nc, row_logs,
                    row_stages, col_logs, col_stages, rows, strip, cluster,
                    static_cast<cudaStream_t>(stream));
}

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
