// Hand-written Hopper (sm_90a) kernels for the WideSA signal-processing
// recurrences of the audio frontend: the FIR filter bank and the VALID 2-D
// cross-correlation (conv2d).
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

const char* widesa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
