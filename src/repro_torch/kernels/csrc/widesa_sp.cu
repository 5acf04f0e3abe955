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

#include <type_traits>

#include "window.cuh"

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

// ---------------------------------------------------------------------------
// FIR: y[n] = sum_t x[n + t] * h[t], n < n_out, t < taps (VALID); and the
// complex FIR on real and imaginary planes, y_re = rr - ii and
// y_im = ri + ir with rr = FIR(x_re, h_re), ii = FIR(x_im, h_im),
// ri = FIR(x_re, h_im), ir = FIR(x_im, h_re).
//
// Replaces src/repro/kernels/fir.py fir_kernel (pallas_call at :59 in
// fir_stacked), which contracts the (T, bn) block of the shifted stack that
// ops.fir writes to HBM with the taps: T x n_out elements stored and read
// back for every call; and ops.fir_complex (src/repro/kernels/ops.py:283),
// four such calls and two array combines.
//
// What bounds it on an H100: bytes at 15 taps; the CUDA cores above ~80
// taps in float32.  The work is 2 * taps operations an output against 5-8
// bytes moved (x read once, y written once; the complex FIR moves twice the
// bytes for four times the work): at 15 taps 4-6 operations a byte, where
// the CUDA cores' 67 TFLOP/s against 3.35 TB/s allow 20.  A form that
// stages a block's inputs and taps in shared memory and sums one output a
// thread reads two 4-byte words from it for every multiply-add (30 an
// output at 15 taps) and is bound by shared memory, at 44 % of its byte
// bound on an H100.  The design:
//
//   * A compile-time tap count for the one the repository runs: 15 (the
//     paper's and the whisper frontend's), with the taps in registers.
//     Any other count up to kFirMaxTaps runs the generic
//     instantiation: the taps in shared memory, read as one 16-byte
//     broadcast (int8: one word) for every 4 taps and all 4 of a lane's
//     outputs.
//   * A lane computes kFirLaneOutputs = 4 consecutive outputs from one
//     register window of its 4 + T - 1 inputs, read from shared memory as
//     vectors of 4 elements (16, 8 or 4 bytes: at 15 taps 5 vector loads
//     for 4 float32 outputs, where that form makes 120 word loads), and
//     stores them as one 16-byte vector: a warp's stores are 512
//     contiguous bytes.
//   * A block of 128 or 256 lanes walks chunks of lanes * 4 outputs
//     (blockIdx, blockIdx + gridDim, ...) through a ring of kFirStages
//     chunk slots: each chunk's inputs and their taps - 1 halo are copied
//     into a slot by 16-byte cp.async, whatever the alignment of x (the
//     16-byte units that hold them, as window::stage does), three chunks in
//     flight while one is computed.  runtime.fir_config sizes the grid to
//     the blocks the card keeps resident, so that at 1M outputs every SM
//     has work and every chunk's copy is issued before the first chunk is
//     computed.
//   * Wherever x starts in its 16-byte unit, a lane's vectors start on
//     vector boundaries and its window is realigned in registers: whole
//     words by a compile-time case of the word offset (a uniform branch),
//     the bytes of int8 and int16 by a funnel shift.
//   * int8 takes __dp4a: four taps an instruction, the taps packed four to
//     a word (zero past T), each output's shifted 4-byte windows cut from
//     the realigned words by __byte_perm.  int16 and int32 take 32-bit
//     integer multiply-adds.
//   * The complex FIR is one launch: both planes of x staged, both planes
//     of h in registers (or shared memory), four accumulators an output
//     (rr, ri from x_re, ii, ir from x_im, each in t order as the
//     reference's four passes) combined at the end: x_re and x_im read
//     once, y_re and y_im written once.
//
// Each output sums in t order, one fused multiply-add a product in float32;
// integers wrap modulo 2^32.  Only a chunk's halo, taps - 1 inputs, is read
// twice (from L2).  The plan's tile ({n: 103} on the TPU) is not a CUDA
// tile: runtime.fir_tile picks the launch for the card.
// ---------------------------------------------------------------------------
constexpr int kFirLanes = 256;      // the most lanes a block (128 or 256 at run time)
constexpr int kFirLaneOutputs = 4;  // consecutive outputs a lane computes a chunk
constexpr int kFirStages = 4;       // chunk slots of a block's ring
constexpr int kFirSmLanes = 1024;   // lanes an SM keeps resident (the complex FIR half)
constexpr int kFirMaxTaps = 4096;
constexpr int kFirSlack = 64;       // bytes a slot holds past its chunk's inputs

__host__ __device__ constexpr int fir_tpad(int taps) { return (taps + 3) & ~3; }

// Bytes of one plane's chunk slot: the chunk's lanes * 4 + taps - 1 inputs
// from any 16-byte phase, the taps rounded up to 4, and the slack the last
// lane's vectors read past them (kept equal to runtime.fir_smem).
__host__ __device__ constexpr int fir_slot_bytes(int lanes, int taps, int elem) {
  return ((lanes * kFirLaneOutputs + fir_tpad(taps)) * elem + 16 + kFirSlack + 15) & ~15;
}

// Bytes of one plane's taps in shared memory (the generic instantiation):
// int8 packed four to a word, the rest as 32-bit accumulator values, zero
// past the last tap.
__host__ __device__ constexpr int fir_taps_bytes(int taps, int elem) {
  return elem == 1 ? (fir_tpad(taps) + 15) & ~15 : 4 * fir_tpad(taps);
}

template <typename TIn, typename TOut>
struct FirArgs {
  const TIn* x[2];  // the input planes (the complex FIR's re, im)
  const TIn* h[2];
  TOut* y[2];
  int n_out, taps;
};

template <typename Acc>
struct alignas(16) Four {
  Acc x[4];
};

// The taps of a compiled count T in registers: as accumulator values, or,
// in int8, packed four to a word (zero past T) for __dp4a.
template <typename TIn, int T>
struct FirTaps {
  typename Elem<TIn>::Acc v[T];
  __device__ __forceinline__ void load(const TIn* h) {
#pragma unroll
    for (int t = 0; t < T; ++t) v[t] = Elem<TIn>::load(h + t);
  }
};
template <int T>
struct FirTaps<int8_t, T> {
  uint32_t w[(T + 3) / 4];
  __device__ __forceinline__ void load(const int8_t* h) {
#pragma unroll
    for (int m = 0; m < (T + 3) / 4; ++m) {
      uint32_t word = 0;
#pragma unroll
      for (int b = 0; b < 4; ++b)
        if (4 * m + b < T) word |= (uint32_t)(uint8_t)h[4 * m + b] << (8 * b);
      w[m] = word;
    }
  }
};

// Copy the n > 0 elements src[0 .. n) into `slot` (16-byte aligned) as the
// 16-byte units that hold them, the block's threads a unit each in turn:
// src[k] lands at byte (src & 15) + k * sizeof(T) of the slot.  As in
// window::stage, no unit reaches past the page of an element it holds.
template <typename T>
__device__ __forceinline__ void fir_stage(unsigned char* slot, const T* src, int n) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~uintptr_t(15);
  const int units = (int)((a - a0 + (uintptr_t)n * sizeof(T) + 15) >> 4);
  for (int u = threadIdx.x; u < units; u += blockDim.x)
    window::cp16(slot + 16 * u, reinterpret_cast<const void*>(a0 + 16 * (uintptr_t)u));
}

// One vector of VW words (4, 8 or 16 bytes) from shared memory.
template <int VW>
__device__ __forceinline__ void fir_lds(uint32_t* w, const uint32_t* p) {
  if constexpr (VW == 4) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x;
    w[1] = v.y;
    w[2] = v.z;
    w[3] = v.w;
  } else if constexpr (VW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
    w[0] = p[0];
  }
}

// The NU words of a lane's window, u[k] = the words w[WL + k ...] loaded
// from the lane's first vector on, shifted down by s bytes (s > 0 only in
// int8 and int16, which load one word more for it).
template <int NU, int WL, int SZ>
__device__ __forceinline__ void fir_realign(uint32_t* u, const uint32_t* w, int s) {
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    if constexpr (SZ < 4)
      u[k] = __funnelshift_r(w[WL + k], w[WL + k + 1], 8 * s);
    else
      u[k] = w[WL + k];
  }
}

// Element k of a realigned window, as the accumulator type.
template <typename TIn>
__device__ __forceinline__ typename Elem<TIn>::Acc fir_elem(const uint32_t* u, int k) {
  if constexpr (std::is_same<TIn, float>::value)
    return __uint_as_float(u[k]);
  else if constexpr (sizeof(TIn) == 4)
    return u[k];
  else
    return (uint32_t)(int32_t)(int16_t)(u[k >> 1] >> (16 * (k & 1)));
}

// Output j's 4-byte int8 window at tap group m: bytes j .. j + 3 of the
// pair u[m], u[m + 1].
__device__ __forceinline__ int fir_bytes(const uint32_t* u, int m, int j) {
  return (int)(j == 0 ? u[m] : __byte_perm(u[m], u[m + 1], 0x3210 + 0x1111 * j));
}

// A lane's 4 outputs at a compiled tap count T from the window that starts
// WL words and s bytes into the vector at `src`: a0 += the products with
// h0, and with NH = 2 also a1 += those with h1, in t order.
template <typename TIn, int T, int WL, int NH>
__device__ __forceinline__ void fir_window(const uint32_t* src, int s, const FirTaps<TIn, T>& h0,
                                           const FirTaps<TIn, T>& h1,
                                           typename Elem<TIn>::Acc (&a0)[kFirLaneOutputs],
                                           typename Elem<TIn>::Acc (&a1)[kFirLaneOutputs]) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int SZ = sizeof(TIn), VW = SZ, R = kFirLaneOutputs;
  constexpr bool kDp4a = SZ == 1;
  constexpr int E = R + (kDp4a ? fir_tpad(T) : T) - 1;  // the window's elements
  constexpr int NU = (E * SZ + 3) / 4;                  // its words
  constexpr int NW = WL + NU + (SZ < 4 ? 1 : 0);        // the words loaded
  constexpr int NV = (NW + VW - 1) / VW;                // as vectors
  uint32_t w[NV * VW];
#pragma unroll
  for (int v = 0; v < NV; ++v) fir_lds<VW>(w + v * VW, src + v * VW);
  uint32_t u[NU];
  fir_realign<NU, WL, SZ>(u, w, s);
  if constexpr (kDp4a) {
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int m = 0; m < fir_tpad(T) / 4; ++m) {
        const int v = fir_bytes(u, m, j);
        a0[j] = (uint32_t)__dp4a(v, (int)h0.w[m], (int)a0[j]);
        if constexpr (NH == 2) a1[j] = (uint32_t)__dp4a(v, (int)h1.w[m], (int)a1[j]);
      }
  } else {
    Acc e[E];
#pragma unroll
    for (int k = 0; k < E; ++k) e[k] = fir_elem<TIn>(u, k);
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        a0[j] = window::mac(a0[j], h0.v[t], e[j + t]);
        if constexpr (NH == 2) a1[j] = window::mac(a1[j], h1.v[t], e[j + t]);
      }
  }
}

// Taps 4g .. 4g + 3 of the generic instantiation (the first `valid` of
// them; int8's taps are zero past the last) on the window words w of the
// group: outputs j of the lane take x[4g + j + tt] * h[4g + tt].
template <typename TIn, int WL, int NH>
__device__ __forceinline__ void fir_group(const uint32_t* w, int s, int g, int valid,
                                          const unsigned char* hs0, const unsigned char* hs1,
                                          typename Elem<TIn>::Acc (&a0)[kFirLaneOutputs],
                                          typename Elem<TIn>::Acc (&a1)[kFirLaneOutputs]) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int SZ = sizeof(TIn), R = kFirLaneOutputs;
  constexpr int NU = (7 * SZ + 3) / 4;  // words of the group's 4 + 3 elements
  uint32_t u[NU];
  fir_realign<NU, WL, SZ>(u, w, s);
  if constexpr (SZ == 1) {
    const int t0 = (int)reinterpret_cast<const uint32_t*>(hs0)[g];
    const int t1 = NH == 2 ? (int)reinterpret_cast<const uint32_t*>(hs1)[g] : 0;
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int v = fir_bytes(u, 0, j);
      a0[j] = (uint32_t)__dp4a(v, t0, (int)a0[j]);
      if constexpr (NH == 2) a1[j] = (uint32_t)__dp4a(v, t1, (int)a1[j]);
    }
  } else {
    const Four<Acc> t0 = reinterpret_cast<const Four<Acc>*>(hs0)[g];
    const Four<Acc> t1 = reinterpret_cast<const Four<Acc>*>(NH == 2 ? hs1 : hs0)[g];
    Acc e[R + 3];
#pragma unroll
    for (int k = 0; k < R + 3; ++k) e[k] = fir_elem<TIn>(u, k);
#pragma unroll
    for (int tt = 0; tt < 4; ++tt) {
      if (tt >= valid) break;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        a0[j] = window::mac(a0[j], t0.x[tt], e[j + tt]);
        if constexpr (NH == 2) a1[j] = window::mac(a1[j], t1.x[tt], e[j + tt]);
      }
    }
  }
}

// The generic instantiation's lane: the window slides one vector (4
// elements) a group of 4 taps, KV vectors of it in registers.
template <typename TIn, int WL, int NH>
__device__ __forceinline__ void fir_window_generic(
    const uint32_t* src, int s, int taps, const unsigned char* hs0, const unsigned char* hs1,
    typename Elem<TIn>::Acc (&a0)[kFirLaneOutputs], typename Elem<TIn>::Acc (&a1)[kFirLaneOutputs]) {
  constexpr int SZ = sizeof(TIn), VW = SZ;
  constexpr int NU = (7 * SZ + 3) / 4;
  constexpr int KV = (WL + NU + (SZ < 4 ? 1 : 0) + VW - 1) / VW;
  uint32_t w[KV * VW];
#pragma unroll
  for (int v = 0; v + 1 < KV; ++v) fir_lds<VW>(w + v * VW, src + v * VW);
  const int groups = taps / 4;
  for (int g = 0; g < groups; ++g) {
    fir_lds<VW>(w + (KV - 1) * VW, src + (g + KV - 1) * VW);
    fir_group<TIn, WL, NH>(w, s, g, 4, hs0, hs1, a0, a1);
#pragma unroll
    for (int k = 0; k < (KV - 1) * VW; ++k) w[k] = w[k + VW];
  }
  if (taps % 4) {
    fir_lds<VW>(w + (KV - 1) * VW, src + (groups + KV - 1) * VW);
    fir_group<TIn, WL, NH>(w, s, groups, taps % 4, hs0, hs1, a0, a1);
  }
}

// One input plane of a lane: the compile-time case of its word offset wl
// (in [0, sizeof(TIn)): the words between its first vector and its first
// input), then its window at the compiled tap count T, or the generic one.
template <typename TIn, int T, int NH, int WL = 0>
__device__ __forceinline__ void fir_plane(int wl, const uint32_t* src, int s, int taps,
                                          const FirTaps<TIn, (T > 0 ? T : 1)>& h0,
                                          const FirTaps<TIn, (T > 0 ? T : 1)>& h1,
                                          const unsigned char* hs0, const unsigned char* hs1,
                                          typename Elem<TIn>::Acc (&a0)[kFirLaneOutputs],
                                          typename Elem<TIn>::Acc (&a1)[kFirLaneOutputs]) {
  if constexpr (WL + 1 < (int)sizeof(TIn)) {
    if (wl != WL) {
      fir_plane<TIn, T, NH, WL + 1>(wl, src, s, taps, h0, h1, hs0, hs1, a0, a1);
      return;
    }
  }
  if constexpr (T > 0)
    fir_window<TIn, T, WL, NH>(src, s, h0, h1, a0, a1);
  else
    fir_window_generic<TIn, WL, NH>(src, s, taps, hs0, hs1, a0, a1);
}

// T: the compiled tap count, 0 for the generic instantiation; PLANES: 1 for
// the real FIR, 2 for the complex one.
template <typename TIn, typename TOut, int T, int PLANES>
__global__ void __launch_bounds__(kFirLanes, kFirSmLanes / PLANES / kFirLanes)
fir_kernel(const FirArgs<TIn, TOut> a) {
  using Acc = typename Elem<TIn>::Acc;
  constexpr int R = kFirLaneOutputs, SZ = sizeof(TIn);
  constexpr int VB = R * SZ;  // bytes of a lane's vector
  struct alignas(16) Out4 {
    TOut v[R];
  };
  extern __shared__ __align__(16) unsigned char fir_smem[];

  const int taps = T > 0 ? T : a.taps;
  const int lanes = blockDim.x, lane = threadIdx.x;
  const int chunk = lanes * R;
  const int slot_bytes = fir_slot_bytes(lanes, taps, SZ);
  const int taps_bytes = T > 0 ? 0 : fir_taps_bytes(taps, SZ);
  unsigned char* hs = fir_smem;                          // PLANES x taps_bytes
  unsigned char* ring = fir_smem + PLANES * taps_bytes;  // kFirStages x PLANES slots
  const long long n_in = (long long)a.n_out + taps - 1;
  const int nchunks = (int)(((long long)a.n_out + chunk - 1) / chunk);

  FirTaps<TIn, (T > 0 ? T : 1)> h[PLANES];
#pragma unroll
  for (int p = 0; p < PLANES; ++p) {
    if constexpr (T > 0) {
      h[p].load(a.h[p]);
    } else if constexpr (SZ == 1) {
      uint32_t* hw = reinterpret_cast<uint32_t*>(hs + p * taps_bytes);
      for (int m = lane; m < fir_tpad(taps) / 4; m += lanes) {
        uint32_t word = 0;
        for (int b = 0; b < 4; ++b)
          if (4 * m + b < taps) word |= (uint32_t)(uint8_t)a.h[p][4 * m + b] << (8 * b);
        hw[m] = word;
      }
    } else {
      Acc* hv = reinterpret_cast<Acc*>(hs + p * taps_bytes);
      for (int t = lane; t < fir_tpad(taps); t += lanes)
        hv[t] = t < taps ? Elem<TIn>::load(a.h[p] + t) : Acc(0);
    }
  }
  int lead[PLANES];  // where x[c0] lands in its slot (the same for every chunk)
#pragma unroll
  for (int p = 0; p < PLANES; ++p) lead[p] = (int)(reinterpret_cast<uintptr_t>(a.x[p]) & 15);

  // chunk c's inputs and halo, every plane, into ring slot `slot` as one
  // cp.async group (an empty one past the last chunk)
  auto fetch = [&](int c, int slot) {
    if (c < nchunks) {
      const long long c0 = (long long)c * chunk;
      const int n = (int)min((long long)chunk + taps - 1, n_in - c0);
#pragma unroll
      for (int p = 0; p < PLANES; ++p)
        fir_stage(ring + (slot * PLANES + p) * slot_bytes, a.x[p] + c0, n);
    }
    window::commit();
  };

#pragma unroll
  for (int i = 0; i + 1 < kFirStages; ++i) fetch(blockIdx.x + i * gridDim.x, i);
  int i = 0;
  for (int c = blockIdx.x; c < nchunks; c += gridDim.x, ++i) {
    // the slot of chunk i + 3 last held chunk i - 1, read before the
    // __syncthreads() that ended the previous chunk
    fetch(c + (kFirStages - 1) * gridDim.x, (i + kFirStages - 1) % kFirStages);
    window::wait<kFirStages - 1>();  // this thread's copies of chunk i have landed
    __syncthreads();                 // and every thread's (and the taps)
    const long long n0 = (long long)c * chunk + (long long)lane * R;
    if (n0 < a.n_out) {
      // real: acc[0]; complex: rr, ri (x_re), ii, ir (x_im)
      Acc acc[2 * PLANES][R];
#pragma unroll
      for (int q = 0; q < 2 * PLANES; ++q)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[q][j] = Acc(0);
      const unsigned char* slots = ring + (i % kFirStages) * PLANES * slot_bytes;
#pragma unroll
      for (int p = 0; p < PLANES; ++p) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            slots + p * slot_bytes + (lane + lead[p] / VB) * VB);
        const int r = lead[p] % VB;
        // x_re with (h_re, h_im), x_im with (h_im, h_re)
        fir_plane<TIn, T, PLANES>(r >> 2, src, r & 3, taps, h[p], h[PLANES - 1 - p],
                                  hs + p * taps_bytes, hs + (PLANES - 1 - p) * taps_bytes,
                                  acc[2 * p], acc[2 * p + 1]);
      }
      Out4 o[PLANES];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if constexpr (PLANES == 1) {
          o[0].v[j] = Flush<Acc, TOut>::cast(acc[0][j]);
        } else {
          o[0].v[j] = Flush<Acc, TOut>::cast(acc[0][j] - acc[2][j]);
          o[1].v[j] = Flush<Acc, TOut>::cast(acc[1][j] + acc[3][j]);
        }
      }
#pragma unroll
      for (int q = 0; q < PLANES; ++q) {
        TOut* y = a.y[q] + n0;
        if (n0 + R <= a.n_out) {
          *reinterpret_cast<Out4*>(y) = o[q];
        } else {
#pragma unroll
          for (int j = 0; j < R; ++j)
            if (n0 + j < a.n_out) y[j] = o[q].v[j];
        }
      }
    }
    __syncthreads();
  }
}

template <typename TIn, typename TOut, int T, int PLANES>
int fir_launch(const FirArgs<TIn, TOut>& a, int lanes, int blocks, cudaStream_t stream) {
  const int smem = PLANES * ((T > 0 ? 0 : fir_taps_bytes(a.taps, sizeof(TIn))) +
                             kFirStages * fir_slot_bytes(lanes, a.taps, sizeof(TIn)));
  if (smem > 48 * 1024) {
    const cudaError_t allowed = cudaFuncSetAttribute(
        fir_kernel<TIn, TOut, T, PLANES>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (allowed != cudaSuccess) return (int)allowed;
  }
  fir_kernel<TIn, TOut, T, PLANES><<<blocks, lanes, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// The compiled tap counts: 15, and 0, the generic instantiation (kept equal
// to FIR_TAPS and FIR_GENERIC in repro_torch/kernels/build.py).
template <typename TIn, typename TOut, int PLANES>
int launch_fir(int ctaps, int lanes, int blocks, const FirArgs<TIn, TOut>& a,
               cudaStream_t stream) {
  if (a.taps < 1 || a.taps > kFirMaxTaps || a.n_out < 1 || blocks < 1 ||
      (lanes != kFirLanes && lanes != kFirLanes / 2))
    return (int)cudaErrorInvalidValue;
  for (int p = 0; p < PLANES; ++p)
    if (reinterpret_cast<uintptr_t>(a.y[p]) % 16 != 0) return (int)cudaErrorInvalidValue;
  if (ctaps == 15 && a.taps == 15) return fir_launch<TIn, TOut, 15, PLANES>(a, lanes, blocks, stream);
  if (ctaps == 0) return fir_launch<TIn, TOut, 0, PLANES>(a, lanes, blocks, stream);
  return (int)cudaErrorInvalidValue;
}

template <typename TIn, typename TOut, int PLANES>
int fir_typed(const void* const* x, const void* const* h, void* const* y, int n_out, int taps,
              int ctaps, int lanes, int blocks, cudaStream_t stream) {
  FirArgs<TIn, TOut> a;
  for (int p = 0; p < 2; ++p) {
    a.x[p] = static_cast<const TIn*>(x[p]);
    a.h[p] = static_cast<const TIn*>(h[p]);
    a.y[p] = static_cast<TOut*>(y[p]);
  }
  a.n_out = n_out;
  a.taps = taps;
  return launch_fir<TIn, TOut, PLANES>(ctaps, lanes, blocks, a, stream);
}

template <int PLANES>
int fir_dtypes(int in_dtype, int out_dtype, const void* const* x, const void* const* h,
               void* const* y, int n_out, int taps, int ctaps, int lanes, int blocks,
               cudaStream_t s) {
  if (in_dtype == F32 && out_dtype == F32)
    return fir_typed<float, float, PLANES>(x, h, y, n_out, taps, ctaps, lanes, blocks, s);
  if (in_dtype == I8 && out_dtype == I32)
    return fir_typed<int8_t, int32_t, PLANES>(x, h, y, n_out, taps, ctaps, lanes, blocks, s);
  if (in_dtype == I16 && out_dtype == I32)
    return fir_typed<int16_t, int32_t, PLANES>(x, h, y, n_out, taps, ctaps, lanes, blocks, s);
  if (in_dtype == I32 && out_dtype == I32)
    return fir_typed<int32_t, int32_t, PLANES>(x, h, y, n_out, taps, ctaps, lanes, blocks, s);
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
// What bounds it on an H100: bytes.  2 * P * Q operations per output (32 at
// 4 x 4, 40 at the frontend's 5 x 4, 128 at int8's 8 x 8) against 5-8 bytes
// moved per output (I read once, O written once).  The design keeps the
// instructions under the bytes:
//
//   * The filter sizes the repository runs are compile-time cases: 4 x 4
//     (the bench's float32, int16 and int32), 8 x 8 (the bench's int8) and
//     5 x 4 (whisper's int16 frontend), with the filter in registers.  Any
//     other size up to 32 x 32 runs the generic instantiation of the same
//     kernel, with the extents at run time: up to 8 x 8 the filter in
//     registers, each row's loads issued before its products and the
//     unrolled loops ending at the filter's extents, so that a 3 x 3
//     filter spends no product on the taps it lacks; above, the filter in
//     shared memory, four filter rows a 16-byte load that all lanes read
//     at once.
//   * The row streaming of csrc/window.cuh: a block of 4 warps owns 512
//     output columns (a warp 128, a lane 4 of them 32 apart) and walks a band
//     of `rows` output rows (runtime.conv2d_tile picks it so that the grid
//     fills the card); each input row of a warp's strip and its Q - 1 halo
//     columns lands in the warp's ring once, by 16-byte cp.async copies
//     whatever the alignment (the inputs' rows are an odd number of elements
//     wide), kept 16 rows ahead.  No element is staged by a division.
//   * The window slides down the rows as P accumulators a column: an input
//     row, read from the ring once a lane, adds its Q products to each of
//     the P outputs it touches (filter row P - 1 - k to accumulator k), and
//     the oldest accumulator is complete and stored.  Each output so sums p
//     then q, the plain version's order, one fused multiply-add a product
//     in float32; integers wrap modulo 2^32.
//   * int8 with Q a multiple of 4 takes __dp4a: four int8 products into an
//     int32 an instruction, the window's 4 bytes cut from two aligned words
//     by a funnel shift (8 x 8: 16 __dp4a an output).
//
// Device memory reads each input row once a band plus the P - 1 rows the
// band below reads again ((P - 1) / rows), and each column once plus the
// Q - 1 halo columns of a strip.
// ---------------------------------------------------------------------------
constexpr int kMaxFilter = 32;
constexpr int kLaneCols = 4;  // output columns a lane, 32 apart

// A window of P x Q taps (GENERIC: of at most P x Q, the extents p x q at
// run time).
template <typename TIn, typename TOut, int P, int Q, bool GENERIC>
__global__ void __launch_bounds__(window::kThreads)
conv2d_kernel(const TIn* __restrict__ img, const TIn* __restrict__ filt, TOut* __restrict__ out,
              int oh, int ow, int p, int q, int rows) {
  using Acc = typename Elem<TIn>::Acc;
  struct alignas(16) Acc4 { Acc x[4]; };
  constexpr int LC = kLaneCols;
  constexpr int STRIP = window::kLanes * LC;  // columns a warp
  // the generic window up to 8 x 8 keeps its filter in registers, a
  // larger one in shared memory
  constexpr bool kSharedFilter = GENERIC && P * Q > 64;
  constexpr bool kDp4a = std::is_same<TIn, int8_t>::value && !GENERIC && Q % 4 == 0;
  // the window's columns past the strip, and the 3 bytes a word read of
  // __dp4a may take past them
  constexpr int HALO = (GENERIC ? kMaxFilter - 1 : Q - 1) + (kDp4a ? 4 : 0);
  constexpr int D = window::kPrefetchRows;
  constexpr int NSLOT = D + 1;  // the row landing and D in flight
  constexpr int SLOT = window::slot_bytes<TIn, STRIP + HALO>();
  __shared__ __align__(16) unsigned char ring[window::kWarps][NSLOT][SLOT];
  // fs[qq][k] = F[np - 1 - k][qq], 0 from k = np on
  __shared__ __align__(16) Acc fs[kSharedFilter ? Q : 1][kSharedFilter ? P : 4];

  const int np = GENERIC ? p : P;
  const int nq = GENERIC ? q : Q;
  if constexpr (kSharedFilter) {
    for (int e = threadIdx.x; e < P * Q; e += window::kThreads) {
      const int qq = e / P, k = e % P;
      fs[qq][k] = k < np && qq < nq ? Elem<TIn>::load(filt + (np - 1 - k) * nq + qq) : Acc(0);
    }
    __syncthreads();
  }
  const int warp = threadIdx.x / window::kLanes;
  const int lane = threadIdx.x % window::kLanes;
  const int c0 = (blockIdx.x * window::kWarps + warp) * STRIP;
  if (c0 >= ow) return;
  const int in_w = ow + nq - 1;
  const int r0 = blockIdx.y * rows;
  const int n_in = min(rows, oh - r0) + np - 1;
  const int seg = min(STRIP + nq - 1, in_w - c0);
  const window::Ring<TIn, NSLOT, SLOT> rows_in{ring[warp], img + (size_t)r0 * in_w + c0, in_w,
                                                seg, n_in, lane};

  // the filter in registers: f[pp][qq] = F[pp][qq] in a compiled window
  // (bytes packed four to a word for __dp4a); f[k][qq] = F[np - 1 - k][qq]
  // in the generic one, 0 past the filter
  constexpr int FQ = kDp4a ? Q / 4 : (kSharedFilter ? 1 : Q);
  constexpr int FP = kSharedFilter ? 1 : P;
  Acc f[FP][FQ];
  if constexpr (kDp4a) {
#pragma unroll
    for (int pp = 0; pp < P; ++pp)
#pragma unroll
      for (int m = 0; m < FQ; ++m) {
        const uint8_t* b = reinterpret_cast<const uint8_t*>(filt + pp * Q + 4 * m);
        f[pp][m] = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
      }
  } else if constexpr (!GENERIC) {
#pragma unroll
    for (int pp = 0; pp < P; ++pp)
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) f[pp][qq] = Elem<TIn>::load(filt + pp * Q + qq);
  } else if constexpr (!kSharedFilter) {
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int qq = 0; qq < Q; ++qq)
        f[k][qq] = k < np && qq < nq ? Elem<TIn>::load(filt + (np - 1 - k) * nq + qq) : Acc(0);
  }

#pragma unroll
  for (int i = 0; i < D; ++i) rows_in.fetch(i);
  // acc[k]: the output row that input row i reaches with filter row np-1-k
  Acc acc[P][LC];
#pragma unroll
  for (int k = 0; k < P; ++k)
#pragma unroll
    for (int j = 0; j < LC; ++j) acc[k][j] = Acc(0);

  for (int i = 0; i < n_in; ++i) {
    // the slot of row i + D last held row i - 1, read before the
    // __syncwarp() that ended the previous row
    rows_in.fetch(i + D);
    rows_in.template land<D>();
    const TIn* row = rows_in.row(i);
    if constexpr (kDp4a) {
      const uint32_t* words = reinterpret_cast<const uint32_t*>(rows_in.slot(i));
      const int lead = (int)(row - reinterpret_cast<const TIn*>(words));
#pragma unroll
      for (int j = 0; j < LC; ++j) {
        const int x = lead + lane + window::kLanes * j;  // the window's first byte
        uint32_t wd[FQ + 1];
#pragma unroll
        for (int m = 0; m <= FQ; ++m) wd[m] = words[(x >> 2) + m];
#pragma unroll
        for (int m = 0; m < FQ; ++m) {
          const int v = (int)__funnelshift_r(wd[m], wd[m + 1], 8 * (x & 3));
#pragma unroll
          for (int k = 0; k < P; ++k)
            acc[k][j] = (uint32_t)__dp4a(v, (int)f[P - 1 - k][m], (int)acc[k][j]);
        }
      }
    } else if constexpr (!GENERIC) {
#pragma unroll
      for (int j = 0; j < LC; ++j)
#pragma unroll
        for (int qq = 0; qq < Q; ++qq) {
          const Acc v = Elem<TIn>::load(row + lane + window::kLanes * j + qq);
#pragma unroll
          for (int k = 0; k < P; ++k) acc[k][j] = window::mac(acc[k][j], f[P - 1 - k][qq], v);
        }
    } else if constexpr (!kSharedFilter) {
      // every load of the row first (Q <= 8 columns past the lane's lie in
      // the slot), then the products the filter has
      Acc v[Q][LC];
#pragma unroll
      for (int qq = 0; qq < Q; ++qq)
#pragma unroll
        for (int j = 0; j < LC; ++j) v[qq][j] = Elem<TIn>::load(row + lane + window::kLanes * j + qq);
#pragma unroll
      for (int qq = 0; qq < Q; ++qq) {
        if (qq >= nq) break;
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (k >= np) break;
#pragma unroll
          for (int j = 0; j < LC; ++j) acc[k][j] = window::mac(acc[k][j], f[k][qq], v[qq][j]);
        }
      }
    } else {
      for (int qq = 0; qq < nq; ++qq) {
        Acc v[LC];
#pragma unroll
        for (int j = 0; j < LC; ++j) v[j] = Elem<TIn>::load(row + lane + window::kLanes * j + qq);
        // four filter rows a 16-byte load; the products past np (of the
        // filter's 0) reach only accumulators that no output reads
#pragma unroll
        for (int kb = 0; kb < P; kb += 4) {
          if (kb >= np) break;
          const Acc4 w = *reinterpret_cast<const Acc4*>(&fs[qq][kb]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int j = 0; j < LC; ++j)
              acc[kb + u][j] = window::mac(acc[kb + u][j], w.x[u], v[j]);
        }
      }
    }
    if (i >= np - 1) {
      TOut* o = out + (size_t)(r0 + i - (np - 1)) * ow + c0;
#pragma unroll
      for (int j = 0; j < LC; ++j) {
        const int c = lane + window::kLanes * j;
        if (c0 + c < ow) o[c] = Flush<Acc, TOut>::cast(acc[0][j]);
      }
    }
    // slide: acc[np - 1] starts the next output row from 0
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (k >= np) break;
#pragma unroll
      for (int j = 0; j < LC; ++j) acc[k][j] = k + 1 < np ? acc[k + 1][j] : Acc(0);
    }
    __syncwarp();
  }
}

template <typename TIn, typename TOut, int P, int Q, bool GENERIC>
int conv2d_window(const void* img, const void* filt, void* out, int oh, int ow, int p, int q,
                  int rows, cudaStream_t stream) {
  constexpr int block_cols = window::kWarps * window::kLanes * kLaneCols;
  const dim3 grid((unsigned)((ow + block_cols - 1) / block_cols), (unsigned)((oh + rows - 1) / rows));
  conv2d_kernel<TIn, TOut, P, Q, GENERIC><<<grid, window::kThreads, 0, stream>>>(
      static_cast<const TIn*>(img), static_cast<const TIn*>(filt), static_cast<TOut*>(out), oh,
      ow, p, q, rows);
  return (int)cudaGetLastError();
}

// The compiled windows: 4 x 4, 8 x 8 and 5 x 4, and (0, 0), the generic
// instantiation, with the filter in registers up to 8 x 8 and in shared
// memory above (kept equal to CONV2D_WINDOWS and CONV2D_GENERIC_SMALL in
// repro_torch/kernels/build.py).
template <typename TIn, typename TOut>
int launch_conv2d(int wp, int wq, int rows, const void* img, const void* filt, void* out, int oh,
                  int ow, int p, int q, cudaStream_t stream) {
  if (p < 1 || q < 1 || p > kMaxFilter || q > kMaxFilter || oh < 1 || ow < 1 || rows < 1)
    return (int)cudaErrorInvalidValue;
  if (wp == 4 && wq == 4 && p == 4 && q == 4)
    return conv2d_window<TIn, TOut, 4, 4, false>(img, filt, out, oh, ow, p, q, rows, stream);
  if (wp == 8 && wq == 8 && p == 8 && q == 8)
    return conv2d_window<TIn, TOut, 8, 8, false>(img, filt, out, oh, ow, p, q, rows, stream);
  if (wp == 5 && wq == 4 && p == 5 && q == 4)
    return conv2d_window<TIn, TOut, 5, 4, false>(img, filt, out, oh, ow, p, q, rows, stream);
  if (wp == 0 && wq == 0 && p <= 8 && q <= 8)
    return conv2d_window<TIn, TOut, 8, 8, true>(img, filt, out, oh, ow, p, q, rows, stream);
  if (wp == 0 && wq == 0)
    return conv2d_window<TIn, TOut, kMaxFilter, kMaxFilter, true>(img, filt, out, oh, ow, p, q,
                                                                 rows, stream);
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

// y[n] = sum_t x[n + t] h[t] for n < n_out (the fir recurrence) on the
// compiled tap count ctaps (0: the generic instantiation), `lanes` lanes a
// block and `blocks` blocks.  Returns a cudaError_t.
int widesa_fir_launch(const void* x, const void* h, void* y, int n_out, int taps,
                      int in_dtype, int out_dtype, int ctaps, int lanes, int blocks,
                      void* stream) {
  const void* xs[2] = {x, x};
  const void* hs[2] = {h, h};
  void* ys[2] = {y, y};
  return fir_dtypes<1>(in_dtype, out_dtype, xs, hs, ys, n_out, taps, ctaps, lanes, blocks,
                       static_cast<cudaStream_t>(stream));
}

// The complex FIR, (y_re, y_im) = (rr - ii, ri + ir), in one launch, as
// widesa_fir_launch.  Returns a cudaError_t.
int widesa_fir_complex_launch(const void* x_re, const void* x_im, const void* h_re,
                              const void* h_im, void* y_re, void* y_im, int n_out, int taps,
                              int in_dtype, int out_dtype, int ctaps, int lanes, int blocks,
                              void* stream) {
  const void* xs[2] = {x_re, x_im};
  const void* hs[2] = {h_re, h_im};
  void* ys[2] = {y_re, y_im};
  return fir_dtypes<2>(in_dtype, out_dtype, xs, hs, ys, n_out, taps, ctaps, lanes, blocks,
                       static_cast<cudaStream_t>(stream));
}

// O[r, c] = sum_{p,q} I[r + p, c + q] F[p, q] over an oh x ow output (the
// conv2d recurrence) on the compiled window (wp, wq), (0, 0) for the
// generic one; each warp walks `rows` output rows.  Returns a cudaError_t.
int widesa_conv2d_launch(const void* img, const void* filt, void* out, int oh, int ow, int p,
                         int q, int in_dtype, int out_dtype, int wp, int wq, int rows,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (in_dtype == F32 && out_dtype == F32)
    return launch_conv2d<float, float>(wp, wq, rows, img, filt, out, oh, ow, p, q, s);
  if (in_dtype == I8 && out_dtype == I32)
    return launch_conv2d<int8_t, int32_t>(wp, wq, rows, img, filt, out, oh, ow, p, q, s);
  if (in_dtype == I16 && out_dtype == I32)
    return launch_conv2d<int16_t, int32_t>(wp, wq, rows, img, filt, out, oh, ow, p, q, s);
  if (in_dtype == I32 && out_dtype == I32)
    return launch_conv2d<int32_t, int32_t>(wp, wq, rows, img, filt, out, oh, ow, p, q, s);
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
