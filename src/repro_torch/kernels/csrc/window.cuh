// Row streaming for the window kernels: the star stencils of
// csrc/widesa_hpc.cu (star_kernel) and conv2d in csrc/widesa_sp.cu
// (conv2d_kernel).  Both are window contractions bound by bytes, built on
// one design:
//
//   * A block is kWarps warps side by side.  Each warp owns a strip of
//     output columns (32 lanes, a lane's columns 32 apart, so that every
//     load from shared memory and every store to device memory is one run
//     of consecutive addresses across the warp) and walks a band of output
//     rows down the grid.
//   * Each input row of the strip, with its halo, reaches the SM once: the
//     warp copies it into a ring of row slots in its own part of shared
//     memory with 16-byte cp.async copies, keeping kPrefetchRows later rows
//     in flight while it computes on the rows that have landed (8 KB of
//     float32 rows a warp: on an H100 float32 ran faster with 16 rows in
//     flight than with 4 or 8, the narrower types alike).  The ring is the
//     warp's alone, so __syncwarp() is the only barrier.
//   * Any alignment takes 16-byte copies: a row is copied as the aligned
//     16-byte units that hold it, and its first element lands lead(src)
//     elements into the slot.
//   * Each input row is read from shared memory once a lane, into a window
//     that slides down the rows in registers (the kernels say which).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace window {

constexpr int kLanes = 32;
constexpr int kWarps = 4;                  // warps a block, side by side
constexpr int kThreads = kWarps * kLanes;  // 128
constexpr int kPrefetchRows = 16;          // later rows a warp keeps in flight

// Bytes of a ring slot for ELEMS elements of T that start anywhere in a
// 16-byte unit (one unit more than the elements fill).
template <typename T, int ELEMS>
__host__ __device__ constexpr int slot_bytes() {
  return ((ELEMS * (int)sizeof(T) + 15) / 16 + 1) * 16;
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc + w * v: one fused multiply-add in float32 (one rounding), modulo
// 2^32 in the integers (sign-extended to uint32).
__device__ __forceinline__ float mac(float acc, float w, float v) { return fmaf(w, v, acc); }
__device__ __forceinline__ uint32_t mac(uint32_t acc, uint32_t w, uint32_t v) {
  return acc + w * v;
}

// Where src[0] lands in a slot that stage() filled from src: its element
// offset inside its 16-byte unit.
template <typename T>
__device__ __forceinline__ int lead(const T* src) {
  return (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(T));
}

// Copy the n > 0 elements src[0 .. n) of one row into `slot` (16-byte
// aligned) as the 16-byte units that hold them, the warp's lanes a unit
// each in turn: src[x] lands at element lead(src) + x of the slot.  A unit
// that holds an element of the row lies inside that element's memory page,
// so no copy can fault, whatever the alignment of the row; the bytes it
// brings from beyond the row feed only outputs past the edge, which are
// masked.
template <typename T>
__device__ __forceinline__ void stage(unsigned char* slot, const T* src, int n, int lane) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t a0 = a & ~uintptr_t(15);
  const int units = (int)((a - a0 + (uintptr_t)n * sizeof(T) + 15) >> 4);
  for (int u = lane; u < units; u += kLanes)
    cp16(slot + 16 * u, reinterpret_cast<const void*>(a0 + 16 * (uintptr_t)u));
}

// The ring of row slots of one warp: NSLOT slots of SLOT bytes that take
// rows src[i * pitch ...] of n in turn, seg elements each.  fetch(i) copies
// row i (if there is one) into its slot as one cp.async group; after
// land<D>() row i is there for every lane, D later rows still in flight.
template <typename T, int NSLOT, int SLOT>
struct Ring {
  unsigned char (*slots)[SLOT];
  const T* src;
  int pitch, seg, n, lane;

  __device__ __forceinline__ unsigned char* slot(int i) const { return slots[i % NSLOT]; }
  __device__ __forceinline__ const T* row(int i) const {
    return reinterpret_cast<const T*>(slot(i)) + lead(src + (size_t)i * pitch);
  }
  __device__ __forceinline__ void fetch(int i) const {
    if (i < n) stage(slot(i), src + (size_t)i * pitch, seg, lane);
    commit();
  }
  template <int D>
  __device__ __forceinline__ void land() const {
    wait<D>();  // this lane's copies of the row have landed
    __syncwarp();  // and every lane's
  }
};

}  // namespace window
