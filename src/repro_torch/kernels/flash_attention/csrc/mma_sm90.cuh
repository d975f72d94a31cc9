// Warp-level tensor-core and asynchronous-copy instructions (sm_80 and
// later, so sm_90a) as inline PTX, for the 16-bit flash attention kernel.
//
//   cp.async.cg        16-byte global -> shared copy that bypasses L1 and
//                      does not stall the issuing thread; src_bytes 0
//                      writes 16 zero bytes and reads nothing
//   ldmatrix .x4       four 8x8 tiles of 16-bit values from shared memory
//                      into the mma fragment layout (row i of a tile from
//                      the address given by lane 8 * tile + i); .trans
//                      gives the transposed fragments
//   mma.sync m16n8k16  D(16x8, fp32) += A(16x16) * B(16x8), A and B bf16
//                      or fp16, accumulating in fp32
//
// Fragments (g = lane / 4, t = lane % 4): A holds a0 = (row g, cols 2t,
// 2t+1), a1 = (g + 8, 2t..), a2 = (g, 2t + 8..), a3 = (g + 8, 2t + 8..);
// B holds b0 = (rows 2t, 2t+1, col g), b1 = (rows 2t + 8.., col g); the
// fp32 accumulator c0, c1 = (row g, cols 2t, 2t+1), c2, c3 = (row g + 8,
// cols 2t, 2t+1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_16(unsigned dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The 16-bit operand types: mma on them, and a pair of fp32 values
// rounded to nearest into one 32-bit register (first value in the low
// half, the lower column of a fragment).
template <typename T>
struct Mma16;

template <>
struct Mma16<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float x, float y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(unsigned u) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
  }
};

template <>
struct Mma16<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                             unsigned b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ unsigned pack(float x, float y) {
    const __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&v);
  }
  static __device__ __forceinline__ float2 unpack(unsigned u) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  }
};

// Splits two fp32 values into hi = T(x) and lo = T(x - hi), each pair
// packed as a fragment register. x - hi is exact in fp32, so hi + lo is
// within 2^-18 |x| of x in bf16 and 2^-22 |x| in fp16 (above fp16's
// subnormals), where hi alone is within 2^-9 |x| and 2^-11 |x|.
template <typename T>
__device__ __forceinline__ void split_pair(float x, float y, unsigned& hi, unsigned& lo) {
  hi = Mma16<T>::pack(x, y);
  const float2 h = Mma16<T>::unpack(hi);
  lo = Mma16<T>::pack(x - h.x, y - h.y);
}
