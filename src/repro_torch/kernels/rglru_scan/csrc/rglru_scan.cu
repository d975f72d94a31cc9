// RG-LRU linear recurrence scan for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan/rglru_scan.py:58
// (`_kernel` :26 inside rglru_scan_btw :51, launched through
// pl.pallas_call; public entry ops.py::rglru_scan :15). Elementwise over
// the width W, sequential over time T:
//
//   h[b,t,w] = a[b,t,w] * h[b,t-1,w] + b[b,t,w],   h[b,-1,w] = 0
//
// with an fp32 carry and an fp32 output, as the Pallas out_shape is. The
// update is __fmul_rn then __fadd_rn (no fused multiply-add), the plain
// version's order, so the kernel equals ref.py bit for bit in fp32.
//
// Bound on this card: bytes. Each step reads a and b once and writes h
// once, 2 flops per element: at the serving shape (B 8, T 128, W 2560,
// fp32) that is 31.5 MB, ~9.4 us at 3.35 TB/s. The recurrence is a serial
// chain per channel; the parallelism is B * W channels, not time. Design:
//   * one thread per (b, w) channel, the carry in a register; the TPU
//     kernel's chunk axis and its VMEM scratch carry exist for VMEM and
//     have no counterpart here, and nothing is padded: the block masks
//     the ragged W;
//   * neighbouring threads read neighbouring w, so every load and store
//     of a time step coalesces across the block;
//   * the loads of RG_UNROLL = 16 steps are issued before the chain that
//     consumes them (they do not depend on the carry), so a thread keeps
//     32 loads in flight instead of waiting out each step's latency.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define RG_THREADS 128
#define RG_UNROLL 16

enum RgDtype { RG_F32 = 0, RG_BF16 = 1, RG_F16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__global__ void __launch_bounds__(RG_THREADS)
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ h,
                  int T_len, int W) {
  const int w = blockIdx.x * RG_THREADS + threadIdx.x;
  if (w >= W) return;
  const long long base = static_cast<long long>(blockIdx.y) * T_len * W + w;
  float carry = 0.f;
  int t = 0;
  for (; t + RG_UNROLL <= T_len; t += RG_UNROLL) {
    float av[RG_UNROLL], bv[RG_UNROLL];
#pragma unroll
    for (int u = 0; u < RG_UNROLL; ++u) {
      const long long e = base + static_cast<long long>(t + u) * W;
      av[u] = to_f32(a[e]);
      bv[u] = to_f32(b[e]);
    }
#pragma unroll
    for (int u = 0; u < RG_UNROLL; ++u) {
      carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
      h[base + static_cast<long long>(t + u) * W] = carry;
    }
  }
  for (; t < T_len; ++t) {
    const long long e = base + static_cast<long long>(t) * W;
    carry = __fadd_rn(__fmul_rn(to_f32(a[e]), carry), to_f32(b[e]));
    h[e] = carry;
  }
}

extern "C" {

// Launches the scan on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, so the wrapper must check this).
// a, b: contiguous (B, T, W) of `dtype`; h: contiguous fp32 (B, T, W).
cudaError_t rglru_scan_launch(const void* a, const void* b, float* h, int dtype, int B,
                              int T_len, int W, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || W <= 0) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>((W + RG_THREADS - 1) / RG_THREADS),
                  static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RG_F32:
      rglru_scan_kernel<float><<<grid, RG_THREADS, 0, s>>>(
          static_cast<const float*>(a), static_cast<const float*>(b), h, T_len, W);
      break;
    case RG_BF16:
      rglru_scan_kernel<__nv_bfloat16><<<grid, RG_THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b), h, T_len,
          W);
      break;
    case RG_F16:
      rglru_scan_kernel<__half><<<grid, RG_THREADS, 0, s>>>(
          static_cast<const __half*>(a), static_cast<const __half*>(b), h, T_len, W);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
