// Fused hypersolver update for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/hyper_step/hyper_step.py
// (_rk_kernel, launched through pl.pallas_call by rk_update_batched; public
// entry ops.py::fused_rk_update). Per batch row i and element n:
//
//   out[i,n] = active[i] ? z[i,n] + sum_j (eps[i]*b_j) * r_j[i,n]
//                                 + epsp[i] * g[i,n]
//                        : z[i,n]
//
// accumulated in fp32 in exactly the reference's order (z, then each live
// stage, then g), with no fused multiply-adds (__fmul_rn / __fadd_rn), so
// the result equals the plain PyTorch version in ref.py bit for bit in
// fp32 and the single final rounding to the storage type is the only one.
//
// Bound: pure memory traffic. The update reads each operand once and
// writes the state once, (live_stages + 2 + has_g) * B * N * itemsize
// bytes, against 2 flops per stage per element; at the serving shape
// (B = 8, N = 128 * 2560, bf16) that is ~21 MB, ~6.3 us at 3.35 TB/s.
// Design against that bound:
//   * every operand is viewed as (B, N); the grid is (cdiv(N, TILE), B),
//     each thread owns VEC = 8 consecutive elements and moves them with
//     16-byte vector loads/stores (two for fp32), and the ragged tail is
//     masked in the kernel — no padding copies (the TPU kernel's (R, 128)
//     lane padding has no use here);
//   * each block reads eps[i], epsp[i] and active[i] once, and a frozen
//     row (active[i] == 0) copies z without reading its stages or g;
//   * b_j and the stage pointers travel by value in the kernel-parameter
//     struct (at most HS_MAX_STAGES live stages: DOPRI5 has five);
//   * the state type is a template parameter (fp32, bf16, fp16); each
//     stage and g carry their own runtime dtype code, because a bf16
//     state under a per-sample fp32 eps evaluates later RK stages in fp32
//     (the reference's type promotion) and the kernel reads them as is.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define HS_MAX_STAGES 6
#define HS_THREADS 256
#define HS_VEC 8
#define HS_TILE (HS_THREADS * HS_VEC)

enum HsDtype { HS_F32 = 0, HS_BF16 = 1, HS_F16 = 2 };

struct HyperStepParams {
  const void* z;
  void* out;
  const void* stage[HS_MAX_STAGES];
  float b[HS_MAX_STAGES];
  int stage_dtype[HS_MAX_STAGES];
  const void* g;  // nullptr: no correction term
  int g_dtype;
  int n_stages;
  const float* eps;   // (B,)
  const float* epsp;  // (B,) eps^(order+1), computed by the wrapper in fp32
  const int* active;  // (B,)
  long long n;        // elements per batch row
  int vec;            // 1: n % HS_VEC == 0 and every pointer 16-byte aligned
};

template <typename T> __device__ __forceinline__ float to_f32(T v);
template <> __device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <> __device__ __forceinline__ float to_f32<__half>(__half v) {
  return __half2float(v);
}

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half_rn(v);
}

// Eight consecutive elements from a 16-byte aligned address.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float (&v)[HS_VEC]) {
  if constexpr (sizeof(T) == 4) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 c = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
  } else {
    alignas(16) T t[HS_VEC];
    *reinterpret_cast<uint4*>(t) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int k = 0; k < HS_VEC; ++k) v[k] = to_f32<T>(t[k]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[HS_VEC]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    alignas(16) T t[HS_VEC];
#pragma unroll
    for (int k = 0; k < HS_VEC; ++k) t[k] = from_f32<T>(v[k]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(t);
  }
}

__device__ __forceinline__ void load8_any(const void* base, int dtype, long long e,
                                          float (&v)[HS_VEC]) {
  switch (dtype) {
    case HS_F32: load8(static_cast<const float*>(base) + e, v); break;
    case HS_BF16: load8(static_cast<const __nv_bfloat16*>(base) + e, v); break;
    default: load8(static_cast<const __half*>(base) + e, v); break;
  }
}

__device__ __forceinline__ float load1_any(const void* base, int dtype, long long e) {
  switch (dtype) {
    case HS_F32: return static_cast<const float*>(base)[e];
    case HS_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(base)[e]);
    default: return __half2float(static_cast<const __half*>(base)[e]);
  }
}

template <typename T>
__global__ void __launch_bounds__(HS_THREADS) hyper_step_kernel(const HyperStepParams p) {
  const long long row = blockIdx.y;
  const long long e0 = static_cast<long long>(blockIdx.x) * HS_TILE
                       + static_cast<long long>(threadIdx.x) * HS_VEC;
  if (e0 >= p.n) return;
  const long long base = row * p.n;
  const T* z = static_cast<const T*>(p.z) + base;
  T* out = static_cast<T*>(p.out) + base;
  const bool act = p.active[row] != 0;
  const float eps = p.eps[row];
  const float epsp = p.epsp[row];
  float coef[HS_MAX_STAGES];
#pragma unroll
  for (int j = 0; j < HS_MAX_STAGES; ++j) coef[j] = __fmul_rn(eps, p.b[j]);

  if (p.vec) {  // n % HS_VEC == 0: every thread's eight elements are in range
    float z32[HS_VEC], acc[HS_VEC], v[HS_VEC];
    load8(z + e0, z32);
    if (!act) {
      store8(out + e0, z32);
      return;
    }
#pragma unroll
    for (int k = 0; k < HS_VEC; ++k) acc[k] = z32[k];
#pragma unroll
    for (int j = 0; j < HS_MAX_STAGES; ++j) {
      if (j < p.n_stages) {
        load8_any(p.stage[j], p.stage_dtype[j], base + e0, v);
#pragma unroll
        for (int k = 0; k < HS_VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(coef[j], v[k]));
      }
    }
    if (p.g != nullptr) {
      load8_any(p.g, p.g_dtype, base + e0, v);
#pragma unroll
      for (int k = 0; k < HS_VEC; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(epsp, v[k]));
    }
    store8(out + e0, acc);
    return;
  }

  // unaligned or ragged rows: element by element, tail masked
  for (int k = 0; k < HS_VEC; ++k) {
    const long long e = e0 + k;
    if (e >= p.n) break;
    const float zk = to_f32<T>(z[e]);
    float acc = zk;
    if (act) {
#pragma unroll
      for (int j = 0; j < HS_MAX_STAGES; ++j) {
        if (j < p.n_stages) {
          acc = __fadd_rn(acc, __fmul_rn(coef[j], load1_any(p.stage[j], p.stage_dtype[j], base + e)));
        }
      }
      if (p.g != nullptr) {
        acc = __fadd_rn(acc, __fmul_rn(epsp, load1_any(p.g, p.g_dtype, base + e)));
      }
    }
    out[e] = from_f32<T>(act ? acc : zk);
  }
}

extern "C" {

// Launches the update on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, so the wrapper must check this).
// `stages`, `stage_dtypes` and `b` are host arrays of length n_stages.
cudaError_t hyper_step_launch(const void* z, void* out, int z_dtype,
                              const void* const* stages, const int* stage_dtypes,
                              const float* b, int n_stages, const void* g, int g_dtype,
                              const float* eps, const float* epsp, const int* active,
                              long long batch, long long n, int vec, void* stream) {
  if (n_stages < 0 || n_stages > HS_MAX_STAGES) return cudaErrorInvalidValue;
  if (batch <= 0 || batch > 65535 || n <= 0) return cudaErrorInvalidValue;
  HyperStepParams p = {};
  p.z = z;
  p.out = out;
  for (int j = 0; j < n_stages; ++j) {
    p.stage[j] = stages[j];
    p.stage_dtype[j] = stage_dtypes[j];
    p.b[j] = b[j];
  }
  p.g = g;
  p.g_dtype = g_dtype;
  p.n_stages = n_stages;
  p.eps = eps;
  p.epsp = epsp;
  p.active = active;
  p.n = n;
  p.vec = vec;
  const dim3 grid(static_cast<unsigned>((n + HS_TILE - 1) / HS_TILE),
                  static_cast<unsigned>(batch));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (z_dtype) {
    case HS_F32: hyper_step_kernel<float><<<grid, HS_THREADS, 0, s>>>(p); break;
    case HS_BF16: hyper_step_kernel<__nv_bfloat16><<<grid, HS_THREADS, 0, s>>>(p); break;
    case HS_F16: hyper_step_kernel<__half><<<grid, HS_THREADS, 0, s>>>(p); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* hyper_step_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
