// Gradient of the RG-LRU scan for Hopper (sm_90a): the backward of
// rglru_scan.cu's recurrence h_t = a_t h_{t-1} + b_t, h_{-1} = 0.
//
// Replaces no TPU kernel: the reference has no Pallas backward. Its
// training step differentiates a plain lax.scan (src/repro/nn/rglru.py:80),
// which XLA compiles into one loop on the device. This kernel is that
// loop on the card, the CUDA implementation of the operator
// repro_torch::rglru_scan_backward (ops.py). For t from T - 1 down to 0,
// per (b, w) column, with grad g of the fp32 output h:
//
//   carry = g_t + a_{t+1} carry   (carry = g_{T-1} at the last step)
//   da_t  = carry h_{t-1}          (h_{-1} = 0)
//   db_t  = carry
//
// Each product and sum rounds on its own (__fmul_rn, __fadd_rn, no fused
// multiply-add), in the order of ref.py::rglru_scan_backward_ref, and the
// results are cast to a's dtype and to b's with round-to-nearest-even, so
// the kernel equals the plain version bit for bit.
//
// Bound on this card: bytes. Each element reads g, a and h once and
// writes da and db once, 3 flops: at the training shape (B 8, T 128,
// W 2560, fp32) 20 bytes an element, 52.4 MB, 15.6 us at 3.35 TB/s. The
// design is the simple one: one thread per column, going backward in
// time; it loads RGB_CHUNK steps of g, a and h into registers (all in
// flight at once) before running their part of the chain. Neighbouring
// threads take neighbouring columns, so with unit width strides each load
// and store of a warp is one contiguous row. grad, a and h are read in
// place through their strides, each in its own float type (an expanded
// gradient, stride 0, is read as it is).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define RGB_THREADS 64  // columns per block
#define RGB_CHUNK 16    // time steps of the operands held in registers at once

enum RgDtype { RG_F32 = 0, RG_BF16 = 1, RG_F16 = 2 };

struct RgOperand {
  const void* ptr;
  long long sb, st, sw;  // element strides of B, T, W
  int dtype;
};

__device__ __forceinline__ float load_f32(const void* p, long long i, int dtype) {
  switch (dtype) {
    case RG_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case RG_F16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_cast(void* p, long long i, float x, int dtype) {
  switch (dtype) {
    case RG_BF16: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x); break;
    case RG_F16: static_cast<__half*>(p)[i] = __float2half_rn(x); break;
    default: static_cast<float*>(p)[i] = x;
  }
}

// da (a's dtype) and db (b's dtype) are contiguous (B, T, W).
__global__ void __launch_bounds__(RGB_THREADS)
rglru_scan_backward_kernel(const RgOperand g, const RgOperand a, const RgOperand h, void* da,
                           void* db, int da_dtype, int db_dtype, int B, int T, int W) {
  const long long col = static_cast<long long>(blockIdx.x) * RGB_THREADS + threadIdx.x;
  if (col >= static_cast<long long>(B) * W) return;
  const long long b = col / W, w = col % W;
  const long long gb = b * g.sb + w * g.sw, ab = b * a.sb + w * a.sw, hb = b * h.sb + w * h.sw;
  const long long ob = b * T * W + w;
  float carry = 0.f;
#pragma unroll 1
  for (int t1 = T; t1 > 0; t1 -= RGB_CHUNK) {  // steps t1 - 1 down to t1 - n
    const int n = min(RGB_CHUNK, t1);
    float gv[RGB_CHUNK], an[RGB_CHUNK], hp[RGB_CHUNK];
#pragma unroll
    for (int u = 0; u < RGB_CHUNK; ++u) {
      const int t = t1 - 1 - u;
      if (u < n) {
        gv[u] = load_f32(g.ptr, gb + t * g.st, g.dtype);
        an[u] = t + 1 < T ? load_f32(a.ptr, ab + (t + 1) * a.st, a.dtype) : 0.f;
        hp[u] = t > 0 ? load_f32(h.ptr, hb + (t - 1) * h.st, h.dtype) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < RGB_CHUNK; ++u) {
      const int t = t1 - 1 - u;
      if (u < n) {
        carry = t + 1 < T ? __fadd_rn(gv[u], __fmul_rn(an[u], carry)) : gv[u];
        store_cast(da, ob + static_cast<long long>(t) * W, __fmul_rn(carry, hp[u]), da_dtype);
        store_cast(db, ob + static_cast<long long>(t) * W, carry, db_dtype);
      }
    }
  }
}

extern "C" {

// Launches the backward on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, so the wrapper must check it).
// grad, a, h: (B, T, W) with their B, T, W element strides in `strides`
// (3 each, in that order); `dtypes` holds the type codes of grad, a, h,
// da and db. da and db are contiguous (B, T, W).
cudaError_t rglru_scan_backward_launch(const void* grad, const void* a, const void* h, void* da,
                                       void* db, const long long* strides, const int* dtypes,
                                       int B, int T_len, int W, void* stream) {
  if (B <= 0 || T_len <= 0 || W <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (dtypes[i] < RG_F32 || dtypes[i] > RG_F16) return cudaErrorInvalidValue;
  const void* ptrs[3] = {grad, a, h};
  RgOperand ops[3];
  for (int i = 0; i < 3; ++i) {
    ops[i].ptr = ptrs[i];
    ops[i].sb = strides[3 * i];
    ops[i].st = strides[3 * i + 1];
    ops[i].sw = strides[3 * i + 2];
    ops[i].dtype = dtypes[i];
  }
  const long long blocks = (static_cast<long long>(B) * W + RGB_THREADS - 1) / RGB_THREADS;
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  rglru_scan_backward_kernel<<<static_cast<unsigned>(blocks), RGB_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      ops[0], ops[1], ops[2], da, db, dtypes[3], dtypes[4], B, T_len, W);
  return cudaGetLastError();
}

const char* rglru_scan_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
