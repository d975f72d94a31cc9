// WKV6 recurrence of RWKV-6 "Finch" for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rwkv6_scan/rwkv6_scan.py:71
// (`_kernel` :29 inside wkv6_bthd :62, launched through pl.pallas_call;
// public entry ops.py::wkv6 :15). Per (batch b, head h), with a (D, D)
// fp32 state S and fp32 output o:
//
//   kv  = k_t^T v_t                     (outer product)
//   o_t = r_t (S_{t-1} + diag(u) kv)
//   S_t = diag(w_t) S_{t-1} + kv,       S_{-1} = S0 or 0
//
// Every operand converts to fp32 on load, as the Pallas kernel's
// `.astype(jnp.float32)` does. The state update and the bonus term round
// each multiply and add on its own (__fmul_rn, __fadd_rn), the order of
// the plain version (ref.py), so the state is the plain version's bit for
// bit; only the D-term dot product of o_t is summed in another order.
//
// Bound on this card: operations. 7 flops per state element per token:
// at the serving shape (B 8, T 128, H 32, D 64) that is 0.94 GFLOP,
// 14.0 us at the 67 TFLOP/s fp32 rate, against 29.4 MB of operands and
// output (bf16 r, k, v; fp32 w and o), 8.8 us at 3.35 TB/s. The
// recurrence is serial in T; the parallelism is B * H * D state columns.
// Design:
//   * one block per (head, batch), D threads; thread j owns column j of
//     the state, S[:, j], in D registers (D is a template parameter, so
//     the loop over i unrolls and S never leaves registers). The TPU
//     kernel's 128-token chunks and its VMEM scratch state exist for
//     VMEM and have no counterpart here;
//   * r, k, v, w of WKV_TILE = 8 tokens are staged in shared memory once
//     per tile (one pair of __syncthreads per tile, not per token); the
//     reads of r_t[i], k_t[i], w_t[i], u[i] are broadcasts, four lanes at
//     a time as float4;
//   * the loads of the next tile are issued, as raw 16- or 32-bit words
//     into registers, before the current tile's arithmetic and converted
//     to fp32 only when staged, so the latency of device memory hides
//     behind a tile of arithmetic instead of stalling every token (a load
//     converted on arrival waits for it);
//   * r, k, v, w are read in (B, T, H, D) in place through their strides,
//     each in its own float type; nothing is padded: the last tile masks
//     the ragged tail of T;
//   * the D-term dot product of o_t keeps 4 partial sums, so the chain of
//     dependent adds is D / 4 long.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define WKV_TILE 8

enum WkvDtype { WKV_F32 = 0, WKV_BF16 = 1, WKV_F16 = 2 };

struct WkvOperand {
  const void* ptr;
  long long sb, st, sh;  // element strides of B, T, H; the D stride is 1
  int dtype;
};

struct WkvArgs {
  WkvOperand r, k, v, w;
  const void* u;  // (H, D), contiguous
  int u_dtype;
  const float* S0;  // (B, H, D, D) or null: start from zero
  float* o;         // (B, T, H, D), contiguous
  float* S_T;       // (B, H, D, D) or null: no write
  int T, H;
};

__device__ __forceinline__ float load_f32(const void* p, long long i, int dtype) {
  switch (dtype) {
    case WKV_BF16:
      return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case WKV_F16:
      return __half2float(static_cast<const __half*>(p)[i]);
    default:
      return static_cast<const float*>(p)[i];
  }
}

// Issues the loads of tokens t0 .. t0 + n - 1 of one operand's column
// `base` as raw words (zero past n); nothing here waits for them.
__device__ __forceinline__ void fetch(const WkvOperand& x, long long base, int t0, int n,
                                      unsigned (&raw)[WKV_TILE]) {
  if (x.dtype == WKV_F32) {
    const unsigned* p = static_cast<const unsigned*>(x.ptr) + base;
#pragma unroll
    for (int tt = 0; tt < WKV_TILE; ++tt)
      raw[tt] = tt < n ? __ldg(p + static_cast<long long>(t0 + tt) * x.st) : 0u;
  } else {
    const unsigned short* p = static_cast<const unsigned short*>(x.ptr) + base;
#pragma unroll
    for (int tt = 0; tt < WKV_TILE; ++tt)
      raw[tt] = tt < n ? static_cast<unsigned>(__ldg(p + static_cast<long long>(t0 + tt) * x.st))
                       : 0u;
  }
}

// Converts fetched words to fp32 into column j of a staged tile.
template <int D>
__device__ __forceinline__ void stage(float (&dst)[WKV_TILE][D], const unsigned (&raw)[WKV_TILE],
                                      int dtype, int j) {
  if (dtype == WKV_BF16) {
#pragma unroll
    for (int tt = 0; tt < WKV_TILE; ++tt) dst[tt][j] = __uint_as_float(raw[tt] << 16);
  } else if (dtype == WKV_F16) {
#pragma unroll
    for (int tt = 0; tt < WKV_TILE; ++tt)
      dst[tt][j] = __half2float(__ushort_as_half(static_cast<unsigned short>(raw[tt])));
  } else {
#pragma unroll
    for (int tt = 0; tt < WKV_TILE; ++tt) dst[tt][j] = __uint_as_float(raw[tt]);
  }
}

__device__ __forceinline__ long long row_base(const WkvOperand& x, int b, int h, int j) {
  return static_cast<long long>(b) * x.sb + static_cast<long long>(h) * x.sh + j;
}

template <int D>
__global__ void __launch_bounds__(D) wkv6_kernel(const WkvArgs a) {
  const int h = blockIdx.x, b = blockIdx.y, j = threadIdx.x;
  __shared__ __align__(16) float sr[WKV_TILE][D];
  __shared__ __align__(16) float sk[WKV_TILE][D];
  __shared__ __align__(16) float sv[WKV_TILE][D];
  __shared__ __align__(16) float sw[WKV_TILE][D];
  __shared__ __align__(16) float su[D];

  const long long rb = row_base(a.r, b, h, j), kb = row_base(a.k, b, h, j);
  const long long vb = row_base(a.v, b, h, j), wb = row_base(a.w, b, h, j);
  unsigned pr[WKV_TILE], pk[WKV_TILE], pv[WKV_TILE], pw[WKV_TILE];
  {
    const int n = min(WKV_TILE, a.T);
    fetch(a.r, rb, 0, n, pr);
    fetch(a.k, kb, 0, n, pk);
    fetch(a.v, vb, 0, n, pv);
    fetch(a.w, wb, 0, n, pw);
  }

  su[j] = load_f32(a.u, static_cast<long long>(h) * D + j, a.u_dtype);
  const long long bh = static_cast<long long>(b) * a.H + h;
  float S[D];
  if (a.S0 != nullptr) {
    const float* s0 = a.S0 + bh * D * D + j;
#pragma unroll
    for (int i = 0; i < D; ++i) S[i] = s0[i * D];
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) S[i] = 0.f;
  }

  const long long o_st = static_cast<long long>(a.H) * D;
  float* out = a.o + static_cast<long long>(b) * a.T * o_st + static_cast<long long>(h) * D + j;

  for (int t0 = 0; t0 < a.T; t0 += WKV_TILE) {
    const int n = min(WKV_TILE, a.T - t0);
    __syncthreads();  // the last tile's reads are done; su is written
    stage<D>(sr, pr, a.r.dtype, j);
    stage<D>(sk, pk, a.k.dtype, j);
    stage<D>(sv, pv, a.v.dtype, j);
    stage<D>(sw, pw, a.w.dtype, j);
    __syncthreads();
    const int t1 = t0 + WKV_TILE;
    if (t1 < a.T) {  // the next tile's loads fly while this one computes
      const int n1 = min(WKV_TILE, a.T - t1);
      fetch(a.r, rb, t1, n1, pr);
      fetch(a.k, kb, t1, n1, pk);
      fetch(a.v, vb, t1, n1, pv);
      fetch(a.w, wb, t1, n1, pw);
    }
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < D; i += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(&sr[tt][i]);
        const float4 k4 = *reinterpret_cast<const float4*>(&sk[tt][i]);
        const float4 w4 = *reinterpret_cast<const float4*>(&sw[tt][i]);
        const float4 u4 = *reinterpret_cast<const float4*>(&su[i]);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
        const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float kv = __fmul_rn(kk[q], vj);
          acc[q] = __fmaf_rn(rr[q], __fadd_rn(S[i + q], __fmul_rn(uu[q], kv)), acc[q]);
          S[i + q] = __fadd_rn(__fmul_rn(ww[q], S[i + q]), kv);
        }
      }
      out[(t0 + tt) * o_st] = (acc[0] + acc[1]) + (acc[2] + acc[3]);
    }
  }

  if (a.S_T != nullptr) {
    float* sT = a.S_T + bh * D * D + j;
#pragma unroll
    for (int i = 0; i < D; ++i) sT[i * D] = S[i];
  }
}

extern "C" {

// Launches the recurrence on `stream`; returns cudaGetLastError() after
// the launch (a refused launch never runs, so the wrapper must check it).
// r, k, v, w: (B, T, H, D) with their B, T, H element strides in
// `strides` (3 each, in that order; the D stride is 1); u: contiguous
// (H, D); `dtypes` holds the type codes of r, k, v, w, u. S0 and S_T are
// contiguous fp32 (B, H, D, D) or null; o is contiguous fp32 (B, T, H, D).
cudaError_t rwkv6_scan_launch(const void* r, const void* k, const void* v, const void* w,
                              const void* u, const float* S0, float* o, float* S_T,
                              const long long* strides, const int* dtypes, int B, int T_len,
                              int H, int D, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || T_len <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (dtypes[i] < WKV_F32 || dtypes[i] > WKV_F16) return cudaErrorInvalidValue;
  WkvArgs a;
  const void* ptrs[4] = {r, k, v, w};
  WkvOperand* ops[4] = {&a.r, &a.k, &a.v, &a.w};
  for (int i = 0; i < 4; ++i) {
    ops[i]->ptr = ptrs[i];
    ops[i]->sb = strides[3 * i];
    ops[i]->st = strides[3 * i + 1];
    ops[i]->sh = strides[3 * i + 2];
    ops[i]->dtype = dtypes[i];
  }
  a.u = u;
  a.u_dtype = dtypes[4];
  a.S0 = S0;
  a.o = o;
  a.S_T = S_T;
  a.T = T_len;
  a.H = H;
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 8: wkv6_kernel<8><<<grid, 8, 0, s>>>(a); break;
    case 16: wkv6_kernel<16><<<grid, 16, 0, s>>>(a); break;
    case 32: wkv6_kernel<32><<<grid, 32, 0, s>>>(a); break;
    case 64: wkv6_kernel<64><<<grid, 64, 0, s>>>(a); break;
    case 128: wkv6_kernel<128><<<grid, 128, 0, s>>>(a); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
