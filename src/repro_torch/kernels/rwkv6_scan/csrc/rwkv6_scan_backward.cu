// Gradient of the WKV6 recurrence for Hopper (sm_90a): the backward of
// rwkv6_scan.cu's
//
//   kv  = k_t^T v_t,   o_t = r_t (S_{t-1} + diag(u) kv),
//   S_t = diag(w_t) S_{t-1} + kv,   S_{-1} = S0 or 0
//
// against go (the gradient of o, or none) and gS (of S_T, or none).
//
// Replaces no TPU kernel: the reference has no Pallas backward. Its
// training step differentiates a plain lax.scan (src/repro/nn/rwkv6.py:158),
// which XLA compiles into one loop on the device. This kernel is that loop
// on the card, the CUDA implementation of the operator
// repro_torch::wkv6_backward (ops.py), in the recurrences of
// ref.py::wkv6_scan_backward_ref. One block per (b, h), in two phases:
//
//  (i)  recompute S_{-1} = S0 ... S_{T-2} into a global fp32 workspace of T
//       (D, D) blocks, what the plain version holds. Each update rounds as
//       the forward kernel and ref.py do: k v, then w S, then the add, no
//       fused multiply-add, so the states equal the plain version's bit
//       for bit;
//  (ii) go backward in time with dS (carried from gS, or zero) on chip:
//         M   = S_{t-1} + u kv,     dM = r_t^T go_t,     dr_t = M go_t
//         dkv = dM u + dS,          dw_t = sum_j dS S_{t-1}
//         dk_t = sum_j dkv v_t,     dv_t = sum_i dkv k_t
//         du partial_t = sum_j dM kv
//         dS <- dM + w_t dS
//       and dS0 is the last dS. The elementwise steps round as the plain
//       version does (__fmul_rn, __fadd_rn), so dS and dS0 equal its bit
//       for bit; only the five reductions regroup (each an fma chain).
//
// du: the kernel writes one partial per (b, t, h, i), at time row
// T - 1 - t, and the wrapper sums them over b, then over the rows in
// order, from the last step back: the plain version's order.
//
// Thread i of the block owns row i of the state: dS's row in registers,
// and S_{t-1}'s row read back from the workspace that the same thread
// wrote (so no block-wide barrier guards it). The workspace holds each
// (D, D) block transposed, [j][i], so a warp's loads and stores of one j
// are contiguous. r, k, v, w and go of BWD_TILE tokens are staged in
// shared memory, read by every thread (broadcasts for v_j and go_j); the
// column sum dv goes through shared memory (row i's D products, rows
// padded by one float so the D threads store to distinct banks), then
// thread j sums column j.
//
// Bound on this card: operations, plus the workspace's traffic. About 21
// flops per state element and token: at the training shape (B 8, T 128,
// H 32, D 64) 2.8 GFLOP, 42 us at the 67 TFLOP/s fp32 rate; writing and
// reading the states adds 1.07 GB, 0.32 ms at 3.35 TB/s. This is the
// simple design: its parallelism is B H D threads, 2 warps a block at
// D 64, and the states' round trip through device memory is in series
// with the arithmetic.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define BWD_TILE 8  // tokens staged in shared memory at once

enum WkvDtype { WKV_F32 = 0, WKV_BF16 = 1, WKV_F16 = 2 };

struct WkvTensor {  // a 4-D operand read through its element strides
  const void* ptr;  // null: absent
  long long s0, s1, s2, s3;
  int dtype;
};

struct WkvBackwardArgs {
  WkvTensor go, r, k, v, w;  // (B, T, H, D)
  WkvTensor gS, S0;          // (B, H, D, D)
  WkvTensor u;               // (H, D): s0, s1; s2 = s3 = 0
  void *dr, *dk, *dv, *dw;   // (B, T, H, D), contiguous, dtypes of r, k, v, w
  void* dS0;                 // (B, H, D, D), contiguous, S0's dtype; null without S0
  float* states;             // (B, H, T, D, D): S_{t-1} at [b][h][t][j][i]
  float* du_part;            // (B, T, H, D): the partial of step t at time row T - 1 - t
  int T, H;
};

__device__ __forceinline__ float load_f32(const void* p, long long i, int dtype) {
  switch (dtype) {
    case WKV_BF16: return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
    case WKV_F16: return __half2float(static_cast<const __half*>(p)[i]);
    default: return static_cast<const float*>(p)[i];
  }
}

__device__ __forceinline__ void store_cast(void* p, long long i, float x, int dtype) {
  switch (dtype) {
    case WKV_BF16: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x); break;
    case WKV_F16: static_cast<__half*>(p)[i] = __float2half_rn(x); break;
    default: static_cast<float*>(p)[i] = x;
  }
}

__device__ __forceinline__ float at(const WkvTensor& x, long long a, long long b, long long c,
                                    long long d) {
  return load_f32(x.ptr, a * x.s0 + b * x.s1 + c * x.s2 + d * x.s3, x.dtype);
}

template <int D>
__host__ __device__ constexpr int bwd_smem_floats() {
  // r, k, v, w, go of a tile; u; the column-sum matrix
  return 5 * BWD_TILE * D + D + D * (D + 1);
}

template <int D, bool GO>
__global__ void __launch_bounds__(D) wkv6_backward_kernel(const WkvBackwardArgs a) {
  constexpr int LD = D + 1;  // padded row of the column-sum matrix
  const int h = blockIdx.x, b = blockIdx.y, i = threadIdx.x, T = a.T;
  extern __shared__ float smem[];
  float* sr = smem;  // [BWD_TILE][D] each
  float* sk = sr + BWD_TILE * D;
  float* sv = sk + BWD_TILE * D;
  float* sw = sv + BWD_TILE * D;
  float* sg = sw + BWD_TILE * D;
  float* su = sg + BWD_TILE * D;  // [D]
  float* red = su + D;            // [D][LD]

  const long long bh = static_cast<long long>(b) * a.H + h;
  float* st = a.states + bh * T * D * D + i;  // row i of each block, at [t][j]: st[(t D + j) D]
  su[i] = at(a.u, h, i, 0, 0);

  // (i) the forward states, S_{t-1} stored before step t's update
  float S[D];
#pragma unroll
  for (int j = 0; j < D; ++j) S[j] = a.S0.ptr != nullptr ? at(a.S0, b, h, i, j) : 0.f;
#pragma unroll 1
  for (int t0 = 0; t0 < T; t0 += BWD_TILE) {
    const int n = min(BWD_TILE, T - t0);
    __syncthreads();  // the last tile's reads are done
    for (int tt = 0; tt < n; ++tt) {
      sk[tt * D + i] = at(a.k, b, t0 + tt, h, i);
      sv[tt * D + i] = at(a.v, b, t0 + tt, h, i);
      sw[tt * D + i] = at(a.w, b, t0 + tt, h, i);
    }
    __syncthreads();
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      float* out = st + static_cast<long long>(t0 + tt) * D * D;
      const float ki = sk[tt * D + i], wi = sw[tt * D + i];
#pragma unroll
      for (int j = 0; j < D; ++j) {
        out[j * D] = S[j];
        S[j] = __fadd_rn(__fmul_rn(wi, S[j]), __fmul_rn(ki, sv[tt * D + j]));
      }
    }
  }

  // (ii) backward in time; S now holds dS
#pragma unroll
  for (int j = 0; j < D; ++j) S[j] = a.gS.ptr != nullptr ? at(a.gS, b, h, i, j) : 0.f;
  const float ui = su[i];
  const long long o_st = static_cast<long long>(a.H) * D;  // token stride of the outputs
  const long long o_base = static_cast<long long>(b) * T * o_st + static_cast<long long>(h) * D + i;
#pragma unroll 1
  for (int t1 = T; t1 > 0; t1 -= BWD_TILE) {
    const int n = min(BWD_TILE, t1), t0 = t1 - n;
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      sr[tt * D + i] = at(a.r, b, t0 + tt, h, i);
      sk[tt * D + i] = at(a.k, b, t0 + tt, h, i);
      sv[tt * D + i] = at(a.v, b, t0 + tt, h, i);
      sw[tt * D + i] = at(a.w, b, t0 + tt, h, i);
      sg[tt * D + i] = GO ? at(a.go, b, t0 + tt, h, i) : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tt = n - 1; tt >= 0; --tt) {
      const int t = t0 + tt;
      const float* prev = st + static_cast<long long>(t) * D * D;  // S_{t-1}, row i
      const float* vt = sv + tt * D;
      const float* gt = sg + tt * D;
      const float ri = sr[tt * D + i], ki = sk[tt * D + i], wi = sw[tt * D + i];
      float dr = 0.f, dk = 0.f, dw = 0.f, du = 0.f;
#pragma unroll
      for (int j = 0; j < D; ++j) {
        const float s = prev[j * D];
        const float vj = vt[j];
        const float kv = __fmul_rn(ki, vj);
        float dkv = S[j];
        float dM = 0.f;
        if (GO) {
          const float gj = gt[j];
          dM = __fmul_rn(ri, gj);
          dkv = __fadd_rn(__fmul_rn(dM, ui), S[j]);
          dr = __fmaf_rn(__fadd_rn(s, __fmul_rn(ui, kv)), gj, dr);
          du = __fmaf_rn(dM, kv, du);
        }
        dw = __fmaf_rn(S[j], s, dw);
        dk = __fmaf_rn(dkv, vj, dk);
        red[i * LD + j] = __fmul_rn(dkv, ki);
        S[j] = __fmul_rn(wi, S[j]);
        if (GO) S[j] = __fadd_rn(dM, S[j]);
      }
      __syncthreads();  // every row's dkv k products are in red
      float dv = 0.f;
#pragma unroll 8
      for (int q = 0; q < D; ++q) dv += red[q * LD + i];
      const long long o = o_base + static_cast<long long>(t) * o_st;
      store_cast(a.dr, o, dr, a.r.dtype);
      store_cast(a.dk, o, dk, a.k.dtype);
      store_cast(a.dv, o, dv, a.v.dtype);
      store_cast(a.dw, o, dw, a.w.dtype);
      a.du_part[o_base + static_cast<long long>(T - 1 - t) * o_st] = du;
      __syncthreads();  // red is read before the next step writes it
    }
  }
  if (a.dS0 != nullptr) {
#pragma unroll
    for (int j = 0; j < D; ++j) store_cast(a.dS0, (bh * D + i) * D + j, S[j], a.S0.dtype);
  }
}

template <int D, bool GO>
static cudaError_t launch_d(const WkvBackwardArgs& a, const dim3& grid, cudaStream_t s) {
  constexpr int bytes = bwd_smem_floats<D>() * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_backward_kernel<D, GO>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv6_backward_kernel<D, GO><<<grid, D, bytes, s>>>(a);
  return cudaGetLastError();
}

template <bool GO>
static cudaError_t launch_go(const WkvBackwardArgs& a, int D, const dim3& grid, cudaStream_t s) {
  switch (D) {
    case 8: return launch_d<8, GO>(a, grid, s);
    case 16: return launch_d<16, GO>(a, grid, s);
    case 32: return launch_d<32, GO>(a, grid, s);
    case 64: return launch_d<64, GO>(a, grid, s);
    case 128: return launch_d<128, GO>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" {

// Launches the backward on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, so the wrapper must check it).
// `ptrs` holds go, r, k, v, w, gS, S0, u (go, gS, S0 may be null), then the
// outputs dr, dk, dv, dw, dS0 (null without S0), then the workspace's
// states (B H T D D floats) and du partials (B T H D floats). `strides`
// holds 4 element strides for each of go, r, k, v, w, gS, S0 and u (u's
// last two 0), `dtypes` the type codes of the same 8 operands; each output
// takes its input's type. Outputs are contiguous.
cudaError_t rwkv6_scan_backward_launch(void* const* ptrs, const long long* strides,
                                       const int* dtypes, int B, int T_len, int H, int D,
                                       void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || T_len <= 0) return cudaErrorInvalidValue;
  if (ptrs[1] == nullptr || ptrs[2] == nullptr || ptrs[3] == nullptr || ptrs[4] == nullptr
      || ptrs[7] == nullptr)
    return cudaErrorInvalidValue;
  WkvBackwardArgs a;
  WkvTensor* ins[8] = {&a.go, &a.r, &a.k, &a.v, &a.w, &a.gS, &a.S0, &a.u};
  for (int n = 0; n < 8; ++n) {
    if (dtypes[n] < WKV_F32 || dtypes[n] > WKV_F16) return cudaErrorInvalidValue;
    ins[n]->ptr = ptrs[n];
    ins[n]->s0 = strides[4 * n];
    ins[n]->s1 = strides[4 * n + 1];
    ins[n]->s2 = strides[4 * n + 2];
    ins[n]->s3 = strides[4 * n + 3];
    ins[n]->dtype = dtypes[n];
  }
  a.dr = ptrs[8];
  a.dk = ptrs[9];
  a.dv = ptrs[10];
  a.dw = ptrs[11];
  a.dS0 = ptrs[12];
  if ((a.dS0 == nullptr) != (a.S0.ptr == nullptr)) return cudaErrorInvalidValue;
  a.states = static_cast<float*>(ptrs[13]);
  a.du_part = static_cast<float*>(ptrs[14]);
  a.T = T_len;
  a.H = H;
  const dim3 grid(static_cast<unsigned>(H), static_cast<unsigned>(B));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return a.go.ptr != nullptr ? launch_go<true>(a, D, grid, s) : launch_go<false>(a, D, grid, s);
}

const char* rwkv6_scan_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
