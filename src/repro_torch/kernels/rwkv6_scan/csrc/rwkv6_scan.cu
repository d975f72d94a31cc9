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
// `.astype(jnp.float32)` does. The state update rounds each multiply and
// add on its own (__fmul_rn, __fadd_rn), in the order of the plain
// version (ref.py), so the state is the plain version's bit for bit. The
// output is the same sum regrouped, o_t = r_t S_{t-1} + v_t c_t with
// c_t = r_t . (u * k_t) (below), and summed in another order.
//
// Bound on this card: operations. 5 flops per state element per token
// (k_i v_j, w_i S_ij, + kv, and r_i S_ij as one fma of 2): at the serving
// shape (B 8, T 128, H 32, D 64) that is 0.67 GFLOP, 10.0 us at the
// 67 TFLOP/s fp32 rate, against 29.4 MB of operands and output (bf16 r,
// k, v; fp32 w and o), 8.8 us at 3.35 TB/s. The bit-exact update is 4
// fp32 instructions per state element and token (kv, w * S, + kv, and
// the fma of r * S), so ~16 us of the fp32 pipes is a floor for this
// arithmetic. The recurrence is serial in T; the parallelism is
// B * H * D^2 state elements, and what limits a thread is how often it
// reads the staged r_t, k_t, w_t (shared memory delivers 32 floats a
// cycle per SM). One thread per column (D threads, one warp per
// scheduler) or P threads per column with one column each both read 3
// floats per 4 instructions. Design:
//   * a thread owns a tile of the state: 4 columns j0 .. j0 + 3 by D / P
//     rows, in registers (32 at D 64), so each float4 of r_t, k_t, w_t it
//     reads serves 4 columns, and each v_t float4 4 x (D / P) rows.
//     P = 8 threads (neighbouring lanes) share a group of 4 columns, each
//     with the rows of float4 groups p, p + P, ... (interleaved, so the P
//     lanes read P neighbouring 16-byte chunks, one conflict-free
//     wavefront, the other column groups' lanes reading the same chunks).
//     At the serving shape a block of 128 threads per (head, batch), 256
//     blocks, 2 an SM. The TPU kernel's 128-token chunks and its VMEM
//     scratch state exist for VMEM and have no counterpart here;
//   * o_t = r_t S_{t-1} + v_t c_t with c_t = r_t . (u * k_t): the bonus
//     term's dot product is one scalar per token and head, computed once
//     per tile for all its tokens (a regrouping of the output's arithmetic
//     only, held to the same tolerance). Each thread stores its 4 partial
//     sums of r_t S_{t-1} per token to shared memory (rows padded by 4
//     floats so the P lanes hit distinct banks); after the tile's tokens
//     one pass sums the P partials, adds v_t c_t and writes o with 16-byte
//     stores. No shuffle chain sits in the token loop;
//   * r, k, v, w of a tile (16 tokens at D 64) are staged in shared memory
//     once per tile, each thread fetching WKV_WORDS words of each operand,
//     neighbouring threads on neighbouring elements of a token;
//   * the loads of the next tile are issued, as raw 16- or 32-bit words
//     into registers, before the current tile's arithmetic and converted
//     to fp32 only when staged, so the latency of device memory hides
//     behind a tile of arithmetic;
//   * r, k, v, w are read in (B, T, H, D) in place through their strides,
//     each in its own float type; nothing is padded: the last tile masks
//     the ragged tail of T.
// At D 8 a block is 4 threads (D^2 / 16), each with 16 elements: a
// single warp's dependent chain, slower than one thread per column there.
// tools/wkv6_ab.py times this kernel beside other sources of the same
// interface (the one-column-per-thread design in tools/wkv6_quad.cu).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>


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

// The thread tile: 4 columns of the state by D / P rows, P threads
// (neighbouring lanes) per group of 4 columns.
#define WKV_WORDS 8  // words of each operand one thread fetches per tile

template <int D>
__host__ __device__ constexpr int wkv_lanes() {
  return D >= 32 ? 8 : D / 4;
}

template <int D>
__host__ __device__ constexpr int wkv_threads() {
  return D / 4 * wkv_lanes<D>();
}

template <int D>
__host__ __device__ constexpr int wkv_tile() {  // tokens staged per tile
  return WKV_WORDS * wkv_threads<D>() / D;
}

// Shared memory: r, k, v, w of a tile, then each thread's partial sums of
// the outputs (rows padded by 4 floats, so the P lanes of a column group
// store to distinct banks), then u and the tile's c_t.
template <int D>
__host__ __device__ constexpr int wkv_smem_floats() {
  return (4 * D + wkv_lanes<D>() * (D + 4) + 1) * wkv_tile<D>() + D;
}

// Issues the loads of one operand's words e = tid + w * N (token e / D,
// element e % D) of the tile at t0 as raw words, zero past its n tokens;
// nothing here waits for them.
template <int D, int N>
__device__ __forceinline__ void fetch(const WkvOperand& x, long long base, int t0, int n,
                                      unsigned (&raw)[WKV_WORDS]) {
  if (x.dtype == WKV_F32) {
    const unsigned* p = static_cast<const unsigned*>(x.ptr) + base;
#pragma unroll
    for (int w = 0; w < WKV_WORDS; ++w) {
      const int e = threadIdx.x + w * N, tt = e / D;
      raw[w] = tt < n ? __ldg(p + static_cast<long long>(t0 + tt) * x.st + e % D) : 0u;
    }
  } else {
    const unsigned short* p = static_cast<const unsigned short*>(x.ptr) + base;
#pragma unroll
    for (int w = 0; w < WKV_WORDS; ++w) {
      const int e = threadIdx.x + w * N, tt = e / D;
      raw[w] = tt < n ? static_cast<unsigned>(__ldg(p + static_cast<long long>(t0 + tt) * x.st
                                                    + e % D))
                      : 0u;
    }
  }
}

// Converts fetched words to fp32 into their places in a staged tile
// (dst[tt * D + d]).
template <int N>
__device__ __forceinline__ void stage(float* dst, const unsigned (&raw)[WKV_WORDS], int dtype) {
  if (dtype == WKV_BF16) {
#pragma unroll
    for (int w = 0; w < WKV_WORDS; ++w) dst[threadIdx.x + w * N] = __uint_as_float(raw[w] << 16);
  } else if (dtype == WKV_F16) {
#pragma unroll
    for (int w = 0; w < WKV_WORDS; ++w)
      dst[threadIdx.x + w * N] =
          __half2float(__ushort_as_half(static_cast<unsigned short>(raw[w])));
  } else {
#pragma unroll
    for (int w = 0; w < WKV_WORDS; ++w) dst[threadIdx.x + w * N] = __uint_as_float(raw[w]);
  }
}

__device__ __forceinline__ long long head_base(const WkvOperand& x, int b, int h) {
  return static_cast<long long>(b) * x.sb + static_cast<long long>(h) * x.sh;
}

template <int D>
__global__ void __launch_bounds__(wkv_threads<D>()) wkv6_kernel(const WkvArgs a) {
  constexpr int P = wkv_lanes<D>();          // threads per group of 4 columns
  constexpr int N = wkv_threads<D>();        // threads
  constexpr int G = D / P / 4;               // float4 row groups per thread
  constexpr int TILE = wkv_tile<D>();
  constexpr int TPT = N / TILE;              // threads per token for c_t ...
  constexpr int EPT = D / TPT;               // ... and its terms each
  constexpr int LO = D + 4;                  // padded row of partial sums
  constexpr unsigned MASK = N >= 32 ? 0xffffffffu : (1u << (N & 31)) - 1u;
  static_assert(G >= 1 && EPT % 4 == 0 && TPT <= 32 && (TPT & (TPT - 1)) == 0,
                "bad thread tile");
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int p = tid % P, j0 = tid / P * 4;  // row groups p, p + P, ...; columns j0 ..
  extern __shared__ float4 wkv_smem[];
  float* sr = reinterpret_cast<float*>(wkv_smem);  // [TILE][D] each
  float* sk = sr + TILE * D;
  float* sv = sk + TILE * D;
  float* sw = sv + TILE * D;
  float* so = sw + TILE * D;                       // [TILE][P][LO]
  float* su = so + TILE * P * LO;                  // [D]
  float* sc = su + D;                              // [TILE]

  const long long rb = head_base(a.r, b, h), kb = head_base(a.k, b, h);
  const long long vb = head_base(a.v, b, h), wb = head_base(a.w, b, h);
  unsigned pr[WKV_WORDS], pk[WKV_WORDS], pv[WKV_WORDS], pw[WKV_WORDS];
  {
    const int n = min(TILE, a.T);
    fetch<D, N>(a.r, rb, 0, n, pr);
    fetch<D, N>(a.k, kb, 0, n, pk);
    fetch<D, N>(a.v, vb, 0, n, pv);
    fetch<D, N>(a.w, wb, 0, n, pw);
  }

  for (int i = tid; i < D; i += N)
    su[i] = load_f32(a.u, static_cast<long long>(h) * D + i, a.u_dtype);
  const long long bh = static_cast<long long>(b) * a.H + h;
  float S[4 * G][4];  // S[4 q + c][col]: row 4 (q P + p) + c, column j0 + col
  if (a.S0 != nullptr) {
    const float* s0 = a.S0 + bh * D * D + j0;
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int col = 0; col < 4; ++col) S[4 * q + c][col] = s0[(4 * (q * P + p) + c) * D + col];
  } else {
#pragma unroll
    for (int i = 0; i < 4 * G; ++i)
#pragma unroll
      for (int col = 0; col < 4; ++col) S[i][col] = 0.f;
  }

  const long long o_st = static_cast<long long>(a.H) * D;
  float* out = a.o + static_cast<long long>(b) * a.T * o_st + static_cast<long long>(h) * D;

  for (int t0 = 0; t0 < a.T; t0 += TILE) {
    const int n = min(TILE, a.T - t0);
    __syncthreads();  // the last tile's reads are done; su is written
    stage<N>(sr, pr, a.r.dtype);
    stage<N>(sk, pk, a.k.dtype);
    stage<N>(sv, pv, a.v.dtype);
    stage<N>(sw, pw, a.w.dtype);
    __syncthreads();
    const int t1 = t0 + TILE;
    if (t1 < a.T) {  // the next tile's loads fly while this one computes
      const int n1 = min(TILE, a.T - t1);
      fetch<D, N>(a.r, rb, t1, n1, pr);
      fetch<D, N>(a.k, kb, t1, n1, pk);
      fetch<D, N>(a.v, vb, t1, n1, pv);
      fetch<D, N>(a.w, wb, t1, n1, pw);
    }
    {  // c_t = sum_i r_i u_i k_i of every token of the tile, TPT lanes each
      const int tt = tid / TPT, e0 = (tid % TPT) * EPT;
      float c = 0.f;
#pragma unroll
      for (int e = 0; e < EPT; e += 4) {
        const float4 r4 = *reinterpret_cast<const float4*>(sr + tt * D + e0 + e);
        const float4 k4 = *reinterpret_cast<const float4*>(sk + tt * D + e0 + e);
        const float4 u4 = *reinterpret_cast<const float4*>(su + e0 + e);
        c += r4.x * (u4.x * k4.x) + r4.y * (u4.y * k4.y) + r4.z * (u4.z * k4.z)
             + r4.w * (u4.w * k4.w);
      }
#pragma unroll
      for (int off = TPT / 2; off > 0; off >>= 1) c += __shfl_xor_sync(MASK, c, off);
      if (tid % TPT == 0) sc[tt] = c;
    }
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      const float4 v4 = *reinterpret_cast<const float4*>(sv + tt * D + j0);
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int q = 0; q < G; ++q) {
        const int i4 = 4 * (q * P + p);
        const float4 r4 = *reinterpret_cast<const float4*>(sr + tt * D + i4);
        const float4 k4 = *reinterpret_cast<const float4*>(sk + tt * D + i4);
        const float4 w4 = *reinterpret_cast<const float4*>(sw + tt * D + i4);
        const float rr[4] = {r4.x, r4.y, r4.z, r4.w};
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float ww[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int c = 0; c < 4; ++c)
#pragma unroll
          for (int col = 0; col < 4; ++col) {
            float& s = S[4 * q + c][col];
            const float kv = __fmul_rn(kk[c], vv[col]);
            acc[col] = __fmaf_rn(rr[c], s, acc[col]);
            s = __fadd_rn(__fmul_rn(ww[c], s), kv);
          }
      }
      *reinterpret_cast<float4*>(so + (tt * P + p) * LO + j0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
    __syncthreads();  // every partial sum of the tile is in so, c_t in sc
    for (int i = 4 * tid; i < n * D; i += 4 * N) {  // o = the P partials + v c_t, 4 a thread
      const int tt = i / D, j = i % D;
      float4 o = *reinterpret_cast<const float4*>(so + tt * P * LO + j);
#pragma unroll
      for (int q = 1; q < P; ++q) {
        const float4 x = *reinterpret_cast<const float4*>(so + (tt * P + q) * LO + j);
        o.x += x.x; o.y += x.y; o.z += x.z; o.w += x.w;
      }
      const float4 v4 = *reinterpret_cast<const float4*>(sv + tt * D + j);
      const float c = sc[tt];
      *reinterpret_cast<float4*>(out + (t0 + tt) * o_st + j) =
          make_float4(__fmaf_rn(v4.x, c, o.x), __fmaf_rn(v4.y, c, o.y), __fmaf_rn(v4.z, c, o.z),
                      __fmaf_rn(v4.w, c, o.w));
    }
  }

  if (a.S_T != nullptr) {
    float* sT = a.S_T + bh * D * D + j0;
#pragma unroll
    for (int q = 0; q < G; ++q)
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int col = 0; col < 4; ++col) sT[(4 * (q * P + p) + c) * D + col] = S[4 * q + c][col];
  }
}

template <int D>
static cudaError_t launch_d(const WkvArgs& a, const dim3& grid, cudaStream_t s) {
  constexpr int bytes = wkv_smem_floats<D>() * 4;
  const cudaError_t err =
      cudaFuncSetAttribute(wkv6_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv6_kernel<D><<<grid, wkv_threads<D>(), bytes, s>>>(a);
  return cudaGetLastError();
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
    case 8: return launch_d<8>(a, grid, s);
    case 16: return launch_d<16>(a, grid, s);
    case 32: return launch_d<32>(a, grid, s);
    case 64: return launch_d<64>(a, grid, s);
    case 128: return launch_d<128>(a, grid, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
