// WKV6 recurrence, a second design kept for comparison: P = 4 threads
// (neighbouring lanes, a quad) per state column, one column each.
//
// Same extern "C" interface, operand handling and numeric contract as the
// serving kernel, src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu:
// the state update rounds each multiply and add on its own, in the order
// of the plain version, so S_T is bit for bit; o_t = r_t S_{t-1} + v_t c_t
// with c_t = r_t . (u * k_t) once per token. Thread (j, p) of a block of
// 4 D threads per (head, batch) owns rows p, p + 4, ... of column j
// (interleaved, so the quad reads 4 neighbouring floats, a broadcast to
// the other quads of the warp); the quad's 4 partial sums of r_t S_{t-1}
// are reduced with two xor shuffles per token and lane 0 writes o_t.
// Every state-element update reads 3 staged floats (r_i, k_i, w_i) for 4
// fp32 instructions, which is what the serving kernel's 4-column thread
// tile avoids. Nothing in the package builds or loads this file:
// tools/wkv6_ab.py times it beside the serving kernel.
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

#define WKV_WORDS 8  // words of each operand one thread fetches per tile

template <int D>
__host__ __device__ constexpr int quad_threads() {
  return 4 * D;
}

template <int D>
__host__ __device__ constexpr int quad_tile() {  // tokens staged per tile: 32
  return WKV_WORDS * quad_threads<D>() / D;
}

// r, k, v, w of a tile, then u and the tile's c_t.
template <int D>
__host__ __device__ constexpr int quad_smem_floats() {
  return 4 * D * quad_tile<D>() + D + quad_tile<D>();
}

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

// Issues the loads of one operand's words e = tid + w * N (token e / D,
// element e % D) of the tile at t0 as raw words, zero past its n tokens.
template <int D, int N>
__device__ __forceinline__ void fetch(const WkvOperand& x, long long base, int t0, int n,
                                      unsigned (&raw)[WKV_WORDS]) {
#pragma unroll
  for (int w = 0; w < WKV_WORDS; ++w) {
    const int e = threadIdx.x + w * N, tt = e / D;
    const long long i = static_cast<long long>(t0 + tt) * x.st + e % D;
    if (tt >= n)
      raw[w] = 0u;
    else if (x.dtype == WKV_F32)
      raw[w] = __ldg(static_cast<const unsigned*>(x.ptr) + base + i);
    else
      raw[w] = __ldg(static_cast<const unsigned short*>(x.ptr) + base + i);
  }
}

// Converts fetched words to fp32 into their places in a staged tile.
template <int N>
__device__ __forceinline__ void stage(float* dst, const unsigned (&raw)[WKV_WORDS], int dtype) {
#pragma unroll
  for (int w = 0; w < WKV_WORDS; ++w)
    dst[threadIdx.x + w * N] =
        dtype == WKV_BF16  ? __uint_as_float(raw[w] << 16)
        : dtype == WKV_F16 ? __half2float(__ushort_as_half(static_cast<unsigned short>(raw[w])))
                           : __uint_as_float(raw[w]);
}

__device__ __forceinline__ long long head_base(const WkvOperand& x, int b, int h) {
  return static_cast<long long>(b) * x.sb + static_cast<long long>(h) * x.sh;
}

template <int D>
__global__ void __launch_bounds__(quad_threads<D>()) wkv6_quad_kernel(const WkvArgs a) {
  constexpr int N = quad_threads<D>();
  constexpr int R = D / 4;                   // rows per thread
  constexpr int TILE = quad_tile<D>();
  constexpr int TPT = N / TILE;              // threads per token for c_t ...
  constexpr int EPT = D / TPT;               // ... and its terms each
  static_assert(EPT % 4 == 0 && TPT <= 32 && (TPT & (TPT - 1)) == 0, "bad tile");
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int j = tid / 4, p = tid % 4;  // column j, rows p, p + 4, ...
  extern __shared__ float4 quad_smem[];
  float* sr = reinterpret_cast<float*>(quad_smem);  // [TILE][D] each
  float* sk = sr + TILE * D;
  float* sv = sk + TILE * D;
  float* sw = sv + TILE * D;
  float* su = sw + TILE * D;  // [D]
  float* sc = su + D;         // [TILE]

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
  float S[R];  // S[m]: row p + 4 m, column j
#pragma unroll
  for (int m = 0; m < R; ++m)
    S[m] = a.S0 != nullptr ? a.S0[bh * D * D + (p + 4 * m) * D + j] : 0.f;

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
      for (int e = 0; e < EPT; ++e) c += sr[tt * D + e0 + e] * (su[e0 + e] * sk[tt * D + e0 + e]);
#pragma unroll
      for (int off = TPT / 2; off > 0; off >>= 1) c += __shfl_xor_sync(0xffffffffu, c, off);
      if (tid % TPT == 0) sc[tt] = c;
    }
    __syncthreads();  // sc is written
#pragma unroll 1
    for (int tt = 0; tt < n; ++tt) {
      const float* rt = sr + tt * D + p;
      const float* kt = sk + tt * D + p;
      const float* wt = sw + tt * D + p;
      const float vj = sv[tt * D + j];
      float acc = 0.f;
#pragma unroll
      for (int m = 0; m < R; ++m) {
        const float kv = __fmul_rn(kt[4 * m], vj);
        acc = __fmaf_rn(rt[4 * m], S[m], acc);
        S[m] = __fadd_rn(__fmul_rn(wt[4 * m], S[m]), kv);
      }
      acc += __shfl_xor_sync(0xffffffffu, acc, 1);
      acc += __shfl_xor_sync(0xffffffffu, acc, 2);
      if (p == 0) out[(t0 + tt) * o_st + j] = __fmaf_rn(vj, sc[tt], acc);
    }
  }

  if (a.S_T != nullptr) {
#pragma unroll
    for (int m = 0; m < R; ++m) a.S_T[bh * D * D + (p + 4 * m) * D + j] = S[m];
  }
}

template <int D>
static cudaError_t launch_d(const WkvArgs& a, const dim3& grid, cudaStream_t s) {
  constexpr int bytes = quad_smem_floats<D>() * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_quad_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv6_quad_kernel<D><<<grid, quad_threads<D>(), bytes, s>>>(a);
  return cudaGetLastError();
}

extern "C" {

// The serving kernel's entry point, argument for argument.
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
