// Blocked causal GQA attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:96
// (`kernel` :54 inside flash_attention_bhsd :32, launched through
// pl.pallas_call; public entry ops.py::flash_attention :19). It computes
//
//   o[b,s,h,:] = sum_t softmax_t(mask(q[b,s,h,:] . k[b,t,h/G,:] * hd^-0.5)) v[b,t,h/G,:]
//
// with the Pallas kernel's arithmetic: q is cast to fp32 and scaled before
// the dot; the running max m, the running sum l and the accumulator are
// fp32; masked scores take the finite -1e30 (not -inf), and the output is
// acc / max(l, 1e-30), rounded once to q's type. The probabilities stay
// fp32 for P.V (never rounded to the activation type).
//
// Masks: causal (k <= q), sliding window (q - k < window), and the ragged
// sequence tail (k < S). The kv loop runs from the window's lower tile to
// the causal diagonal, the Pallas kernel's loop bounds (:81-88), so a
// dense S^2 is never masked. A row whose first visited tile is fully
// masked takes p = exp(-1e30 - (-1e30)) = 1 there, and the next tile's
// alpha = exp(-1e30 - m) = 0 wipes it out, as in the Pallas kernel; with
// -inf that rescale would be exp(-inf + inf) = NaN. Key/value rows past S
// load as zeros, so that transient never multiplies garbage.
//
// Bound on this card: at the serving shapes (B 8, S 128) the work is tiny
// against the bytes: Griffin (10 query heads over 1 kv head, hd 256, bf16)
// moves 11.5 MB (q and o 5.24 MB each, k and v 0.52 MB each), ~3.4 us at
// 3.35 TB/s, against ~0.67 GFLOP (~0.7 us at the bf16 tensor-core peak);
// Qwen3 (32 over 8, hd 128) moves 21 MB, ~6.3 us. A window of 2048 over
// S 4096 (B 1, 10 heads, hd 256) is ~64 GFLOP: operations, ~65 us at
// 989 TFLOP/s. This first kernel runs its products on the CUDA cores in
// fp32 FMAs (no mma.sync / wgmma, no TMA: later work), so it sits far
// from the operation bound; its design keeps the bytes at the bound:
//   * one block per (query tile of FA_BQ = 32 rows, query head, batch);
//     q, k and v are read in place in the (B, S, heads, hd) layout through
//     their strides (no transposes, no padding copies: the TPU wrapper's
//     layout work has no counterpart), 4 elements per thread per load;
//   * q (scaled), then each K and V tile of FA_BK = 32 rows, are staged in
//     shared memory as fp32, rows padded by 4 floats so that the 16-byte
//     reads of 4 neighbouring rows fall in distinct banks; the tiles
//     outgrow 48 KB (104 KB at hd 256), so shared memory is dynamic and
//     the launcher raises the block's limit with cudaFuncSetAttribute;
//   * 4 threads (a quad of neighbouring lanes) own one query row: each
//     computes 8 of the tile's 32 scores, the row's max and sum are
//     reduced with two xor shuffles, and each owns hd/4 of the row's fp32
//     accumulators (64 registers at hd 256) so nothing spills;
//   * the probabilities go through shared memory (one row per quad) for
//     P.V, which runs over the V tile with 16-byte reads.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define FA_BQ 32
#define FA_BK 32
#define FA_THREADS (FA_BQ * 4)
#define FA_NEG_INF (-1e30f)

enum FaDtype { FA_F32 = 0, FA_BF16 = 1, FA_F16 = 2 };

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_ss, q_sh;  // element strides of batch, sequence, head
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  int S, H, KV;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

// Four consecutive elements as fp32, from an address aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}
__device__ __forceinline__ void store4(__half* p, float4 v) {
  const __half2 a = __floats2half2_rn(v.x, v.y);
  const __half2 b = __floats2half2_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const unsigned*>(&a);
  raw.y = *reinterpret_cast<const unsigned*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

template <int HD>
constexpr int fa_smem_bytes() {
  return ((FA_BQ + 2 * FA_BK) * (HD + 4) + FA_BQ * (FA_BK + 1)) * 4;
}

// Stage rows [row0, row0 + ROWS) of one head into shared memory as fp32
// (times `mul`); rows at or past S are zeros.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const T* base, long long row_stride,
                                           int row0, int S, float mul) {
  constexpr int LD = HD + 4;
  constexpr int C4 = HD / 4;
  for (int e = threadIdx.x; e < ROWS * C4; e += FA_THREADS) {
    const int row = e / C4;
    const int c = (e % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + row < S) {
      x = load4(base + static_cast<long long>(row0 + row) * row_stride + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    store4(dst + row * LD + c, x);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_THREADS) flash_attention_kernel(const FlashParams p) {
  constexpr int LD = HD + 4;      // padded shared-memory row, in floats
  constexpr int CH = HD / 16;     // 4-column chunks of the row each quad lane owns
  constexpr int NS = FA_BK / 4;   // scores per thread per tile
  constexpr int LP = FA_BK + 1;   // padded probability row
  extern __shared__ float4 fa_smem[];
  float* sQ = reinterpret_cast<float*>(fa_smem);
  float* sK = sQ + FA_BQ * LD;
  float* sV = sK + FA_BK * LD;
  float* sP = sV + FA_BK * LD;

  const int q0 = blockIdx.x * FA_BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int r = threadIdx.x >> 2;     // query row of this quad within the tile
  const int lane4 = threadIdx.x & 3;  // lane within the quad
  const int qpos = q0 + r;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage_tile<T, HD, FA_BQ>(sQ, qb, p.q_ss, q0, p.S, p.scale);

  int hi = (p.S + FA_BK - 1) / FA_BK;
  if (p.causal) hi = min(hi, (q0 + FA_BQ + FA_BK - 1) / FA_BK);
  int lo = 0;
  if (p.window > 0) {
    const int first = q0 - (p.window - 1);
    lo = first > 0 ? first / FA_BK : 0;
  }

  float acc[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m = FA_NEG_INF;
  float l = 0.f;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * FA_BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage_tile<T, HD, FA_BK>(sK, kb, p.k_ss, k0, p.S, 1.f);
    stage_tile<T, HD, FA_BK>(sV, vb, p.v_ss, k0, p.S, 1.f);
    __syncthreads();

    // scores of row r against key rows lane4 + 4 * i
    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    const float* qrow = sQ + r * LD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float4 qv = *reinterpret_cast<const float4*>(qrow + d);
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const float4 kv = *reinterpret_cast<const float4*>(sK + (lane4 + 4 * i) * LD + d);
        s[i] = fmaf(qv.x, kv.x, s[i]);
        s[i] = fmaf(qv.y, kv.y, s[i]);
        s[i] = fmaf(qv.z, kv.z, s[i]);
        s[i] = fmaf(qv.w, kv.w, s[i]);
      }
    }

    float mt = FA_NEG_INF;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int kpos = k0 + lane4 + 4 * i;
      bool ok = kpos < p.S;
      if (p.causal) ok = ok && kpos <= qpos;
      if (p.window > 0) ok = ok && (qpos - kpos < p.window);
      s[i] = ok ? s[i] : FA_NEG_INF;
      mt = fmaxf(mt, s[i]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const float pi = expf(s[i] - m_new);
      ls += pi;
      sP[r * LP + lane4 + 4 * i] = pi;
    }
    ls += __shfl_xor_sync(0xffffffffu, ls, 1);
    ls += __shfl_xor_sync(0xffffffffu, ls, 2);
    l = alpha * l + ls;
    m = m_new;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      acc[c][0] *= alpha; acc[c][1] *= alpha; acc[c][2] *= alpha; acc[c][3] *= alpha;
    }
    __syncwarp();  // row r's probabilities were written by its own quad

    const float* prow = sP + r * LP;
#pragma unroll 4
    for (int t = 0; t < FA_BK; ++t) {
      const float pt = prow[t];
      const float* vrow = sV + t * LD;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(vrow + (lane4 + 4 * c) * 4);
        acc[c][0] = fmaf(pt, vv.x, acc[c][0]);
        acc[c][1] = fmaf(pt, vv.y, acc[c][1]);
        acc[c][2] = fmaf(pt, vv.z, acc[c][2]);
        acc[c][3] = fmaf(pt, vv.w, acc[c][3]);
      }
    }
  }

  if (qpos < p.S) {
    const float den = fmaxf(l, 1e-30f);
    T* orow = static_cast<T*>(p.o) + b * p.o_sb + static_cast<long long>(qpos) * p.o_ss
              + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      store4(orow + (lane4 + 4 * c) * 4,
             make_float4(acc[c][0] / den, acc[c][1] / den, acc[c][2] / den, acc[c][3] / den));
    }
  }
}

template <typename T, int HD>
static cudaError_t launch_typed(const FlashParams& p, int B, cudaStream_t s) {
  constexpr int bytes = fa_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.S + FA_BQ - 1) / FA_BQ), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(B));
  flash_attention_kernel<T, HD><<<grid, FA_THREADS, bytes, s>>>(p);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_hd(const FlashParams& p, int B, int hd, cudaStream_t s) {
  switch (hd) {
    case 128: return launch_typed<T, 128>(p, B, s);
    case 256: return launch_typed<T, 256>(p, B, s);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, so the wrapper must check this).
// q: (B, S, H, hd), k and v: (B, S, KV, hd), o: (B, S, H, hd), each given
// by its pointer and its batch, sequence and head strides in elements;
// the last axis is contiguous and every stride and pointer is aligned to
// 4 elements. window <= 0 means no window.
cudaError_t flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int S, int H, int KV, int hd,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* o_strides,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || KV <= 0 || H % KV != 0) return cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;
  FlashParams p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_strides[0]; p.q_ss = q_strides[1]; p.q_sh = q_strides[2];
  p.k_sb = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sb = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  p.o_sb = o_strides[0]; p.o_ss = o_strides[1]; p.o_sh = o_strides[2];
  p.S = S; p.H = H; p.KV = KV;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case FA_F32: return launch_hd<float>(p, B, hd, s);
    case FA_BF16: return launch_hd<__nv_bfloat16>(p, B, hd, s);
    case FA_F16: return launch_hd<__half>(p, B, hd, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
