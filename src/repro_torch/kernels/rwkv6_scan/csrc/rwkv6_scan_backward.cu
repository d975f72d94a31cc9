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
// ref.py::wkv6_scan_backward_ref. Going backward in time with dS (G below,
// carried from gS, or zero):
//
//   dr_t = S_{t-1} go_t + u k_t (v_t . go_t)    dk_t = G v_t + r_t u (v_t . go_t)
//   dv_t = k_t^T G + go_t (r_t . u k_t)         dw_t = sum_j G S_{t-1}
//   du partial_t = r_t k_t (v_t . go_t)         G <- r_t^T go_t + w_t G
//
// and dS0 is the last G. These are the plain version's sums regrouped
// (M = S_{t-1} + u kv and dkv = dM u + G written out). Both recurrences,
// S_ij <- w_i S_ij + k_i v_j and G_ij <- r_i go_j + w_i G_ij, are
// independent in i and j; only the reductions couple the elements (dr,
// dk, dw sum over j, dv over i). Each recurrence rounds as the plain
// version does (__fmul_rn, __fadd_rn, no fused multiply-add), so the
// states, G and dS0 equal its bit for bit; only the reductions regroup.
//
// Bound on this card: operations. About 21 flops per state element and
// token in the plain version's arithmetic: at the training shape (B 8,
// T 128, H 32, D 64) 2.8 GFLOP, 42 us at the 67 TFLOP/s fp32 rate. The
// design (one block per (b, h)):
//  * the states stay on chip, by chunk. Phase (i) runs the recurrence
//    forward and keeps one checkpoint, the state before every
//    WKV_CKPT-th token, in the workspace: B H ceil(T / 16) D^2 floats
//    (34 MB at the training shape, against the T states, 537 MB, that a
//    design storing every state writes and reads back). Phase (ii) walks
//    the chunks from the last one, each in passes of SUB tokens from the
//    last: a pass recomputes the states before its tokens and steps back
//    through them. At D <= 64 a pass holds its 4 states in registers;
//    the chunk's first pass, walking forward from the checkpoint to its
//    token 12, leaves the states before tokens 4 and 8 in shared
//    memory, where the middle passes start (24 forward steps a chunk of
//    16). At D 128 (32 elements a thread) a pass holds 2 states in
//    shared memory and starts from the checkpoint. The recomputation
//    rounds as the forward does, so the states are the plain version's;
//  * more threads a head: a thread owns a tile of R rows by 4 columns of
//    S and G in registers (at D 64 a block of 256 threads, 8 warps, 16
//    elements each), and no arithmetic depends on another thread's. Per
//    token each thread writes its partial sums (R rows of dr, dk and dw
//    over its 4 columns; 4 columns of dv over its R rows) to shared
//    memory; after each pass one reduction sums them in a fixed order
//    (each output a sequence of float4 adds over the column or row
//    groups), adds the terms that need no state (the two dot products a
//    token, computed once per chunk) and writes dr, dk, dv, dw and du's
//    partial. Two block barriers a pass of 4 tokens (a token at D 128), no
//    atomics: two launches on the same inputs give the same bits;
//  * r, k, v, w and go of the next chunk (earlier in time) are issued as
//    raw words into registers before the current chunk's arithmetic and
//    converted to fp32 only when staged, as the forward kernel does; the
//    next chunk's checkpoint too (D <= 64).
// At D 64 the block holds 120 KB of shared memory and 198 registers a
// thread (with go; ptxas, no spill at any D), one block (8 warps) an SM. Holding a pass's states
// in registers instead of 8 states in shared memory took the training
// shape from 0.2188 to 0.2005 ms (tools/kernel_ab.py, H100 80GB HBM3,
// 700 W); 512 threads of 8 elements each took 0.2738. Tensor cores are
// not used: each token's products are matrix-vector products with a
// matrix new at every token (S_{t-1} go_t, k_t^T G). A GEMM appears only
// in the chunked parallel form (cumulative decays, exp/log of w within a
// chunk), which rounds the state otherwise and would break dS0's bit
// equality.
//
// du: the kernel writes one partial per (b, t, h, i), at time row
// T - 1 - t, and the wrapper sums them over b, then over the rows in
// order, from the last step back: the plain version's order.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#define WKV_CKPT 16  // tokens between checkpoints: ops.py::CHECKPOINT_EVERY

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
  float* states;             // (B, H, ceil(T / WKV_CKPT), D, D): the checkpoints
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

// Four consecutive elements at p[i..i + 3] (i a multiple of 4), each
// rounded to nearest even.
__device__ __forceinline__ void store4(void* p, long long i, float4 x, int dtype) {
  switch (dtype) {
    case WKV_BF16: {
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i);
      q[0] = __floats2bfloat162_rn(x.x, x.y);
      q[1] = __floats2bfloat162_rn(x.z, x.w);
      break;
    }
    case WKV_F16: {
      __half2* q = reinterpret_cast<__half2*>(static_cast<__half*>(p) + i);
      q[0] = __floats2half2_rn(x.x, x.y);
      q[1] = __floats2half2_rn(x.z, x.w);
      break;
    }
    default: *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = x;
  }
}

__device__ __forceinline__ float at(const WkvTensor& x, long long a, long long b, long long c,
                                    long long d) {
  return load_f32(x.ptr, a * x.s0 + b * x.s1 + c * x.s2 + d * x.s3, x.dtype);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The block's shape for head size D.
template <int D>
struct Bwd {
  static constexpr int R = D == 8 ? 1 : D == 16 ? 2 : D == 128 ? 8 : 4;  // rows a thread owns
  static constexpr int CG = D / 4;                  // groups of 4 columns
  static constexpr int RG = D / R;                  // groups of R rows
  static constexpr int N = CG * RG;                 // threads
  // a pass's states in registers (D <= 64: 4 of them, 16 elements a
  // thread at D 64), shared memory holding the chunk's states before
  // tokens 4 and 8, and the chunk's checkpoint in registers too; or
  // (D 128, 32 elements a thread) in shared memory
  static constexpr bool REG = D <= 64;
  static constexpr int SUB = REG ? 4 : 2;           // states a pass holds: tokens it walks
  static constexpr int TILES = REG ? WKV_CKPT / SUB - 2 : SUB;  // (D, D) states in shared memory
  static constexpr int RT = REG ? SUB : 1;          // tokens a reduction pass sums
  static constexpr int LDP = D + 4;                 // padded row of the partial sums
  static constexpr int SLOT = (3 * CG + RG) * LDP;  // one token's partial sums
  static constexpr int WPO = WKV_CKPT * D / N;      // words of an operand a thread fetches a chunk
  static constexpr int GS = N / WKV_CKPT;           // threads a token's dot products take
  // floats: the states, the partial sums, r k v w go of a chunk, u, the dot products
  static constexpr int SMEM = TILES * D * D + RT * SLOT + 5 * WKV_CKPT * D + D + 2 * WKV_CKPT;
  static_assert(WPO * N == WKV_CKPT * D && GS * WKV_CKPT == N && GS <= 32, "bad block shape");
};

template <int R>
__device__ __forceinline__ void lds_rows(const float* p, float (&x)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q) {
      const float4 v = reinterpret_cast<const float4*>(p)[q];
      x[4 * q] = v.x; x[4 * q + 1] = v.y; x[4 * q + 2] = v.z; x[4 * q + 3] = v.w;
    }
  } else if constexpr (R == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else {
    x[0] = p[0];
  }
}

template <int R>
__device__ __forceinline__ void sts_rows(float* p, const float (&x)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int q = 0; q < R / 4; ++q)
      reinterpret_cast<float4*>(p)[q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2], x[4 * q + 3]);
  } else if constexpr (R == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    p[0] = x[0];
  }
}

__device__ __forceinline__ void lds4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}

// Issues the loads of one operand's words e = tid + q N (token e / D,
// element e % D) of the chunk at tc as raw words, zero past its n tokens;
// nothing here waits for them.
template <int D, int N, int WPO>
__device__ __forceinline__ void fetch(const WkvTensor& x, int b, int h, int tc, int n,
                                      unsigned (&raw)[WPO]) {
  const long long base = b * x.s0 + h * x.s2 + tc * x.s1;
  if (x.dtype == WKV_F32) {
    const unsigned* p = static_cast<const unsigned*>(x.ptr) + base;
#pragma unroll
    for (int q = 0; q < WPO; ++q) {
      const int e = threadIdx.x + q * N, tt = e / D;
      raw[q] = tt < n ? __ldg(p + tt * x.s1 + (e % D) * x.s3) : 0u;
    }
  } else {
    const unsigned short* p = static_cast<const unsigned short*>(x.ptr) + base;
#pragma unroll
    for (int q = 0; q < WPO; ++q) {
      const int e = threadIdx.x + q * N, tt = e / D;
      raw[q] = tt < n ? static_cast<unsigned>(__ldg(p + tt * x.s1 + (e % D) * x.s3)) : 0u;
    }
  }
}

// Converts fetched words to fp32 into their places in a staged chunk
// (dst[tt * D + d]).
template <int N, int WPO>
__device__ __forceinline__ void stage(float* dst, const unsigned (&raw)[WPO], int dtype) {
  if (dtype == WKV_BF16) {
#pragma unroll
    for (int q = 0; q < WPO; ++q) dst[threadIdx.x + q * N] = __uint_as_float(raw[q] << 16);
  } else if (dtype == WKV_F16) {
#pragma unroll
    for (int q = 0; q < WPO; ++q)
      dst[threadIdx.x + q * N] = __half2float(__ushort_as_half(static_cast<unsigned short>(raw[q])));
  } else {
#pragma unroll
    for (int q = 0; q < WPO; ++q) dst[threadIdx.x + q * N] = __uint_as_float(raw[q]);
  }
}

// One forward step of a thread's tile: S <- w S + k v, rounded as the
// forward kernel and the plain version round it.
template <int R>
__device__ __forceinline__ void forward_step(float (&S)[R][4], const float* kt, const float* wt,
                                             const float* vt) {
  float kk[R], ww[R], vv[4];
  lds_rows<R>(kt, kk);
  lds_rows<R>(wt, ww);
  lds4(vt, vv);
#pragma unroll
  for (int a = 0; a < R; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) S[a][c] = __fadd_rn(__fmul_rn(ww[a], S[a][c]), __fmul_rn(kk[a], vv[c]));
}

template <int D, int R>
__device__ __forceinline__ void tile_load(float (&S)[R][4], const float* src, int i0, int j0) {
#pragma unroll
  for (int a = 0; a < R; ++a) lds4(src + (i0 + a) * D + j0, S[a]);
}

template <int D, int R>
__device__ __forceinline__ void tile_store(float* dst, const float (&S)[R][4], int i0, int j0) {
#pragma unroll
  for (int a = 0; a < R; ++a)
    *reinterpret_cast<float4*>(dst + (i0 + a) * D + j0) = make_float4(S[a][0], S[a][1], S[a][2], S[a][3]);
}

// One token back in time for a thread's tile: its partial sums into the
// reduction slot ps, then G <- r^T go + w G. S holds the tile of S_{t-1};
// sr points at the chunk's staged r (then k, v, w, go WKV_CKPT D floats
// apart each), m is the token's index in the chunk.
template <int D, bool GO>
__device__ __forceinline__ void back_step(float (&G)[Bwd<D>::R][4], const float (&S)[Bwd<D>::R][4],
                                          const float* sr, int m, float* ps, int i0, int j0,
                                          int cg, int rg) {
  using K = Bwd<D>;
  constexpr int R = K::R, CG = K::CG, LDP = K::LDP, CD = WKV_CKPT * D;
  const float* tok = sr + m * D;
  float rr[R], kk[R], ww[R], vv[4], gg[4];
  lds_rows<R>(tok + CD + i0, kk);
  lds_rows<R>(tok + 3 * CD + i0, ww);
  lds4(tok + 2 * CD + j0, vv);
  if (GO) {
    lds_rows<R>(tok + i0, rr);
    lds4(tok + 4 * CD + j0, gg);
  }
  float pdr[R], pdk[R], pdw[R], pdv[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < R; ++i) {
    pdr[i] = pdk[i] = pdw[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = G[i][j], s = S[i][j];
      if (GO) pdr[i] = __fmaf_rn(s, gg[j], pdr[i]);
      pdw[i] = __fmaf_rn(g, s, pdw[i]);
      pdk[i] = __fmaf_rn(g, vv[j], pdk[i]);
      pdv[j] = __fmaf_rn(g, kk[i], pdv[j]);
      G[i][j] = GO ? __fadd_rn(__fmul_rn(rr[i], gg[j]), __fmul_rn(ww[i], g)) : __fmul_rn(ww[i], g);
    }
  }
  if (GO) sts_rows<R>(ps + cg * LDP + i0, pdr);
  sts_rows<R>(ps + (CG + cg) * LDP + i0, pdk);
  sts_rows<R>(ps + (2 * CG + cg) * LDP + i0, pdw);
  *reinterpret_cast<float4*>(ps + (3 * CG + rg) * LDP + j0) = make_float4(pdv[0], pdv[1], pdv[2], pdv[3]);
}

// Sums the partials of the nb tokens m_hi, m_hi - 1, .. (slot s holds
// token m_hi - s) in a fixed order, adds the terms that need no state and
// writes dr, dk, dv, dw and du's partial: one output float4 an item
// (slot, quantity, element), the block's threads over the items.
template <int D, bool GO>
__device__ __forceinline__ void reduce_tokens(const WkvBackwardArgs& a, const float* part,
                                              const float* sr, const float* su, const float* svg,
                                              const float* scr, int nb, int m_hi, int tc,
                                              long long o_bh, long long o_st) {
  using K = Bwd<D>;
  constexpr int CG = K::CG, LDP = K::LDP, CD = WKV_CKPT * D;
#pragma unroll 1
  for (int x = threadIdx.x; x < nb * D; x += K::N) {
    const int s = x / D, q = (x % D) / (D / 4), e = (x % (D / 4)) * 4;
    const int m = m_hi - s, t = tc + m;
    const long long o = o_bh + static_cast<long long>(t) * o_st + e;
    float4* du = reinterpret_cast<float4*>(a.du_part + o_bh + static_cast<long long>(a.T - 1 - t) * o_st + e);
    if (q == 0 && !GO) {
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      store4(a.dr, o, z, a.r.dtype);
      *du = z;
      continue;
    }
    // q 0..2: dr, dk, dw over the CG column groups; q 3: dv over the row groups
    const float* src = part + s * K::SLOT + (q < 3 ? q * CG : 3 * CG) * LDP + e;
    const int cnt = q < 3 ? CG : K::RG;
    float4 s0 = *reinterpret_cast<const float4*>(src);
    float4 s1 = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int y = 1; y + 1 < cnt; y += 2) {
      s0 = add4(s0, *reinterpret_cast<const float4*>(src + y * LDP));
      s1 = add4(s1, *reinterpret_cast<const float4*>(src + (y + 1) * LDP));
    }
    if (cnt % 2 == 0) s1 = add4(s1, *reinterpret_cast<const float4*>(src + (cnt - 1) * LDP));
    float4 sum = add4(s0, s1);
    const float* tok = sr + m * D + e;  // r, then k, v, w, go CD floats apart
    if (q == 0) {  // dr, and du's partial
      const float vg = svg[m];
      const float4 r4 = *reinterpret_cast<const float4*>(tok);
      const float4 k4 = *reinterpret_cast<const float4*>(tok + CD);
      const float4 u4 = *reinterpret_cast<const float4*>(su + e);
      sum.x += u4.x * k4.x * vg; sum.y += u4.y * k4.y * vg;
      sum.z += u4.z * k4.z * vg; sum.w += u4.w * k4.w * vg;
      store4(a.dr, o, sum, a.r.dtype);
      *du = make_float4(r4.x * k4.x * vg, r4.y * k4.y * vg, r4.z * k4.z * vg, r4.w * k4.w * vg);
    } else if (q == 1) {
      if (GO) {
        const float vg = svg[m];
        const float4 r4 = *reinterpret_cast<const float4*>(tok);
        const float4 u4 = *reinterpret_cast<const float4*>(su + e);
        sum.x += r4.x * u4.x * vg; sum.y += r4.y * u4.y * vg;
        sum.z += r4.z * u4.z * vg; sum.w += r4.w * u4.w * vg;
      }
      store4(a.dk, o, sum, a.k.dtype);
    } else if (q == 2) {
      store4(a.dw, o, sum, a.w.dtype);
    } else {
      if (GO) {
        const float cr = scr[m];
        const float4 g4 = *reinterpret_cast<const float4*>(tok + 4 * CD);
        sum.x += g4.x * cr; sum.y += g4.y * cr; sum.z += g4.z * cr; sum.w += g4.w * cr;
      }
      store4(a.dv, o, sum, a.v.dtype);
    }
  }
}

template <int D, bool GO>
__global__ void __launch_bounds__(Bwd<D>::N, 1) wkv6_backward_kernel(const WkvBackwardArgs a) {
  using K = Bwd<D>;
  constexpr int R = K::R, CG = K::CG, N = K::N, C = WKV_CKPT, WPO = K::WPO, SUB = K::SUB;
  constexpr unsigned MASK = N >= 32 ? 0xffffffffu : (1u << (N & 31)) - 1u;
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x, T = a.T;
  const int cg = tid % CG, rg = tid / CG, i0 = rg * R, j0 = cg * 4;
  extern __shared__ float4 wkvb_smem[];
  float* st = reinterpret_cast<float*>(wkvb_smem);  // [TILES][D][D]: states a thread keeps
  float* part = st + K::TILES * D * D;              // [RT][SLOT]: partial sums
  float* sr = part + K::RT * K::SLOT;               // [C][D] each: r, k, v, w, go
  float* sk = sr + C * D;
  float* sv = sk + C * D;
  float* sw = sv + C * D;
  float* sg = sw + C * D;
  float* su = sg + C * D;  // [D]
  float* svg = su + D;     // [C]: v_t . go_t
  float* scr = svg + C;    // [C]: sum_i r_i u_i k_i

  const long long bh = static_cast<long long>(b) * a.H + h;
  const int nC = (T + C - 1) / C;
  float* ckpt = a.states + bh * nC * D * D;  // [nC][D][D]
  for (int i = tid; i < D; i += N) su[i] = at(a.u, h, i, 0, 0);

  unsigned pr[WPO], pk[WPO], pv[WPO], pw[WPO], pg[WPO];
  auto fetch_chunk = [&](int c, bool all) {  // k, v, w (and r, go) of chunk c
    const int tc = c * C, n = min(C, T - tc);
    fetch<D, N, WPO>(a.k, b, h, tc, n, pk);
    fetch<D, N, WPO>(a.v, b, h, tc, n, pv);
    fetch<D, N, WPO>(a.w, b, h, tc, n, pw);
    if (all && GO) {
      fetch<D, N, WPO>(a.r, b, h, tc, n, pr);
      fetch<D, N, WPO>(a.go, b, h, tc, n, pg);
    }
  };

  // (i) forward: checkpoint c is the state before token c C
  float S[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) S[i][j] = a.S0.ptr != nullptr ? at(a.S0, b, h, i0 + i, j0 + j) : 0.f;
  fetch_chunk(0, nC == 1);
#pragma unroll 1
  for (int c = 0; c + 1 < nC; ++c) {
    tile_store<D, R>(ckpt + static_cast<long long>(c) * D * D, S, i0, j0);
    __syncthreads();  // the last chunk's reads are done
    stage<N, WPO>(sk, pk, a.k.dtype);
    stage<N, WPO>(sv, pv, a.v.dtype);
    stage<N, WPO>(sw, pw, a.w.dtype);
    __syncthreads();
    fetch_chunk(c + 1, c + 2 == nC);  // the loads fly while this chunk computes
#pragma unroll 1
    for (int m = 0; m < C; ++m) forward_step<R>(S, sk + m * D + i0, sw + m * D + i0, sv + m * D + j0);
  }
  tile_store<D, R>(ckpt + static_cast<long long>(nC - 1) * D * D, S, i0, j0);
  float ck[K::REG ? R : 1][4];  // the checkpoint of the chunk being walked
  if constexpr (K::REG) {
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) ck[i][j] = S[i][j];
  }

  // (ii) backward in time, chunk by chunk
  float G[R][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) G[i][j] = a.gS.ptr != nullptr ? at(a.gS, b, h, i0 + i, j0 + j) : 0.f;
  const long long o_st = static_cast<long long>(a.H) * D;  // token stride of the outputs
  const long long o_bh = static_cast<long long>(b) * T * o_st + static_cast<long long>(h) * D;

#pragma unroll 1
  for (int c = nC - 1; c >= 0; --c) {
    const int tc = c * C, n = min(C, T - tc);
    __syncthreads();  // the last chunk's reads of the staged operands are done
    stage<N, WPO>(sk, pk, a.k.dtype);
    stage<N, WPO>(sv, pv, a.v.dtype);
    stage<N, WPO>(sw, pw, a.w.dtype);
    if (GO) {
      stage<N, WPO>(sr, pr, a.r.dtype);
      stage<N, WPO>(sg, pg, a.go.dtype);
    }
    __syncthreads();
    if (c > 0) fetch_chunk(c - 1, true);
    if (GO) {  // the chunk's dot products, K::GS threads a token
      const int tt = tid / K::GS, p = tid % K::GS;
      float vg = 0.f, cr = 0.f;
#pragma unroll
      for (int d = p; d < D; d += K::GS) {
        vg = __fmaf_rn(sv[tt * D + d], sg[tt * D + d], vg);
        cr = __fmaf_rn(__fmul_rn(sr[tt * D + d], su[d]), sk[tt * D + d], cr);
      }
#pragma unroll
      for (int off = K::GS / 2; off > 0; off >>= 1) {
        vg += __shfl_xor_sync(MASK, vg, off);
        cr += __shfl_xor_sync(MASK, cr, off);
      }
      if (p == 0) {
        svg[tt] = vg;
        scr[tt] = cr;
      }
    }

    // the chunk's passes, the last first; pass p walks tokens p SUB ..
    // p SUB + SUB - 1 back from the states before them, recomputed from
    // the checkpoint (or, in registers, from the state before token p SUB
    // kept in shared memory by the first pass). Each thread keeps and
    // reads only its own tile's states, so no barrier guards them.
    const int last = (n - 1) / SUB;
#pragma unroll 1
    for (int pass = last; pass >= 0; --pass) {
      const int m0 = pass * SUB, nb = min(SUB, n - m0);
      if constexpr (K::REG) {
        if (pass == last || pass == 0) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) S[i][j] = ck[i][j];
        }
        if (pass == 0 && c > 0) {  // the next chunk's checkpoint flies meanwhile
          const float* src = ckpt + static_cast<long long>(c - 1) * D * D;
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float4 x = *reinterpret_cast<const float4*>(src + (i0 + i) * D + j0);
            ck[i][0] = x.x; ck[i][1] = x.y; ck[i][2] = x.z; ck[i][3] = x.w;
          }
        }
        if (pass == last) {  // forward to token m0, keeping the state before every SUB-th
#pragma unroll 1
          for (int m = 0; m < m0; ++m) {
            if (m % SUB == 0 && m > 0) tile_store<D, R>(st + (m / SUB - 1) * D * D, S, i0, j0);
            forward_step<R>(S, sk + m * D + i0, sw + m * D + i0, sv + m * D + j0);
          }
        } else if (pass > 0) {
          tile_load<D, R>(S, st + (pass - 1) * D * D, i0, j0);
        }
        float P[SUB][R][4];  // the states before tokens m0 .. m0 + nb - 1
#pragma unroll
        for (int q = 0; q < SUB; ++q) {
#pragma unroll
          for (int i = 0; i < R; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) P[q][i][j] = S[i][j];
          if (q + 1 < nb) {
            const int m = m0 + q;
            forward_step<R>(S, sk + m * D + i0, sw + m * D + i0, sv + m * D + j0);
          }
        }
#pragma unroll
        for (int q = SUB - 1; q >= 0; --q)
          if (q < nb) back_step<D, GO>(G, P[q], sr, m0 + q, part + (nb - 1 - q) * K::SLOT, i0, j0, cg, rg);
        __syncthreads();  // every partial of the pass's nb tokens is written
        reduce_tokens<D, GO>(a, part, sr, su, svg, scr, nb, m0 + nb - 1, tc, o_bh, o_st);
        __syncthreads();  // the partials are read before the next pass writes them
      } else {  // the pass's states in shared memory, the partials summed a token at a time
        tile_load<D, R>(S, ckpt + static_cast<long long>(c) * D * D, i0, j0);
#pragma unroll 1
        for (int m = 0; m < m0 + nb; ++m) {
          if (m >= m0) tile_store<D, R>(st + (m - m0) * D * D, S, i0, j0);
          if (m + 1 < m0 + nb) forward_step<R>(S, sk + m * D + i0, sw + m * D + i0, sv + m * D + j0);
        }
#pragma unroll 1
        for (int m = m0 + nb - 1; m >= m0; --m) {
          float Sm[R][4];
          tile_load<D, R>(Sm, st + (m - m0) * D * D, i0, j0);
          back_step<D, GO>(G, Sm, sr, m, part, i0, j0, cg, rg);
          __syncthreads();
          reduce_tokens<D, GO>(a, part, sr, su, svg, scr, 1, m, tc, o_bh, o_st);
          __syncthreads();
        }
      }
    }
  }
  if (a.dS0 != nullptr) {
#pragma unroll
    for (int i = 0; i < R; ++i)
      store4(a.dS0, (bh * D + i0 + i) * D + j0, make_float4(G[i][0], G[i][1], G[i][2], G[i][3]),
             a.S0.dtype);
  }
}

template <int D, bool GO>
static cudaError_t launch_d(const WkvBackwardArgs& a, const dim3& grid, cudaStream_t s) {
  constexpr int bytes = Bwd<D>::SMEM * 4;
  const cudaError_t err = cudaFuncSetAttribute(
      wkv6_backward_kernel<D, GO>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  wkv6_backward_kernel<D, GO><<<grid, Bwd<D>::N, bytes, s>>>(a);
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
// checkpoints (B H ceil(T / 16) D D floats) and du partials (B T H D
// floats). `strides` holds 4 element strides for each of go, r, k, v, w,
// gS, S0 and u (u's last two 0), `dtypes` the type codes of the same 8
// operands; each output takes its input's type. Outputs are contiguous.
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
