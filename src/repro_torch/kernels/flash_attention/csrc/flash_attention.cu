// Blocked causal GQA attention with an online softmax, for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/flash_attention.py:96
// (`kernel` :54 inside flash_attention_bhsd :32, launched through
// pl.pallas_call; public entry ops.py::flash_attention :19). It computes
//
//   o[b,s,h,:] = sum_t softmax_t(mask(q[b,s,h,:] . k[b,t,h/G,:] * hd^-0.5)) v[b,t,h/G,:]
//
// with the Pallas kernel's arithmetic: the running max m, the running sum
// l and the accumulator are fp32; masked scores take the finite -1e30
// (not -inf), and the output is acc / max(l, 1e-30), rounded once to q's
// type. The probabilities are never rounded to the activation type alone
// before P.V.
//
// Query and key lengths: Sq rows of q and o (the grid), Sk rows of k and
// v (the kv loop). They differ only for cross-attention (a decoder's
// queries over an encoder's frames), which is non-causal and unwindowed;
// the launcher refuses a causal or windowed call with Sq != Sk. The
// Pallas kernel has one S; the reference computes cross-attention in
// plain jnp (src/repro/nn/attention.py:113-140), which the port sends
// through this kernel as it does every full-sequence attention.
//
// Masks: causal (k <= q), sliding window (q - k < window), and the ragged
// key tail (k < Sk). The kv loop runs from the window's lower tile to
// the causal diagonal, the Pallas kernel's loop bounds (:81-88), so a
// dense S^2 is never masked. A row whose first visited tile is fully
// masked takes p = exp(-1e30 - (-1e30)) = 1 there, and the next tile's
// alpha = exp(-1e30 - m) = 0 wipes it out, as in the Pallas kernel; with
// -inf that rescale would be exp(-inf + inf) = NaN. Key/value rows past S
// load as zeros, so that transient never multiplies garbage; query rows
// past Sq load as zeros and are never stored.
//
// Bound on this card: at the serving shapes (B 8, S 128) the work is tiny
// against the bytes: Griffin (10 query heads over 1 kv head, hd 256, bf16)
// moves 11.5 MB (q and o 5.24 MB each, k and v 0.52 MB each), ~3.4 us at
// 3.35 TB/s, against ~0.67 GFLOP (~0.7 us at the bf16 tensor-core peak);
// Qwen3 (32 over 8, hd 128) moves 21 MB, ~6.3 us; Nemotron-4-340B (96
// over 8, hd 192) 81.8 MB, ~24.4 us, against 4.9 GFLOP. Whisper-base (8 heads
// of 64): its encoder (B 8, 1,500 frames, non-causal) is ~37 GFLOP,
// operations-bound (~37 us); cross-attention of 448 queries over 1,500
// frames ~11 GFLOP (~11 us). A window of 2048 over
// S 4096 (B 1, 10 heads, hd 256) is ~64 GFLOP: operations, ~65 us at
// 989 TFLOP/s. Two kernels, one launch per call either way:
//
// bf16 and fp16: flash_attention_mma_kernel, FlashAttention-2 on the
// tensor cores (mma.sync m16n8k16, fp32 accumulators; mma_sm90.cuh):
//   * one block of 4 warps per (query tile of FA_MMA_BQ = 64 rows, query
//     head, batch), each warp owning 16 query rows; the G heads of a kv
//     group re-read the same K/V tiles from L2, not from device memory;
//   * q and each K/V tile (BK = 32 rows at hd 64 and 192, 64 at hd 128, 16 at
//     hd 256) are
//     copied to shared memory with 16-byte cp.async in the operand type
//     (rows past S zero-filled through cp.async's source size), in rows
//     whose 16-byte chunks are XOR-swizzled by the row's low 3 bits, so
//     the 8 rows of every ldmatrix tile fall in 8 distinct bank groups;
//   * K/V are double-buffered: tile j + 1 is in flight while tile j
//     computes (commit_group / wait_group 1). Shared memory: 24 KB at hd
//     64, 80 KB at hd 128, 72 KB at hd 192, 64 KB at hd 256; registers
//     allow 2 blocks an SM at hd 128 and 256, 3 at hd 192, 4 at hd 64
//     (127 registers: the fp32 O accumulator is 32 a thread and 32-key
//     score fragments 16; 64 keys took 148-156 registers and ran 10-23 %
//     slower, 128 keys 241 and ran no faster). At hd 192 the accumulator
//     is 96 registers a thread: 32 keys take 168 without a spill, 16 keys
//     168 too and run 6-18 % slower, 64 keys spill 48-64 bytes at 255 and
//     run 23-46 % slower on causal self-attention (tools/flash_ab.py);
//   * S = Q K^T by mma.sync from ldmatrix fragments. Products of two
//     16-bit values are exact in fp32, so only the summation order
//     differs from the plain version. The scale is applied to the fp32
//     scores after the product (q * hd^-0.5 rounded to 16 bits would not
//     be exact at hd 128), folded with log2(e) so the softmax runs on
//     exp2f; Q is re-read from shared memory for every K tile (at hd 256
//     the fp32 O accumulator alone holds 128 registers a thread);
//   * mask, row max and row sum on the score fragments in registers, the
//     row's max reduced over the quad of lanes that share it;
//   * P.V keeps P near fp32: each p is split into hi = T(p) and
//     lo = T(p - hi), and hi.V + lo.V run as two mma.sync into the same
//     fp32 accumulator, which leaves p off by at most 2^-18 of itself in
//     bf16 (rounding p once would leave 2^-9); the doubled P.V products
//     cost nothing at byte-bound shapes;
//   * the output is staged through the warp's own q rows in shared memory
//     and written with 16-byte stores.
//
// float32: flash_attention_kernel, products on the CUDA cores in fp32
// FMAs (the tensor cores have no fp32 route that keeps the 2e-5 contract
// short of 3xTF32); q is cast to fp32 and scaled before the dot, as in the
// Pallas kernel:
//   * one block per (query tile of FA_BQ = 32 rows, query head, batch);
//   * q (scaled), then each K and V tile of FA_BK = 32 rows, are staged in
//     shared memory as fp32, rows padded by 4 floats so that the 16-byte
//     reads of 4 neighbouring rows fall in distinct banks (104 KB at hd
//     256: dynamic shared memory, limit raised per instantiation);
//   * 4 threads (a quad of neighbouring lanes) own one query row: each
//     computes 8 of the tile's 32 scores, the row's max and sum are
//     reduced with two xor shuffles, and each owns hd/4 of the row's fp32
//     accumulators (64 registers at hd 256) so nothing spills;
//   * the probabilities go through shared memory (one row per quad) for
//     P.V, which runs over the V tile with 16-byte reads;
//   * it is instantiated at hd 16 (the reduced LMs whose continuous-depth
//     hypersolver is fitted on the card), where each quad lane owns one
//     4-column chunk, and at hd 64 (Whisper-base, 4 chunks a lane), 128,
//     192 (Nemotron-4-340B, 12 chunks a lane) and 256; the 16-bit path is not instantiated at hd 16 (its swizzle
//     needs 8 chunks a row), so a 16-bit hd 16 call is refused.
//
// Both read q, k and v in place in the (B, S, heads, hd) layout through
// their strides (no transposes, no padding copies: the TPU wrapper's
// layout work has no counterpart).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include "mma_sm90.cuh"

#define FA_BQ 32
#define FA_BK 32
#define FA_THREADS (FA_BQ * 4)
#define FA_NEG_INF (-1e30f)

#define FA_MMA_BQ 64
#define FA_MMA_THREADS 128

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
  int Sq, Sk;  // query rows (grid, output), key rows (kv tiles)
  int H, KV;
  int causal;
  int window;  // <= 0: no window
  float scale;
};

// The kv tiles [lo, hi) of width BK that a query tile starting at q0 of
// BQ rows visits: from the window's lower tile to the causal diagonal.
template <int BQ, int BK>
__device__ __forceinline__ void kv_tiles(const FlashParams& p, int q0, int& lo, int& hi) {
  hi = (p.Sk + BK - 1) / BK;
  if (p.causal) hi = min(hi, (q0 + BQ + BK - 1) / BK);
  lo = 0;
  if (p.window > 0) {
    const int first = q0 - (p.window - 1);
    lo = first > 0 ? first / BK : 0;
  }
}

__device__ __forceinline__ bool kv_visible(const FlashParams& p, int qpos, int kpos) {
  bool ok = kpos < p.Sk;
  if (p.causal) ok = ok && kpos <= qpos;
  if (p.window > 0) ok = ok && (qpos - kpos < p.window);
  return ok;
}

// ---------------------------------------------------------------------
// bf16 / fp16: tensor cores

template <int HD>
__host__ __device__ constexpr int fa_mma_bk() {
  // 32 at hd 256 spills (255 registers); at hd 64, 32 keys beat 64 and
  // tie 128 (tools/flash_ab.py on the H100) at 127 registers; at hd 192,
  // 32 beat 16 and 64 (which spills): see the header
  return HD >= 256 ? 16 : (HD == 128 ? 64 : 32);
}

template <int HD>
constexpr int fa_mma_smem_bytes() {
  return (FA_MMA_BQ + 4 * fa_mma_bk<HD>()) * HD * 2;  // q, then 2 K and 2 V buffers
}

// Byte offset of 16-byte chunk c of row r in a tile of HD-wide 16-bit rows.
template <int HD>
__device__ __forceinline__ unsigned swz(int r, int c) {
  return static_cast<unsigned>(r * HD * 2 + ((c ^ (r & 7)) << 4));
}

// Starts the copies of rows [row0, row0 + ROWS) of one head into the tile
// at shared address dst; rows at or past S (the operand's length) are
// zero-filled.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void load_tile(unsigned dst, const T* base, long long row_stride,
                                          int row0, int S) {
  constexpr int CH = HD / 8;
  static_assert((ROWS * CH) % FA_MMA_THREADS == 0, "tile chunks must split over the block");
#pragma unroll
  for (int i = 0; i < ROWS * CH / FA_MMA_THREADS; ++i) {
    const int e = threadIdx.x + i * FA_MMA_THREADS;
    const int r = e / CH, c = e % CH;
    const bool ok = row0 + r < S;
    const T* src = ok ? base + static_cast<long long>(row0 + r) * row_stride + c * 8 : base;
    cp_async_16(dst + swz<HD>(r, c), src, ok ? 16 : 0);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(FA_MMA_THREADS) flash_attention_mma_kernel(const FlashParams p) {
  constexpr int BK = fa_mma_bk<HD>();
  constexpr int TILE = BK * HD * 2;  // bytes of one K or V buffer
  constexpr int NT = BK / 8;         // score n-tiles of 8 keys per warp
  constexpr int OT = HD / 8;         // output n-tiles of 8 columns per warp
  constexpr int CH = HD / 8;         // 16-byte chunks per row
  static_assert(CH % 8 == 0, "swz permutes a row's 16-byte chunks within "
                "groups of 8: HD must be a multiple of 64");
  static_assert((HD / 16) % 4 == 0, "the ldmatrix offsets step over 64-column "
                "groups of 4 k-steps: HD must be a multiple of 64");
  extern __shared__ uint4 fa_mma_smem[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(fa_mma_smem);
  const unsigned sQ = smem_addr(smem);
  const unsigned sK = sQ + FA_MMA_BQ * HD * 2;
  const unsigned sV = sK + 2 * TILE;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * FA_MMA_BQ;

  // ldmatrix addresses. Every row a lane addresses has row & 7 == x, and
  // the 16-byte chunk of the k-th 16-column step is 2 k + hi (hi = 0 or 1
  // by lane), whose swizzled place (2 k + hi) ^ x is 8 (k / 4) +
  // ((2 (k % 4) + hi) ^ x): four offsets a lane and an immediate cover all
  // k, instead of one address register per step.
  const int x = lane & 7;
  unsigned xq[4], xk[4];  // hi = lane / 16 for q and v, (lane / 8) % 2 for k
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    xq[i] = ((2 * i + (lane >> 4)) ^ x) << 4;
    xk[i] = ((2 * i + ((lane >> 3) & 1)) ^ x) << 4;
  }
  const unsigned q_lane = sQ + (warp * 16 + (lane & 15)) * HD * 2;
  const unsigned k_lane = (((lane >> 4) << 3) + x) * HD * 2;
  const unsigned v_lane = ((((lane >> 3) & 1) << 3) + x) * HD * 2;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  int lo, hi;
  kv_tiles<FA_MMA_BQ, BK>(p, q0, lo, hi);  // lo < hi: the diagonal tile is always visited

  load_tile<T, HD, FA_MMA_BQ>(sQ, qb, p.q_ss, q0, p.Sq);
  load_tile<T, HD, BK>(sK, kb, p.k_ss, lo * BK, p.Sk);
  load_tile<T, HD, BK>(sV, vb, p.v_ss, lo * BK, p.Sk);
  cp_async_commit();

  float acc[OT][4];
#pragma unroll
  for (int n = 0; n < OT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {FA_NEG_INF, FA_NEG_INF};  // rows g and g + 8 of the warp
  float l[2] = {0.f, 0.f};                // this lane's share of the row sums
  const float scale2 = p.scale * 1.4426950408889634f;  // hd^-0.5 * log2(e)
  const int qrow = q0 + warp * 16 + g;

  for (int j = lo; j < hi; ++j) {
    const int buf = (j - lo) & 1;
    if (j + 1 < hi) {  // the next tile lands while this one computes
      load_tile<T, HD, BK>(sK + (buf ^ 1) * TILE, kb, p.k_ss, (j + 1) * BK, p.Sk);
      load_tile<T, HD, BK>(sV + (buf ^ 1) * TILE, vb, p.v_ss, (j + 1) * BK, p.Sk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile j (and q) are in shared memory for every warp
    const unsigned kt = sK + buf * TILE, vt = sV + buf * TILE;

    // S = Q K^T: 16 query rows by BK keys per warp
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_lane + xq[kk & 3] + (kk >> 2) * 128);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        unsigned kf[4];
        ldmatrix_x4(kf, kt + k_lane + np * 16 * HD * 2 + xk[kk & 3] + (kk >> 2) * 128);
        Mma16<T>::mma(s[2 * np], a, kf[0], kf[1]);
        Mma16<T>::mma(s[2 * np + 1], a, kf[2], kf[3]);
      }
    }

    // mask, online softmax (base 2) on the fragments
    const int k0 = j * BK;
    float mt[2] = {FA_NEG_INF, FA_NEG_INF};
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + n * 8 + 2 * t + (e & 1);
        const float x = kv_visible(p, qrow + (e >> 1) * 8, kpos) ? s[n][e] * scale2 : FA_NEG_INF;
        s[n][e] = x;
        mt[e >> 1] = fmaxf(mt[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int n = 0; n < OT; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }

    // O += P V, with P as hi + lo: the score fragments of two n-tiles are
    // the A fragment of one 16-key step
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned ph[4], pl[4];
      split_pair<T>(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_pair<T>(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_pair<T>(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_pair<T>(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        unsigned vf[4];
        ldmatrix_x4_trans(vf, vt + v_lane + kk * 16 * HD * 2 + xq[dp & 3] + (dp >> 2) * 128);
        Mma16<T>::mma(acc[2 * dp], ph, vf[0], vf[1]);
        Mma16<T>::mma(acc[2 * dp], pl, vf[0], vf[1]);
        Mma16<T>::mma(acc[2 * dp + 1], ph, vf[2], vf[3]);
        Mma16<T>::mma(acc[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer buf before it is refilled
  }

  // o = acc / max(l, 1e-30), staged in this warp's own q rows (no other
  // warp reads them), then written 16 bytes a lane
  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int n = 0; n < OT; ++n) {
    *reinterpret_cast<unsigned*>(smem + swz<HD>(r0, n) + 4 * t) =
        Mma16<T>::pack(acc[n][0] / den[0], acc[n][1] / den[0]);
    *reinterpret_cast<unsigned*>(smem + swz<HD>(r0 + 8, n) + 4 * t) =
        Mma16<T>::pack(acc[n][2] / den[1], acc[n][3] / den[1]);
  }
  __syncwarp();
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 16 * CH / 32; ++i) {
    const int e = lane + 32 * i;
    const int r = warp * 16 + e / CH, c = e % CH;
    if (q0 + r < p.Sq) {
      *reinterpret_cast<uint4*>(ob + static_cast<long long>(q0 + r) * p.o_ss + c * 8) =
          *reinterpret_cast<const uint4*>(smem + swz<HD>(r, c));
    }
  }
}

// ---------------------------------------------------------------------
// float32: CUDA cores

// Four consecutive floats, from an address aligned to 4 elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int HD>
constexpr int fa_smem_bytes() {
  return ((FA_BQ + 2 * FA_BK) * (HD + 4) + FA_BQ * (FA_BK + 1)) * 4;
}

// Stage rows [row0, row0 + ROWS) of one head into shared memory (times
// `mul`); rows at or past S are zeros.
template <int HD, int ROWS>
__device__ __forceinline__ void stage_tile(float* dst, const float* base, long long row_stride,
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
    *reinterpret_cast<float4*>(dst + row * LD + c) = x;
  }
}

template <int HD>
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

  const float* qb = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kb = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* vb = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  stage_tile<HD, FA_BQ>(sQ, qb, p.q_ss, q0, p.Sq, p.scale);

  int lo, hi;
  kv_tiles<FA_BQ, FA_BK>(p, q0, lo, hi);

  float acc[CH][4];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c][0] = acc[c][1] = acc[c][2] = acc[c][3] = 0.f;
  float m = FA_NEG_INF;
  float l = 0.f;

  for (int j = lo; j < hi; ++j) {
    const int k0 = j * FA_BK;
    __syncthreads();  // the previous tile's K, V and P are no longer read
    stage_tile<HD, FA_BK>(sK, kb, p.k_ss, k0, p.Sk, 1.f);
    stage_tile<HD, FA_BK>(sV, vb, p.v_ss, k0, p.Sk, 1.f);
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
      s[i] = kv_visible(p, qpos, k0 + lane4 + 4 * i) ? s[i] : FA_NEG_INF;
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

  if (qpos < p.Sq) {
    const float den = fmaxf(l, 1e-30f);
    float* orow = static_cast<float*>(p.o) + b * p.o_sb + static_cast<long long>(qpos) * p.o_ss
                  + h * p.o_sh;
#pragma unroll
    for (int c = 0; c < CH; ++c) {
      *reinterpret_cast<float4*>(orow + (lane4 + 4 * c) * 4) =
          make_float4(acc[c][0] / den, acc[c][1] / den, acc[c][2] / den, acc[c][3] / den);
    }
  }
}

// ---------------------------------------------------------------------
// launch

template <typename K>
static cudaError_t launch_kernel(K kernel, const FlashParams& p, int B, int bq, int threads,
                                 int bytes, cudaStream_t s) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(static_cast<unsigned>((p.Sq + bq - 1) / bq), static_cast<unsigned>(p.H),
                  static_cast<unsigned>(B));
  kernel<<<grid, threads, bytes, s>>>(p);
  return cudaGetLastError();
}

template <int HD>
static cudaError_t launch_hd(const FlashParams& p, int dtype, int B, cudaStream_t s) {
  switch (dtype) {
    case FA_F32:
      return launch_kernel(flash_attention_kernel<HD>, p, B, FA_BQ, FA_THREADS,
                           fa_smem_bytes<HD>(), s);
    case FA_BF16:
      return launch_kernel(flash_attention_mma_kernel<__nv_bfloat16, HD>, p, B, FA_MMA_BQ,
                           FA_MMA_THREADS, fa_mma_smem_bytes<HD>(), s);
    case FA_F16:
      return launch_kernel(flash_attention_mma_kernel<__half, HD>, p, B, FA_MMA_BQ,
                           FA_MMA_THREADS, fa_mma_smem_bytes<HD>(), s);
    default:
      return cudaErrorInvalidValue;
  }
}

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, so the wrapper must check this).
// q: (B, Sq, H, hd), k and v: (B, Sk, KV, hd), o: (B, Sq, H, hd), each
// given by its pointer and its batch, sequence and head strides in
// elements; the last axis is contiguous and every stride and pointer is
// aligned to 16 bytes. window <= 0 means no window. Sq != Sk only for a
// non-causal, unwindowed call.
cudaError_t flash_attention_launch(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int KV, int hd,
                                   const long long* q_strides, const long long* k_strides,
                                   const long long* v_strides, const long long* o_strides,
                                   int causal, int window, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || KV <= 0 || H % KV != 0)
    return cudaErrorInvalidValue;
  if (Sq != Sk && (causal || window > 0)) return cudaErrorInvalidValue;
  if (B > 65535 || H > 65535) return cudaErrorInvalidValue;
  FlashParams p = {};
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_sb = q_strides[0]; p.q_ss = q_strides[1]; p.q_sh = q_strides[2];
  p.k_sb = k_strides[0]; p.k_ss = k_strides[1]; p.k_sh = k_strides[2];
  p.v_sb = v_strides[0]; p.v_ss = v_strides[1]; p.v_sh = v_strides[2];
  p.o_sb = o_strides[0]; p.o_ss = o_strides[1]; p.o_sh = o_strides[2];
  p.Sq = Sq; p.Sk = Sk; p.H = H; p.KV = KV;
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      if (dtype != FA_F32) return cudaErrorInvalidValue;
      return launch_kernel(flash_attention_kernel<16>, p, B, FA_BQ, FA_THREADS,
                           fa_smem_bytes<16>(), s);
    case 64: return launch_hd<64>(p, dtype, B, s);
    case 128: return launch_hd<128>(p, dtype, B, s);
    case 192: return launch_hd<192>(p, dtype, B, s);
    case 256: return launch_hd<256>(p, dtype, B, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
