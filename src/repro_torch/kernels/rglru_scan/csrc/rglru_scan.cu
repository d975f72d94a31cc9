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
// update is __fmul_rn then __fadd_rn (no fused multiply-add), in time
// order, the plain version's order, so the kernel equals ref.py bit for
// bit. Time is never split into chunks with a carry fix-up: that would
// round differently.
//
// Bound on this card: bytes. Each step reads a and b once and writes h
// once, 2 flops per element: at the serving shape (B 8, T 128, W 2560,
// fp32) that is 31.5 MB, 9.39 us at 3.35 TB/s. The serial arithmetic of
// one chain is ~128 steps x 8 cycles, well under a microsecond: the time
// is memory latency, and the parallelism is B * W = 20,480 chains.
//
// What held the previous design back (one thread per chain, 160 blocks
// of 128 threads; 26.8 us on an H100 80GB HBM3 at 700 W): 28 SMs carried
// two blocks and 104 one; each thread loaded 16 steps into registers and
// then ran their chain with no load in flight, so it waited out T/16 = 8
// device-memory round trips in series with at most ~16 KB in flight per
// block, where each SM needs ~25 KB in flight all the time to draw its
// share of 3.35 TB/s against ~1 us of latency.
//
// This design finds the parallelism in memory, not in time:
//   * a block is five warps over a tile of RG_CH = 32 channels of one
//     batch row: warp 0 runs the 32 chains, one per lane, and does nothing
//     else; RG_PRODUCERS = 4 warps copy a and b in and store h out. The
//     grid is (cdiv(W, 32), B): at the serve shape 640 blocks of 40 KB of
//     shared memory, 5 of which fit on an SM, so the grid is 0.97 of one
//     wave (every block resident from the start), 4 or 5 per SM;
//   * a and b stream through a ring of RG_DEPTH = 8 stages in shared
//     memory. A stage is SB / (32 * sizeof(T)) time steps x 32 channels of
//     each input. The producers keep every free slot filled with 16-byte
//     cp.async copies, each stage's completion tracked by an mbarrier
//     (cp.async.mbarrier.arrive.noinc), while the chain consumes the
//     oldest. SB is 2 KB (16 fp32 steps: at the serve shape the whole of
//     T = 128 is requested at once, ~150 KB per SM) unless the grid has at
//     most one block per SM and T spans more than the ring (a long prompt
//     at small batch): then SB is 8 KB (64 fp32 steps, 112 KB ahead per
//     block, 160 KB of dynamic shared memory in fp32 and 192 KB in 16
//     bits, admitted through cudaFuncAttributeMaxDynamicSharedMemorySize),
//     which also spreads the chain's barrier waits over 4x the steps;
//   * the chain writes h into one of RG_HBUF = 4 staging tiles; the
//     producers store each time-step row of a finished tile as 16-byte
//     coalesced stores, so neither the stores nor the copies' address
//     arithmetic sit in the chain's instruction stream;
//   * ragged edges are masked, nothing is padded: copies past T or W
//     zero-fill through cp.async's source size and their outputs are
//     never stored. Rows whose byte length or base is not a multiple of
//     16 take a scalar path: 4-byte cp.async for fp32, plain loads into
//     the ring for 16-bit types (cp.async has no 2-byte copy), and 4-byte
//     stores of h where W % 4 != 0.
// One producer warp, its copies all in flight, still fed a lone block too
// slowly: a 2,048-token prompt at batch 1 took 90 us with one and takes
// 33 us with four (tools/kernel_ab.py; H100 80GB HBM3, 700 W).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RG_CH 32           // channels per block: one chain per lane of its chain warp
#define RG_DEPTH 8         // ring stages
#define RG_STAGE_BYTES 2048  // one input's bytes per stage
#define RG_STAGE_BYTES_DEEP 8192  // ... when a block has an SM to itself
#define RG_CHUNK 16        // time steps the chain loads from shared memory at once
#define RG_HBUF 4          // staging tiles of h between the chain and the stores
#define RG_PRODUCERS 4     // warps that copy a and b in and store h out

enum RgDtype { RG_F32 = 0, RG_BF16 = 1, RG_F16 = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy bypassing L1; src_bytes 0 writes 16 zero bytes, reads nothing.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

template <typename T, int SB>
struct RgTile {
  static constexpr int STEPS = SB / (RG_CH * sizeof(T));  // time steps per stage
  static constexpr int EPC = 16 / sizeof(T);                          // elements per 16 B
  static constexpr int CPR = RG_CH / EPC;                             // 16 B chunks per row
};

template <int DEPTH, int SB>
constexpr int rg_smem_bytes(int item) {
  // a and b rings, the fp32 staging tiles of h, then the mbarriers
  return 2 * DEPTH * SB + RG_HBUF * (SB / (RG_CH * item)) * RG_CH * 4 + (DEPTH + 2 * RG_HBUF) * 8;
}

// Issues the copies of time steps [t0, t0 + STEPS) of one input into a
// ring slot (STEPS x RG_CH elements). The 16-bit scalar path loads
// synchronously.
template <typename T, int SB>
__device__ __forceinline__ void fill(T* slot, const T* __restrict__ src, long long row0, int t0,
                                     int T_len, int w0, int W, bool vec, int lane, int part) {
  using G = RgTile<T, SB>;
  if (vec) {
#pragma unroll
    for (int i = part; i < G::STEPS * G::CPR / 32; i += RG_PRODUCERS) {
      const int q = lane + 32 * i, step = q / G::CPR, c = (q % G::CPR) * G::EPC;
      const int t = t0 + step, w = w0 + c;
      const bool ok = t < T_len && w < W;
      cp_async_16(slot + step * RG_CH + c, ok ? src + (row0 + t) * W + w : src, ok ? 16 : 0);
    }
    return;
  }
  const bool wok = w0 + lane < W;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int step = part; step < G::STEPS; step += RG_PRODUCERS) {
      const int t = t0 + step;
      const bool ok = wok && t < T_len;
      cp_async_4(slot + step * RG_CH + lane, ok ? src + (row0 + t) * W + w0 + lane : src,
                 ok ? 4 : 0);
    }
  } else {  // moves the 16-bit patterns as they are
    const unsigned short* raw = reinterpret_cast<const unsigned short*>(src);
    unsigned short* dst = reinterpret_cast<unsigned short*>(slot);
    static_assert(G::STEPS % RG_PRODUCERS == 0, "each producer fills STEPS / RG_PRODUCERS steps");
    constexpr int N = G::STEPS / RG_PRODUCERS;
    unsigned short v[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int t = t0 + i * RG_PRODUCERS + part;
      v[i] = (wok && t < T_len) ? raw[(row0 + t) * W + w0 + lane] : 0;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) dst[(i * RG_PRODUCERS + part) * RG_CH + lane] = v[i];
  }
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("{\n\t.reg .b64 st;\n\tmbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Arrives on `bar` once every cp.async this thread issued so far has landed.
__device__ __forceinline__ void mbar_arrive_cp_async(unsigned long long* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar, int parity) {
  unsigned done = 0;
  do {
    asm volatile("{\n\t.reg .pred p;\n\t"
                 "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
                 "selp.u32 %0, 1, 0, p;\n\t}"
                 : "=r"(done)
                 : "r"(smem_addr(bar)), "r"(parity)
                 : "memory");
  } while (!done);
}

// Warp 0 runs the 32 chains; warps 1..RG_PRODUCERS move data. Barriers
// (mbarrier, in shared memory): full[slot] completes when all 32 *
// RG_PRODUCERS producer threads' copies of a stage have landed (cp.async
// arrivals, or plain arrivals after the 16-bit scalar fill's stores);
// hfull[i] when the chain has written stage c's h into staging tile
// i = c % RG_HBUF, which also frees ring slot c % DEPTH; hempty[i] when
// every producer thread has stored its part of that tile out.
template <typename T, int DEPTH, int SB>
__global__ void __launch_bounds__(32 * (1 + RG_PRODUCERS))
rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b, float* __restrict__ h,
                  int T_len, int W, int vec_in, int vec_out) {
  using G = RgTile<T, SB>;
  constexpr int STEPS = G::STEPS;
  constexpr int SLOT = STEPS * RG_CH;  // elements of one input per stage
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring_a = reinterpret_cast<T*>(smem);
  T* ring_b = ring_a + DEPTH * SLOT;
  float* hs = reinterpret_cast<float*>(ring_b + DEPTH * SLOT);  // RG_HBUF x STEPS x RG_CH
  unsigned long long* full = reinterpret_cast<unsigned long long*>(hs + RG_HBUF * SLOT);
  unsigned long long* hfull = full + DEPTH;
  unsigned long long* hempty = hfull + RG_HBUF;

  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * RG_CH;
  const long long row0 = static_cast<long long>(blockIdx.y) * T_len;
  const int n_stages = (T_len + STEPS - 1) / STEPS;
  const bool vi = vec_in != 0, vo = vec_out != 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < DEPTH; ++i) mbar_init(full + i, 32 * RG_PRODUCERS);
    for (int i = 0; i < RG_HBUF; ++i) {
      mbar_init(hfull + i, 32);
      mbar_init(hempty + i, 32 * RG_PRODUCERS);
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the chains
    float carry = 0.f;
#pragma unroll 1
    for (int c = 0; c < n_stages; ++c) {
      mbar_wait(full + c % DEPTH, (c / DEPTH) & 1);
      if (c >= RG_HBUF) mbar_wait(hempty + c % RG_HBUF, ((c - RG_HBUF) / RG_HBUF) & 1);
      const T* sa = ring_a + (c % DEPTH) * SLOT + lane;
      const T* sb = ring_b + (c % DEPTH) * SLOT + lane;
      float* out = hs + (c % RG_HBUF) * SLOT + lane;
#pragma unroll
      for (int u0 = 0; u0 < STEPS; u0 += RG_CHUNK) {
        float av[RG_CHUNK], bv[RG_CHUNK];
#pragma unroll
        for (int u = 0; u < RG_CHUNK; ++u) {
          av[u] = to_f32(sa[(u0 + u) * RG_CH]);
          bv[u] = to_f32(sb[(u0 + u) * RG_CH]);
        }
#pragma unroll
        for (int u = 0; u < RG_CHUNK; ++u) {
          carry = __fadd_rn(__fmul_rn(av[u], carry), bv[u]);
          out[(u0 + u) * RG_CH] = carry;
        }
      }
      mbar_arrive(hfull + c % RG_HBUF);
    }
    return;
  }

  // the producers: fill the ring ahead, store each finished stage of h;
  // warp `part` takes every RG_PRODUCERS-th chunk of both
  const int part = threadIdx.x / 32 - 1;
  auto fill_stage = [&](int s) {
    const int slot = s % DEPTH;
    fill<T, SB>(ring_a + slot * SLOT, a, row0, s * STEPS, T_len, w0, W, vi, lane, part);
    fill<T, SB>(ring_b + slot * SLOT, b, row0, s * STEPS, T_len, w0, W, vi, lane, part);
    if (vi || sizeof(T) == 4) {
      mbar_arrive_cp_async(full + slot);
    } else {
      mbar_arrive(full + slot);
    }
  };
#pragma unroll 1
  for (int s = 0; s < DEPTH && s < n_stages; ++s) fill_stage(s);
#pragma unroll 1
  for (int c = 0; c < n_stages; ++c) {
    mbar_wait(hfull + c % RG_HBUF, (c / RG_HBUF) & 1);
    // ring slot c % DEPTH is free again: refill it first, then store
    if (c + DEPTH < n_stages) fill_stage(c + DEPTH);
    const float* src = hs + (c % RG_HBUF) * SLOT;
    const int t0 = c * STEPS;
    if (vo) {
#pragma unroll
      for (int i = part; i < STEPS * (RG_CH / 4) / 32; i += RG_PRODUCERS) {
        const int q = lane + 32 * i, step = q / (RG_CH / 4), col = (q % (RG_CH / 4)) * 4;
        const int t = t0 + step, w = w0 + col;
        if (t < T_len && w < W) {
          *reinterpret_cast<float4*>(h + (row0 + t) * W + w) =
              *reinterpret_cast<const float4*>(src + step * RG_CH + col);
        }
      }
    } else if (w0 + lane < W) {
#pragma unroll
      for (int u = part; u < STEPS; u += RG_PRODUCERS) {
        if (t0 + u < T_len) h[(row0 + t0 + u) * W + w0 + lane] = src[u * RG_CH + lane];
      }
    }
    mbar_arrive(hempty + c % RG_HBUF);
  }
}

// devices whose per-device state (SM count, function attributes) is kept
constexpr int RG_MAX_DEVICES = 64;

static int sm_count() {
  static int cached[RG_MAX_DEVICES] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= RG_MAX_DEVICES) return 0;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

template <typename T, int DEPTH, int SB>
static cudaError_t launch_t(const void* a, const void* b, float* h, int T_len, int W,
                            dim3 grid, int vec_in, int vec_out, cudaStream_t s) {
  constexpr int smem = rg_smem_bytes<DEPTH, SB>(sizeof(T));
  // once per instantiation and device (a function attribute belongs to
  // the current device): admit the dynamic shared memory (above 48 KB for
  // the deep ring) and ask for the largest shared-memory carveout, so
  // that 6 blocks of the shallow ring fit on an SM
  static bool attr_set[RG_MAX_DEVICES] = {};
  static cudaError_t attr[RG_MAX_DEVICES];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev < 0 || dev >= RG_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    attr[dev] = cudaFuncSetAttribute(rglru_scan_kernel<T, DEPTH, SB>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (attr[dev] == cudaSuccess) {
      attr[dev] = cudaFuncSetAttribute(rglru_scan_kernel<T, DEPTH, SB>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
    }
    attr_set[dev] = true;
  }
  if (attr[dev] != cudaSuccess) return attr[dev];
  rglru_scan_kernel<T, DEPTH, SB><<<grid, 32 * (1 + RG_PRODUCERS), smem, s>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), h, T_len, W, vec_in, vec_out);
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_dtype(const void* a, const void* b, float* h, int B, int T_len,
                                int W, cudaStream_t s) {
  const dim3 grid(static_cast<unsigned>((W + RG_CH - 1) / RG_CH), static_cast<unsigned>(B));
  const int vec_in = (static_cast<long long>(W) * sizeof(T)) % 16 == 0
                     && reinterpret_cast<uintptr_t>(a) % 16 == 0
                     && reinterpret_cast<uintptr_t>(b) % 16 == 0;
  const int vec_out = W % 4 == 0 && reinterpret_cast<uintptr_t>(h) % 16 == 0;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const long long blocks = static_cast<long long>(grid.x) * grid.y;
  if (blocks <= sms && T_len > RG_DEPTH * RgTile<T, RG_STAGE_BYTES>::STEPS) {
    return launch_t<T, RG_DEPTH, RG_STAGE_BYTES_DEEP>(a, b, h, T_len, W, grid, vec_in, vec_out,
                                                      s);
  }
  return launch_t<T, RG_DEPTH, RG_STAGE_BYTES>(a, b, h, T_len, W, grid, vec_in, vec_out, s);
}

extern "C" {

// Launches the scan on `stream`; returns cudaGetLastError() after the
// launch (a refused launch never runs, so the wrapper must check this).
// a, b: contiguous (B, T, W) of `dtype`; h: contiguous fp32 (B, T, W).
cudaError_t rglru_scan_launch(const void* a, const void* b, float* h, int dtype, int B,
                              int T_len, int W, void* stream) {
  if (B <= 0 || B > 65535 || T_len <= 0 || W <= 0) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case RG_F32: return launch_dtype<float>(a, b, h, B, T_len, W, s);
    case RG_BF16: return launch_dtype<__nv_bfloat16>(a, b, h, B, T_len, W, s);
    case RG_F16: return launch_dtype<__half>(a, b, h, B, T_len, W, s);
    default: return cudaErrorInvalidValue;
  }
}

const char* rglru_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
