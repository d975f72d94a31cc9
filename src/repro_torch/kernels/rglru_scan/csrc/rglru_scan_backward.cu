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
// the kernel equals the plain version bit for bit. The last step needs no
// select: the chain starts from carry = -0 and a_T reads as +0, so
// g_{T-1} + (+0 * -0) is g_{T-1} exactly, whatever its sign.
//
// Bound on this card: bytes. Each element reads g, a and h once and
// writes da and db once, 3 flops: at the training shape (B 8, T 128,
// W 2560, fp32) 20 bytes an element, 52.4 MB, 15.6 us at 3.35 TB/s. The
// design is the forward kernel's (rglru_scan.cu), in reverse time:
//   * a block is five warps over a tile of RGB_CH = 32 channels of one
//     batch row: warp 0 runs the 32 chains, one per lane, and does nothing
//     else; RGB_PRODUCERS = 4 warps copy g, a and h in and store da and db
//     out. The grid is (cdiv(W, 32), B): at the training shape 640 blocks
//     of 40 KB of shared memory, 5 of which fit on an SM, one wave. That
//     needs at most 80 registers a thread (__launch_bounds__ asks for 5
//     blocks; the chain holds 8 steps of each input at a time): at 86 an
//     SM held 4 and the grid took two waves, 0.0366 ms against 0.0264;
//   * g, a (one step ahead) and h (one step behind) stream through a ring
//     of RGB_DEPTH = 4 stages of RGB_STEPS = 16 time steps, the latest
//     stage first. The producers keep every free slot filled with 16-byte
//     cp.async copies, each stage's completion tracked by an mbarrier,
//     while the chain consumes the oldest. A stage's row i of each input
//     holds the step that the chain's step base + i reads (a at t + 1, h
//     at t - 1), so the shifts cost nothing; rows past either end of time
//     zero-fill;
//   * the chain writes da and db into one of RGB_HBUF = 4 fp32 staging
//     tiles; the producers cast them and store each time-step row of a
//     finished tile with 16-byte (fp32) or 8-byte (16-bit) stores;
//   * every operand is read in place through its strides, each in its own
//     float type. A row of 16-byte chunks (unit width stride, row strides
//     and base a multiple of 16 bytes, W a multiple of a chunk; an
//     expanded gradient, time stride 0, qualifies) takes the vector path;
//     otherwise fp32 takes 4-byte cp.async and 16-bit types plain loads
//     into the ring (cp.async has no 2-byte copy). Copies past T or W
//     zero-fill and their outputs are never stored.
// The design it replaces (one thread per column, 16 steps loaded into
// registers before their part of the chain, no load in flight during it)
// took 0.039168 ms at the training shape on an H100 80GB HBM3 at 700 W.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define RGB_CH 32          // channels per block: one chain per lane of its chain warp
#define RGB_STEPS 16       // time steps per ring stage
#define RGB_DEPTH 4        // ring stages
#define RGB_HBUF 4         // staging tiles of da and db between the chain and the stores
#define RGB_PRODUCERS 4    // warps that copy g, a, h in and store da, db out
#define RGB_BLOCKS_PER_SM 5  // resident blocks an SM: registers capped at 80 a thread
#define RGB_SLOT (RGB_STEPS * RGB_CH * 4)  // bytes of one input's stage (4-byte elements at most)
#define RGB_HALF (RGB_STEPS / 2)  // rows the chain holds in registers at once

enum RgDtype { RG_F32 = 0, RG_BF16 = 1, RG_F16 = 2 };

enum RgFill { RG_VEC = 0, RG_ASYNC4 = 1, RG_SYNC = 2 };  // how an input reaches the ring

struct RgIn {
  const unsigned char* ptr;
  long long sb, st, sw;  // element strides of B, T, W
  int dtype, esize;
  int fill;              // RgFill
  int shift;             // the chain's step t reads this input at t + shift
};

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

// Issues the copies of one input into a ring slot: row i (of RGB_STEPS)
// holds time step t0 + i + shift, zero outside [0, T) or past W. The
// 16-bit scalar path loads synchronously.
__device__ __forceinline__ void fill(unsigned char* slot, const RgIn& x, long long b, int t0,
                                     int T, int w0, int W, int lane, int part) {
  t0 += x.shift;
  if (x.fill == RG_VEC) {
    const int epc = 16 / x.esize, cpr = RGB_CH / epc;  // elements a chunk, chunks a row
    for (int q = lane + 32 * part; q < RGB_STEPS * cpr; q += 32 * RGB_PRODUCERS) {
      const int row = q / cpr, c = (q % cpr) * epc, t = t0 + row, w = w0 + c;
      const bool ok = t >= 0 && t < T && w < W;
      const unsigned char* src = ok ? x.ptr + (b * x.sb + t * x.st + w) * x.esize : x.ptr;
      cp_async_16(slot + (row * RGB_CH + c) * x.esize, src, ok ? 16 : 0);
    }
    return;
  }
  const bool wok = w0 + lane < W;
  const long long col = b * x.sb + static_cast<long long>(w0 + lane) * x.sw;
  if (x.fill == RG_ASYNC4) {
#pragma unroll
    for (int row = part; row < RGB_STEPS; row += RGB_PRODUCERS) {
      const int t = t0 + row;
      const bool ok = wok && t >= 0 && t < T;
      const unsigned char* src = ok ? x.ptr + (col + t * x.st) * 4 : x.ptr;
      cp_async_4(slot + (row * RGB_CH + lane) * 4, src, ok ? 4 : 0);
    }
    return;
  }
  // moves the 16-bit patterns as they are, all loads in flight first
  const unsigned short* raw = reinterpret_cast<const unsigned short*>(x.ptr);
  unsigned short* dst = reinterpret_cast<unsigned short*>(slot);
  constexpr int NR = RGB_STEPS / RGB_PRODUCERS;
  unsigned short v[NR];
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int t = t0 + i * RGB_PRODUCERS + part;
    v[i] = (wok && t >= 0 && t < T) ? raw[col + t * x.st] : 0;
  }
#pragma unroll
  for (int i = 0; i < NR; ++i) dst[(i * RGB_PRODUCERS + part) * RGB_CH + lane] = v[i];
}

// Rows r0 .. r0 + RGB_HALF - 1 of one input at the chain's lane, as fp32.
__device__ __forceinline__ void load_rows(const unsigned char* slot, int dtype, int r0, int lane,
                                          float (&x)[RGB_HALF]) {
  const int at = r0 * RGB_CH + lane;
  if (dtype == RG_BF16) {
    const __nv_bfloat16* p = reinterpret_cast<const __nv_bfloat16*>(slot) + at;
#pragma unroll
    for (int i = 0; i < RGB_HALF; ++i) x[i] = __bfloat162float(p[i * RGB_CH]);
  } else if (dtype == RG_F16) {
    const __half* p = reinterpret_cast<const __half*>(slot) + at;
#pragma unroll
    for (int i = 0; i < RGB_HALF; ++i) x[i] = __half2float(p[i * RGB_CH]);
  } else {
    const float* p = reinterpret_cast<const float*>(slot) + at;
#pragma unroll
    for (int i = 0; i < RGB_HALF; ++i) x[i] = p[i * RGB_CH];
  }
}

__device__ __forceinline__ void store_cast(void* p, long long i, float x, int dtype) {
  switch (dtype) {
    case RG_BF16: static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(x); break;
    case RG_F16: static_cast<__half*>(p)[i] = __float2half_rn(x); break;
    default: static_cast<float*>(p)[i] = x;
  }
}

// Four consecutive elements at p[i..i + 3] (i a multiple of 4).
__device__ __forceinline__ void store4(void* p, long long i, float4 x, int dtype) {
  switch (dtype) {
    case RG_BF16: {
      __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p) + i);
      q[0] = __floats2bfloat162_rn(x.x, x.y);
      q[1] = __floats2bfloat162_rn(x.z, x.w);
      break;
    }
    case RG_F16: {
      __half2* q = reinterpret_cast<__half2*>(static_cast<__half*>(p) + i);
      q[0] = __floats2half2_rn(x.x, x.y);
      q[1] = __floats2half2_rn(x.z, x.w);
      break;
    }
    default: *reinterpret_cast<float4*>(static_cast<float*>(p) + i) = x;
  }
}

constexpr int rgb_smem_bytes() {
  // g, a and h rings, the fp32 staging tiles of da and db, then the mbarriers
  return 3 * RGB_DEPTH * RGB_SLOT + 2 * RGB_HBUF * RGB_STEPS * RGB_CH * 4
         + (RGB_DEPTH + 2 * RGB_HBUF) * 8;
}

// Warp 0 runs the 32 chains; warps 1..RGB_PRODUCERS move data. Barriers
// (mbarrier, in shared memory): full[slot] completes when every producer
// thread has arrived `arrivals` times for a stage (once through
// cp.async's arrival if any input is copied asynchronously, once plainly
// after its stores if any is loaded synchronously); hfull[i] when the
// chain has written stage c's da and db into staging tile i = c % RGB_HBUF,
// which also frees ring slot c % RGB_DEPTH; hempty[i] when every producer
// thread has stored its part of that tile out. Stage c holds the chain's
// steps T - (c + 1) RGB_STEPS + i, i < RGB_STEPS, and the chain runs each
// stage from its last row to its first.
__global__ void __launch_bounds__(32 * (1 + RGB_PRODUCERS), RGB_BLOCKS_PER_SM)
rglru_scan_backward_kernel(const RgIn g, const RgIn a, const RgIn h, void* da, void* db,
                           int da_dtype, int db_dtype, int T, int W, int vec_out,
                           int any_async, int any_sync) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring_g = smem;
  unsigned char* ring_a = ring_g + RGB_DEPTH * RGB_SLOT;
  unsigned char* ring_h = ring_a + RGB_DEPTH * RGB_SLOT;
  float* hs_da = reinterpret_cast<float*>(ring_h + RGB_DEPTH * RGB_SLOT);  // HBUF x STEPS x CH
  float* hs_db = hs_da + RGB_HBUF * RGB_STEPS * RGB_CH;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(hs_db + RGB_HBUF * RGB_STEPS * RGB_CH);
  unsigned long long* hfull = full + RGB_DEPTH;
  unsigned long long* hempty = hfull + RGB_HBUF;

  const int lane = threadIdx.x % 32;
  const int w0 = blockIdx.x * RGB_CH;
  const long long bidx = blockIdx.y;
  const int n_stages = (T + RGB_STEPS - 1) / RGB_STEPS;

  if (threadIdx.x == 0) {
    for (int i = 0; i < RGB_DEPTH; ++i) mbar_init(full + i, 32 * RGB_PRODUCERS * (any_async + any_sync));
    for (int i = 0; i < RGB_HBUF; ++i) {
      mbar_init(hfull + i, 32);
      mbar_init(hempty + i, 32 * RGB_PRODUCERS);
    }
  }
  __syncthreads();

  if (threadIdx.x < 32) {  // the chains
    float carry = -0.f;
#pragma unroll 1
    for (int c = 0; c < n_stages; ++c) {
      mbar_wait(full + c % RGB_DEPTH, (c / RGB_DEPTH) & 1);
      if (c >= RGB_HBUF) mbar_wait(hempty + c % RGB_HBUF, ((c - RGB_HBUF) / RGB_HBUF) & 1);
      const int slot = (c % RGB_DEPTH) * RGB_SLOT;
#pragma unroll
      for (int r0 = RGB_STEPS - RGB_HALF; r0 >= 0; r0 -= RGB_HALF) {  // the later half first
        float gv[RGB_HALF], av[RGB_HALF], hv[RGB_HALF];
        load_rows(ring_g + slot, g.dtype, r0, lane, gv);
        load_rows(ring_a + slot, a.dtype, r0, lane, av);
        load_rows(ring_h + slot, h.dtype, r0, lane, hv);
        float* oa = hs_da + ((c % RGB_HBUF) * RGB_STEPS + r0) * RGB_CH + lane;
        float* ob = hs_db + ((c % RGB_HBUF) * RGB_STEPS + r0) * RGB_CH + lane;
#pragma unroll
        for (int i = RGB_HALF - 1; i >= 0; --i) {
          carry = __fadd_rn(gv[i], __fmul_rn(av[i], carry));
          oa[i * RGB_CH] = __fmul_rn(carry, hv[i]);
          ob[i * RGB_CH] = carry;
        }
      }
      mbar_arrive(hfull + c % RGB_HBUF);
    }
    return;
  }

  // the producers: fill the ring ahead, store each finished stage of da
  // and db; warp `part` takes every RGB_PRODUCERS-th chunk of each
  const int part = threadIdx.x / 32 - 1;
  auto fill_stage = [&](int s) {
    const int slot = (s % RGB_DEPTH) * RGB_SLOT, t0 = T - (s + 1) * RGB_STEPS;
    fill(ring_g + slot, g, bidx, t0, T, w0, W, lane, part);
    fill(ring_a + slot, a, bidx, t0, T, w0, W, lane, part);
    fill(ring_h + slot, h, bidx, t0, T, w0, W, lane, part);
    if (any_sync) mbar_arrive(full + s % RGB_DEPTH);
    if (any_async) mbar_arrive_cp_async(full + s % RGB_DEPTH);
  };
#pragma unroll 1
  for (int s = 0; s < RGB_DEPTH && s < n_stages; ++s) fill_stage(s);
#pragma unroll 1
  for (int c = 0; c < n_stages; ++c) {
    mbar_wait(hfull + c % RGB_HBUF, (c / RGB_HBUF) & 1);
    // ring slot c % RGB_DEPTH is free again: refill it first, then store
    if (c + RGB_DEPTH < n_stages) fill_stage(c + RGB_DEPTH);
    const float* sa = hs_da + (c % RGB_HBUF) * RGB_STEPS * RGB_CH;
    const float* sb = hs_db + (c % RGB_HBUF) * RGB_STEPS * RGB_CH;
    const int t0 = T - (c + 1) * RGB_STEPS;
    if (vec_out) {
      constexpr int ITEMS = RGB_STEPS * (RGB_CH / 4);  // float4 groups of one tile
#pragma unroll
      for (int q = lane + 32 * part; q < 2 * ITEMS; q += 32 * RGB_PRODUCERS) {
        const int which = q / ITEMS, r = q % ITEMS, row = r / (RGB_CH / 4);
        const int col = (r % (RGB_CH / 4)) * 4, t = t0 + row, w = w0 + col;
        if (t >= 0 && w < W) {
          const float4 x = *reinterpret_cast<const float4*>((which ? sb : sa) + row * RGB_CH + col);
          store4(which ? db : da, (bidx * T + t) * W + w, x, which ? db_dtype : da_dtype);
        }
      }
    } else if (w0 + lane < W) {
#pragma unroll
      for (int row = part; row < RGB_STEPS; row += RGB_PRODUCERS) {
        const int t = t0 + row;
        if (t >= 0) {
          const long long o = (bidx * T + t) * W + w0 + lane;
          store_cast(da, o, sa[row * RGB_CH + lane], da_dtype);
          store_cast(db, o, sb[row * RGB_CH + lane], db_dtype);
        }
      }
    }
    mbar_arrive(hempty + c % RGB_HBUF);
  }
}

// devices whose function attributes are set
constexpr int RGB_MAX_DEVICES = 64;

static RgIn make_in(const void* p, const long long* s, int dtype, int W, int shift) {
  RgIn x;
  x.ptr = static_cast<const unsigned char*>(p);
  x.sb = s[0];
  x.st = s[1];
  x.sw = s[2];
  x.dtype = dtype;
  x.esize = dtype == RG_F32 ? 4 : 2;
  x.shift = shift;
  const bool vec = x.sw == 1 && (static_cast<long long>(W) * x.esize) % 16 == 0
                   && (x.sb * x.esize) % 16 == 0 && (x.st * x.esize) % 16 == 0
                   && reinterpret_cast<uintptr_t>(p) % 16 == 0;
  x.fill = vec ? RG_VEC : x.esize == 4 ? RG_ASYNC4 : RG_SYNC;
  return x;
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
  if (B <= 0 || B > 65535 || T_len <= 0 || W <= 0) return cudaErrorInvalidValue;
  for (int i = 0; i < 5; ++i)
    if (dtypes[i] < RG_F32 || dtypes[i] > RG_F16) return cudaErrorInvalidValue;
  for (int i = 0; i < 9; ++i)
    if (strides[i] < 0) return cudaErrorInvalidValue;
  const RgIn g_in = make_in(grad, strides, dtypes[0], W, 0);
  const RgIn a_in = make_in(a, strides + 3, dtypes[1], W, 1);
  const RgIn h_in = make_in(h, strides + 6, dtypes[2], W, -1);
  const RgIn* ins[3] = {&g_in, &a_in, &h_in};
  int any_async = 0, any_sync = 0;
  for (int i = 0; i < 3; ++i) {
    if (ins[i]->fill == RG_SYNC) any_sync = 1;
    else any_async = 1;
  }
  const int vec_out = W % 4 == 0 && reinterpret_cast<uintptr_t>(da) % 16 == 0
                      && reinterpret_cast<uintptr_t>(db) % 16 == 0;
  // once per device (a function attribute belongs to the current device):
  // ask for the largest shared-memory carveout, so that 5 blocks fit an SM
  static bool attr_set[RGB_MAX_DEVICES] = {};
  static cudaError_t attr[RGB_MAX_DEVICES];
  int dev = 0;
  const cudaError_t got = cudaGetDevice(&dev);
  if (got != cudaSuccess) return got;
  if (dev < 0 || dev >= RGB_MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    attr[dev] = cudaFuncSetAttribute(rglru_scan_backward_kernel,
                                     cudaFuncAttributePreferredSharedMemoryCarveout,
                                     cudaSharedmemCarveoutMaxShared);
    attr_set[dev] = true;
  }
  if (attr[dev] != cudaSuccess) return attr[dev];
  const dim3 grid(static_cast<unsigned>((W + RGB_CH - 1) / RGB_CH), static_cast<unsigned>(B));
  rglru_scan_backward_kernel<<<grid, 32 * (1 + RGB_PRODUCERS), rgb_smem_bytes(),
                               static_cast<cudaStream_t>(stream)>>>(
      g_in, a_in, h_in, da, db, dtypes[3], dtypes[4], T_len, W, vec_out, any_async, any_sync);
  return cudaGetLastError();
}

const char* rglru_scan_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
