// Mamba's selective-SSM scan for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (repro_torch/kernels/mamba_scan).
//
// mamba_scan replaces the Pallas TPU kernel
// src/repro/kernels/mamba_scan/kernel.py:45 (mamba_scan_btd, body
// _mamba_kernel) and the model's scans in src/repro/models/mamba.py
// (_ssm_scan for prefill, the decode branch of mamba_layer).  Per batch row
// b and channel c, with an (ds,) f32 state h that starts from h0 (zeros
// when none is given):
//
//   h[s] <- exp(dt_t * A[c][s]) * h[s] + (dt_t * x_t) * B_t[s]
//   y_t   = h . C_t  (+ rounded to bf16 when round_y)  + D[c] * x_t
//
// and the final state is written out, so a decode step continues from the
// state a prefill left.  x, dt (B, T, di) and B_t, C_t (B, T, ds) are bf16,
// read through their strides (B_t and C_t are strided slices of the
// model's x_proj output, at any element offset); A (di, ds) and D (di,)
// are f32; y is (B, T, di) f32.  dt * x is formed in f32, as the Pallas
// kernel forms it and as the reference's model scans compute it when run.
// round_y rounds h . C to bf16 before D * x is added, as _ssm_scan does
// (src/repro/models/mamba.py:42); the decode branch and the Pallas kernel
// do not round.
//
// What bounds it on an H100, at jamba's prefill (B 2, T 1024, di 8192,
// ds 16): bytes, 8 per (b, t, c) (x, dt 2 each, y 4) plus A, D and the
// state, 136 MB or 0.0406 ms at 3.35 TB/s; and the exponentials, one per
// state element and step, B T di ds = 268 M, which the special-function
// units give at 16 a clock an SM: 0.064 ms at 1980 MHz, a floor for any
// design that takes its exps from them.  A state element's step also costs
// ~7 more instructions (dt a, the exp's range check, dbx B, the update,
// the product with C), and a lane's step ~19 (its loads, the shuffles,
// rounding, the y store): ~51 a lane and step at G = 4, 0.105 ms at one
// instruction a clock per scheduler.  The recurrence is sequential in T;
// the (b, channel, state) axes carry the parallelism: 262,144 state
// recurrences against 270,336 resident threads on the card, so the
// sequence is not cut.
//
// The design (G lanes a channel; kLanes below is the fastest of the sweep
// tools/mamba_scan_lanes.py runs, G = 4 at both d_states):
// - Each channel's ds states are spread over G neighbouring lanes, ds / G
//   a lane, kept in registers with the matching entries of A for the whole
//   sequence.  h . C is a partial sum a lane, then log2(G) __shfl_xor_sync
//   steps, always in the same order, so every lane of the channel holds the
//   same bits and runs are deterministic.  A CTA is 256 threads: 256 / G
//   channels of one batch row.  At G = 4 that is 2,048 warps at jamba's
//   prefill, 16 on most SMs (the old kernel had 4).
// - An asynchronous input ring: x and dt for CT = 32 steps of the CTA's
//   channels come in by 16-byte cp.async, three stages, two chunks in
//   flight while the threads scan the third.  The ragged channel tail
//   copies only its own bytes (zero-filling the rest).  16-byte copies
//   need x and dt on 16-byte boundaries with strides in multiples of 8
//   elements: the wrapper refuses other views (no caller passes one).
// - B_t and C_t, 2 ds values a step that every channel shares, may sit at
//   any element offset (jamba's dt_rank 256 puts them 16-byte aligned,
//   jamba-tiny's 4 at 8 bytes, a test's 5 at 10).  They are read with
//   2-byte loads into registers one chunk ahead, and stored as f32 into a
//   double buffer in shared memory after the current chunk's steps.
// - A step's operands are loaded from shared memory one step ahead (see
//   the step loop), and every loop over a chunk's copies runs a fixed count
//   a thread, so neither leaves latency bare.
// - y is staged a chunk at a time in shared memory (double-buffered) and
//   written as whole rows of the CTA's channel span with 16-byte stores,
//   after the next chunk's barrier, instead of 32 / G channels a warp.
// - T = 1 (224 of jamba's path B's 231 launches) takes its own entry of
//   the kernel: one step straight from device memory, no ring and no
//   shared memory; the state in and out moves as ds / G contiguous floats
//   a lane (16-byte runs at G = 4, ds = 16), so a warp's loads and stores
//   are whole sectors.
// - The exponential: log2(e) is folded into A once, in registers, and each
//   step takes exp2f (4 instructions with its range check), not expf (8:
//   NVCC_FLAGS have no fast math).  That moves exp(dt A) by an f32 rounding
//   of its argument; the limits chip_smoke.py and the card tests hold it to
//   are unchanged.  The state update rounds as the plain version's does
//   (see the step).  The tree order of h . C is a changed f32 summation
//   order, which kernels/mamba_scan/ops.py::rounding_errs allows (slack at
//   sum_s |h_s C_s|); tests/test_torch_mamba_rounding.py emulates all
//   three.
// Resources at ds 16, G 4 (ring entry): at most 64 registers a thread
// (__launch_bounds__ asks for 4 CTAs an SM); shared memory: ring 3 x 2 x
// 32 x 64 x 2 = 24,576 bytes, B/C 2 x 2 x 32 x 16 x 4 = 8,192, y 2 x 32 x
// 64 x 4 = 16,384: 49,152 bytes, so 4 CTAs fit an SM (chip_smoke.py phase
// 1 prints the registers, shared memory and CTAs an SM, and fails on any
// local memory: a spill).
// Where it stands: PERF.md gives its times against these bounds.
// Throwaway variants on the card: removing the shuffles, the rounding or
// the y store each saved a few percent at most; removing the exponentials
// saved about an eighth, and expf in place of exp2f is slower.  At one CTA
// an SM the scan runs well over half the time of two CTAs, and at four
// nearly twice it: at jamba's two CTAs an SM it is issue-bound with
// latency still showing.  A lane count other than 4 issues more
// instructions a state element (G = 8, 16) or hides less latency (G = 2).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NT = 256;                 // threads per CTA
constexpr int CT = 32;                  // time steps per chunk (ring stage)
constexpr int NS = 3;                   // ring stages
constexpr unsigned FULL = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// The lanes a channel at both d_states: the fastest of the sweep in
// tools/mamba_scan_lanes.py on the H100 (PERF.md).
constexpr int kLanes = 4;

template <int DS>
struct Cfg {
  static constexpr int G = kLanes;                 // lanes a channel
  static constexpr int SPL = DS / G;               // states a lane
  static constexpr int NCH = NT / G;               // channels a CTA
  static constexpr int XP = NCH / 8;               // 16-byte pieces a row
  static constexpr int BCN = 2 * CT * DS;          // B and C values a chunk
  static constexpr int BCP = (BCN + NT - 1) / NT;  // ... a thread
  // shared memory, in bytes
  static constexpr int RING = NS * 2 * CT * NCH * 2;
  static constexpr int BCB = 2 * BCN * 4;
  static constexpr int YB = 2 * CT * NCH * 4;
  static constexpr int SMEM = RING + BCB + YB;
  static_assert(G >= 2 && G <= 32 && DS % G == 0, "lanes divide d_state");
  static_assert(NCH % 8 == 0, "whole 16-byte pieces a row");
};

// The arguments of one scan (kernel parameters by value).  Strides are in
// elements, (batch, time) for each of x, dt, Bc, Cc.
struct Scan {
  const bf16 *x, *dt, *Bc, *Cc;
  const float *A, *D, *h0;
  float *y, *hT;
  int T, di, round_y;
  long long xsb, xst, dsb, dst, bsb, bst, csb, cst;
};

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float bf(bf16 v) { return __bfloat162float(v); }

// 16 bytes from global to shared, of which the first `bytes` are read and
// the rest zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// N (4, 2 or 1) floats between registers and memory aligned to 4 N bytes
template <int N>
__device__ __forceinline__ void load_vec(float* d, const float* s) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(s);
    d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(s);
    d[0] = v.x; d[1] = v.y;
  } else {
    static_assert(N == 1, "4, 2 or 1 floats");
    d[0] = *s;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* d, const float* s) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(d) = make_float4(s[0], s[1], s[2], s[3]);
  } else if constexpr (N == 2) {
    *reinterpret_cast<float2*>(d) = make_float2(s[0], s[1]);
  } else {
    static_assert(N == 1, "4, 2 or 1 floats");
    *d = s[0];
  }
}

// Grid (channel blocks of NCH, B), NT threads: lane g of channel ch is
// thread G ch + g and holds states g SPL .. g SPL + SPL - 1.  ONE: the T = 1
// entry (no shared memory); otherwise the ring, with Cfg::SMEM bytes of
// dynamic shared memory: the ring (per stage: x then dt, each (CT, NCH)
// bf16), B and C of two chunks (per chunk: B then C, each (CT, DS) f32) and
// y of two chunks ((CT, NCH) f32).
template <int DS, bool ONE>
__global__ void __launch_bounds__(NT, 4)
mamba_scan_kernel(const Scan p) {
  using K = Cfg<DS>;
  constexpr int G = K::G, SPL = K::SPL, NCH = K::NCH, XP = K::XP;
  constexpr int BCN = K::BCN;
  const int b = blockIdx.y, tid = threadIdx.x;
  const int c0 = blockIdx.x * NCH, ch = tid / G, g = tid % G;
  const int c = c0 + ch, di = p.di, T = p.T;
  const bool ok = c < di;

  float h[SPL], a[SPL];
  const size_t hoff = ((size_t)b * di + c) * DS + g * SPL;
  if (ok && p.h0) {
    load_vec<SPL>(h, p.h0 + hoff);
  } else {
#pragma unroll
    for (int k = 0; k < SPL; ++k) h[k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < SPL; ++k)               // A log2(e): exp2 takes it
    a[k] = ok ? p.A[(size_t)c * DS + g * SPL + k] * kLog2e : 0.f;
  const float Dc = ok ? p.D[c] : 0.f;
  const bf16* bb = p.Bc + (size_t)b * p.bsb;
  const bf16* cb = p.Cc + (size_t)b * p.csb;

  // One step of this lane's states; returns y_t (the same in all G lanes).
  // dt x B is exact in f32 (three bf16 factors: at most 24 significant
  // bits), so fma(dbx, B, round(exp h)) rounds as exp h + dbx B in two
  // steps, the plain version's order; left to nvcc, the update contracts
  // to fma(exp, h, dbx B), whose h drifts from the plain version's where
  // the terms of a state nearly cancel.
  auto step = [&](float xt, float dtt, const float* Bv, const float* Cv) {
    const float dbx = dtt * xt;
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      h[k] = __fmaf_rn(dbx, Bv[k], __fmul_rn(exp2f(dtt * a[k]), h[k]));
      s += h[k] * Cv[k];
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(FULL, s, o);
    if (p.round_y) s = round_bf16(s);
    return s + xt * Dc;
  };

  if constexpr (ONE) {
    float Bv[SPL], Cv[SPL];
#pragma unroll
    for (int k = 0; k < SPL; ++k) {
      Bv[k] = bf(bb[g * SPL + k]);
      Cv[k] = bf(cb[g * SPL + k]);
    }
    const float xt = ok ? bf(p.x[(size_t)b * p.xsb + c]) : 0.f;
    const float dtt = ok ? bf(p.dt[(size_t)b * p.dsb + c]) : 0.f;
    const float yv = step(xt, dtt, Bv, Cv);
    if (ok) {
      if (g == 0) p.y[(size_t)b * di + c] = yv;
      store_vec<SPL>(p.hT + hoff, h);
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);
  float* bcs = reinterpret_cast<float*>(smem + K::RING);
  float* ys = reinterpret_cast<float*>(smem + K::RING + K::BCB);
  const int nchunks = (T + CT - 1) / CT;
  const bf16* xb = p.x + (size_t)b * p.xsb + c0;
  const bf16* db = p.dt + (size_t)b * p.dsb + c0;

  // Chunk k's x and dt into stage k % NS, one commit group a chunk (empty
  // past the last chunk).  Steps past T are not copied.  Every loop over a
  // chunk's pieces runs a fixed count a thread (piece tid + j NT), so it
  // unrolls to straight code.
  constexpr int XN = 2 * CT * XP, XJ = (XN + NT - 1) / NT;
  auto issue = [&](int k) {
    if (k < nchunks) {
      const int t0 = k * CT, n = min(CT, T - t0);
      bf16* stg = ring + (size_t)(k % NS) * 2 * CT * NCH;
#pragma unroll
      for (int j = 0; j < XJ; ++j) {
        const int i = tid + j * NT;
        const int w = i / (CT * XP), cc = i / XP % CT, q = 8 * (i % XP);
        if ((XN % NT == 0 || i < XN) && cc < n) {
          const bf16* row = (w ? db + (size_t)(t0 + cc) * p.dst
                               : xb + (size_t)(t0 + cc) * p.xst);
          const int valid = min(8, di - c0 - q);
          cp_async16(stg + (w * CT + cc) * NCH + q, valid > 0 ? row + q : row,
                     valid > 0 ? 2 * valid : 0);
        }
      }
    }
    cp_async_commit();
  };

  // Chunk k's B and C: 2-byte loads into registers, then f32 into buffer
  // k & 1 (laid out as B then C, each (CT, DS)).
  bf16 bcr[K::BCP];
  auto fetch_bc = [&](int k) {
    const int t0 = k * CT, n = min(CT, T - t0);
#pragma unroll
    for (int j = 0; j < K::BCP; ++j) {
      const int i = tid + j * NT, w = i / (CT * DS), cc = i / DS % CT;
      const int s = i % DS;
      bcr[j] = i < BCN && cc < n
                   ? (w ? cb[(size_t)(t0 + cc) * p.cst + s]
                        : bb[(size_t)(t0 + cc) * p.bst + s])
                   : __float2bfloat16(0.f);
    }
  };
  auto store_bc = [&](int k) {
    float* d = bcs + (size_t)(k & 1) * BCN;
#pragma unroll
    for (int j = 0; j < K::BCP; ++j) {
      const int i = tid + j * NT;
      if (i < BCN) d[i] = bf(bcr[j]);
    }
  };

  // Chunk k's y rows (buffer k & 1), 4 channels a thread, 16-byte stores
  // where the row allows.
  constexpr int YN = CT * NCH / 4, YJ = (YN + NT - 1) / NT;
  const bool vec_y = di % 4 == 0;
  auto write_y = [&](int k) {
    const int t0 = k * CT, n = min(CT, T - t0);
    const float* yk = ys + (size_t)(k & 1) * CT * NCH;
#pragma unroll
    for (int j = 0; j < YJ; ++j) {
      const int i = tid + j * NT;
      const int cc = i / (NCH / 4), q = 4 * (i % (NCH / 4)), cq = c0 + q;
      if ((YN % NT != 0 && i >= YN) || cc >= n) continue;
      float* out = p.y + ((size_t)b * T + t0 + cc) * di + cq;
      const float* src = yk + cc * NCH + q;
      if (vec_y && cq + 4 <= di) {
        *reinterpret_cast<float4*>(out) =
            *reinterpret_cast<const float4*>(src);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (cq + e < di) out[e] = src[e];
      }
    }
  };

  issue(0);
  issue(1);
  if (nchunks > 0) {
    fetch_bc(0);
    store_bc(0);
  }
  for (int k = 0; k < nchunks; ++k) {
    const int n = min(CT, T - k * CT);
    cp_async_wait_one();             // chunk k has landed (k + 1 may fly)
    __syncthreads();                 // ... for every thread; chunk k - 1's
                                     // steps are done
    issue(k + 2);                    // into the stage chunk k - 1 used
    if (k > 0) write_y(k - 1);
    if (k + 1 < nchunks) fetch_bc(k + 1);
    const bf16* xs = ring + (size_t)(k % NS) * 2 * CT * NCH;
    const float* bk = bcs + (size_t)(k & 1) * BCN;
    float* yk = ys + (size_t)(k & 1) * CT * NCH;
    // A step's operands are loaded one step ahead, before the previous
    // step's y store: the compiler keeps shared loads behind a shared store
    // (one array, so they may alias), which left each step's latency bare.
    struct Ops { float x, dt, B[SPL], C[SPL]; };
    auto load_ops = [&](int cc, Ops& o) {
      o.x = bf(xs[cc * NCH + ch]);
      o.dt = bf(xs[(CT + cc) * NCH + ch]);
      load_vec<SPL>(o.B, bk + cc * DS + g * SPL);
      load_vec<SPL>(o.C, bk + (CT + cc) * DS + g * SPL);
    };
    Ops cur, nxt;
    load_ops(0, cur);
#pragma unroll 4
    for (int cc = 0; cc < n; ++cc) {
      load_ops(min(cc + 1, n - 1), nxt);
      const float yv = step(cur.x, cur.dt, cur.B, cur.C);
      if (g == 0) yk[cc * NCH + ch] = yv;
      cur = nxt;
    }
    if (k + 1 < nchunks) store_bc(k + 1);   // into the buffer k - 1 read
  }
  __syncthreads();
  if (nchunks > 0) write_y(nchunks - 1);
  if (ok) store_vec<SPL>(p.hT + hoff, h);
}

template <int DS>
int launch(const Scan& p, int B, cudaStream_t stream) {
  using K = Cfg<DS>;
  const dim3 grid((p.di + K::NCH - 1) / K::NCH, B);
  if (p.T == 1) {
    mamba_scan_kernel<DS, true><<<grid, NT, 0, stream>>>(p);
  } else {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<DS, false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
    if (e != cudaSuccess) return (int)e;
    mamba_scan_kernel<DS, false><<<grid, NT, K::SMEM, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

// out[0..4]: lanes a channel, the ring entry's registers a thread, its
// dynamic shared memory a CTA in bytes and its CTAs an SM on the current
// device, and the larger local memory a thread of the two entries (a
// spill); 0 or a CUDA error.
template <int DS>
int resources(int* out) {
  using K = Cfg<DS>;
  const auto ring = mamba_scan_kernel<DS, false>;
  cudaFuncAttributes attr, one;
  cudaError_t e = cudaFuncSetAttribute(
      ring, cudaFuncAttributeMaxDynamicSharedMemorySize, K::SMEM);
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, ring);
  if (e == cudaSuccess)
    e = cudaFuncGetAttributes(&one, mamba_scan_kernel<DS, true>);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[3], ring, NT,
                                                      K::SMEM);
  if (e != cudaSuccess) return (int)e;
  out[0] = K::G;
  out[1] = attr.numRegs;
  out[2] = K::SMEM;
  out[4] = (int)(attr.localSizeBytes > one.localSizeBytes
                     ? attr.localSizeBytes : one.localSizeBytes);
  return 0;
}

}  // namespace

// The last dim of x, dt, Bc, Cc is contiguous; x and dt start on 16-byte
// boundaries with (batch, time) strides in multiples of 8 elements; h0
// (may be null: zero state) starts on a 16-byte boundary (the wrapper
// checks).  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int mamba_scan(const void* x, const void* dt, const void* Bc,
                          const void* Cc, const void* A, const void* D,
                          const void* h0, void* y, void* hT, int B, int T,
                          int di, int DS, int round_y, long long xsb,
                          long long xst, long long dsb, long long dst,
                          long long bsb, long long bst, long long csb,
                          long long cst, void* stream) {
  if (B == 0 || di == 0) return 0;
  const Scan p{static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
               static_cast<const bf16*>(Bc), static_cast<const bf16*>(Cc),
               static_cast<const float*>(A), static_cast<const float*>(D),
               static_cast<const float*>(h0), static_cast<float*>(y),
               static_cast<float*>(hT), T, di, round_y, xsb, xst, dsb, dst,
               bsb, bst, csb, cst};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DS) {
    case 8: return launch<8>(p, B, s);
    case 16: return launch<16>(p, B, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The kernel's resources at d_state DS into out[0..4] (see resources).
extern "C" int mamba_scan_config(int DS, int* out) {
  switch (DS) {
    case 8: return resources<8>(out);
    case 16: return resources<16>(out);
    default: return (int)cudaErrorInvalidValue;
  }
}
