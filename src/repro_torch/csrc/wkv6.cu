// The WKV6 recurrence (RWKV-6 "Finch" time mix) for Hopper (sm_90a), with a
// plain C interface bound from Python through ctypes
// (repro_torch/kernels/rwkv6).
//
// wkv6 replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py:47
// (wkv6_bht, body _wkv6_kernel) and the model's scan
// src/repro/models/rwkv.py::_wkv6_scan.  Per (batch row b, head h), with a
// (dh, dh) f32 state S indexed [key i][value j] that starts from state0
// (zeros when none is given):
//
//   o_t[j] = sum_i r_t[i] * S[i][j]  +  v_t[j] * sum_i r_t[i] * u[i] * k_t[i]
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// (the reference's sum_i r_t[i] * (S + u k_t v_t^T)[i][j] with the u term
// factored out), and the final state is written out, so a decode step
// (T = 1) continues from the state a prefill left.  r, k, v are bf16 and w
// (the decay) f32, all read in the model's layout (B, T, H, dh) through
// their strides; u is (H, dh) f32; the output (B, T, H, dh) f32.
//
// What bounds it on an H100, at rwkv6-7b's prefill (B 4, T 1024, H 64,
// dh 64): bytes, 14 a head lane and step (r, k, v 2 each, w 4, o 4), 235 MB
// or 0.070 ms at 3.35 TB/s; and f32 operations, 5 a state element and step,
// 0.0814 ms at 67 TFLOP/s.  The recurrence is sequential in T, so time walks
// inside the CTA and the (b, h, state element) axes carry the parallelism.
// The design, all arithmetic in f32 on the CUDA cores:
// - One CTA per (b, h): (dh / TI) x (dh / TJ) threads, 128 at dh 64.  Each
//   thread keeps a TI x TJ tile of S (8 x 4 at dh 64) in registers for the
//   whole sequence.  A step costs 3 FP instructions a state element (k v, an
//   FMA into o, an FMA into S) against 7 16-byte shared loads a thread (its
//   8 rows of r, k, w; its 4 columns of v), each value used 4 or 8 times.
//   The next step's operands are loaded before this step stores its partial
//   sums: the compiler would not move a load past that store.
// - The sum over i for o: each thread adds its TI rows, and the NR row
//   tiles of a column are summed after the chunk, not every step.  A step
//   stores each thread's TJ partial sums (one 16-byte store) into a
//   (CT, NR, dh) buffer in shared memory; once the chunk is done, a pass
//   sums the NR partials of each (step, 4 columns), adds v_j * (r.u.k), and
//   writes o as coalesced 16-byte rows.  A per-step shuffle tree over the
//   row tiles would cost ~14 instructions a step (shuffles and selects)
//   against the store's one.
// - r.u.k, one dot product a step and (b, h), is taken once, in the pass
//   that unpacks the chunk's bf16 inputs to f32 (each value unpacked once
//   per CTA instead of once per reading thread).
// - An asynchronous input ring: the next chunks' r, k, v, w (CT steps each)
//   are in flight by 16-byte cp.async, two stages ahead, while the threads
//   step through the current one.  16-byte copies need 16-byte rows: the
//   wrapper refuses base pointers not aligned to 16 bytes and strides that
//   are not multiples of 8 (bf16) or 4 (f32) elements.  The ragged last
//   chunk copies and steps only its own steps: a T = 1 call moves one step.
// - Shared memory: ring 2 x CT x dh x 10 bytes, f32 inputs double-buffered
//   2 x 4 x CT x dh x 4, partials CT x NR x dh x 4: 86,144 bytes at dh 64,
//   so two CTAs fit on an SM and rwkv6-7b's 256 (b, h) run in one wave.
// Where it stands (PERF.md): about 3x its operation bound at the prefill
// shape.  Variants tried on the card put about a quarter of the time in the
// unpack and partial-sum passes, and the rest in a step loop that issues
// well under the f32 rate but is not bound by shared memory (3 loads a
// step in place of 7 barely sped it up).  8 x 8 tiles leave one warp a
// scheduler and ran slower; 4 x 4 tiles and 8-step chunks ran slower too.
// Fewer FP instructions a state element (folding several steps) is the
// next lever.
// Not the chunked tensor-core form: its intra-chunk products multiply r and
// k by f32 decay factors, so the operands are no longer bf16 (bf16 or TF32
// wgmma misses the 1e-3 the state is held to; 3xTF32 triples the work); and
// the model's decay exp(-exp(d)), d up to 3, is ~exp(-20) a step, so the
// cumulative decay of a 16-step chunk leaves f32's range without sub-chunks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CT = 16;                  // time steps per chunk (ring stage)
constexpr int NS = 2;                   // ring stages

template <int DH>
struct Tile {
  static constexpr int TI = DH == 64 ? 8 : 4;  // state rows per thread
  static constexpr int TJ = DH == 64 ? 4 : 2;  // state columns per thread
  static constexpr int NR = DH / TI;           // row tiles summed for o
  static constexpr int NT = NR * (DH / TJ);    // threads per CTA
  // shared memory, in bytes
  static constexpr int RING = NS * CT * DH * (3 * 2 + 4);
  static constexpr int WORK = 2 * 4 * CT * DH * 4;
  static constexpr int RUK = 2 * CT * 4;
  static constexpr int PART = CT * NR * DH * 4;
  static constexpr int SMEM = RING + WORK + RUK + PART;
  static_assert(CT * DH / 8 % 32 == 0, "whole warps unpack");
  static_assert(NT % 32 == 0, "whole warps");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// N (4 or 2) floats between registers and 16-byte (8-byte) aligned memory
template <int N>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (N == 4) {
    const float4 t = *reinterpret_cast<const float4*>(src);
    dst[0] = t.x; dst[1] = t.y; dst[2] = t.z; dst[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(src);
    dst[0] = t.x; dst[1] = t.y;
  }
}

template <int N>
__device__ __forceinline__ void store_vec(float* dst, const float* src) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(src[0], src[1], src[2],
                                                  src[3]);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(src[0], src[1]);
  }
}

// Per CTA: one (b, h).  Shared memory: the ring (per stage: r, k, v bf16
// and w f32, each (CT, DH)), the unpacked f32 inputs of two chunks (R, K,
// V, W each (CT, DH)), r.u.k of two chunks (CT), and the partial sums of o
// (CT, NR, DH).
template <int DH>
__global__ void __launch_bounds__(Tile<DH>::NT)
wkv6_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ sT, int T, int H,
            long long sb, long long st, long long sh, long long wsb,
            long long wst, long long wsh) {
  using G = Tile<DH>;
  constexpr int TI = G::TI, TJ = G::TJ, NR = G::NR, NT = G::NT;
  constexpr int CD = CT * DH;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ring = reinterpret_cast<bf16*>(smem);             // NS x 3 x CD
  float* ring_w = reinterpret_cast<float*>(smem + NS * CD * 3 * 2);
  float* work = reinterpret_cast<float*>(smem + G::RING);  // 2 x 4 x CD
  float* ruk = reinterpret_cast<float*>(smem + G::RING + G::WORK);
  float* part = reinterpret_cast<float*>(smem + G::RING + G::WORK + G::RUK);

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const bf16* rb = r + (size_t)b * sb + (size_t)h * sh;
  const bf16* kb = k + (size_t)b * sb + (size_t)h * sh;
  const bf16* vb = v + (size_t)b * sb + (size_t)h * sh;
  const float* wb = w + (size_t)b * wsb + (size_t)h * wsh;
  const int nchunks = (T + CT - 1) / CT;

  // ---- the ring: chunk c into stage c % NS, one commit group a chunk ----
  // bf16 rows: DH / 8 pieces of 16 bytes a step; w: DH / 4.  Steps past T
  // are not copied.
  auto issue = [&](int c) {
    if (c < nchunks) {
      const int t0 = c * CT, n = min(CT, T - t0), stg = c % NS;
#pragma unroll
      for (int p = tid; p < CD / 8; p += NT) {
        const int cc = p / (DH / 8), q = 8 * (p % (DH / 8));
        if (cc < n) {
          const size_t g = (size_t)(t0 + cc) * st + q;
          bf16* d = ring + (size_t)stg * 3 * CD + cc * DH + q;
          cp_async16(d, rb + g);
          cp_async16(d + CD, kb + g);
          cp_async16(d + 2 * CD, vb + g);
        }
      }
#pragma unroll
      for (int p = tid; p < CD / 4; p += NT) {
        const int cc = p / (DH / 4), q = 4 * (p % (DH / 4));
        if (cc < n)
          cp_async16(ring_w + (size_t)stg * CD + cc * DH + q,
                     wb + (size_t)(t0 + cc) * wst + q);
      }
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  // ---- the state tile: rows 4 (rt + NR g) + q, columns j0 .. j0 + TJ ----
  // Row tile rt is the same for DH / TJ neighbouring threads, so a warp's
  // r, k, w loads read 2 (dh 64) addresses and its v load, store of
  // partials and state rows are 16-byte runs across the columns.
  const int rt = tid / (DH / TJ);
  const int j0 = (tid % (DH / TJ)) * TJ;
  auto row = [&](int ii) { return 4 * (rt + NR * (ii / 4)) + ii % 4; };
  float s[TI][TJ];
  const float* s0p = s0 ? s0 + (size_t)bh * DH * DH : nullptr;
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) {
    if (s0p) {
      load_vec<TJ>(s[ii], s0p + row(ii) * DH + j0);
    } else {
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) s[ii][jj] = 0.f;
    }
  }
  // Unpack chunk c (stage c % NS) into work buffer c & 1; r.u.k per step.
  // A thread unpacks lanes 8 q .. 8 q + 7 of its steps; q is the same for
  // all of them (NT is a multiple of DH / 8), so u stays in registers.
  const int uq0 = 8 * (tid % (DH / 8));
  float uq[8];
#pragma unroll
  for (int m = 0; m < 8; ++m) uq[m] = u[(size_t)h * DH + uq0 + m];
  auto unpack = [&](int c) {
#pragma unroll
    for (int p = tid; p < CD / 8; p += NT) {
      const int cc = p / (DH / 8), e0 = cc * DH + uq0;
      const bf16* src = ring + (size_t)(c % NS) * 3 * CD + e0;
      const float* wsrc = ring_w + (size_t)(c % NS) * CD + e0;
      float* dst = work + (size_t)(c & 1) * 4 * CD + e0;
      float f[3][8];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src + a * CD);
        const bf16* hv = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int m = 0; m < 8; ++m) f[a][m] = __bfloat162float(hv[m]);
#pragma unroll
        for (int m = 0; m < 8; m += 4)
          store_vec<4>(dst + a * CD + m, f[a] + m);
      }
#pragma unroll
      for (int m = 0; m < 8; m += 4)
        *reinterpret_cast<float4*>(dst + 3 * CD + m) =
            *reinterpret_cast<const float4*>(wsrc + m);
      float d = 0.f;
#pragma unroll
      for (int m = 0; m < 8; ++m) d = fmaf(f[0][m] * uq[m], f[1][m], d);
#pragma unroll
      for (int o = DH / 16; o > 0; o >>= 1)
        d += __shfl_xor_sync(0xffffffffu, d, o);
      if (uq0 == 0) ruk[(c & 1) * CT + cc] = d;
    }
  };

  // A step's operands: this thread's TI rows of r, k, w and TJ columns of
  // v, loaded from the unpacked chunk wk before the previous step stores its
  // partial sums (the compiler may not move a load across a store to the
  // same shared memory), so their latency hides behind a step of math.
  struct Ops { float r[TI], k[TI], w[TI], v[TJ]; };
  auto load_ops = [&](const float* wk, int cc, Ops& o) {
#pragma unroll
    for (int g = 0; g < TI / 4; ++g) {
      const int i0 = cc * DH + 4 * (rt + NR * g);
      load_vec<4>(o.r + 4 * g, wk + i0);
      load_vec<4>(o.k + 4 * g, wk + CD + i0);
      load_vec<4>(o.w + 4 * g, wk + 3 * CD + i0);
    }
    load_vec<TJ>(o.v, wk + 2 * CD + cc * DH + j0);
  };
  // Step cc: partial o over this thread's rows, then the state update.
  auto step = [&](const Ops& o, int cc) {
    float acc[TJ];
#pragma unroll
    for (int jj = 0; jj < TJ; ++jj) acc[jj] = 0.f;
#pragma unroll
    for (int ii = 0; ii < TI; ++ii) {
#pragma unroll
      for (int jj = 0; jj < TJ; ++jj) {
        acc[jj] = fmaf(o.r[ii], s[ii][jj], acc[jj]);
        s[ii][jj] = fmaf(o.w[ii], s[ii][jj], o.k[ii] * o.v[jj]);
      }
    }
    store_vec<TJ>(part + (cc * NR + rt) * DH + j0, acc);
  };

  // Sum chunk c's partials over the row tiles, add v_j * r.u.k, write o.
  auto reduce = [&](int c) {
    const int t0 = c * CT, n = min(CT, T - t0);
    const float* wk = work + (size_t)(c & 1) * 4 * CD;
#pragma unroll
    for (int p = tid; p < CD / 4; p += NT) {
      const int cc = p / (DH / 4), j = 4 * (p % (DH / 4));
      if (cc >= n) continue;
      float o[4], x[4];
      load_vec<4>(x, wk + 2 * CD + cc * DH + j);
      const float q = ruk[(c & 1) * CT + cc];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) o[jj] = x[jj] * q;
#pragma unroll
      for (int g = 0; g < NR; ++g) {
        load_vec<4>(x, part + (cc * NR + g) * DH + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) o[jj] += x[jj];
      }
      store_vec<4>(out + (((size_t)b * T + t0 + cc) * H + h) * DH + j, o);
    }
  };

  for (int c = 0; c < nchunks; ++c) {
    const int n = min(CT, T - c * CT);
    cp_async_wait_one();             // chunk c has landed (c + 1 may fly)
    __syncthreads();                 // ... for every thread; chunk c - 1's
                                     // steps are done
    unpack(c);
    if (c > 0) reduce(c - 1);
    __syncthreads();                 // unpacked; c - 1's partials read
    issue(c + 2);                    // into the stage unpack(c) just read
    const float* wk = work + (size_t)(c & 1) * 4 * CD;
    Ops cur, nxt;
    load_ops(wk, 0, cur);
    if (n == CT) {
#pragma unroll
      for (int cc = 0; cc < CT; cc += 2) {
        load_ops(wk, cc + 1, nxt);
        step(cur, cc);
        if (cc + 2 < CT) load_ops(wk, cc + 2, cur);
        step(nxt, cc + 1);
      }
    } else {
      for (int cc = 0; cc < n; ++cc) {
        if (cc + 1 < n) load_ops(wk, cc + 1, nxt);
        step(cur, cc);
        cur = nxt;
      }
    }
  }
  __syncthreads();
  if (nchunks > 0) reduce(nchunks - 1);

  float* sTp = sT + (size_t)bh * DH * DH;
#pragma unroll
  for (int ii = 0; ii < TI; ++ii) store_vec<TJ>(sTp + row(ii) * DH + j0, s[ii]);
}

template <int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* sT, int B, int T,
           int H, long long sb, long long st, long long sh, long long wsb,
           long long wst, long long wsh, cudaStream_t stream) {
  using G = Tile<DH>;
  static bool ready = false;
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        G::SMEM);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  wkv6_kernel<DH><<<B * H, G::NT, G::SMEM, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), T, H, sb, st, sh,
      wsb, wst, wsh);
  return (int)cudaGetLastError();
}

template <int DH>
int ctas_per_sm() {
  int n = 0;
  if (cudaFuncSetAttribute(wkv6_kernel<DH>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           Tile<DH>::SMEM) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, wkv6_kernel<DH>, Tile<DH>::NT, Tile<DH>::SMEM) != cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// r, k, v share the strides (sb, st, sh) in elements, w has (wsb, wst,
// wsh); the last dim of each is contiguous, every pointer is 16-byte
// aligned and every stride a multiple of 16 bytes (the wrapper checks).
// s0 may be null (zero state).  Returns cudaGetLastError() after the launch
// (0 on success).
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0, void* out,
                    void* sT, int B, int T, int H, int DH, long long sb,
                    long long st, long long sh, long long wsb, long long wst,
                    long long wsh, void* stream) {
  if (B == 0 || H == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DH) {
    case 16:
      return launch<16>(r, k, v, w, u, s0, out, sT, B, T, H, sb, st, sh, wsb,
                        wst, wsh, s);
    case 64:
      return launch<64>(r, k, v, w, u, s0, out, sT, B, T, H, sb, st, sh, wsb,
                        wst, wsh, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of a CTA at head size DH (-1 for another size).
extern "C" int wkv6_smem_bytes(int DH) {
  return DH == 16 ? Tile<16>::SMEM : DH == 64 ? Tile<64>::SMEM : -1;
}

// CTAs of wkv6_kernel that fit on one SM of the current device at head
// size DH (the occupancy calculator's count); -1 on error.
extern "C" int wkv6_ctas_per_sm(int DH) {
  return DH == 16 ? ctas_per_sm<16>() : DH == 64 ? ctas_per_sm<64>() : -1;
}
