// The WKV6 recurrence (RWKV-6 "Finch" time mix) for Hopper (sm_90a), with a
// plain C interface bound from Python through ctypes
// (repro_torch/kernels/rwkv6).
//
// wkv6 replaces the Pallas TPU kernel src/repro/kernels/rwkv6/kernel.py
// (wkv6_bht, body _wkv6_kernel) and the model's scan
// src/repro/models/rwkv.py::_wkv6_scan.  Per (batch row b, head h), with a
// (dh, dh) f32 state S that starts from state0 (zeros when none is given):
//
//   o_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// and the final state is written out, so a decode step (T = 1) continues
// from the state a prefill left.  r, k, v are bf16 and w (the decay) f32,
// all read in the model's layout (B, T, H, dh) through their strides, with
// no fold/transpose copies; u is (H, dh) f32; the output (B, T, H, dh) f32.
//
// What bounds it on an H100: bytes, if the time loop could be spread.  Per
// element of (B, T, H, dh) the kernel reads r, k, v (2 bytes each) and w
// (4) and writes o (4), and does 6 dh flops; at dh = 64 that is about 27
// flops a byte against the card's ~295 for bf16 tensor cores (or ~20 for
// f32 CUDA cores, which is what a recurrence of rank-1 updates runs on).
// The recurrence is sequential in T, so the design gives parallelism to the
// (b, h, column) axes and walks T inside the CTA:
// - one CTA per (b, h), dh threads; thread j keeps column S[:, j] in
//   registers for the whole sequence, so the state never touches memory
//   between steps (the Pallas kernel keeps it in VMEM scratch across the
//   chunk axis of its grid; Hopper CTAs run in no order, so the time loop
//   moves inside the CTA and any T works: no T % chunk requirement);
// - CT steps of r, k, w, v at a time are staged in shared memory with
//   coalesced loads (neighbouring threads read neighbouring j), so each step
//   reads r_t[i], k_t[i], w_t[i] and u[i] as shared-memory broadcasts;
// - four partial sums break the dependency chain of the dot product over i.
// Its limit is occupancy: B * H CTAs of dh threads (256 CTAs of 2 warps at
// rwkv6-7b's B = 4, H = 64) leave most warp slots empty, so the step
// latency is exposed.  Splitting the state's rows across warps, or a
// chunked (matrix-product) form of the recurrence, is the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int CT = 32;                  // time steps staged per chunk

template <int DH>
__global__ void __launch_bounds__(DH)
wkv6_kernel(const bf16* __restrict__ r, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ s0,
            float* __restrict__ out, float* __restrict__ sT, int T, int H,
            long long sb, long long st, long long sh, long long wsb,
            long long wst, long long wsh) {
  __shared__ float Rs[CT][DH], Ks[CT][DH], Vs[CT][DH], Ws[CT][DH];
  __shared__ float Us[DH];

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int j = threadIdx.x;
  const size_t base = (size_t)b * sb + (size_t)h * sh;
  const size_t wbase = (size_t)b * wsb + (size_t)h * wsh;

  float s[DH];
  const float* s0p = s0 ? s0 + (size_t)bh * DH * DH : nullptr;
#pragma unroll
  for (int i = 0; i < DH; ++i) s[i] = s0p ? s0p[i * DH + j] : 0.f;
  Us[j] = u[h * DH + j];

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int n = min(CT, T - t0);
    __syncthreads();                 // the previous chunk is consumed
#pragma unroll 8
    for (int c = 0; c < n; ++c) {
      const size_t off = base + (size_t)(t0 + c) * st + j;
      Rs[c][j] = __bfloat162float(r[off]);
      Ks[c][j] = __bfloat162float(k[off]);
      Vs[c][j] = __bfloat162float(v[off]);
      Ws[c][j] = w[wbase + (size_t)(t0 + c) * wst + j];
    }
    __syncthreads();
    for (int c = 0; c < n; ++c) {
      const float vj = Vs[c][j];
      float o[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < DH; ++i) {
        const float kv = Ks[c][i] * vj;
        o[i % 4] += Rs[c][i] * (s[i] + Us[i] * kv);
        s[i] = Ws[c][i] * s[i] + kv;
      }
      out[(((size_t)b * T + t0 + c) * H + h) * DH + j] =
          (o[0] + o[1]) + (o[2] + o[3]);
    }
  }
  float* sTp = sT + (size_t)bh * DH * DH;
#pragma unroll
  for (int i = 0; i < DH; ++i) sTp[i * DH + j] = s[i];
}

template <int DH>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* out, void* sT, int B, int T,
           int H, long long sb, long long st, long long sh, long long wsb,
           long long wst, long long wsh, cudaStream_t stream) {
  wkv6_kernel<DH><<<B * H, DH, 0, stream>>>(
      static_cast<const bf16*>(r), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(out), static_cast<float*>(sT), T, H, sb, st, sh,
      wsb, wst, wsh);
  return (int)cudaGetLastError();
}

}  // namespace

// r, k, v share the strides (sb, st, sh) in elements, w has (wsb, wst,
// wsh); the last dim of each is contiguous.  s0 may be null (zero state).
// Returns cudaGetLastError() after the launch (0 on success).
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
