// Mamba's selective-SSM scan for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (repro_torch/kernels/mamba_scan).
//
// mamba_scan replaces the Pallas TPU kernel
// src/repro/kernels/mamba_scan/kernel.py (mamba_scan_btd, body
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
// model's x_proj output); A (di, ds) and D (di,) are f32; y is (B, T, di)
// f32.  dt * x is formed in f32, as the Pallas kernel forms it and as the
// reference's model scans compute it when run (their bf16 product feeds an
// f32 cast, and XLA keeps the excess precision).  round_y rounds
// h . C to bf16 before D * x is added, as _ssm_scan does
// (src/repro/models/mamba.py:42); the decode branch and the Pallas kernel do
// not round.
//
// What bounds it on an H100: bytes, if the time loop could be spread.  Per
// (b, t, c) it reads x and dt (2 bytes each) and writes y (4), and does
// about 4 ds flops plus ds exponentials; at ds = 16 that is ~10 flops a
// byte, under the ~20 of the card's f32 CUDA cores.  The design:
// - one thread per (b, channel) holds h[ds] and A[c][:] in registers for the
//   whole sequence (the Pallas kernel keeps a (bd, ds) state tile in VMEM
//   across a sequential chunk axis of its grid; Hopper CTAs run in no
//   order, so the time loop moves inside the CTA and any T works);
// - CT steps of B_t and C_t, which all channels of a row share, are staged
//   in shared memory once per CTA, and CT steps of x and dt with coalesced
//   loads (neighbouring threads, neighbouring channels);
// - the ds state updates of a step are independent, which gives the
//   instruction-level parallelism; y's sum over s is one short chain.
// Its limit is the exposed latency of the time loop: at jamba's di = 8192
// and B = 2 the grid is 256 CTAs of 2 warps.  Splitting the sequence into
// chunks scanned in parallel (a two-pass associative scan) is the later
// work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NC = 64;                  // channels (threads) per CTA
constexpr int CT = 32;                  // time steps staged per chunk

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

template <int DS>
__global__ void __launch_bounds__(NC)
mamba_scan_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dt,
                  const bf16* __restrict__ Bc, const bf16* __restrict__ Cc,
                  const float* __restrict__ A, const float* __restrict__ D,
                  const float* __restrict__ h0, float* __restrict__ y,
                  float* __restrict__ hT, int T, int di, int round_y,
                  long long xsb, long long xst, long long dsb, long long dst,
                  long long bsb, long long bst, long long csb,
                  long long cst) {
  __shared__ float Bs[CT][DS], Cs[CT][DS];
  __shared__ float Xs[CT][NC], DTs[CT][NC];

  const int b = blockIdx.y, tid = threadIdx.x;
  const int c = blockIdx.x * NC + tid;
  const bool ok = c < di;

  float h[DS], a[DS];
  float Dc = 0.f;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    h[s] = (ok && h0) ? h0[((size_t)b * di + c) * DS + s] : 0.f;
    a[s] = ok ? A[(size_t)c * DS + s] : 0.f;
  }
  if (ok) Dc = D[c];

  const bf16* xb = x + (size_t)b * xsb;
  const bf16* db = dt + (size_t)b * dsb;
  const bf16* bb = Bc + (size_t)b * bsb;
  const bf16* cb = Cc + (size_t)b * csb;

  for (int t0 = 0; t0 < T; t0 += CT) {
    const int n = min(CT, T - t0);
    __syncthreads();                 // the previous chunk is consumed
    for (int i = tid; i < n * DS; i += NC) {
      const int cc = i / DS, s = i % DS;
      Bs[cc][s] = __bfloat162float(bb[(size_t)(t0 + cc) * bst + s]);
      Cs[cc][s] = __bfloat162float(cb[(size_t)(t0 + cc) * cst + s]);
    }
#pragma unroll 8
    for (int cc = 0; cc < n; ++cc) {
      Xs[cc][tid] = ok ? __bfloat162float(xb[(size_t)(t0 + cc) * xst + c])
                       : 0.f;
      DTs[cc][tid] = ok ? __bfloat162float(db[(size_t)(t0 + cc) * dst + c])
                        : 0.f;
    }
    __syncthreads();
    if (!ok) continue;
    for (int cc = 0; cc < n; ++cc) {
      const float xt = Xs[cc][tid], dtt = DTs[cc][tid];
      const float dbx = dtt * xt;
      float yv = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        h[s] = expf(dtt * a[s]) * h[s] + dbx * Bs[cc][s];
        yv += h[s] * Cs[cc][s];
      }
      if (round_y) yv = round_bf16(yv);
      y[((size_t)b * T + t0 + cc) * di + c] = yv + xt * Dc;
    }
  }
  if (ok) {
#pragma unroll
    for (int s = 0; s < DS; ++s) hT[((size_t)b * di + c) * DS + s] = h[s];
  }
}

template <int DS>
int launch(const void* x, const void* dt, const void* Bc, const void* Cc,
           const void* A, const void* D, const void* h0, void* y, void* hT,
           int B, int T, int di, int round_y, long long xsb, long long xst,
           long long dsb, long long dst, long long bsb, long long bst,
           long long csb, long long cst, cudaStream_t stream) {
  dim3 grid((di + NC - 1) / NC, B);
  mamba_scan_kernel<DS><<<grid, NC, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dt),
      static_cast<const bf16*>(Bc), static_cast<const bf16*>(Cc),
      static_cast<const float*>(A), static_cast<const float*>(D),
      static_cast<const float*>(h0), static_cast<float*>(y),
      static_cast<float*>(hT), T, di, round_y, xsb, xst, dsb, dst, bsb, bst,
      csb, cst);
  return (int)cudaGetLastError();
}

}  // namespace

// Strides are in elements, (batch, time) for each of x, dt, Bc, Cc; the
// last dim of each is contiguous.  h0 may be null (zero state).  Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int mamba_scan(const void* x, const void* dt, const void* Bc,
                          const void* Cc, const void* A, const void* D,
                          const void* h0, void* y, void* hT, int B, int T,
                          int di, int DS, int round_y, long long xsb,
                          long long xst, long long dsb, long long dst,
                          long long bsb, long long bst, long long csb,
                          long long cst, void* stream) {
  if (B == 0 || di == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (DS) {
    case 8:
      return launch<8>(x, dt, Bc, Cc, A, D, h0, y, hT, B, T, di, round_y, xsb,
                       xst, dsb, dst, bsb, bst, csb, cst, s);
    case 16:
      return launch<16>(x, dt, Bc, Cc, A, D, h0, y, hT, B, T, di, round_y,
                        xsb, xst, dsb, dst, bsb, bst, csb, cst, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
