// Flash-attention prefill for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (repro_torch/kernels/flash_attention).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd, body _flash_kernel).  Same function: softmax
// attention with scale 1/sqrt(D); causal mask kpos <= qpos and sliding
// window qpos - kpos < window, both positions counted from 0; online softmax
// with an f32 running max, sum and accumulator; the probabilities rounded to
// bf16 before the P.V product, as the Pallas body does (p.astype(v.dtype)).
// Rows that see no key give 0.
//
// Layout: q (B, Sq, H, D), k/v (B, Sk, K, D), out (B, Sq, H, D), all bf16 and
// contiguous.  Query head h reads KV head h / (H / K) in place: GQA is never
// expanded in memory.  The ragged edge (S not a multiple of the tile) is
// masked here, and key tiles that no query row of the CTA can see (past the
// causal diagonal, or left of the sliding window) are skipped.
//
// What bounds it on an H100: at the main path's prefill (S = 1024, D = 128,
// G = 3 query heads per KV head) one head does 2*D*S*S causal FLOPs on about
// 0.7 MB, some 380 FLOPs a byte, above the card's ~295: tensor-core FLOPs
// bound it.  The simple design feeds the tensor cores through WMMA
// (mma.sync, 16x16x16 bf16 tiles, f32 accumulation) from shared memory.
// Each of the 4 warps owns 16 query rows of the CTA's 64, so the softmax of a
// row needs only warp shuffles and no block barrier.  There is no TMA, no
// wgmma and no pipelining: a key tile's loads do not overlap the math of the
// previous one, so the kernel runs well below the tensor-core peak.  That is
// the later work; this one is simple and right.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;                 // query rows per CTA, 16 per warp
constexpr int BK = 64;                 // keys per shared-memory tile
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr float NEG_INF = -1e30f;

// byte offsets into the dynamic shared memory; each a multiple of 256 bytes,
// so every WMMA tile pointer below is 32-byte aligned
template <int D>
struct Smem {
  static constexpr int q = 0;                    // bf16 [BQ][D]
  static constexpr int k = q + BQ * D * 2;       // bf16 [BK][D]
  static constexpr int v = k + BK * D * 2;       // bf16 [BK][D]
  static constexpr int s = v + BK * D * 2;       // f32  [BQ][BK] scores
  static constexpr int p = s + BQ * BK * 4;      // bf16 [BQ][BK] probabilities
  static constexpr int o = p + BQ * BK * 2;      // f32  [BQ][D] accumulator
  static constexpr int m = o + BQ * D * 4;       // f32  [BQ] running max
  static constexpr int l = m + BQ * 4;           // f32  [BQ] running sum
  static constexpr int bytes = l + BQ * 4;
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Copy ROWS rows of D bf16 (row r at src + (row0 + r) * stride) into a dense
// [ROWS][D] shared tile, 16 bytes per thread and step; rows >= n_valid are 0.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int row0, int n_valid,
                                          size_t stride) {
  constexpr int VPR = D / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_valid)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + c);
    *reinterpret_cast<uint4*>(dst + r * D + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     int Sq, int Sk, int H, int K, int causal, int window,
                     float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem + Smem<D>::q);
  bf16* Ks = reinterpret_cast<bf16*>(smem + Smem<D>::k);
  bf16* Vs = reinterpret_cast<bf16*>(smem + Smem<D>::v);
  float* S = reinterpret_cast<float*>(smem + Smem<D>::s);
  bf16* P = reinterpret_cast<bf16*>(smem + Smem<D>::p);
  float* O = reinterpret_cast<float*>(smem + Smem<D>::o);
  float* M = reinterpret_cast<float*>(smem + Smem<D>::m);
  float* L = reinterpret_cast<float*>(smem + Smem<D>::l);

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;   // longest rows first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;                           // this warp's rows

  const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
  const bf16* kb = k + ((size_t)b * Sk * K + kvh) * D;
  const bf16* vb = v + ((size_t)b * Sk * K + kvh) * D;

  load_rows<D, BQ>(Qs, qb, q0, min(BQ, Sq - q0), (size_t)H * D);
  for (int i = threadIdx.x; i < BQ * D; i += NTHREADS) O[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
    M[i] = NEG_INF;
    L[i] = 0.f;
  }

  // keys that some row q0 .. q0+BQ-1 can see
  int k_end = Sk;
  if (causal) k_end = min(Sk, q0 + BQ);
  int k_begin = window ? max(0, q0 - window + 1) : 0;
  k_begin = (k_begin / BK) * BK;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();               // the previous tile is consumed
    load_rows<D, BK>(Ks, kb, k0, min(BK, Sk - k0), (size_t)K * D);
    load_rows<D, BK>(Vs, vb, k0, min(BK, Sk - k0), (size_t)K * D);
    __syncthreads();

    // S[r0:r0+16, :] = Q K^T
#pragma unroll
    for (int j = 0; j < BK / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + r0 * D + kk * 16, D);
        wmma::load_matrix_sync(fb, Ks + j * 16 * D + kk * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(S + r0 * BK + j * 16, acc, BK,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax of the warp's 16 rows, two columns per lane
    for (int r = r0; r < r0 + 16; ++r) {
      const int qpos = q0 + r;
      float sc[2];
      bool ok[2];
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        const int kpos = k0 + col;
        bool valid = kpos < Sk;
        if (causal) valid = valid && kpos <= qpos;
        if (window) valid = valid && qpos - kpos < window;
        ok[c] = valid;
        sc[c] = valid ? S[r * BK + col] * scale : NEG_INF;
        mx = fmaxf(mx, sc[c]);
      }
      mx = warp_max(mx);
      const float m_prev = M[r];
      const float m_new = fmaxf(m_prev, mx);
      const float alpha = expf(fminf(m_prev - m_new, 0.f));
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float pv = ok[c] ? expf(sc[c] - m_new) : 0.f;
        P[r * BK + lane + 32 * c] = __float2bfloat16(pv);
        sum += pv;
      }
      sum = warp_sum(sum);
      for (int d = lane; d < D; d += 32) O[r * D + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        M[r] = m_new;
        L[r] = L[r] * alpha + sum;
      }
    }
    __syncwarp();

    // O[r0:r0+16, :] += P V
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, O + r0 * D + n * 16, D, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, P + r0 * BK + kk * 16, BK);
        wmma::load_matrix_sync(fb, Vs + kk * 16 * D + n * 16, D);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(O + r0 * D + n * 16, acc, D, wmma::mem_row_major);
    }
    __syncwarp();
  }
  __syncthreads();                 // the initial O, M, L when no tile ran

  for (int r = r0; r < r0 + 16; ++r) {
    const int qpos = q0 + r;
    if (qpos >= Sq) break;
    const float denom = fmaxf(L[r], 1e-30f);
    bf16* orow = o + (((size_t)b * Sq + qpos) * H + h) * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = __float2bfloat16(O[r * D + d] / denom);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int K, int causal, int window, float scale,
           cudaStream_t stream) {
  const int bytes = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + BQ - 1) / BQ);
  flash_prefill_kernel<D><<<grid, NTHREADS, bytes, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o), Sq, Sk, H, K,
      causal, window, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int K,
                             int D, int causal, int window, float scale,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return launch<16>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, s);
    case 64:
      return launch<64>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, s);
    case 128:
      return launch<128>(q, k, v, o, B, Sq, Sk, H, K, causal, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
