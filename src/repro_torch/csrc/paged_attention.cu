// Paged decode attention and the paged KV append for Hopper (sm_90a), with a
// plain C interface bound from Python through ctypes
// (repro_torch/kernels/paged_attention).
//
// paged_decode replaces the Pallas TPU kernel
// src/repro/kernels/paged_attention/kernel.py (paged_decode_attention, body
// _paged_kernel): one query token per batch row, attending through the row's
// block table over one layer's pool (num_blocks, block, K, D), positions
// idx < len, with the G = H / K query heads of a KV head sharing its keys;
// scale 1/sqrt(D), online softmax with an f32 running max, sum and
// accumulator, the probabilities rounded to bf16 before the P.V product as
// the Pallas body does.  It also takes the model path's sliding window
// (src/repro/models/layers.py decode_attention: pos - window < idx <= pos,
// that is len - window <= idx < len), which the Pallas kernel lacks.
//
// paged_append replaces the mode="drop" scatter of
// src/repro/kernels/paged_attention/ops.py::paged_decode_step and
// src/repro/models/layers.py::paged_kv_update: it writes each row's new K/V
// at (block_ids[b], offsets[b]) and skips, on the device and with no host
// sync, every row whose block id or offset is out of range (the engine's
// idle-row sentinel is num_blocks).
//
// What bounds them on an H100: bytes.  Decode reads every visible K/V row
// once and does 4*G*D FLOPs per K/V row of 4*D bytes, about G FLOPs a byte,
// far below the card's ~295; the append only moves bytes.  The simple decode
// design: one CTA per (batch row, KV head) walks the row's blocks straight
// from the block table, 64 tokens at a time, with 16-byte loads; the G query
// heads of the KV head share every K/V load.  Its limit is parallelism:
// B * K CTAs (32 at the main path's B = 4, K = 8) on 132 SMs cannot draw the
// card's full memory rate.  Splitting the KV range across CTAs
// (flash-decoding) is the later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;
constexpr int CH = 64;                 // tokens per chunk
constexpr float NEG_INF = -1e30f;

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

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
}

// D: head dim; MAXG: bound on the query heads per KV head (G <= MAXG).
// Thread t owns dims (t % TPG) * 8 .. +8 of token group t / TPG, in both the
// score pass and the P.V pass.
template <int D, int MAXG>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                    const bf16* __restrict__ v_pool,
                    const int* __restrict__ tables, const int* __restrict__ lens,
                    bf16* __restrict__ out, int H, int K, int num_blocks,
                    int block, int nb, int window, float scale) {
  constexpr int TPG = D / 8;               // threads per token row
  constexpr int TPP = NTHREADS / TPG;      // tokens per pass
  __shared__ float Ps[MAXG][CH];           // scores, then probabilities
  __shared__ int Row[CH];                  // pool row of each chunk token, -1 if none
  __shared__ float Ms[MAXG], Ls[MAXG], As[MAXG];
  __shared__ float Part[TPP][MAXG][D];     // per-group partial outputs

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = tid / TPG, dc = (tid % TPG) * 8;
  const int len = min(lens[b], nb * block);
  const int lo = window ? max(0, len - window) : 0;
  const int* tbl = tables + (size_t)b * nb;

  float qr[MAXG][8];
  float acc[MAXG][8];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
#pragma unroll
    for (int i = 0; i < 8; ++i) qr[g][i] = acc[g][i] = 0.f;
    if (g < G)
      unpack8(*reinterpret_cast<const uint4*>(
                  q + ((size_t)b * H + kvh * G + g) * D + dc), qr[g]);
  }
  if (tid < MAXG) {
    Ms[tid] = NEG_INF;
    Ls[tid] = 0.f;
  }

  for (int t0 = lo; t0 < len; t0 += CH) {
    // scores of tokens t0 .. t0+CH-1
#pragma unroll
    for (int pass = 0; pass < CH / TPP; ++pass) {
      const int c = pass * TPP + grp;
      const int t = t0 + c;
      int row = -1;
      if (t < len) {
        const int phys = tbl[t / block];
        if (phys >= 0 && phys < num_blocks) row = phys * block + t % block;
      }
      float part[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) part[g] = 0.f;
      if (row >= 0) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(
                    k_pool + ((size_t)row * K + kvh) * D + dc), kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
#pragma unroll
          for (int i = 0; i < 8; ++i) part[g] += qr[g][i] * kf[i];
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int off = TPG / 2; off > 0; off >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], off);
      if (tid % TPG == 0) {
        Row[c] = row;
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) Ps[g][c] = row >= 0 ? part[g] * scale : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, one warp per query head, two tokens per lane
    for (int g = warp; g < G; g += NTHREADS / 32) {
      const float s0 = Ps[g][lane], s1 = Ps[g][lane + 32];
      const bool ok0 = Row[lane] >= 0, ok1 = Row[lane + 32] >= 0;
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float alpha = expf(fminf(m_prev - m_new, 0.f));
      const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
      const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
      const float sum = warp_sum(p0 + p1);
      Ps[g][lane] = __bfloat162float(__float2bfloat16(p0));
      Ps[g][lane + 32] = __bfloat162float(__float2bfloat16(p1));
      __syncwarp();
      if (lane == 0) {
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + sum;
        As[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over this chunk
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float a = As[g];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] *= a;
      }
    }
    for (int c = grp; c < CH; c += TPP) {
      const int row = Row[c];
      if (row < 0) continue;
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(
                  v_pool + ((size_t)row * K + kvh) * D + dc), vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float pg = Ps[g][c];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] += pg * vf[i];
        }
      }
    }
    __syncthreads();               // before the next chunk rewrites Ps, Row
  }

#pragma unroll
  for (int g = 0; g < MAXG; ++g)
    if (g < G)
#pragma unroll
      for (int i = 0; i < 8; ++i) Part[grp][g][dc + i] = acc[g][i];
  __syncthreads();
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float s = 0.f;
    for (int p = 0; p < TPP; ++p) s += Part[p][g][d];
    out[((size_t)b * H + kvh * G + g) * D + d] =
        __float2bfloat16(s / fmaxf(Ls[g], 1e-30f));
  }
}

// One CTA per batch row; KD = K * D elements of K and of V per row.
__global__ void paged_append_kernel(const bf16* __restrict__ k_new,
                                    const bf16* __restrict__ v_new,
                                    bf16* __restrict__ k_pool,
                                    bf16* __restrict__ v_pool,
                                    const int* __restrict__ block_ids,
                                    const int* __restrict__ offsets, int KD,
                                    int num_blocks, int block) {
  const int b = blockIdx.x;
  const int bid = block_ids[b], off = offsets[b];
  if (bid < 0 || bid >= num_blocks || off < 0 || off >= block) return;
  const size_t dst = ((size_t)bid * block + off) * KD;
  const size_t src = (size_t)b * KD;
  for (int i = threadIdx.x * 8; i < KD; i += blockDim.x * 8) {
    *reinterpret_cast<uint4*>(k_pool + dst + i) =
        *reinterpret_cast<const uint4*>(k_new + src + i);
    *reinterpret_cast<uint4*>(v_pool + dst + i) =
        *reinterpret_cast<const uint4*>(v_new + src + i);
  }
}

template <int D, int MAXG>
int launch_decode(const void* q, const void* k_pool, const void* v_pool,
                  const void* tables, const void* lens, void* out, int B,
                  int H, int K, int num_blocks, int block, int nb, int window,
                  float scale, cudaStream_t stream) {
  dim3 grid(B, K);
  paged_decode_kernel<D, MAXG><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<bf16*>(out), H, K,
      num_blocks, block, nb, window, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_groups(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* lens, void* out, int B,
                    int H, int K, int num_blocks, int block, int nb,
                    int window, float scale, cudaStream_t stream) {
  const int G = H / K;
  if (G <= 4)
    return launch_decode<D, 4>(q, k_pool, v_pool, tables, lens, out, B, H, K,
                               num_blocks, block, nb, window, scale, stream);
  if (G <= 8)
    return launch_decode<D, 8>(q, k_pool, v_pool, tables, lens, out, B, H, K,
                               num_blocks, block, nb, window, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success).
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lens, void* out, int B, int H, int K,
                            int D, int num_blocks, int block, int nb,
                            int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return dispatch_groups<16>(q, k_pool, v_pool, tables, lens, out, B, H, K,
                                 num_blocks, block, nb, window, scale, s);
    case 64:
      return dispatch_groups<64>(q, k_pool, v_pool, tables, lens, out, B, H, K,
                                 num_blocks, block, nb, window, scale, s);
    case 128:
      return dispatch_groups<128>(q, k_pool, v_pool, tables, lens, out, B, H,
                                  K, num_blocks, block, nb, window, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int paged_append(const void* k_new, const void* v_new,
                            void* k_pool, void* v_pool, const void* block_ids,
                            const void* offsets, int B, int K, int D,
                            int num_blocks, int block, void* stream) {
  if (B == 0) return 0;
  paged_append_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(k_new), static_cast<const bf16*>(v_new),
      static_cast<bf16*>(k_pool), static_cast<bf16*>(v_pool),
      static_cast<const int*>(block_ids), static_cast<const int*>(offsets),
      K * D, num_blocks, block);
  return (int)cudaGetLastError();
}
