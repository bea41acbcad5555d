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
// that is len - window <= idx < len), which the Pallas kernel lacks.  A row
// with no visible position (len <= 0) gives 0, as the Pallas body does.
//
// paged_append replaces the mode="drop" scatter of
// src/repro/kernels/paged_attention/ops.py::paged_decode_step and
// src/repro/models/layers.py::paged_kv_update: it writes each row's new K/V
// at (block_ids[b], offsets[b]) and skips, on the device and with no host
// sync, every row whose block id or offset is out of range (the engine's
// idle-row sentinel is num_blocks).
//
// What bounds them on an H100: bytes.  Decode reads every visible K/V row
// once and does 4 * G * D FLOPs per K/V row of 4 * D bytes, about G FLOPs a
// byte, far below the card's ~295; the append only moves bytes.  To draw the
// card's memory rate, decode needs many CTAs with many bytes in flight, but
// the served path has one live row (B * K = 32 (row, kv head) pairs, 8 of
// them live) and jamba's has B = 2.  So decode splits each row's positions
// across CTAs (flash-decoding):
// - The grid is (splits, K, B).  CTA s takes positions [s * span,
//   (s + 1) * span) of its row, clipped to the row's window, and walks the
//   block table for them, so a span can start and end inside a block (the
//   contiguous cache is one block of max_len tokens).  CTAs whose span lies
//   wholly outside [max(0, len - window), len) exit at once.  The wrapper
//   sizes span and splits from the table's capacity nb * block and from
//   B * K alone (kernels/paged_attention/ops.py split_schedule), never from
//   lens, so it needs no host sync.
// - Inside a CTA, chunks of CH tokens go into shared memory by cp.async,
//   16 bytes per thread, double-buffered: chunk c + 1's loads fly while
//   chunk c's scores, softmax and P.V run.  The G query heads share every
//   K/V load.
// - Each split writes its f32 partial (m, l, acc[G][D], with p rounded to
//   bf16 relative to the split's own running max) to scratch the wrapper
//   allocates.  The last CTA of a (row, kv head) to finish, found by
//   __threadfence and an atomic ticket in a per-device int32 buffer, rescales
//   each partial by exp(m_split - m) in f32, sums, divides and writes the
//   bf16 output, then resets the ticket to 0.  No second launch.  A row whose
//   window fits one span skips the scratch and writes directly.  The rounding
//   is the Pallas body's, relative to another running max, so the result
//   agrees with it within the bf16 tolerance 2e-2 (tests/test_kernels.py:38).
//   The tickets assume the calls on one device run in stream order.
//
// Left for later: TMA does not suit a gather through a block table; FP8 K/V,
// and a persistent grid or CUDA graph over the decode layer loop, whose
// launches (host-bound at these sizes) cost more than this kernel.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int NTHREADS = 128;
constexpr int NWARPS = NTHREADS / 32;
constexpr int CH = 32;                 // tokens per ring chunk (ops.CHUNK)
constexpr int STAGES = 2;              // ring depth: double-buffered
constexpr int MAX_SPLITS = 64;         // ops.MAX_SPLITS

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

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// D: head dim; MAXG: bound on the query heads per KV head (G <= MAXG).
// Thread t owns dims (t % TPG) * 8 .. +8 of token group t / TPG, in both the
// score pass and the P.V pass.
template <int D, int MAXG>
__global__ void __launch_bounds__(NTHREADS)
paged_decode_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                    const bf16* __restrict__ v_pool,
                    const int* __restrict__ tables,
                    const int* __restrict__ lens,
                    bf16* __restrict__ out, float* __restrict__ part,
                    int* __restrict__ tickets, int H, int K, int num_blocks,
                    int block, int nb, int window, int span, int splits,
                    float scale) {
  constexpr int TPG = D / 8;               // threads per token row
  constexpr int TPP = NTHREADS / TPG;      // tokens per pass
  constexpr int TILE = CH * D;             // elements of one K or V chunk
  constexpr int RING = STAGES * 2 * TILE * 2;   // bytes of K and V chunks
  constexpr int PART = NWARPS * MAXG * D * 4;
  // the ring, and after the last chunk each warp's partial output
  __shared__ __align__(16) unsigned char ring[RING > PART ? RING : PART];
  __shared__ float Ps[MAXG][CH];           // scores, then probabilities
  __shared__ int Ok[STAGES][CH];           // chunk token has a pool row
  __shared__ float Ms[MAXG], Ls[MAXG], As[MAXG];
  __shared__ float Mj[MAX_SPLITS][MAXG];   // the combine: each split's m,
  __shared__ float Lj[MAX_SPLITS][MAXG];   // then its weight; its l
  __shared__ int is_last;

  const int s = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = H / K;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int grp = tid / TPG, dc = (tid % TPG) * 8;
  const int len = min(lens[b], nb * block);
  const int lo = window ? max(0, len - window) : 0;
  bf16* orow = out + ((size_t)b * H + kvh * G) * D;   // G heads of D
  if (len <= 0) {
    if (s == 0)
      for (int i = tid; i < G * D; i += NTHREADS)
        orow[i] = __float2bfloat16(0.f);
    return;
  }
  const int first = lo / span, last = (len - 1) / span;
  if (s < first || s > last) return;       // nothing visible in this span
  const int n_act = last - first + 1;
  const int t_begin = max(s * span, lo), t_end = min((s + 1) * span, len);
  const int n_chunks = (t_end - t_begin + CH - 1) / CH;
  const int* tbl = tables + (size_t)b * nb;
  bf16* Kr = reinterpret_cast<bf16*>(ring);           // [STAGES][CH][D]
  bf16* Vr = Kr + STAGES * TILE;                      // [STAGES][CH][D]

  // chunk c of the span into ring stage st; tokens past the span or with a
  // block id out of range are zero-filled and flagged
  // (all the table reads go out before the first copy)
  constexpr int PIECES = (CH * D / 8 + NTHREADS - 1) / NTHREADS;
  auto load_chunk = [&](int c, int st) {
    const int t0 = t_begin + c * CH;
    int rows[PIECES];
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int p = tid + i * NTHREADS;
      const int t = t0 + p / (D / 8);
      rows[i] = -1;
      if (p < CH * D / 8 && t < t_end) {
        const int phys = tbl[t / block];
        if (phys >= 0 && phys < num_blocks) rows[i] = phys * block + t % block;
      }
    }
#pragma unroll
    for (int i = 0; i < PIECES; ++i) {
      const int p = tid + i * NTHREADS;
      if (p >= CH * D / 8) break;
      const int tok = p / (D / 8), col = (p % (D / 8)) * 8;
      const int row = rows[i];
      const size_t off = row >= 0 ? ((size_t)row * K + kvh) * D + col : 0;
      cp_async16(Kr + st * TILE + tok * D + col, k_pool + off, row >= 0);
      cp_async16(Vr + st * TILE + tok * D + col, v_pool + off, row >= 0);
      if (col == 0) Ok[st][tok] = row >= 0;
    }
    cp_async_commit();
  };
  load_chunk(0, 0);

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
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
  }

  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % STAGES;
    cp_async_wait_all();           // this thread's copies of chunk c
    __syncthreads();               // everyone's; chunk c - 1 is consumed
    if (c + 1 < n_chunks) load_chunk(c + 1, (c + 1) % STAGES);
    const bf16* Kc = Kr + st * TILE;
    const bf16* Vc = Vr + st * TILE;

    // scores of the chunk's tokens
#pragma unroll
    for (int pass = 0; pass < (CH + TPP - 1) / TPP; ++pass) {
      const int tok = pass * TPP + grp;
      float sc[MAXG];
#pragma unroll
      for (int g = 0; g < MAXG; ++g) sc[g] = 0.f;
      if (tok < CH) {
        float kf[8];
        unpack8(*reinterpret_cast<const uint4*>(Kc + tok * D + dc), kf);
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
#pragma unroll
          for (int i = 0; i < 8; ++i) sc[g] += qr[g][i] * kf[i];
      }
#pragma unroll
      for (int g = 0; g < MAXG; ++g)
#pragma unroll
        for (int off = TPG / 2; off > 0; off >>= 1)
          sc[g] += __shfl_xor_sync(0xffffffffu, sc[g], off);
      if (tid % TPG == 0 && tok < CH) {
#pragma unroll
        for (int g = 0; g < MAXG; ++g)
          if (g < G) Ps[g][tok] = Ok[st][tok] ? sc[g] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax, one warp per query head, one token per lane
    for (int g = warp; g < G; g += NWARPS) {
      const float x = Ps[g][lane];
      const float m_prev = Ms[g];
      const float m_new = fmaxf(m_prev, warp_max(x));
      const float mu = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = expf(m_prev - mu);
      const float p = expf(x - mu);            // 0 where masked
      const float sum = warp_sum(p);
      Ps[g][lane] = __bfloat162float(__float2bfloat16(p));
      __syncwarp();
      if (lane == 0) {
        Ms[g] = m_new;
        Ls[g] = Ls[g] * alpha + sum;
        As[g] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V over the chunk
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g < G) {
        const float a = As[g];
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[g][i] *= a;
      }
    }
#pragma unroll
    for (int i = 0; i < (CH + TPP - 1) / TPP; ++i) {
      const int tok = grp + i * TPP;
      if (tok >= CH) break;
      float vf[8];
      unpack8(*reinterpret_cast<const uint4*>(Vc + tok * D + dc), vf);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g < G) {
          const float pg = Ps[g][tok];
#pragma unroll
          for (int i = 0; i < 8; ++i) acc[g][i] += pg * vf[i];
        }
      }
    }
  }

  // sum acc over the token groups: the lanes of a warp, then the warps
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int off = TPG; off < 32; off <<= 1)
        acc[g][i] += __shfl_xor_sync(0xffffffffu, acc[g][i], off);
  __syncthreads();                 // the ring is free
  float* Part = reinterpret_cast<float*>(ring);       // [NWARPS][MAXG][D]
  if (lane < TPG) {
#pragma unroll
    for (int g = 0; g < MAXG; ++g)
      if (g < G)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          Part[(warp * MAXG + g) * D + dc + i] = acc[g][i];
  }
  __syncthreads();

  if (n_act == 1) {                // the whole window in this span
    for (int i = tid; i < G * D; i += NTHREADS) {
      const int g = i / D, d = i % D;
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < NWARPS; ++w) v += Part[(w * MAXG + g) * D + d];
      orow[i] = __float2bfloat16(v / fmaxf(Ls[g], 1e-30f));
    }
    return;
  }

  // partial of split s: acc [G][D], then (m, l) per head
  const int pair = b * K + kvh;
  const size_t stride = (size_t)G * (D + 2);
  float* mine = part + ((size_t)pair * splits + s) * stride;
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D, d = i % D;
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < NWARPS; ++w) v += Part[(w * MAXG + g) * D + d];
    mine[i] = v;
  }
  if (tid < G) {
    mine[G * D + 2 * tid] = Ms[tid];
    mine[G * D + 2 * tid + 1] = Ls[tid];
  }
  __threadfence();                 // the partial is visible device-wide
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(tickets + pair, 1) == n_act - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();

  // the last split of (b, kvh): every split's (m, l) at once, the weights
  // exp(m_s - m) / l, then the weighted sum
  const float* p0 = part + ((size_t)pair * splits + first) * stride;
  for (int t = tid; t < n_act * G; t += NTHREADS) {
    const int j = t / G, g = t % G;
    Mj[j][g] = __ldcg(p0 + j * stride + G * D + 2 * g);
    Lj[j][g] = __ldcg(p0 + j * stride + G * D + 2 * g + 1);
  }
  __syncthreads();
  if (tid < G) {
    float m = -INFINITY;
    for (int j = 0; j < n_act; ++j) m = fmaxf(m, Mj[j][tid]);
    float l = 0.f;
    for (int j = 0; j < n_act; ++j) {
      const float w = m == -INFINITY ? 0.f : expf(Mj[j][tid] - m);
      Mj[j][tid] = w;
      l += w * Lj[j][tid];
    }
    const float inv = 1.f / fmaxf(l, 1e-30f);
    for (int j = 0; j < n_act; ++j) Mj[j][tid] *= inv;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += NTHREADS) {
    const int g = i / D;
    float v = 0.f;
#pragma unroll 8
    for (int j = 0; j < n_act; ++j) v += Mj[j][g] * __ldcg(p0 + j * stride + i);
    orow[i] = __float2bfloat16(v);
  }
  if (tid == 0) tickets[pair] = 0;          // ready for the next call
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
                  const void* tables, const void* lens, void* out, void* part,
                  void* tickets, int B, int H, int K, int num_blocks,
                  int block, int nb, int window, int span, int splits,
                  float scale, cudaStream_t stream) {
  dim3 grid(splits, K, B);
  paged_decode_kernel<D, MAXG><<<grid, NTHREADS, 0, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<const int*>(tables),
      static_cast<const int*>(lens), static_cast<bf16*>(out),
      static_cast<float*>(part), static_cast<int*>(tickets), H, K,
      num_blocks, block, nb, window, span, splits, scale);
  return (int)cudaGetLastError();
}

template <int D>
int dispatch_groups(const void* q, const void* k_pool, const void* v_pool,
                    const void* tables, const void* lens, void* out,
                    void* part, void* tickets, int B, int H, int K,
                    int num_blocks, int block, int nb, int window, int span,
                    int splits, float scale, cudaStream_t stream) {
  const int G = H / K;
  if (G <= 4)
    return launch_decode<D, 4>(q, k_pool, v_pool, tables, lens, out, part,
                               tickets, B, H, K, num_blocks, block, nb,
                               window, span, splits, scale, stream);
  if (G <= 8)
    return launch_decode<D, 8>(q, k_pool, v_pool, tables, lens, out, part,
                               tickets, B, H, K, num_blocks, block, nb,
                               window, span, splits, scale, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Both return cudaGetLastError() after the launch (0 on success).
// paged_decode: part holds B * K * splits * G * (D + 2) floats of scratch;
// tickets B * K int32 that are 0 (each call leaves them 0); span a positive
// multiple of CH and splits <= MAX_SPLITS with span * splits >= nb * block.
extern "C" int paged_decode(const void* q, const void* k_pool,
                            const void* v_pool, const void* tables,
                            const void* lens, void* out, void* part,
                            void* tickets, int B, int H, int K, int D,
                            int num_blocks, int block, int nb, int window,
                            int span, int splits, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) return 0;
  if (span <= 0 || span % CH || splits <= 0 || splits > MAX_SPLITS
      || (long long)span * splits < (long long)nb * block)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16:
      return dispatch_groups<16>(q, k_pool, v_pool, tables, lens, out, part,
                                 tickets, B, H, K, num_blocks, block, nb,
                                 window, span, splits, scale, s);
    case 64:
      return dispatch_groups<64>(q, k_pool, v_pool, tables, lens, out, part,
                                 tickets, B, H, K, num_blocks, block, nb,
                                 window, span, splits, scale, s);
    case 128:
      return dispatch_groups<128>(q, k_pool, v_pool, tables, lens, out, part,
                                  tickets, B, H, K, num_blocks, block, nb,
                                  window, span, splits, scale, s);
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

namespace {
// An empty kernel launched with paged_append's shape (B CTAs of 128
// threads): chip_smoke.py times it as the least device time that a
// separate launch takes, the floor under paged_append's own time.
__global__ void launch_floor_kernel() {}
}  // namespace

extern "C" int launch_floor(int B, void* stream) {
  if (B == 0) return 0;
  launch_floor_kernel<<<B, 128, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}
