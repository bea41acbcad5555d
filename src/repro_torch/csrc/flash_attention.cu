// Flash-attention prefill for Hopper (sm_90a), with a plain C interface
// bound from Python through ctypes (repro_torch/kernels/flash_attention).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (flash_attention_bhsd, body _flash_kernel).  Same function: softmax
// attention with scale 1/sqrt(D); causal mask kpos <= qpos and sliding
// window qpos - kpos < window, both positions counted from 0; online softmax
// with an f32 running max, sum and accumulator; the probabilities rounded to
// bf16 before the P.V product, as the Pallas body does (p.astype(v.dtype)).
// Rows that see no key give 0.  A nonzero cap soft-caps the scaled scores,
// cap * tanh(s / cap) before the mask, as the reference's chunked_attention
// applies cfg.attn_logit_softcap (src/repro/models/layers.py:204-205); the
// accurate tanhf, since tanh.approx.f32 (about 2^-11 relative) would move a
// logit by about cap * 5e-4.  The cap is a template flag (CAP): cap 0
// launches the uncapped instance, which compiles as it did before the cap
// existed.
//
// Layout: q (B, Sq, H, D), k (B, Sk, K, D), v (B, Sk, K, DV), out
// (B, Sq, H, DV), all bf16 and contiguous.  (D, DV) is (16, 16), (64, 64),
// (128, 128) or (192, 128): the last is deepseek-v2's MLA prefill, whose
// query-key width (128 + 64 rope) is wider than its value width; the scale
// stays 1/sqrt(D), as the reference's chunked_attention takes it.  Query
// head h reads KV head h / (H / K) in place: GQA is never expanded in
// memory.  Any Sq and Sk are taken (a cross-attention's Sq != Sk); the
// ragged edge is masked here.
//
// What bounds it on an H100: at the main path's prefill (S = 1024, D = 128,
// 3 query heads per KV head, causal) the function does 2 * 2 * D FLOPs per
// visible (query, key) pair, 6.4 GFLOP on 16.8 MB: ~380 FLOPs a byte, above
// the card's ~295, so the bf16 tensor cores bound it (6.5 us at 989 TFLOP/s).
//
// The design, for those tensor cores:
// - A CTA is two consumer warpgroups of 64 query rows each (128 rows of one
//   query head) and one producer warp.  S = Q K^T is wgmma.mma_async with Q
//   and K from shared memory; O += P V is wgmma with P as the register
//   operand and V from shared memory read MN-major through the transpose
//   bit.  S (64 x 128 keys) and O (64 x D) stay in registers for the whole
//   key loop.  The online softmax works on the accumulator fragments: a
//   row's max and sum by shuffles within the quad of threads that holds it,
//   alpha applied to the register accumulator, the f32 scores rounded to
//   bf16 pairs that are the P.V product's A fragments as they lie.
// - K and V tiles of 128 keys stream through a two-stage shared-memory ring
//   filled by TMA (cp.async.bulk.tensor, 4-d tensor maps over (D, K, Sk, B)
//   so the kv head and batch are coordinates and the K * D row stride is
//   the map's), with a 128-byte swizzle (32-byte at D = 16) that matches
//   the wgmma descriptors.  One thread of the producer warp waits for a
//   stage to be released (an "empty" mbarrier that every consumer thread
//   arrives on) and arms its "full" mbarrier with the tile's bytes; the
//   consumers wait on "full".  So the next tile's loads overlap this tile's
//   math.  TMA was chosen over cp.async because the copy then costs the
//   consumers no instructions or registers, zero-fills keys past Sk, and
//   writes the swizzle the descriptors expect by construction.  The maps
//   hold the base pointers, so the host encodes them on every call
//   (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint: the library
//   links no -lcuda) and passes them as __grid_constant__ parameters.
// - Key tiles that no row of the CTA can see (past the causal diagonal,
//   left of the window) are never loaded; only the diagonal, window-edge
//   and ragged tiles apply the mask.  The grid runs the longest query tiles
//   (the last rows under a causal mask) first.
// - At (D, DV) = (192, 128) K has three 64-column swizzle blocks and V two;
//   a ring stage holds both (80 KiB), so Q (48 KiB) and two stages take
//   209 KiB of the 227 a CTA may have.  S and O keep D = 128's register
//   shapes (64 x 128 f32 each per warpgroup): only the Q K^T loop is longer.
//
// Left for later: a persistent grid, two consumer warpgroups that take
// turns between softmax and wgmma (the softmax of one overlapping the
// products of the other), packing the query heads of one KV head into one
// CTA so each K/V tile is loaded once for all of them, and FP8.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;                    // query rows per consumer warpgroup
constexpr int NWG = 2;                    // consumer warpgroups per CTA
constexpr int BK = 128;                   // keys per ring tile
constexpr int STAGES = 2;                 // ring depth
constexpr int NCONS = NWG * 128;          // consumer threads
constexpr int NTHREADS = NCONS + 32;      // + one producer warp
constexpr uint32_t SPIN_LIMIT = 1u << 22; // mbarrier polls before a trap

// D: the query-key width; DV: the value (and output) width.
template <int D, int DV>
struct Cfg {
  static constexpr int RB = D * 2 < 128 ? D * 2 : 128;  // bytes per smem row
  static_assert(RB == (DV * 2 < 128 ? DV * 2 : 128),
                "the Q/K and V tiles share one swizzle");
  static constexpr int NCB = D * 2 / RB;                // K's column blocks
  static constexpr int NCBV = DV * 2 / RB;              // V's column blocks
  static constexpr int SWZ = RB / 16 - 1;               // swizzle xor mask
  static constexpr uint64_t LAYOUT = RB == 128 ? 1 : RB == 64 ? 2 : 3;
  static constexpr uint32_t SBO = 8 * RB;               // 8-row group stride
  static constexpr int Q_BYTES = BQ * D * 2;            // one warpgroup's Q
  static constexpr int K_BYTES = BK * D * 2;            // one K tile
  static constexpr int V_BYTES = BK * DV * 2;           // one V tile
  static constexpr int ST_BYTES = K_BYTES + V_BYTES;    // one ring stage
  static constexpr int ON = DV < 64 ? DV : 64;          // n of a P.V wgmma
  static constexpr int NO = DV / ON;                    // P.V wgmmas a step
  // byte offsets from the 1024-aligned base; every tile 1024-aligned
  static constexpr int q_off = 0;
  static constexpr int kv_off = NWG * Q_BYTES;          // stage s: K, then V
  static constexpr int bar_off = kv_off + STAGES * ST_BYTES;
  static constexpr int bytes = bar_off + 2 * STAGES * 8 + 1024;  // + align
  static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0
                && V_BYTES % 1024 == 0, "tiles stay 1024-aligned");
  static_assert(bytes <= 232448, "a CTA takes at most 227 KiB");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of a 16-byte chunk in a swizzled tile (CuTe's Swizzle<b,4,3>)
template <class C>
__device__ __forceinline__ uint32_t swizzle(uint32_t off) {
  return off ^ (((off >> 7) & C::SWZ) << 4);
}

// wgmma shared-memory matrix descriptor: start address, leading byte
// offset (unused by these swizzled layouts: 1), stride byte offset between
// 8-row groups, swizzle mode
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t sbo,
                                              uint64_t layout) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16)
      | ((uint64_t)(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait for the completion of the barrier's phase of this parity.  A wait
// that never ends (a lost arrival, a tile's bytes miscounted) traps, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t n = 0;; ++n) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (n == SPIN_LIMIT) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3,
                                            uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads of wgmma accumulators above the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory,
// both K-major; accumulate = 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (four bf16
// pairs in the accumulator layout of a score tile), B from shared
// memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 16] += A[64 x 16] B[16 x 16], A from registers (four bf16
// pairs in the accumulator layout of a score tile), B from shared
// memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t* a,
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// Without CAP, mul = scale * log2(e) and cap_log2 goes unused; with CAP,
// mul = scale / cap and cap_log2 = cap * log2(e).
template <int D, int DV, bool CAP>
__global__ void __launch_bounds__(NTHREADS, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tmap_k,
                     const __grid_constant__ CUtensorMap tmap_v,
                     const bf16* __restrict__ q, bf16* __restrict__ o,
                     int Sq, int Sk, int H, int K, int causal, int window,
                     float mul, float cap_log2) {
  using C = Cfg<D, DV>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const uint32_t full_bar = base + C::bar_off;         // + 8 * stage
  const uint32_t empty_bar = full_bar + STAGES * 8;

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh % H;
  const int kvh = h / (H / K);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * (NWG * BQ);  // longest first
  const int tid = threadIdx.x;

  // key tiles that some row q0 .. q_last of the CTA can see
  const int q_last = min(Sq, q0 + NWG * BQ) - 1;
  const int k_end = causal ? min(Sk, q_last + 1) : Sk;
  const int k_begin = window ? max(0, q0 - window + 1) : 0;
  const int tile0 = k_begin / BK;
  const int n_tiles = k_end > k_begin ? (k_end + BK - 1) / BK - tile0 : 0;

  if (tid < NCONS) {
    // each warpgroup stages its 64 query rows, swizzled; rows >= Sq are 0
    constexpr int CPR = D / 8;                   // 16-byte chunks per row
    const int w = tid / 128;
    for (int i = tid % 128; i < BQ * CPR; i += 128) {
      const int r = i / CPR, c = i % CPR;
      const int qpos = q0 + w * BQ + r;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (qpos < Sq)
        val = *reinterpret_cast<const uint4*>(
            q + (((size_t)b * Sq + qpos) * H + h) * D + c * 8);
      const int cb = c / (C::RB / 16), cc = c % (C::RB / 16);
      const uint32_t off = cb * (BQ * C::RB) + r * C::RB + cc * 16;
      *reinterpret_cast<uint4*>(smem + C::q_off + w * C::Q_BYTES
                                + swizzle<C>(off)) = val;
    }
    // make the generic-proxy stores visible to wgmma (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, NCONS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS) {
    // producer: one thread keeps the ring full
    if (tid == NCONS) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(empty_bar + 8 * s, ((j / STAGES) & 1) ^ 1);
        mbar_expect_tx(full_bar + 8 * s, C::ST_BYTES);
        const int k0 = (tile0 + j) * BK;
        const uint32_t kdst = base + C::kv_off + s * C::ST_BYTES;
#pragma unroll
        for (int cb = 0; cb < C::NCB; ++cb)
          tma_load_4d(kdst + cb * BK * C::RB, &tmap_k, cb * (C::RB / 2), kvh,
                      k0, b, full_bar + 8 * s);
#pragma unroll
        for (int cb = 0; cb < C::NCBV; ++cb)
          tma_load_4d(kdst + C::K_BYTES + cb * BK * C::RB, &tmap_v,
                      cb * (C::RB / 2), kvh, k0, b, full_bar + 8 * s);
      }
    }
    return;
  }

  // consumers: warpgroup w, warp wp of it, rows row0 and row0 + 8
  const int w = tid / 128, wp = (tid % 128) / 32, lane = tid % 32;
  const int wq0 = q0 + w * BQ;                   // the warpgroup's first row
  const int row0 = wq0 + wp * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const uint32_t q_addr = base + C::q_off + w * C::Q_BYTES;

  float acc[C::NO][C::ON / 2];
#pragma unroll
  for (int n = 0; n < C::NO; ++n)
#pragma unroll
    for (int i = 0; i < C::ON / 2; ++i) acc[n][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};            // running max, log2 units
  float l[2] = {0.f, 0.f};        // this thread's share of the row sum

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % STAGES;
    const int k0 = (tile0 + j) * BK;
    const uint32_t k_addr = base + C::kv_off + s * C::ST_BYTES;
    const uint32_t v_addr = k_addr + C::K_BYTES;
    mbar_wait(full_bar + 8 * s, (j / STAGES) & 1);

    // S = Q K^T, 64 x BK in registers
    float sc[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int cb = kk * 32 / C::RB, cbyte = kk * 32 % C::RB;
      wgmma_ss_n128(sc,
                    smem_desc(q_addr + cb * BQ * C::RB + cbyte, C::SBO,
                              C::LAYOUT),
                    smem_desc(k_addr + cb * BK * C::RB + cbyte, C::SBO,
                              C::LAYOUT),
                    kk > 0);
    }
    wgmma_commit_wait();
    fence_regs<BK / 2>(sc);

    // online softmax on the fragments: sc[4i + e] is row row0 + 8 * (e / 2),
    // key k0 + 8 i + col0 + e % 2
    const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wq0)
        || (window && wq0 + BQ - 1 - k0 >= window);
    // the scores in log2 units: s * scale, or with the cap
    // cap * tanh(s * scale / cap) taken to log2 here
    if constexpr (CAP) {
#pragma unroll
      for (int j = 0; j < BK / 2; ++j)
        sc[j] = cap_log2 * tanhf(sc[j] * mul);
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = CAP ? sc[4 * i + e] : sc[4 * i + e] * mul;
        if (edge) {
          const int qpos = row0 + 8 * (e / 2);
          const int kpos = k0 + 8 * i + col0 + e % 2;
          bool ok = kpos < Sk;
          if (causal) ok = ok && kpos <= qpos;
          if (window) ok = ok && qpos - kpos < window;
          x = ok ? x : -INFINITY;
        }
        sc[4 * i + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    }
    float mu[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];   // a row that saw no key yet
      alpha[r] = exp2f(m[r] - mu[r]);
      m[r] = mx[r];
    }
    // p = exp(s - m), its f32 sum, and its bf16 rounding as P.V's A operand
    uint32_t pa[BK / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int i = 2 * kk + half;
        const float p0 = exp2f(sc[4 * i + 0] - mu[0]);
        const float p1 = exp2f(sc[4 * i + 1] - mu[0]);
        const float p2 = exp2f(sc[4 * i + 2] - mu[1]);
        const float p3 = exp2f(sc[4 * i + 3] - mu[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        pa[kk][2 * half] = pack_bf16(p0, p1);
        pa[kk][2 * half + 1] = pack_bf16(p2, p3);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
#pragma unroll
      for (int i = 0; i < C::ON / 2; ++i) acc[n][i] *= alpha[(i / 2) % 2];

    // O += P V: V's tile read MN-major, one wgmma per 64 columns of DV
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < C::NO; ++n) {
        const uint64_t dv = smem_desc(v_addr + n * BK * C::RB + kk * 16 * C::RB,
                                      C::SBO, C::LAYOUT);
        if constexpr (C::ON == 64)
          wgmma_rs_n64(acc[n], pa[kk], dv);
        else
          wgmma_rs_n16(acc[n], pa[kk], dv);
      }
    }
    wgmma_commit_wait();
#pragma unroll
    for (int n = 0; n < C::NO; ++n) fence_regs<C::ON / 2>(acc[n]);
    mbar_arrive(empty_bar + 8 * s);               // this stage may refill
  }

  // out = O / l; acc[n][4 i + e] is row row0 + 8 * (e / 2), column
  // n * ON + 8 i + col0 + e % 2
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const float inv = sum > 0.f ? 1.f / sum : 0.f;
    const int qpos = row0 + 8 * r;
    if (qpos >= Sq) continue;
    bf16* orow = o + (((size_t)b * Sq + qpos) * H + h) * DV;
#pragma unroll
    for (int n = 0; n < C::NO; ++n)
#pragma unroll
      for (int i = 0; i < C::ON / 8; ++i)
        *reinterpret_cast<__nv_bfloat162*>(orow + n * C::ON + 8 * i + col0) =
            __floats2bfloat162_rn(acc[n][4 * i + 2 * r] * inv,
                                  acc[n][4 * i + 2 * r + 1] * inv);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime, so the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A map over one (B, Sk, K, W) tensor as (W, K, Sk, B), innermost first, whose
// box is one column block (RB bytes) of BK keys of one (batch, kv head).
template <class C>
CUresult encode_kv(CUtensorMap* map, EncodeTiled enc, const void* ptr, int B,
                   int Sk, int K, int W) {
  const cuuint64_t dims[4] = {(cuuint64_t)W, (cuuint64_t)K, (cuuint64_t)Sk,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)W * 2, (cuuint64_t)K * W * 2,
                                 (cuuint64_t)Sk * K * W * 2};
  const cuuint32_t box[4] = {C::RB / 2, 1, BK, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle sw = C::RB == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
      : C::RB == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Error codes besides cudaError_t's: cuTensorMapEncodeTiled was not found,
// or the tensor map did not encode (the CUresult is added to the base).
constexpr int ERR_NO_ENCODE = -1;
constexpr int ERR_ENCODE_BASE = -1000;

template <int D, int DV, bool CAP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int K, int causal, int window, float scale,
           float cap, cudaStream_t stream) {
  using C = Cfg<D, DV>;
  EncodeTiled enc = encode_tiled();
  if (!enc) return ERR_NO_ENCODE;
  CUtensorMap tk, tv;
  CUresult r = encode_kv<C>(&tk, enc, k, B, Sk, K, D);
  if (r == CUDA_SUCCESS) r = encode_kv<C>(&tv, enc, v, B, Sk, K, DV);
  if (r != CUDA_SUCCESS) return ERR_ENCODE_BASE - (int)r;
  const int bytes = C::bytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<D, DV, CAP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * H, (Sq + NWG * BQ - 1) / (NWG * BQ));
  constexpr float LOG2E = 1.4426950408889634f;
  flash_prefill_kernel<D, DV, CAP><<<grid, NTHREADS, bytes, stream>>>(
      tk, tv, static_cast<const bf16*>(q), static_cast<bf16*>(o), Sq, Sk, H,
      K, causal, window, CAP ? scale / cap : scale * LOG2E, cap * LOG2E);
  return (int)cudaGetLastError();
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int K, int causal, int window, float scale,
           float cap, cudaStream_t stream) {
  return cap != 0.f
      ? launch<D, DV, true>(q, k, v, o, B, Sq, Sk, H, K, causal, window,
                            scale, cap, stream)
      : launch<D, DV, false>(q, k, v, o, B, Sq, Sk, H, K, causal, window,
                             scale, cap, stream);
}

// The (D, DV) pairs built, as one switch key.
constexpr int widths(int D, int DV) { return D * 1024 + DV; }

}  // namespace

// Returns cudaGetLastError() after the launch (0 on success), or a negative
// code when the K/V tensor maps could not be made (see ERR_* above).
extern "C" int flash_prefill(const void* q, const void* k, const void* v,
                             void* o, int B, int Sq, int Sk, int H, int K,
                             int D, int DV, int causal, int window,
                             float scale, float cap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0 || Sq == 0) return 0;
  if (Sk == 0)                     // no keys: every row gives 0
    return (int)cudaMemsetAsync(o, 0, (size_t)B * Sq * H * DV * 2, s);
  switch (widths(D, DV)) {
    case widths(16, 16):
      return launch<16, 16>(q, k, v, o, B, Sq, Sk, H, K, causal, window,
                            scale, cap, s);
    case widths(64, 64):
      return launch<64, 64>(q, k, v, o, B, Sq, Sk, H, K, causal, window,
                            scale, cap, s);
    case widths(128, 128):
      return launch<128, 128>(q, k, v, o, B, Sq, Sk, H, K, causal, window,
                              scale, cap, s);
    case widths(192, 128):
      return launch<192, 128>(q, k, v, o, B, Sq, Sk, H, K, causal, window,
                              scale, cap, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Dynamic shared memory of one CTA at widths (D, DV) (0 for a pair not
// built): what ptxas cannot print for this kernel.
extern "C" int flash_prefill_smem_bytes(int D, int DV) {
  switch (widths(D, DV)) {
    case widths(16, 16): return Cfg<16, 16>::bytes;
    case widths(64, 64): return Cfg<64, 64>::bytes;
    case widths(128, 128): return Cfg<128, 128>::bytes;
    case widths(192, 128): return Cfg<192, 128>::bytes;
    default: return 0;
  }
}
