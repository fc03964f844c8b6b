// Paged flash-decode over the layer-stacked KV pool, for Hopper (sm_90a):
// what the two kernels share, and the tensor-core kernel itself.
//
// Replaces the TPU kernel production_stack_tpu/ops/pallas/paged_attention.py:
// _decode_kernel (reached through paged_flash_decode_stats), both its
// compute-dtype branch and its quantized=True branch (int8 pools). It
// computes, for ONE layer of the pool [L, Hkv, num_slots, Dh], the attention
// of one decode query per sequence [H, Dh] against that sequence's pages
// (slot j of the page list holds absolute position j; keys at positions >=
// kv_len are masked), and returns the normalized output plus the softmax
// stats (running max m, sum l) so the caller can flash-merge it with the
// in-dispatch ring segment. A row with kv_len == 0 returns (0, -inf, 0).
//
// What bounds it on this card: HBM bytes. Each row and layer reads
// 2 * kv_len * Hkv * Dh * 2 B of 16-bit K/V (int8: Dh + 2 B of payload and
// scale per slot and head, about half) and does ~4 * kv_len * H * Dh flops,
// far below the ~295 flops per byte where an H100 turns compute-bound. At
// decode sizes the bytes are few (23 MB at the served batch), so what is
// left to beat is latency: each tile's copy round trip, barriers, launches.
//
// Two kernels share the work split and the merge; the host picks one by
// shape, never on a failure. paged_decode_kernel (tensor cores, below)
// takes bf16 and f16 q, over pools of q's dtype or int8, at Dh 32, 64, 128
// and 256, any number of query heads per kv head and every block size the
// gate admits; paged_decode_generic (CUDA cores, paged_decode.cu) takes
// float32 q, and bf16 / f16 at the head dims mma.sync tiles cannot take
// cheaply: Dh 1-16 (a k16 step would be mostly padding; no public model
// has them) and Dh > 256 (the accumulators would take more than two column
// blocks of registers).
//
// The design of paged_decode_kernel, one launch per call:
// - Work follows each row's own length, decided on the device: a block
//   takes a fixed chunk of `chunk_tiles` 64-token tiles of one (row, kv
//   head, head group, column block); row b gets ceil(tiles_b / chunk_tiles)
//   chunks. The grid is (max chunks x blocks per kv head, Hkv, B), sized on
//   the host from the block-table width; blocks past their row's chunks
//   exit at once. No host read of kv_lens. Blocks that read the same K/V
//   (head groups, column blocks) are neighbours in grid order, so all but
//   the first find its tiles in L2.
// - A block first reads its chunk's block-table entries once into shared
//   memory (page = token >> log2(bs); at most 257 entries: 8-tile chunks at
//   block size >= 2, 4-tile chunks at one-token pages), then streams its
//   tiles through a ring of 2-4 shared-memory stages with 16-byte cp.async.
//   Each warp copies its own 16 rows of every tile, K and V as two commit
//   groups, so __syncwarp orders a stage and no block barrier runs per
//   tile: the copies of tile i+S-1 are in flight while tile i is scored,
//   and tile i's V lands while its scores run.
//   Positions past kv_len are zero-filled in every stage (payload and int8
//   scales), so a stale slot, NaN included, never reaches the result and no
//   stage carries data of an earlier tile.
// - Four warps split each tile (16 tokens each) and run tensor-core
//   mma.sync.m16n8k16 (bf16 or f16 in, fp32 accumulate): S = q K^T with up
//   to 16 query heads of the kv head as the M rows (padded rows zero; more
//   heads per kv head run as head groups of 16, one block each) and q
//   unscaled in its own dtype (exact), the fp32 score times scale (and the
//   slot's K scale); then the weights P (int8: P times the slot's V scale),
//   split into two parts P = hi + lo, times V: a single 16-bit rounding of P
//   costs ~3e-3 (bf16) / ~5e-4 (f16) of row error on out against fp32
//   weights, too close to the checks' 5e-3 / 6.25e-4. The parts are in q's
//   dtype over compute-dtype pools, in bf16 over int8 pools: P times an
//   arbitrary V scale may leave f16's range.
//   The contraction axis of QK^T is permuted so that each lane reads K with
//   plain 16-byte loads (8-byte loads where a row is 32 bytes: int8 at Dh
//   32), conflict-free on the padded rows; 16-bit V goes through
//   ldmatrix.trans, int8 V through 32-bit loads of four columns. int8 K/V
//   turn into bf16 or f16 exactly (|k| <= 127) on the way into the
//   fragments. Each warp keeps its own online softmax (m, l, acc) in
//   registers, in the log2 domain; the warps merge through shared memory.
// - Dh 256 runs as two column blocks of 128: each computes the whole score
//   (all of K) and its half of P V (half of V), so no warp holds more than
//   128 columns of accumulators (64 registers a lane), and each stage
//   carries half the V bytes.
// - The splits merge inside the kernel: each block writes its partial
//   (m, l, acc) to a per-device scratch, and the last block of a (row, kv
//   head, head group, column block) to finish (a __threadfence plus an
//   atomic ticket) merges them, writes out/m/l and resets the ticket to 0
//   for the next call or graph replay. A row with one chunk writes its
//   output directly.
//
// Numerics follow the Pallas kernel up to rounding: fp32 scores and sums,
// masked keys at -inf, l sums the unrounded, unscaled weights. Int8 pools
// dequantize as rank-1 factors, never materializing 16-bit K/V in HBM.
// Block-table entries past cdiv(kv_len, block_size) are never read.
//
// The tensor-core instances are compiled in four translation units (one
// per q dtype and pool kind, built by parallel nvcc processes);
// paged_decode.cu holds the generic kernel and the plain C interface.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace pstpu {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                // tokens per tile (16 per warp)
constexpr int kMaxGroup = 16;            // query heads per block (M rows)
constexpr int kMaxColumns = 128;         // output columns per block
constexpr int kMaxChunkTiles = 8;        // tiles per block, at most
// Page-list entries: a chunk of 8 tiles at block size >= 2, or of 4 tiles
// at block size 1, spans at most 257 pages.
constexpr int kMaxPages = kMaxChunkTiles * kTile / 2 + 1;
constexpr int kRingBudget = 70 * 1024;   // shared bytes for the tile ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int QT> struct QType;   // 0 bf16, 1 f16, 2 f32
template <> struct QType<0> { using T = __nv_bfloat16; };
template <> struct QType<1> { using T = __half; };
template <> struct QType<2> { using T = float; };

// One call of the tensor-core kernel, as the C interface hands it to an
// instance.
struct DecodeArgs {
  const void* q;               // [B, H, Dh] in the compute dtype
  const void* k_pool;          // [L, Hkv, NS, Dh]
  const void* v_pool;
  const __nv_bfloat16* k_scale;  // [L, Hkv, NS] | null
  const __nv_bfloat16* v_scale;
  const int* block_tables;     // [B, mb]
  const int* kv_lens;          // [B]
  void* out;                   // [B, H, Dh]
  float* m_out;                // [B, H]
  float* l_out;
  float* part_acc;             // [B*Hkv, max_chunks, G, Dh]
  float* part_ml;              // [B*Hkv, column blocks, max_chunks, G, 2]
  int* tickets;                // [B*Hkv * blocks per kv head], 0 between calls
  unsigned long long* launches;  // this variant's count
  int B, H, Hkv;
  long long num_slots;
  int layer, mb, bs_shift, chunk_tiles, max_chunks;
  float scale;
};

template <int QT, bool QUANT, int DH>
struct Layout {
  using TQ = typename QType<QT>::T;
  using T = typename std::conditional<QUANT, int8_t, TQ>::type;
  static constexpr bool kQuant = QUANT;
  static constexpr int kElt = sizeof(T);
  static constexpr int kEpu = 16 / kElt;                 // elements per 16 B
  static constexpr int kSplit = DH > kMaxColumns ? DH / kMaxColumns : 1;  // column blocks
  static constexpr int kDV = DH / kSplit;                // V columns per block
  static constexpr int kRowK = DH * kElt;                // bytes of a K row
  static constexpr int kRowV = kDV * kElt;               // bytes of a block's V row
  // Rows padded by 16 B keep the lane patterns below conflict-free; rows of
  // 64 B (or 32) are conflict-free unpadded.
  static constexpr int kStrideK = kRowK <= 64 ? kRowK : kRowK + 16;
  static constexpr int kStrideV = kRowV + 16;
  static constexpr int kScaleBytes = kQuant ? kTile * 2 : 0;
  static constexpr int kStageBytes =
      kTile * kStrideK + kTile * kStrideV + 2 * kScaleBytes;
  static constexpr int kStagesRaw = kRingBudget / kStageBytes;
  static constexpr int kStages = kStagesRaw < 2 ? 2 : (kStagesRaw > 4 ? 4 : kStagesRaw);
  // K is read by each lane as kKLoads vectors of kLoadBytes of its token
  // row (16 B; a quarter row when rows are shorter than 64 B); each vector
  // feeds kStepsPerLoad k16 steps of the QK^T product.
  static constexpr int kLoadBytes = kRowK >= 64 ? 16 : kRowK / 4;
  static constexpr int kKLoads = kRowK / (4 * kLoadBytes);
  static constexpr int kLoadElts = kLoadBytes / kElt;
  static constexpr int kStepsPerLoad = kLoadElts / 4;
  static constexpr int kKSteps = DH / 16;
  static constexpr int kNTiles = kDV / 8;                // PV n8 tiles
  // Two column blocks hold twice the ring of one (Dh 256: 2 stages of
  // 50 KiB), so two blocks fit an SM, and their 128-column accumulators
  // plus 256 columns of q fragments get the registers of two.
  static constexpr int kMinBlocks = kSplit > 1 ? 2 : 3;
  static_assert(kKLoads * kStepsPerLoad == kKSteps, "k steps");
  static_assert(kRowK >= 32 && kDV % 32 == 0, "Dh 32 .. 256");
};

template <int QT, bool QUANT, int DH, int KG>
constexpr int smem_bytes() {
  using Lay = Layout<QT, QUANT, DH>;
  return Lay::kStages * Lay::kStageBytes > kWarps * KG * Lay::kDV * 4
             ? Lay::kStages * Lay::kStageBytes
             : kWarps * KG * Lay::kDV * 4;
}

// 16-byte global -> shared copy that bypasses registers. With `valid` false
// nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// 4-byte copy of `bytes` (0, 2 or 4) source bytes; the rest is zero-filled.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// D += A * B, m16n8k16, bf16 or f16 inputs (TI), fp32 accumulators.
template <typename TI>
__device__ __forceinline__ void mma(float* d, const unsigned* a, unsigned b0, unsigned b1) {
  if constexpr (std::is_same<TI, __half>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// (x, y) as TI x2 hi = TI(x, y) and lo = TI(x - hi.x, y - hi.y).
template <typename TI>
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  if constexpr (std::is_same<TI, __half>::value) {
    const __half2 h = __floats2half2_rn(x, y);
    const __half2 l = __floats2half2_rn(x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<const unsigned*>(&h);
    lo = *reinterpret_cast<const unsigned*>(&l);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const __nv_bfloat162 l =
        __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
    hi = *reinterpret_cast<const unsigned*>(&h);
    lo = *reinterpret_cast<const unsigned*>(&l);
  }
}

// Byte k of w (int8, already XOR 0x80) as an exact fp32 value: 2^23 + u
// built by bit placement, minus 2^23 + 128.
template <int K>
__device__ __forceinline__ float i8_to_f32(unsigned w_flipped) {
  return __uint_as_float(__byte_perm(w_flipped, 0x4B000000u, 0x7540 | K)) - 8388736.f;
}

// bf16x2 of two exact small-integer floats: their high halves.
__device__ __forceinline__ unsigned pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// TI x2 pairs (bytes 0,1) and (bytes 2,3) of an int8 word, exactly. f16:
// 0x64 above byte u is 1024 + u, minus 1024 + 128.
template <typename TI>
__device__ __forceinline__ void i8x4_to(unsigned w, unsigned& b0, unsigned& b1) {
  w ^= 0x80808080u;
  if constexpr (std::is_same<TI, __half>::value) {
    const __half2 bias = __floats2half2_rn(1152.f, 1152.f);
    unsigned u0 = __byte_perm(w, 0x64646464u, 0x4140);
    unsigned u1 = __byte_perm(w, 0x64646464u, 0x4342);
    const __half2 h0 = __hsub2(*reinterpret_cast<const __half2*>(&u0), bias);
    const __half2 h1 = __hsub2(*reinterpret_cast<const __half2*>(&u1), bias);
    b0 = *reinterpret_cast<const unsigned*>(&h0);
    b1 = *reinterpret_cast<const unsigned*>(&h1);
  } else {
    b0 = pack_exact(i8_to_f32<0>(w), i8_to_f32<1>(w));
    b1 = pack_exact(i8_to_f32<2>(w), i8_to_f32<3>(w));
  }
}

// The K vector of its row that lane group position `tig` reads on load l:
// vectors 2*tig, 2*tig+1, 2*tig+8, 2*tig+9, ... (one vector per lane when
// a row holds only four), so the 8 lanes of a quarter-warp (two rows whose
// padded stride is an odd number of vectors) hit 8 distinct bank groups.
template <int KLOADS>
__device__ __forceinline__ int k_vector(int tig, int l) {
  return KLOADS == 1 ? tig : 2 * tig + (l & 1) + 8 * (l >> 1);
}

// Head dim (within the block's columns) of PV output column e (0, 1) of n8
// tile nt for lane group position tig: 16-bit V (ldmatrix.trans) keeps the
// natural order; int8 V is read as 32-bit words of four columns, so tile
// nt = 4 * grp + j holds columns 32 * grp + 4 * n + j.
template <bool QUANT>
__device__ __forceinline__ int pv_col(int nt, int tig, int e) {
  const int n = 2 * tig + e;
  return QUANT ? 32 * (nt >> 2) + 4 * n + (nt & 3) : 8 * nt + n;
}

// Element conversions of the compute dtypes (and int8 pools).
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) { return __float2half(x); }
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }

// Run by the last block of a (row, kv head, head group, column block) to
// finish: every chunk's partial (m, l) of heads g0 .. g0 + gn - 1 into
// shared memory (w_s: n_chunks * gn * 2 floats; m in the log2 domain),
// then per head the max M and the chunk weights exp2(m_c - M), then acc
// summed over the chunks and normalized. `acc` is chunk 0's partial of
// head 0 of the kv head at the block's first column (chunk c, head g,
// column d at acc[(c * G + g) * stride + d]), `ml` chunk 0's (m, l) pairs,
// `out` / `m_out` / `l_out` head 0 of the kv head (out at the first
// column); `cols` columns are merged, and m / l written when `write_ml`.
// l_s holds gn floats.
template <typename TO>
__device__ __forceinline__ void merge_chunks(
    const float* __restrict__ acc, const float* __restrict__ ml, TO* __restrict__ out,
    float* __restrict__ m_out, float* __restrict__ l_out, float* w_s, float* l_s,
    int n_chunks, int G, int g0, int gn, int stride, int cols, bool write_ml) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n_chunks * gn * 2; i += kThreads) {
    const int c = i / (2 * gn);
    w_s[i] = __ldcg(ml + 2 * ((long long)c * G + g0) + i % (2 * gn));
  }
  __syncthreads();
  if (tid < gn) {
    float m = -INFINITY;
    for (int c = 0; c < n_chunks; ++c) m = fmaxf(m, w_s[2 * (c * gn + tid)]);
    float l = 0.f;
    for (int c = 0; c < n_chunks; ++c) {
      float* e = w_s + 2 * (c * gn + tid);
      e[0] = exp2f(e[0] - m);
      l += e[1] * e[0];
    }
    if (write_ml) {
      m_out[g0 + tid] = m * kLn2;
      l_out[g0 + tid] = l;
    }
    l_s[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < gn * cols; i += kThreads) {
    const int g = i / cols;
    const int d = i % cols;
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < n_chunks; ++c)
      a += __ldcg(acc + ((long long)c * G + g0 + g) * stride + d) * w_s[2 * (c * gn + g)];
    out[(long long)(g0 + g) * stride + d] = from_f32<TO>(a / l_s[g]);
  }
}

// One block: chunk `chunk` of row `b`'s tiles, kv head `kvh`, query heads
// g0 .. g0 + gn - 1 of that kv head (head group hg, at most KG = 8 or 16
// M rows in use), output columns d0 .. d0 + kDV - 1 (column block `split`).
// POOL: 0 pools of q's dtype, 1 int8 pools, 2 int8 pools of one-token
// pages (their scales loaded one by one: a slot pair may lie on two pages,
// and a 2-byte scale is no cp.async source; an instance of its own, so the
// other int8 instances keep the pair copies alone in their loop).
template <int QT, int POOL, int DH, int KG>
__global__ void __launch_bounds__(kThreads, Layout<QT, POOL != 0, DH>::kMinBlocks)
paged_decode_kernel(const typename QType<QT>::T* __restrict__ q,     // [B, H, DH]
                    const typename Layout<QT, POOL != 0, DH>::T* __restrict__ k_pool,  // [L, Hkv, NS, DH]
                    const typename Layout<QT, POOL != 0, DH>::T* __restrict__ v_pool,
                    const __nv_bfloat16* __restrict__ k_scale,  // [L, Hkv, NS] | null
                    const __nv_bfloat16* __restrict__ v_scale,
                    const int* __restrict__ block_tables,       // [B, mb]
                    const int* __restrict__ kv_lens,            // [B]
                    typename QType<QT>::T* __restrict__ out,   // [B, H, DH]
                    float* __restrict__ m_out,                  // [B, H]
                    float* __restrict__ l_out,                  // [B, H]
                    float* __restrict__ part_acc,   // [B*Hkv, max_chunks, G, DH]
                    float* __restrict__ part_ml,    // [B*Hkv, column blocks, max_chunks, G, 2]
                    int* __restrict__ tickets,      // [B*Hkv*per_kv], 0 between calls
                    unsigned long long* __restrict__ launches,  // this variant's count
                    int H, int Hkv, long long num_slots, int layer, int mb,
                    int bs_shift, int chunk_tiles, int max_chunks, float scale) {
  using Lay = Layout<QT, POOL != 0, DH>;
  using TQ = typename Lay::TQ;
  using T = typename Lay::T;
  // PV's operand type: q's over compute-dtype pools; bf16 over int8 pools
  // (P times a V scale can leave f16's range).
  using TV = typename std::conditional<POOL != 0, __nv_bfloat16, TQ>::type;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int S = Lay::kStages;
  constexpr int DV = Lay::kDV;
  static_assert(KG == 8 || KG == kMaxGroup, "8 or 16 M rows");
  static_assert(kTile == kWarps * 16, "16 tokens per warp and tile");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int page_s[kMaxPages];
  __shared__ float m_s[kWarps][KG];
  __shared__ float l_s[kWarps][KG];
  __shared__ int last_s;

  const int G = H / Hkv;
  const int groups = (G + KG - 1) / KG;
  const int per_kv = groups * Lay::kSplit;       // blocks per (row, kv head, chunk)
  const int chunk = per_kv == 1 ? blockIdx.x : blockIdx.x / per_kv;
  const int sh = blockIdx.x - chunk * per_kv;
  const int hg = sh / Lay::kSplit;
  const int split = sh - hg * Lay::kSplit;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int g0 = hg * KG;
  const int gn = min(KG, G - g0);
  const int d0 = split * DV;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;   // mma group: M row, n column
  const int tig = lane & 3;    // position in the group
  const int bs = 1 << bs_shift;
  const long long bh = (long long)b * Hkv + kvh;
  const long long row0 = (long long)b * H + (long long)kvh * G;  // head 0 of kvh
  // One count per launch, taken on the device: a CUDA-graph replay of a
  // captured call counts as the call did.
  if (tid == 0 && blockIdx.x == 0 && kvh == 0 && b == 0) atomicAdd(launches, 1ull);

  // q fragments (A operand, unscaled in q's dtype), loaded first so that
  // their latency overlaps the kv_len and block-table reads, in the
  // permuted contraction order of the K loads: k step s of lane (grp, tig)
  // covers head dims dq, dq+1 (k = 2 tig, 2 tig + 1), dq+2, dq+3 (k = 8 +
  // 2 tig ..).
  unsigned qa[Lay::kKSteps][4];
  {
    const TQ* qb = q + (row0 + g0) * DH;
#pragma unroll
    for (int s = 0; s < Lay::kKSteps; ++s) {
      const int l = s / Lay::kStepsPerLoad;
      const int dq = k_vector<Lay::kKLoads>(tig, l) * Lay::kLoadElts +
                     4 * (s % Lay::kStepsPerLoad);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = grp + 8 * h;
        unsigned lo = 0, hi = 0;
        if ((h == 0 || KG == 16) && g < gn) {
          lo = *reinterpret_cast<const unsigned*>(qb + g * DH + dq);
          hi = *reinterpret_cast<const unsigned*>(qb + g * DH + dq + 2);
        }
        qa[s][h] = lo;        // a0 (row g), a1 (row g + 8)
        qa[s][2 + h] = hi;    // a2, a3
      }
    }
  }

  // This row's plan: its tiles dealt out in chunks of chunk_tiles.
  const int kv_len = min(kv_lens[b], mb << bs_shift);
  const int n_tiles = (kv_len + kTile - 1) / kTile;
  const int n_chunks = (n_tiles + chunk_tiles - 1) / chunk_tiles;
  if (n_chunks == 0) {
    if (chunk == 0) {   // empty row: (0, -inf, 0)
      for (int i = tid; i < gn * DV; i += kThreads)
        out[(row0 + g0 + i / DV) * DH + d0 + i % DV] = from_f32<TQ>(0.f);
      if (split == 0 && tid < gn) {
        m_out[row0 + g0 + tid] = -INFINITY;
        l_out[row0 + g0 + tid] = 0.f;
      }
    }
    return;
  }
  if (chunk >= n_chunks) return;
  const int tok_begin = chunk * chunk_tiles * kTile;
  const int tok_end = min(kv_len, tok_begin + chunk_tiles * kTile);
  const int tiles = (tok_end - tok_begin + kTile - 1) / kTile;

  // The chunk's block-table entries, read once (none past the live pages).
  const int page0 = tok_begin >> bs_shift;
  const int n_pages = ((tok_end - 1) >> bs_shift) - page0 + 1;
  const int* bt = block_tables + (long long)b * mb;
  for (int i = tid; i < n_pages; i += kThreads) page_s[i] = bt[page0 + i];
  __syncthreads();

  const long long head_base = ((long long)layer * Hkv + kvh) * num_slots;
  const T* k_head = k_pool + head_base * DH;
  const T* v_head = v_pool + head_base * DH + d0;

  auto slot_of = [&](int tok) -> long long {
    return ((long long)page_s[(tok >> bs_shift) - page0] << bs_shift) | (tok & (bs - 1));
  };

  // Each warp streams its own 16 tokens of every tile through its rows of
  // the ring, so only __syncwarp orders a stage, never a block barrier.
  // Tile ti -> stage st: payload rows zero-filled past tok_end; int8: the
  // 16 K and 16 V scales (in slot pairs when block sizes are even, so a
  // pair never straddles a page; one by one at one-token pages), zeroed
  // past tok_end.
  auto issue = [&](int ti, int st, bool v) {
    unsigned char* dst = smem + st * Lay::kStageBytes + (v ? kTile * Lay::kStrideK : 0);
    const int stride = v ? Lay::kStrideV : Lay::kStrideK;
    const int units = v ? Lay::kRowV / 16 : Lay::kRowK / 16;   // 16-byte vectors a row
    const T* src_head = v ? v_head : k_head;
    const int t0 = tok_begin + ti * kTile + 16 * warp;
    const int n_valid = tok_end - t0;
#pragma unroll
    for (int c = lane; c < 16 * units; c += 32) {
      const int tt = c / units;
      const int vec = c % units;
      const bool valid = tt < n_valid;
      const long long off = valid ? slot_of(t0 + tt) * DH + vec * Lay::kEpu : 0;
      cp_async16(dst + (16 * warp + tt) * stride + vec * 16, src_head + off, valid);
    }
    if constexpr (kQuant) {
      // Both scale rows travel with K: the softmax reads the V scales.
      unsigned char* sc = smem + st * Lay::kStageBytes + kTile * Lay::kStrideK +
                          kTile * Lay::kStrideV;
      if constexpr (POOL == 1) {
        if (!v && lane < 16) {
          const int j = lane & 7;
          const int n = min(max(n_valid - 2 * j, 0), 2);
          const __nv_bfloat16* src = (lane >> 3) ? v_scale : k_scale;
          src += n ? head_base + slot_of(t0 + 2 * j) : 0;
          cp_async4(sc + (lane >> 3) * Lay::kScaleBytes + 32 * warp + 4 * j, src, 2 * n);
        }
      } else if (!v) {
        const int j = lane & 15;
        const __nv_bfloat16* src = (lane >> 4) ? v_scale : k_scale;
        *reinterpret_cast<unsigned short*>(sc + (lane >> 4) * Lay::kScaleBytes + 32 * warp +
                                           2 * j) =
            j < n_valid
                ? __ldg(reinterpret_cast<const unsigned short*>(src + head_base +
                                                                slot_of(t0 + j)))
                : 0;
      }
    }
  };

  // K and V of a tile are two commit groups, so the scores of tile ti run
  // while its V is still in flight. A warp whose tokens of a tile all lie
  // past tok_end copies nothing (and still commits, to keep the count).
  auto warp_has = [&](int ti) { return tok_begin + ti * kTile + 16 * warp < tok_end; };
  auto issue_tile = [&](int ti) {
    const bool live = ti < tiles && warp_has(ti);
#pragma unroll
    for (int v = 0; v < 2; ++v) {
      if (live) issue(ti, ti % S, v);
      cp_async_commit();
    }
  };
#pragma unroll
  for (int s = 0; s < S - 1; ++s) issue_tile(s);

  const float scale_log2 = scale * kLog2e;
  float acc[Lay::kNTiles][4];
#pragma unroll
  for (int i = 0; i < Lay::kNTiles; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};

  for (int ti = 0; ti < tiles; ++ti) {
    cp_async_wait<2 * S - 3>();
    __syncwarp();   // the warp's K rows of tile ti landed; stage (ti-1)%S is free
    issue_tile(ti + S - 1);
    if (!warp_has(ti)) continue;
    const unsigned char* ks = smem + (ti % S) * Lay::kStageBytes;
    const unsigned char* vs = ks + kTile * Lay::kStrideK;
    const __nv_bfloat16* ksc = reinterpret_cast<const __nv_bfloat16*>(
        vs + kTile * Lay::kStrideV);
    const __nv_bfloat16* vsc = ksc + kTile;

    // S = q K^T for the warp's 16 tokens: n8 tile j holds tokens 8 j + n.
    float sc[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const unsigned char* krow = ks + (16 * warp + 8 * j + grp) * Lay::kStrideK;
#pragma unroll
      for (int l = 0; l < Lay::kKLoads; ++l) {
        unsigned w[4];
        if constexpr (Lay::kLoadBytes == 16) {
          const uint4 kv = *reinterpret_cast<const uint4*>(
              krow + 16 * k_vector<Lay::kKLoads>(tig, l));
          w[0] = kv.x;
          w[1] = kv.y;
          w[2] = kv.z;
          w[3] = kv.w;
        } else {
          const uint2 kv = *reinterpret_cast<const uint2*>(krow + 8 * tig);
          w[0] = kv.x;
          w[1] = kv.y;
          w[2] = w[3] = 0u;
        }
#pragma unroll
        for (int e = 0; e < Lay::kStepsPerLoad; ++e) {
          unsigned b0, b1;
          if constexpr (kQuant) {
            i8x4_to<TQ>(w[e], b0, b1);
          } else {
            b0 = w[2 * e];
            b1 = w[2 * e + 1];
          }
          mma<TQ>(sc[j], qa[l * Lay::kStepsPerLoad + e], b0, b1);
        }
      }
    }

    // Online softmax per warp, log2 domain; lanes of a group share a row.
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int tt = 16 * warp + 8 * j + 2 * tig + (r & 1);   // token in tile
        float s = sc[j][r] * scale_log2;
        if constexpr (kQuant) s *= __bfloat162float(ksc[tt]);
        s = (tok_begin + ti * kTile + tt < tok_end) ? s : -INFINITY;
        sc[j][r] = s;
        mx[r >> 1] = fmaxf(mx[r >> 1], s);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      m_use[h] = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = exp2f(m_run[h] - m_use[h]);
      m_run[h] = m_new;
    }
    float pv[2][4];
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float p = exp2f(sc[j][r] - m_use[r >> 1]);
        psum[r >> 1] += p;
        if constexpr (kQuant) {
          pv[j][r] = p * __bfloat162float(vsc[16 * warp + 8 * j + 2 * tig + (r & 1)]);
        } else {
          pv[j][r] = p;
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + psum[h];
#pragma unroll
    for (int i = 0; i < Lay::kNTiles; ++i) {
      acc[i][0] *= alpha[0];
      acc[i][1] *= alpha[0];
      acc[i][2] *= alpha[1];
      acc[i][3] *= alpha[1];
    }
    // P as the A operand (k = the warp's 16 tokens) in two parts P = hi +
    // lo: one 16-bit product alone puts too much row error on out.
    unsigned pa[2][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k >> 1;
      const int r = 2 * (k & 1);
      if (KG == 8 && r == 2) {
        pa[0][k] = pa[1][k] = 0u;
        continue;
      }
      split2<TV>(pv[j][r], pv[j][r + 1], pa[0][k], pa[1][k]);
    }

    // acc += P V, once the warp's V rows of tile ti landed.
    cp_async_wait<2 * S - 2>();
    __syncwarp();
    if constexpr (kQuant) {
      // Words of four head dims at tokens 2 tig, 2 tig + 1, 2 tig + 8, +9.
      const unsigned char* vrow = vs + (16 * warp + 2 * tig) * Lay::kStrideV + 4 * grp;
#pragma unroll
      for (int g4 = 0; g4 < DV / 32; ++g4) {
        unsigned w[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w[r] = *reinterpret_cast<const unsigned*>(
                     vrow + ((r & 1) + 8 * (r >> 1)) * Lay::kStrideV + 32 * g4) ^
                 0x80808080u;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float f[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            f[r] = __uint_as_float(__byte_perm(w[r], 0x4B000000u, 0x7540 | jj)) - 8388736.f;
          }
          const unsigned b0 = pack_exact(f[0], f[1]);
          const unsigned b1 = pack_exact(f[2], f[3]);
          mma<TV>(acc[4 * g4 + jj], pa[0], b0, b1);
          mma<TV>(acc[4 * g4 + jj], pa[1], b0, b1);
        }
      }
    } else {
      // ldmatrix.trans: lanes 8m..8m+7 give the rows of matrix m (tokens
      // 8 (m & 1) + r, head dims of vector 2 p + (m >> 1)).
      const unsigned char* vaddr = vs + (16 * warp + 8 * ((lane >> 3) & 1) + (lane & 7)) *
                                            Lay::kStrideV + 16 * (lane >> 4);
#pragma unroll
      for (int p = 0; p < Lay::kNTiles / 2; ++p) {
        unsigned r[4];
        ldmatrix_x4_trans(r, vaddr + 32 * p);
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          mma<TV>(acc[2 * p], pa[part], r[0], r[1]);
          mma<TV>(acc[2 * p + 1], pa[part], r[2], r[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // Merge the warps: each warp's (m, l, acc) into shared memory (the ring
  // is idle now), then one (m, l, acc) for the chunk.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
  }
  __syncthreads();   // every warp is done with the ring
  float* o_s = reinterpret_cast<float*>(smem);   // [kWarps][KG][DV]
#pragma unroll
  for (int h = 0; h < (KG == 16 ? 2 : 1); ++h) {
    const int g = grp + 8 * h;
    if (g < gn) {
      if (tig == 0) {
        m_s[warp][g] = m_run[h];
        l_s[warp][g] = l_run[h];
      }
#pragma unroll
      for (int i = 0; i < Lay::kNTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o_s[(warp * KG + g) * DV + pv_col<kQuant>(i, tig, e)] = acc[i][2 * h + e];
      }
    }
  }
  __syncthreads();

  const bool single = n_chunks == 1;
  const long long pc = (bh * max_chunks + chunk) * G + g0;                 // acc partials
  const long long pm = ((bh * Lay::kSplit + split) * max_chunks + chunk) * G + g0;  // (m, l)
  for (int i = tid; i < gn * DV; i += kThreads) {
    const int g = i / DV;
    const int d = i % DV;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_s[w][g]);
    float l = 0.f, acc_gd = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w][g] - m);   // m is finite: tile 0 has tokens
      l += l_s[w][g] * f;
      acc_gd += o_s[(w * KG + g) * DV + d] * f;
    }
    if (single) {
      out[(row0 + g0 + g) * DH + d0 + d] = from_f32<TQ>(acc_gd / l);
      if (d == 0 && split == 0) {
        m_out[row0 + g0 + g] = m * kLn2;
        l_out[row0 + g0 + g] = l;
      }
    } else {
      part_acc[(pc + g) * DH + d0 + d] = acc_gd;
      if (d == 0) {
        part_ml[2 * (pm + g)] = m;
        part_ml[2 * (pm + g) + 1] = l;
      }
    }
  }
  if (single) return;

  // The last block of this (row, kv head, head group, column block) to
  // finish merges every chunk.
  const long long ticket = bh * per_kv + sh;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[ticket], 1) == n_chunks - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  merge_chunks(part_acc + bh * max_chunks * G * DH + d0,
               part_ml + 2 * (bh * Lay::kSplit + split) * max_chunks * G,
               out + row0 * DH + d0, m_out + row0, l_out + row0,
               reinterpret_cast<float*>(smem), &l_s[0][0], n_chunks, G, g0, gn, DH, DV,
               split == 0);
  if (tid == 0) tickets[ticket] = 0;   // ready for the next call / graph replay
}

template <int QT, int POOL, int DH, int KG>
cudaError_t launch_mma(const DecodeArgs& a, cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<QT, POOL != 0, DH, KG>();
  static bool attr_set = false;   // once per instance (idempotent)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<QT, POOL, DH, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int G = a.H / a.Hkv;
  const int per_kv = (G + KG - 1) / KG * Layout<QT, POOL != 0, DH>::kSplit;
  dim3 grid(a.max_chunks * per_kv, a.Hkv, a.B);
  using T = typename Layout<QT, POOL != 0, DH>::T;
  using TQ = typename QType<QT>::T;
  paged_decode_kernel<QT, POOL, DH, KG><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const TQ*>(a.q), static_cast<const T*>(a.k_pool),
      static_cast<const T*>(a.v_pool), a.k_scale, a.v_scale, a.block_tables, a.kv_lens,
      static_cast<TQ*>(a.out), a.m_out, a.l_out, a.part_acc, a.part_ml, a.tickets,
      a.launches, a.H, a.Hkv, a.num_slots, a.layer, a.mb, a.bs_shift, a.chunk_tiles,
      a.max_chunks, a.scale);
  return cudaGetLastError();
}

template <int QT, int POOL, int DH, int KG>
cudaError_t occupancy_mma(int* blocks_per_sm, int* smem) {
  constexpr int kSmem = smem_bytes<QT, POOL != 0, DH, KG>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<QT, POOL, DH, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmem);
  if (err != cudaSuccess) return err;
  *smem = kSmem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, paged_decode_kernel<QT, POOL, DH, KG>, kThreads, kSmem);
}

// The tensor-core instances (q dtype 0 bf16 / 1 f16, POOL, Dh, M rows),
// one list per translation unit. KG 8 serves G <= 8 where an instance has
// it; every other G runs KG 16 (in head groups past 16). One-token pages
// exist at Dh >= 128 only (the gate's pack factor).
#define PSTPU_MMA_BF16(X) \
  X(0, 0, 32, 16) X(0, 0, 64, 8) X(0, 0, 64, 16) X(0, 0, 128, 8) X(0, 0, 128, 16) X(0, 0, 256, 16)
#define PSTPU_MMA_BF16_INT8(X)                                                              \
  X(0, 1, 32, 16) X(0, 1, 64, 8) X(0, 1, 64, 16) X(0, 1, 128, 8) X(0, 1, 128, 16) X(0, 1, 256, 16) \
  X(0, 2, 128, 16) X(0, 2, 256, 16)
#define PSTPU_MMA_F16(X) X(1, 0, 32, 16) X(1, 0, 64, 16) X(1, 0, 128, 16) X(1, 0, 256, 16)
#define PSTPU_MMA_F16_INT8(X)                                                   \
  X(1, 1, 32, 16) X(1, 1, 64, 16) X(1, 1, 128, 16) X(1, 1, 256, 16) X(1, 2, 128, 16) \
  X(1, 2, 256, 16)
#define PSTPU_MMA_ALL(X) \
  PSTPU_MMA_BF16(X) PSTPU_MMA_BF16_INT8(X) PSTPU_MMA_F16(X) PSTPU_MMA_F16_INT8(X)

// Each instance's entry: a launch when `a` is given, else its occupancy.
#define PSTPU_MMA_FN(QT, POOL, DH, KG) mma_##QT##_##POOL##_##DH##_##KG
#define PSTPU_MMA_DECLARE(QT, POOL, DH, KG)                                   \
  cudaError_t PSTPU_MMA_FN(QT, POOL, DH, KG)(const DecodeArgs* a, cudaStream_t st, \
                                             int* blocks_per_sm, int* smem);
#define PSTPU_MMA_DEFINE(QT, POOL, DH, KG)                                    \
  cudaError_t PSTPU_MMA_FN(QT, POOL, DH, KG)(const DecodeArgs* a, cudaStream_t st, \
                                             int* blocks_per_sm, int* smem) { \
    return a ? launch_mma<QT, POOL, DH, KG>(*a, st)                           \
             : occupancy_mma<QT, POOL, DH, KG>(blocks_per_sm, smem);          \
  }

PSTPU_MMA_ALL(PSTPU_MMA_DECLARE)

}  // namespace pstpu
