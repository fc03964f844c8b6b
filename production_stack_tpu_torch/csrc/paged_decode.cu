// Paged flash-decode over the layer-stacked KV pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel production_stack_tpu/ops/pallas/paged_attention.py:
// _decode_kernel (reached through paged_flash_decode_stats), both its bf16
// branch and its quantized=True branch (int8 pools). It computes, for ONE
// layer of the pool [L, Hkv, num_slots, Dh], the attention of one decode
// query per sequence [H, Dh] against that sequence's pages (slot j of the
// page list holds absolute position j; keys at positions >= kv_len are
// masked), and returns the normalized output plus the softmax stats
// (running max m, sum l) so the caller can flash-merge it with the
// in-dispatch ring segment. A row with kv_len == 0 returns (0, -inf, 0).
//
// What bounds it on this card: HBM bytes. Each row and layer reads
// 2 * kv_len * Hkv * Dh * 2 B of bf16 K/V (int8: Dh + 2 B of payload and
// scale per slot and head, about half) and does ~4 * kv_len * H * Dh flops,
// far below the ~295 flops per byte where an H100 turns compute-bound. At
// decode sizes the bytes are few (23 MB at the served batch), so what is
// left to beat is latency: each tile's copy round trip, barriers, launches.
//
// Two kernels share the work split and the merge below; the host picks one
// by shape, never on a failure. paged_decode_kernel (tensor cores) takes bf16
// q over bf16 or int8 pools at Dh 64 or 128, at most 16 query heads per kv
// head and block sizes >= 2; paged_decode_generic (CUDA cores, further down)
// takes every other shape and dtype the Pallas kernel's gate admits.
//
// The design of paged_decode_kernel, one launch per call:
// - Work follows each row's own length, decided on the device: a block
//   takes a fixed chunk of `chunk_tiles` 64-token tiles of one (row, kv
//   head); row b gets ceil(tiles_b / chunk_tiles) chunks. The grid is
//   (max chunks, Hkv, B), sized on the host from the block-table width;
//   blocks past their row's chunks exit at once. No host read of kv_lens.
// - A block first reads its chunk's block-table entries once into shared
//   memory (page = token >> log2(bs)), then streams its tiles through a
//   ring of 2-4 shared-memory stages with 16-byte cp.async. Each warp
//   copies its own 16 rows of every tile, K and V as two commit groups, so
//   __syncwarp orders a stage and no block barrier runs per tile: the
//   copies of tile i+S-1 are in flight while tile i is scored, and tile
//   i's V lands while its scores run.
//   Positions past kv_len are zero-filled in every stage (payload and int8
//   scales), so a stale slot, NaN included, never reaches the result and
//   no stage carries data of an earlier tile.
// - Four warps split each tile (16 tokens each) and run tensor-core
//   mma.sync.m16n8k16 (bf16 in, fp32 accumulate): S = q K^T with the G <= 16
//   query heads of the kv head as the M rows (padded rows zero) and q in
//   bf16 unscaled (exact), the fp32 score times scale (and the slot's K
//   scale); then the weights P (int8: P times the slot's V scale), split
//   into two bf16 parts P = hi + lo, times V: a single bf16 rounding of P,
//   as the TPU's MXU does at default precision, costs ~3e-3 of row error
//   on out against fp32 weights, too close to the check's 5e-3.
//   The contraction axis of QK^T is permuted so that each lane reads K with
//   plain 16-byte loads, conflict-free on the padded rows; bf16 V goes
//   through ldmatrix.trans, int8 V through 32-bit loads of four columns.
//   int8 K/V turn into bf16 exactly (|k| <= 127) on the way into the
//   fragments. Each warp keeps its own online softmax (m, l, acc) in
//   registers, in the log2 domain; the warps merge through shared memory.
// - The splits merge inside the kernel: each block writes its partial
//   (m, l, acc) to a per-device scratch, and the last block of a (row, kv
//   head) to finish (a __threadfence plus an atomic ticket) merges them,
//   writes out/m/l and resets the ticket to 0 for the next call or graph
//   replay. A row with one chunk writes its output directly.
//
// Numerics follow the Pallas kernel up to rounding: fp32 scores and
// sums, masked keys at -inf, l sums the unrounded, unscaled weights. Int8
// pools dequantize as rank-1 factors, never materializing bf16 K/V in HBM.
// Block-table entries past cdiv(kv_len, block_size) are never read.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <vector>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;                // tokens per tile (16 per warp)
constexpr int kMaxGroup = 16;            // query heads per kv head (M rows)
constexpr int kMaxChunkTiles = 8;        // tiles per block, at most
constexpr int kMaxPages = kMaxChunkTiles * kTile / 2 + 1;  // block size >= 2
constexpr int kRingBudget = 70 * 1024;   // shared bytes for the tile ring
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int DH>
struct Layout {
  static constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static constexpr int kElt = sizeof(T);
  static constexpr int kEpu = 16 / kElt;                 // elements per 16 B
  static constexpr int kRowUnits = DH / kEpu;            // 16-byte vectors per row
  // Rows padded by 16 B keep the lane patterns below conflict-free; the
  // int8 Dh=64 K rows (64 B) are conflict-free unpadded.
  static constexpr int kStrideK = (kQuant && DH == 64) ? 64 : DH * kElt + 16;
  static constexpr int kStrideV = DH * kElt + 16;
  static constexpr int kScaleBytes = kQuant ? kTile * 2 : 0;
  static constexpr int kStageBytes =
      kTile * kStrideK + kTile * kStrideV + 2 * kScaleBytes;
  static constexpr int kStagesRaw = kRingBudget / kStageBytes;
  static constexpr int kStages = kStagesRaw < 2 ? 2 : (kStagesRaw > 4 ? 4 : kStagesRaw);
  // K is read by each lane as kKLoads 16-byte vectors of its token row; each
  // vector feeds kStepsPerLoad k16 steps of the QK^T product.
  static constexpr int kKLoads = DH * kElt / 64;
  static constexpr int kStepsPerLoad = kEpu / 4;
  static constexpr int kKSteps = DH / 16;
  static constexpr int kNTiles = DH / 8;                 // PV n8 tiles
  static_assert(kKLoads * kStepsPerLoad == kKSteps, "k steps");
};

template <typename T, int DH, int KG>
constexpr int smem_bytes() {
  return Layout<T, DH>::kStages * Layout<T, DH>::kStageBytes >
                 kWarps * KG * DH * 4
             ? Layout<T, DH>::kStages * Layout<T, DH>::kStageBytes
             : kWarps * KG * DH * 4;
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

// D += A * B, m16n8k16, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned* a, unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned* r, const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// (x, y) as bf16x2 hi = bf16(x, y) and lo = bf16(x - hi.x, y - hi.y).
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(x - __low2float(h), y - __high2float(h));
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
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

// bf16x2 pairs (bytes 0,1) and (bytes 2,3) of an int8 word.
__device__ __forceinline__ void i8x4_to_bf16(unsigned w, unsigned& b0, unsigned& b1) {
  w ^= 0x80808080u;
  b0 = pack_exact(i8_to_f32<0>(w), i8_to_f32<1>(w));
  b1 = pack_exact(i8_to_f32<2>(w), i8_to_f32<3>(w));
}

// The 16-byte vector of its K row that lane group position `tig` reads on
// load l: vectors 2*tig, 2*tig+1, 2*tig+8, 2*tig+9 (one vector per lane when
// a row holds only four), so the 8 lanes of a quarter-warp (two rows whose
// padded stride is an odd number of vectors) hit 8 distinct bank groups.
template <int KLOADS>
__device__ __forceinline__ int k_vector(int tig, int l) {
  return KLOADS == 1 ? tig : 2 * tig + (l & 1) + 8 * (l >> 1);
}

// Head dim of PV output column e (0, 1) of n8 tile nt for lane group
// position tig: bf16 V (ldmatrix.trans) keeps the natural order; int8 V is
// read as 32-bit words of four columns, so tile nt = 4 * grp + j holds
// columns 32 * grp + 4 * n + j.
template <bool QUANT>
__device__ __forceinline__ int pv_col(int nt, int tig, int e) {
  const int n = 2 * tig + e;
  return QUANT ? 32 * (nt >> 2) + 4 * n + (nt & 3) : 8 * nt + n;
}

// Element conversions of the generic kernel's types: q and out in the
// compute dtype (bf16, f16 or f32), pools in it or in int8.
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

// Run by the last block of a (row, kv head, head group) to finish: every
// chunk's partial (m, l) of heads g0 .. g0 + gn - 1 into shared memory
// (w_s: n_chunks * gn * 2 floats; m in the log2 domain), then per head the
// max M and the chunk weights exp2(m_c - M), then acc summed over the
// chunks and normalized. l_s holds gn floats.
template <typename TO>
__device__ __forceinline__ void merge_chunks(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    TO* __restrict__ out, float* __restrict__ m_out, float* __restrict__ l_out,
    float* w_s, float* l_s, long long pc0, long long row0, int n_chunks, int G,
    int g0, int gn, int DH) {
  const int tid = threadIdx.x;
  for (int i = tid; i < n_chunks * gn * 2; i += kThreads) {
    const int c = i / (2 * gn);
    w_s[i] = __ldcg(part_ml + 2 * (pc0 + (long long)c * G + g0) + i % (2 * gn));
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
    m_out[row0 + g0 + tid] = m * kLn2;
    l_out[row0 + g0 + tid] = l;
    l_s[tid] = l;
  }
  __syncthreads();
  for (int i = tid; i < gn * DH; i += kThreads) {
    const int g = i / DH;
    float a = 0.f;
#pragma unroll 8
    for (int c = 0; c < n_chunks; ++c)
      a += __ldcg(part_acc + (pc0 + (long long)c * G + g0) * DH + i) * w_s[2 * (c * gn + g)];
    out[(row0 + g0) * DH + i] = from_f32<TO>(a / l_s[g]);
  }
}

// One block: kv head `kvh` of row `b`, chunk `chunk` of that row's tiles,
// the G <= KG query heads of that kv head (KG = 8 or 16 M rows in use).
template <typename T, int DH, int KG>
__global__ void __launch_bounds__(kThreads, 3)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,        // [B, H, DH]
                    const T* __restrict__ k_pool,               // [L, Hkv, NS, DH]
                    const T* __restrict__ v_pool,               // [L, Hkv, NS, DH]
                    const __nv_bfloat16* __restrict__ k_scale,  // [L, Hkv, NS] | null
                    const __nv_bfloat16* __restrict__ v_scale,  // [L, Hkv, NS] | null
                    const int* __restrict__ block_tables,       // [B, mb]
                    const int* __restrict__ kv_lens,            // [B]
                    __nv_bfloat16* __restrict__ out,            // [B, H, DH]
                    float* __restrict__ m_out,                  // [B, H]
                    float* __restrict__ l_out,                  // [B, H]
                    float* __restrict__ part_acc,   // [B*Hkv, max_chunks, G, DH]
                    float* __restrict__ part_ml,    // [B*Hkv, max_chunks, G, 2]
                    int* __restrict__ tickets,      // [B*Hkv], 0 between calls
                    unsigned long long* __restrict__ launches,  // this variant's count
                    int H, int Hkv, long long num_slots, int layer, int mb,
                    int bs_shift, int chunk_tiles, int max_chunks, float scale) {
  using Lay = Layout<T, DH>;
  constexpr bool kQuant = Lay::kQuant;
  constexpr int S = Lay::kStages;
  static_assert(KG == 8 || KG == 16, "8 or 16 M rows");
  static_assert(kTile == kWarps * 16, "16 tokens per warp and tile");

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int page_s[kMaxPages];
  __shared__ float m_s[kWarps][KG];
  __shared__ float l_s[kWarps][KG];
  __shared__ int last_s;

  const int chunk = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int grp = lane >> 2;   // mma group: M row, n column
  const int tig = lane & 3;    // position in the group
  const int bs = 1 << bs_shift;
  const long long bh = (long long)b * Hkv + kvh;
  const long long row0 = (long long)b * H + (long long)kvh * G;  // first head
  // One count per launch, taken on the device: a CUDA-graph replay of a
  // captured call counts as the call did.
  if (tid == 0 && chunk == 0 && kvh == 0 && b == 0) atomicAdd(launches, 1ull);

  // q fragments (A operand, bf16 unscaled), loaded first so that their
  // latency overlaps the kv_len and block-table reads, in the permuted
  // contraction order of the K loads: k step s of lane (grp, tig) covers
  // head dims dq, dq+1 (k = 2 tig, 2 tig + 1), dq+2, dq+3 (k = 8 + 2 tig..).
  unsigned qa[Lay::kKSteps][4];
  {
    const __nv_bfloat16* qb = q + row0 * DH;
#pragma unroll
    for (int s = 0; s < Lay::kKSteps; ++s) {
      const int l = s / Lay::kStepsPerLoad;
      const int dq = k_vector<Lay::kKLoads>(tig, l) * Lay::kEpu + 4 * (s % Lay::kStepsPerLoad);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int g = grp + 8 * h;
        unsigned lo = 0, hi = 0;
        if ((h == 0 || KG == 16) && g < G) {
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
      for (int i = tid; i < G * DH; i += kThreads) out[row0 * DH + i] = __float2bfloat16(0.f);
      if (tid < G) {
        m_out[row0 + tid] = -INFINITY;
        l_out[row0 + tid] = 0.f;
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
  const T* v_head = v_pool + head_base * DH;

  auto slot_of = [&](int tok) -> long long {
    return ((long long)page_s[(tok >> bs_shift) - page0] << bs_shift) | (tok & (bs - 1));
  };

  // Each warp streams its own 16 tokens of every tile through its rows of
  // the ring, so only __syncwarp orders a stage, never a block barrier.
  // Tile ti -> stage st: payload rows zero-filled past tok_end; int8: the
  // 16 K and 16 V scales in slot pairs (block sizes are even, so a pair
  // never straddles a page), zeroed past tok_end.
  auto issue = [&](int ti, int st, bool v) {
    unsigned char* dst = smem + st * Lay::kStageBytes + (v ? kTile * Lay::kStrideK : 0);
    const int stride = v ? Lay::kStrideV : Lay::kStrideK;
    const T* src_head = v ? v_head : k_head;
    const int t0 = tok_begin + ti * kTile + 16 * warp;
    const int n_valid = tok_end - t0;
#pragma unroll
    for (int c = lane; c < 16 * Lay::kRowUnits; c += 32) {
      const int tt = c / Lay::kRowUnits;
      const int vec = c % Lay::kRowUnits;
      const bool valid = tt < n_valid;
      const long long off = valid ? slot_of(t0 + tt) * DH + vec * Lay::kEpu : 0;
      cp_async16(dst + (16 * warp + tt) * stride + vec * 16, src_head + off, valid);
    }
    if constexpr (kQuant) {
      // Both scale rows travel with K: the softmax reads the V scales.
      if (!v && lane < 16) {
        unsigned char* sc = smem + st * Lay::kStageBytes + kTile * Lay::kStrideK +
                            kTile * Lay::kStrideV + (lane >> 3) * Lay::kScaleBytes;
        const int j = lane & 7;
        const int n = min(max(n_valid - 2 * j, 0), 2);
        const __nv_bfloat16* src = (lane >> 3) ? v_scale : k_scale;
        src += n ? head_base + slot_of(t0 + 2 * j) : 0;
        cp_async4(sc + 32 * warp + 4 * j, src, 2 * n);
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
        const uint4 kv = *reinterpret_cast<const uint4*>(
            krow + 16 * k_vector<Lay::kKLoads>(tig, l));
        const unsigned w[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
        for (int e = 0; e < Lay::kStepsPerLoad; ++e) {
          unsigned b0, b1;
          if constexpr (kQuant) {
            i8x4_to_bf16(w[e], b0, b1);
          } else {
            b0 = w[2 * e];
            b1 = w[2 * e + 1];
          }
          mma_bf16(sc[j], qa[l * Lay::kStepsPerLoad + e], b0, b1);
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
    // P as the A operand (k = the warp's 16 tokens) in two bf16 parts,
    // P = hi + lo: one bf16 product alone puts ~3e-3 of row error on out.
    unsigned pa[2][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = k >> 1;
      const int r = 2 * (k & 1);
      if (KG == 8 && r == 2) {
        pa[0][k] = pa[1][k] = 0u;
        continue;
      }
      split_bf16(pv[j][r], pv[j][r + 1], pa[0][k], pa[1][k]);
    }

    // acc += P V, once the warp's V rows of tile ti landed.
    cp_async_wait<2 * S - 2>();
    __syncwarp();
    if constexpr (kQuant) {
      // Words of four head dims at tokens 2 tig, 2 tig + 1, 2 tig + 8, +9.
      const unsigned char* vrow = vs + (16 * warp + 2 * tig) * Lay::kStrideV + 4 * grp;
#pragma unroll
      for (int g4 = 0; g4 < DH / 32; ++g4) {
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
          mma_bf16(acc[4 * g4 + jj], pa[0], b0, b1);
          mma_bf16(acc[4 * g4 + jj], pa[1], b0, b1);
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
          mma_bf16(acc[2 * p], pa[part], r[0], r[1]);
          mma_bf16(acc[2 * p + 1], pa[part], r[2], r[3]);
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
  float* o_s = reinterpret_cast<float*>(smem);   // [kWarps][KG][DH]
#pragma unroll
  for (int h = 0; h < (KG == 16 ? 2 : 1); ++h) {
    const int g = grp + 8 * h;
    if (g < G) {
      if (tig == 0) {
        m_s[warp][g] = m_run[h];
        l_s[warp][g] = l_run[h];
      }
#pragma unroll
      for (int i = 0; i < Lay::kNTiles; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e)
          o_s[(warp * KG + g) * DH + pv_col<kQuant>(i, tig, e)] = acc[i][2 * h + e];
      }
    }
  }
  __syncthreads();

  const bool single = n_chunks == 1;
  for (int i = tid; i < G * DH; i += kThreads) {
    const int g = i / DH;
    const int d = i % DH;
    float m = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, m_s[w][g]);
    float l = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = exp2f(m_s[w][g] - m);   // m is finite: tile 0 has tokens
      l += l_s[w][g] * f;
      a += o_s[(w * KG + g) * DH + d] * f;
    }
    if (single) {
      out[(row0 + g) * DH + d] = __float2bfloat16(a / l);
      if (d == 0) {
        m_out[row0 + g] = m * kLn2;
        l_out[row0 + g] = l;
      }
    } else {
      const long long pc = (bh * max_chunks + chunk) * G + g;
      part_acc[pc * DH + d] = a;
      if (d == 0) {
        part_ml[2 * pc] = m;
        part_ml[2 * pc + 1] = l;
      }
    }
  }
  if (single) return;

  // The last block of this (row, kv head) to finish merges every chunk.
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[bh], 1) == n_chunks - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  merge_chunks(part_acc, part_ml, out, m_out, l_out, reinterpret_cast<float*>(smem),
               &l_s[0][0], bh * max_chunks * G, row0, n_chunks, G, 0, G, DH);
  if (tid == 0) tickets[bh] = 0;   // ready for the next call / graph replay
}

// ---------------------------------------------------------------------------
// The generic kernel: the rest of the Pallas kernel's domain, which the
// mma.sync kernel above does not take: q in float16 or float32 (over pools
// in that dtype or int8 with bf16 scales), any head dim the gate admits
// (1 .. 64 dividing 128, or a multiple of 128), any number of query heads
// per kv head, block size 1, and bf16 at those shapes. Same work split,
// merge and numerics contract (fp32 scores and sums, masked keys at -inf,
// l over the unscaled weights; the log2 domain inside), on CUDA cores in
// full fp32: no tensor-core product, so float32 keeps float32 accuracy.
//
// One block: kv head `kvh` of row `b`, chunk `chunk`, query heads g0 ..
// g0 + gn - 1 of that kv head (a head group of at most kGenHeads; groups of
// one kv head each read its K/V). q and acc live in shared memory as fp32
// [hb][Dh]; per 64-token tile: (A) each warp scores 16 tokens, 4 at a
// time, its lanes across Dh reading K rows straight from the pool
// (coalesced), one warp reduction per token and head; (B) one warp per
// head updates the online softmax; (C) threads own head-dim columns (for
// Dh < 128, 128 / Dh thread groups split the tokens and reduce through
// shared memory) and read V rows the same way. What bounds it: the
// latency of those dependent loads and reductions, not bytes. No staging
// ring, no tensor cores: a first, simple design.
constexpr int kGenHeads = 8;                          // query heads per block, at most
constexpr int kGenTok = 4;                            // tokens a warp scores at once
constexpr int kGenMaxPages = kMaxChunkTiles * kTile + 1;  // block size >= 1
constexpr int kGenSmemBudget = 200 * 1024;            // dynamic shared bytes, at most

template <int QT> struct QType;   // 0 bf16, 1 f16, 2 f32
template <> struct QType<0> { using T = __nv_bfloat16; };
template <> struct QType<1> { using T = __half; };
template <> struct QType<2> { using T = float; };

// Dynamic shared memory: q and acc [hb][Dh] fp32, later the chunk merge's
// weights [max_chunks][hb][2].
inline int generic_smem_bytes(int Dh, int hb, int max_chunks) {
  const long long a = 2LL * hb * Dh * 4, b = 8LL * max_chunks * hb;
  const long long n = a > b ? a : b;
  return n > (1 << 30) ? (1 << 30) : static_cast<int>(n);
}

template <int QT, bool QUANT>
__global__ void __launch_bounds__(kThreads)
paged_decode_generic(const typename QType<QT>::T* __restrict__ q,   // [B, H, DH]
                     const void* __restrict__ k_pool_,              // [L, Hkv, NS, DH]
                     const void* __restrict__ v_pool_,
                     const __nv_bfloat16* __restrict__ k_scale,     // [L, Hkv, NS] | null
                     const __nv_bfloat16* __restrict__ v_scale,
                     const int* __restrict__ block_tables,          // [B, mb]
                     const int* __restrict__ kv_lens,               // [B]
                     typename QType<QT>::T* __restrict__ out,       // [B, H, DH]
                     float* __restrict__ m_out, float* __restrict__ l_out,
                     float* __restrict__ part_acc, float* __restrict__ part_ml,
                     int* __restrict__ tickets,   // [B*Hkv*groups], 0 between calls
                     unsigned long long* __restrict__ launches,
                     int H, int Hkv, int DH, int hb, long long num_slots, int layer,
                     int mb, int bs_shift, int chunk_tiles, int max_chunks, float scale) {
  using TQ = typename QType<QT>::T;
  using TP = typename std::conditional<QUANT, int8_t, TQ>::type;
  const TP* k_pool = static_cast<const TP*>(k_pool_);
  const TP* v_pool = static_cast<const TP*>(v_pool_);

  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_s[kGenHeads][kTile];          // scores, then weights
  __shared__ float red_s[kGenHeads * kThreads];    // PV partials when Dh < 128
  __shared__ long long slot_s[kTile];
  __shared__ float vsc_s[kTile];
  __shared__ float m_s[kGenHeads], l_s[kGenHeads], alpha_s[kGenHeads];
  __shared__ int page_s[kGenMaxPages];
  __shared__ int last_s;
  float* q_s = reinterpret_cast<float*>(smem);     // [hb][DH]
  float* acc_s = q_s + hb * DH;                    // [hb][DH]

  const int G = H / Hkv;
  const int groups = (G + hb - 1) / hb;
  const int chunk = blockIdx.x;
  const int kvh = blockIdx.y / groups;
  const int hg = blockIdx.y % groups;
  const int b = blockIdx.z;
  const int g0 = hg * hb;
  const int gn = min(hb, G - g0);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bs = 1 << bs_shift;
  const long long bh = (long long)b * Hkv + kvh;
  const long long row0 = (long long)b * H + (long long)kvh * G;   // first head of kvh
  if (tid == 0 && chunk == 0 && blockIdx.y == 0 && b == 0) atomicAdd(launches, 1ull);

  const int kv_len = min(kv_lens[b], mb << bs_shift);
  const int n_tiles = (kv_len + kTile - 1) / kTile;
  const int n_chunks = (n_tiles + chunk_tiles - 1) / chunk_tiles;
  if (n_chunks == 0) {
    if (chunk == 0) {   // empty row: (0, -inf, 0)
      for (int i = tid; i < gn * DH; i += kThreads) out[(row0 + g0) * DH + i] = from_f32<TQ>(0.f);
      if (tid < gn) {
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
  const int page0 = tok_begin >> bs_shift;
  const int n_pages = ((tok_end - 1) >> bs_shift) - page0 + 1;
  const int* bt = block_tables + (long long)b * mb;
  for (int i = tid; i < n_pages; i += kThreads) page_s[i] = bt[page0 + i];
  for (int i = tid; i < hb * DH; i += kThreads) {
    q_s[i] = i < gn * DH ? to_f32(q[(row0 + g0) * DH + i]) : 0.f;
    acc_s[i] = 0.f;
  }
  if (tid < kGenHeads) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();

  const long long head_base = ((long long)layer * Hkv + kvh) * num_slots;
  const TP* k_head = k_pool + head_base * DH;
  const TP* v_head = v_pool + head_base * DH;
  const float scale_log2 = scale * kLog2e;
  // PV: `cols` columns per pass; for Dh < 128, `splits` thread groups
  // share the tokens and reduce through red_s.
  const int cols = DH < kThreads ? DH : kThreads;
  const int splits = kThreads / cols;

  for (int ti = 0; ti < tiles; ++ti) {
    const int t0 = tok_begin + ti * kTile;
    const int n_tok = min(kTile, tok_end - t0);
    // (A) scores of the warp's 16 tokens, kGenTok at a time (their K loads
    // in flight together), fp32 q . k times scale (and the slot's K
    // scale), log2 domain. A token past the tile's end re-reads the last
    // one and is never stored.
    for (int k0 = 0; k0 < 16; k0 += kGenTok) {
      const int tt0 = 16 * warp + k0;
      if (tt0 >= n_tok) break;
      long long slot[kGenTok];
#pragma unroll
      for (int u = 0; u < kGenTok; ++u) {
        const int tok = t0 + min(tt0 + u, n_tok - 1);
        slot[u] = ((long long)page_s[(tok >> bs_shift) - page0] << bs_shift) | (tok & (bs - 1));
      }
      float part[kGenTok][kGenHeads];
#pragma unroll
      for (int u = 0; u < kGenTok; ++u)
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j) part[u][j] = 0.f;
      for (int d = lane; d < DH; d += 32) {
        float kd[kGenTok];
#pragma unroll
        for (int u = 0; u < kGenTok; ++u) kd[u] = to_f32(k_head[slot[u] * DH + d]);
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j) {
          if (j < gn) {
            const float qv = q_s[j * DH + d];
#pragma unroll
            for (int u = 0; u < kGenTok; ++u) part[u][j] = fmaf(qv, kd[u], part[u][j]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kGenTok; ++u)
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j)
          if (j < gn) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
              part[u][j] += __shfl_xor_sync(0xffffffffu, part[u][j], o);
          }
      if (lane < kGenTok && tt0 + lane < n_tok) {
        // Lane u stores token tt0 + u (every lane holds every sum).
        const int tt = tt0 + lane;
        long long my_slot = slot[0];
        float sc[kGenHeads];
#pragma unroll
        for (int u = 0; u < kGenTok; ++u)
          if (u == lane) {
            my_slot = slot[u];
#pragma unroll
            for (int j = 0; j < kGenHeads; ++j) sc[j] = part[u][j];
          }
        float ks = 1.f;
        if (QUANT) {
          ks = __bfloat162float(k_scale[head_base + my_slot]);
          vsc_s[tt] = __bfloat162float(v_scale[head_base + my_slot]);
        }
        slot_s[tt] = my_slot;
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j)
          if (j < gn) s_s[j][tt] = sc[j] * scale_log2 * ks;
      }
    }
    __syncthreads();
    // (B) online softmax, one warp per head: weights into s_s (int8: times
    // the slot's V scale), l over the unscaled weights.
    for (int j = warp; j < gn; j += kWarps) {
      const float s0 = lane < n_tok ? s_s[j][lane] : -INFINITY;
      const float s1 = lane + 32 < n_tok ? s_s[j][lane + 32] : -INFINITY;
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = exp2f(s0 - m_use);
      const float p1 = exp2f(s1 - m_use);
      float ps = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      if (lane < n_tok) s_s[j][lane] = QUANT ? p0 * vsc_s[lane] : p0;
      if (lane + 32 < n_tok) s_s[j][lane + 32] = QUANT ? p1 * vsc_s[lane + 32] : p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        alpha_s[j] = alpha;
        l_s[j] = l_s[j] * alpha + ps;
        m_s[j] = m_new;
      }
    }
    __syncthreads();
    // (C) acc = acc * alpha + P V.
    if (splits == 1) {
      for (int d = tid; d < DH; d += kThreads) {
        float a[kGenHeads];
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j) a[j] = j < gn ? acc_s[j * DH + d] * alpha_s[j] : 0.f;
#pragma unroll 4
        for (int tt = 0; tt < n_tok; ++tt) {
          const float vd = to_f32(v_head[slot_s[tt] * DH + d]);
#pragma unroll
          for (int j = 0; j < kGenHeads; ++j)
            if (j < gn) a[j] = fmaf(s_s[j][tt], vd, a[j]);
        }
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j)
          if (j < gn) acc_s[j * DH + d] = a[j];
      }
    } else {
      const int d = tid % cols;
      const int sp = tid / cols;
      if (sp < splits) {
        float a[kGenHeads];
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j) a[j] = 0.f;
#pragma unroll 4
        for (int tt = sp; tt < n_tok; tt += splits) {
          const float vd = to_f32(v_head[slot_s[tt] * DH + d]);
#pragma unroll
          for (int j = 0; j < kGenHeads; ++j)
            if (j < gn) a[j] = fmaf(s_s[j][tt], vd, a[j]);
        }
#pragma unroll
        for (int j = 0; j < kGenHeads; ++j)
          if (j < gn) red_s[(sp * kGenHeads + j) * cols + d] = a[j];
      }
      __syncthreads();
      for (int i = tid; i < gn * DH; i += kThreads) {
        const int j = i / DH;
        float a = acc_s[i] * alpha_s[j];
        for (int s = 0; s < splits; ++s) a += red_s[(s * kGenHeads + j) * cols + i % DH];
        acc_s[i] = a;
      }
    }
    __syncthreads();
  }

  // The chunk's result: out, m, l directly when the row has one chunk,
  // else its partial for the merge.
  const bool single = n_chunks == 1;
  const long long pc = (bh * max_chunks + chunk) * G + g0;
  for (int i = tid; i < gn * DH; i += kThreads) {
    if (single) {
      out[(row0 + g0) * DH + i] = from_f32<TQ>(acc_s[i] / l_s[i / DH]);
    } else {
      part_acc[pc * DH + i] = acc_s[i];
    }
  }
  if (tid < gn) {
    if (single) {
      m_out[row0 + g0 + tid] = m_s[tid] * kLn2;
      l_out[row0 + g0 + tid] = l_s[tid];
    } else {
      part_ml[2 * (pc + tid)] = m_s[tid];
      part_ml[2 * (pc + tid) + 1] = l_s[tid];
    }
  }
  if (single) return;

  // The last block of this (row, kv head, head group) merges every chunk.
  const long long ticket = bh * groups + hg;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_s = atomicAdd(&tickets[ticket], 1) == n_chunks - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  merge_chunks(part_acc, part_ml, out, m_out, l_out, reinterpret_cast<float*>(smem), l_s,
               bh * max_chunks * G, row0, n_chunks, G, g0, gn, DH);
  if (tid == 0) tickets[ticket] = 0;   // ready for the next call / graph replay
}

template <typename T, int DH, int KG>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* kv_lens, void* out,
                   void* m_out, void* l_out, void* part_acc, void* part_ml,
                   void* tickets, void* launches, int B, int H, int Hkv,
                   long long num_slots, int layer, int mb, int bs_shift,
                   int chunk_tiles, int max_chunks, float scale,
                   cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T, DH, KG>();
  static bool attr_set = false;   // once per instance (idempotent)
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, DH, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  dim3 grid(max_chunks, Hkv, B);
  paged_decode_kernel<T, DH, KG><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(tickets),
      static_cast<unsigned long long*>(launches), H, Hkv,
      num_slots, layer, mb, bs_shift, chunk_tiles, max_chunks, scale);
  return cudaGetLastError();
}

template <typename T, int DH, int KG>
cudaError_t occupancy(int* blocks_per_sm, int* smem) {
  constexpr int kSmem = smem_bytes<T, DH, KG>();
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T, DH, KG>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  *smem = kSmem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, paged_decode_kernel<T, DH, KG>, kThreads, kSmem);
}

bool valid_args(int B, int H, int Hkv, int mb, int bs_shift, int chunk_tiles,
                int max_chunks) {
  return B >= 1 && Hkv >= 1 && H % Hkv == 0 && H / Hkv <= kMaxGroup && mb >= 1 &&
         bs_shift >= 1 && bs_shift <= 9 && chunk_tiles >= 1 &&
         chunk_tiles <= kMaxChunkTiles && B <= 65535 && Hkv <= 65535 &&
         (long long)max_chunks * chunk_tiles * kTile >= ((long long)mb << bs_shift);
}

// Head dim and query heads per kv head -> the template instance.
template <typename T>
cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const void* k_scale, const void* v_scale,
                     const void* block_tables, const void* kv_lens, void* out,
                     void* m_out, void* l_out, void* part_acc, void* part_ml,
                     void* tickets, void* launches, int B, int H, int Hkv,
                     int Dh, long long num_slots, int layer, int mb, int bs_shift,
                     int chunk_tiles, int max_chunks, float scale, void* stream) {
  if (launches == nullptr ||
      !valid_args(B, H, Hkv, mb, bs_shift, chunk_tiles, max_chunks))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
#define PSTPU_LAUNCH(DH_, KG_)                                                      \
  return launch<T, DH_, KG_>(q, k_pool, v_pool, k_scale, v_scale, block_tables,    \
                             kv_lens, out, m_out, l_out, part_acc, part_ml,        \
                             tickets, launches, B, H, Hkv, num_slots, layer, mb,   \
                             bs_shift, chunk_tiles, max_chunks, scale, st)
  if (Dh == 64) {
    if (G <= 8) PSTPU_LAUNCH(64, 8);
    PSTPU_LAUNCH(64, 16);
  }
  if (Dh == 128) {
    if (G <= 8) PSTPU_LAUNCH(128, 8);
    PSTPU_LAUNCH(128, 16);
  }
#undef PSTPU_LAUNCH
  return cudaErrorInvalidValue;
}

template <int QT, bool QUANT>
cudaError_t launch_generic(const void* q, const void* k_pool, const void* v_pool,
                           const void* k_scale, const void* v_scale,
                           const void* block_tables, const void* kv_lens, void* out,
                           void* m_out, void* l_out, void* part_acc, void* part_ml,
                           void* tickets, void* launches, int B, int H, int Hkv, int Dh,
                           int hb, long long num_slots, int layer, int mb, int bs_shift,
                           int chunk_tiles, int max_chunks, float scale,
                           cudaStream_t stream) {
  using TQ = typename QType<QT>::T;
  const int smem = generic_smem_bytes(Dh, hb, max_chunks);
  static int attr_bytes = 48 * 1024;   // the most this instance was set up for
  if (smem > attr_bytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_generic<QT, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    attr_bytes = smem;
  }
  const int groups = (H / Hkv + hb - 1) / hb;
  dim3 grid(max_chunks, Hkv * groups, B);
  paged_decode_generic<QT, QUANT><<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), k_pool, v_pool, static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale), static_cast<const int*>(block_tables),
      static_cast<const int*>(kv_lens), static_cast<TQ*>(out), static_cast<float*>(m_out),
      static_cast<float*>(l_out), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), static_cast<int*>(tickets),
      static_cast<unsigned long long*>(launches), H, Hkv, Dh, hb, num_slots, layer, mb,
      bs_shift, chunk_tiles, max_chunks, scale);
  return cudaGetLastError();
}

template <int QT, bool QUANT>
cudaError_t occupancy_generic(int Dh, int hb, int max_chunks, int* blocks_per_sm, int* smem) {
  *smem = generic_smem_bytes(Dh, hb, max_chunks);
  if (*smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_generic<QT, QUANT>, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
    if (err != cudaSuccess) return err;
  }
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, paged_decode_generic<QT, QUANT>, kThreads, *smem);
}

}  // namespace

extern "C" int pstpu_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* kv_lens, void* out, void* m_out,
    void* l_out, void* part_acc, void* part_ml, void* tickets, void* launches,
    int B, int H, int Hkv, int Dh, long long num_slots, int layer, int mb,
    int bs_shift, int chunk_tiles, int max_chunks, float scale, void* stream) {
  return static_cast<int>(dispatch<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, block_tables, kv_lens, out, m_out,
      l_out, part_acc, part_ml, tickets, launches, B, H, Hkv, Dh, num_slots,
      layer, mb, bs_shift, chunk_tiles, max_chunks, scale, stream));
}

// int8 pools [L, Hkv, NS, Dh] with bf16 per-slot scales [L, Hkv, NS].
extern "C" int pstpu_paged_decode_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* kv_lens,
    void* out, void* m_out, void* l_out, void* part_acc, void* part_ml,
    void* tickets, void* launches, int B, int H, int Hkv, int Dh,
    long long num_slots, int layer, int mb, int bs_shift, int chunk_tiles,
    int max_chunks, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, kv_lens, out, m_out,
      l_out, part_acc, part_ml, tickets, launches, B, H, Hkv, Dh, num_slots,
      layer, mb, bs_shift, chunk_tiles, max_chunks, scale, stream));
}

// Resident blocks per SM the launch gets for one instance (quant 0/1, Dh,
// G), and its dynamic shared memory in bytes.
extern "C" int pstpu_paged_decode_occupancy(int quant, int Dh, int G,
                                            int* blocks_per_sm, int* smem) {
  const bool g8 = G <= 8;
  cudaError_t err = cudaErrorInvalidValue;
  if (quant) {
    if (Dh == 64) err = g8 ? occupancy<int8_t, 64, 8>(blocks_per_sm, smem)
                           : occupancy<int8_t, 64, 16>(blocks_per_sm, smem);
    if (Dh == 128) err = g8 ? occupancy<int8_t, 128, 8>(blocks_per_sm, smem)
                            : occupancy<int8_t, 128, 16>(blocks_per_sm, smem);
  } else {
    if (Dh == 64) err = g8 ? occupancy<__nv_bfloat16, 64, 8>(blocks_per_sm, smem)
                           : occupancy<__nv_bfloat16, 64, 16>(blocks_per_sm, smem);
    if (Dh == 128) err = g8 ? occupancy<__nv_bfloat16, 128, 8>(blocks_per_sm, smem)
                            : occupancy<__nv_bfloat16, 128, 16>(blocks_per_sm, smem);
  }
  return static_cast<int>(err);
}

// The generic kernel: q dtype qt (0 bf16, 1 f16, 2 f32) over pools of that
// dtype (quant 0) or int8 pools with bf16 per-slot scales (quant 1); any
// head dim (dynamic shared memory 2 * hb * Dh * 4 bytes), hb query heads
// per block, block sizes 1 .. 512.
extern "C" int pstpu_paged_decode_generic(
    int qt, int quant, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_lens, void* out, void* m_out, void* l_out, void* part_acc,
    void* part_ml, void* tickets, void* launches, int B, int H, int Hkv, int Dh,
    int hb, long long num_slots, int layer, int mb, int bs_shift, int chunk_tiles,
    int max_chunks, float scale, void* stream) {
  const bool ok = launches != nullptr && B >= 1 && B <= 65535 && Hkv >= 1 && H % Hkv == 0 &&
                  hb >= 1 && hb <= kGenHeads && hb <= H / Hkv && Dh >= 1 && mb >= 1 &&
                  bs_shift >= 0 && bs_shift <= 9 && chunk_tiles >= 1 &&
                  chunk_tiles <= kMaxChunkTiles &&
                  (long long)Hkv * ((H / Hkv + hb - 1) / hb) <= 65535 &&
                  (long long)max_chunks * chunk_tiles * kTile >= ((long long)mb << bs_shift) &&
                  generic_smem_bytes(Dh, hb, max_chunks) <= kGenSmemBudget &&
                  (!quant || (k_scale != nullptr && v_scale != nullptr));
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PSTPU_GENERIC(QT_, QUANT_)                                                       \
  return static_cast<int>(launch_generic<QT_, QUANT_>(                                   \
      q, k_pool, v_pool, k_scale, v_scale, block_tables, kv_lens, out, m_out, l_out,    \
      part_acc, part_ml, tickets, launches, B, H, Hkv, Dh, hb, num_slots, layer, mb,    \
      bs_shift, chunk_tiles, max_chunks, scale, st))
  if (qt == 0) { if (quant) PSTPU_GENERIC(0, true); PSTPU_GENERIC(0, false); }
  if (qt == 1) { if (quant) PSTPU_GENERIC(1, true); PSTPU_GENERIC(1, false); }
  if (qt == 2) { if (quant) PSTPU_GENERIC(2, true); PSTPU_GENERIC(2, false); }
#undef PSTPU_GENERIC
  return static_cast<int>(cudaErrorInvalidValue);
}

// Resident blocks per SM and dynamic shared bytes of a generic launch.
extern "C" int pstpu_paged_decode_generic_occupancy(int qt, int quant, int Dh, int hb,
                                                    int max_chunks, int* blocks_per_sm,
                                                    int* smem) {
  cudaError_t err = cudaErrorInvalidValue;
  if (qt == 0) err = quant ? occupancy_generic<0, true>(Dh, hb, max_chunks, blocks_per_sm, smem)
                           : occupancy_generic<0, false>(Dh, hb, max_chunks, blocks_per_sm, smem);
  if (qt == 1) err = quant ? occupancy_generic<1, true>(Dh, hb, max_chunks, blocks_per_sm, smem)
                           : occupancy_generic<1, false>(Dh, hb, max_chunks, blocks_per_sm, smem);
  if (qt == 2) err = quant ? occupancy_generic<2, true>(Dh, hb, max_chunks, blocks_per_sm, smem)
                           : occupancy_generic<2, false>(Dh, hb, max_chunks, blocks_per_sm, smem);
  return static_cast<int>(err);
}

// Nodes of a captured CUDA graph: all of them, and the kernel nodes.
extern "C" int pstpu_graph_node_counts(void* graph, int* kernels, int* total) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return static_cast<int>(err);
  int k = 0;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return static_cast<int>(err);
    k += type == cudaGraphNodeTypeKernel;
  }
  *kernels = k;
  *total = static_cast<int>(n);
  return 0;
}

extern "C" const char* pstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
