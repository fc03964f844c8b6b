// Paged flash-decode over the layer-stacked KV pool, for Hopper (sm_90a):
// the generic CUDA-core kernel and the plain C interface of both kernels
// (loaded with ctypes; each entry point returns cudaGetLastError() after
// its launch). What the kernels replace and how the tensor-core kernel is
// built: paged_decode.cuh. Its instances are compiled in
// paged_decode_{bf16,bf16_int8,f16,f16_int8}.cu and reached here through
// the table below.

#include <vector>

#include "paged_decode.cuh"

namespace pstpu {

// The generic kernel: the rest of the Pallas kernel's domain, which the
// mma.sync kernel (paged_decode.cuh) does not take: q in float32 (over
// float32 pools or int8 with bf16 scales) at any head dim the gate admits
// (1 .. 64 dividing 128, or a multiple of 128), and bf16 / f16 q at Dh 1 ..
// 16 and > 256, any number of query heads per kv head, every block size
// the gate admits. Same work split, merge and numerics contract (fp32
// scores and sums, masked keys at -inf, l over the unscaled weights; the
// log2 domain inside), on CUDA cores in full fp32: no tensor-core product,
// so float32 keeps float32 accuracy.
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
  merge_chunks(part_acc + bh * max_chunks * G * DH, part_ml + 2 * bh * max_chunks * G,
               out + row0 * DH, m_out + row0, l_out + row0, reinterpret_cast<float*>(smem),
               l_s, n_chunks, G, g0, gn, DH, DH, true);
  if (tid == 0) tickets[ticket] = 0;   // ready for the next call / graph replay
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

// The tensor-core instances, by (q dtype, POOL, Dh, M rows).
struct MmaInstance {
  int qt, pool, dh, kg;
  cudaError_t (*fn)(const DecodeArgs*, cudaStream_t, int*, int*);
};
#define PSTPU_MMA_ENTRY(QT, POOL, DH, KG) {QT, POOL, DH, KG, PSTPU_MMA_FN(QT, POOL, DH, KG)},
constexpr MmaInstance kMmaInstances[] = {PSTPU_MMA_ALL(PSTPU_MMA_ENTRY)};
#undef PSTPU_MMA_ENTRY

// The instance of q dtype qt and pool kind (POOL) that takes G query heads
// per kv head at head dim Dh: 8 M rows where G <= 8 and an instance has
// them, else 16; null where none takes Dh.
const MmaInstance* mma_instance(int qt, int pool, int Dh, int G) {
  const MmaInstance* found = nullptr;
  for (const MmaInstance& m : kMmaInstances) {
    if (m.qt != qt || m.pool != pool || m.dh != Dh) continue;
    if (m.kg == 8 && G <= 8) return &m;
    if (m.kg == 16) found = &m;
  }
  return found;
}

}  // namespace pstpu

using namespace pstpu;

// The tensor-core kernel: q dtype qt (0 bf16, 1 f16) over pools of that
// dtype (quant 0) or int8 pools with bf16 per-slot scales (quant 1), Dh 32,
// 64, 128 or 256, any H / Hkv (head groups of 16), block sizes 1 .. 512
// (chunks of at most 4 tiles at block size 1: the page list's 257
// entries).
extern "C" int pstpu_paged_decode_mma(
    int qt, int quant, const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* block_tables,
    const void* kv_lens, void* out, void* m_out, void* l_out, void* part_acc,
    void* part_ml, void* tickets, void* launches, int B, int H, int Hkv, int Dh,
    long long num_slots, int layer, int mb, int bs_shift, int chunk_tiles, int max_chunks,
    float scale, void* stream) {
  const bool ok = launches != nullptr && B >= 1 && B <= 65535 && Hkv >= 1 &&
                  Hkv <= 65535 && H % Hkv == 0 && mb >= 1 && bs_shift >= 0 &&
                  bs_shift <= 9 && chunk_tiles >= 1 && chunk_tiles <= kMaxChunkTiles &&
                  ((chunk_tiles * kTile) >> bs_shift) + 1 <= kMaxPages &&
                  (long long)max_chunks * chunk_tiles * kTile >= ((long long)mb << bs_shift) &&
                  (long long)max_chunks * (H / Hkv) * 2 <= 0x7fffffff &&
                  (!quant || (k_scale != nullptr && v_scale != nullptr));
  const int pool = quant ? (bs_shift == 0 ? 2 : 1) : 0;
  const MmaInstance* inst = ok ? mma_instance(qt, pool, Dh, H / Hkv) : nullptr;
  if (inst == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const DecodeArgs a{q, k_pool, v_pool,
                     static_cast<const __nv_bfloat16*>(k_scale),
                     static_cast<const __nv_bfloat16*>(v_scale),
                     static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
                     out, static_cast<float*>(m_out), static_cast<float*>(l_out),
                     static_cast<float*>(part_acc), static_cast<float*>(part_ml),
                     static_cast<int*>(tickets), static_cast<unsigned long long*>(launches),
                     B, H, Hkv, num_slots, layer, mb, bs_shift, chunk_tiles, max_chunks, scale};
  return static_cast<int>(inst->fn(&a, static_cast<cudaStream_t>(stream), nullptr, nullptr));
}

// Resident blocks per SM the launch gets for one tensor-core instance (q
// dtype, POOL: 0 q's dtype, 1 int8, 2 int8 at one-token pages; Dh, M rows
// KG), and its dynamic shared memory in bytes.
extern "C" int pstpu_paged_decode_mma_occupancy(int qt, int pool, int Dh, int KG,
                                                int* blocks_per_sm, int* smem) {
  for (const MmaInstance& m : kMmaInstances)
    if (m.qt == qt && m.pool == pool && m.dh == Dh && m.kg == KG)
      return static_cast<int>(m.fn(nullptr, nullptr, blocks_per_sm, smem));
  return static_cast<int>(cudaErrorInvalidValue);
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
