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
// far below the ~295 flops per byte where an H100 turns compute-bound.
//
// What the design does about it: split-KV flash-decoding. The grid is
// (num_splits, Hkv, B): one block handles the G = H / Hkv query heads that
// share one kv head, for one sequence, over a contiguous range of that
// sequence's tokens, so each K/V byte is read from HBM once and the grid
// has enough blocks to keep all 132 SMs streaming even at batch 1. A block
// looks up its own block-table entries (there is no scalar prefetch), copies
// 64-token tiles of K and V into shared memory with 16-byte cp.async (the
// whole tile in flight at once), scores them with each lane dotting half a
// key row against every query head (no per-token reductions), and keeps
// fp32 running (m, l, acc[G, Dh]). A second small kernel merges the splits.
// The TPU layout tricks (lane packing of Dh = 64, 512-token superpages, the
// pre-gathered lane-half-major scale window) exist for the TPU's 128-lane
// DMA grain and are not carried over: the int8 variant reads its tile's
// per-slot scales by slot itself, into shared memory beside the tile.
//
// Numerics follow the Pallas kernel: q is converted to fp32 and pre-scaled,
// scores and the PV product accumulate in fp32, masked keys get -inf before
// the max, and positions past kv_len are zero-filled in shared memory so a
// stale or NaN slot of a freed block can never reach the output through
// 0 * NaN. Block-table entries past cdiv(kv_len, block_size) are never read.
// Int8 pools dequantize as rank-1 factors, never materializing bf16 K/V:
// the K scale of a slot multiplies its score, the V scale multiplies its
// softmax weight on the way into PV only (l sums the unscaled weights), and
// the scales of positions past the range are zeroed, not only the payload.
//
// Plain C interface (loaded with ctypes); each entry point returns
// cudaGetLastError() after its launches.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;       // tokens per shared-memory tile
constexpr int kMaxGroup = 16;   // query heads per kv head

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// 16-byte global -> shared copy that bypasses registers (sm_80+). With
// `valid` false nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void unpack_bf16x8(const uint4 u, float* f) {
  // bf16 -> fp32 is exact: the bf16 bits are the high half of the fp32.
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// 16 int8 -> fp32 (exact): four sign-extended bytes of each 32-bit word.
__device__ __forceinline__ void unpack_i8x16(const uint4 u, float* f) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      f[4 * i + j] = static_cast<float>(static_cast<signed char>(w[i] >> (8 * j)));
  }
}

// Eight products of q (fp32, shared) and k (fp32, registers), summed in one
// expression.
__device__ __forceinline__ float dot8(const float* q, const float* kf) {
  const float4 a = *reinterpret_cast<const float4*>(q);
  const float4 c = *reinterpret_cast<const float4*>(q + 4);
  return a.x * kf[0] + a.y * kf[1] + a.z * kf[2] + a.w * kf[3] +
         c.x * kf[4] + c.y * kf[5] + c.z * kf[6] + c.w * kf[7];
}

__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(int8_t x) { return static_cast<float>(x); }

// One block: kv head `kvh` of row `b`, tokens of split `split`, the KG >= G
// query heads of that kv head. T is the pool element type (bf16, or int8
// with per-slot bf16 scales k_scale/v_scale [L, Hkv, NS]; null for bf16).
// Shared rows are padded by 16 B: a row is an even number of 16-byte
// vectors, so the padded stride is odd and the score loop's 16-byte reads
// of 8 neighbouring rows hit distinct banks.
template <typename T, int DH, int KG>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const __nv_bfloat16* __restrict__ q,        // [B, H, DH]
                          const T* __restrict__ k_pool,               // [L, Hkv, NS, DH]
                          const T* __restrict__ v_pool,               // [L, Hkv, NS, DH]
                          const __nv_bfloat16* __restrict__ k_scale,  // [L, Hkv, NS] | null
                          const __nv_bfloat16* __restrict__ v_scale,  // [L, Hkv, NS] | null
                          const int* __restrict__ block_tables,       // [B, mb]
                          const int* __restrict__ kv_lens,            // [B]
                          float* __restrict__ part_acc,               // [B, H, S, DH]
                          float* __restrict__ part_m,                 // [B, H, S]
                          float* __restrict__ part_l,                 // [B, H, S]
                          int H, int Hkv, long long num_slots, int layer,
                          int mb, int bs, int num_splits, float scale) {
  static_assert(DH == 64 || DH == 128, "unsupported head dim");
  static_assert(kTile == 4 * 16, "the score loop maps 16 tokens to each warp");
  constexpr bool kQuant = std::is_same<T, int8_t>::value;
  static_assert(kQuant || std::is_same<T, __nv_bfloat16>::value, "bf16 or int8 pools");
  static_assert(kThreads == 2 * kTile, "one thread per K scale and per V scale");
  constexpr int kEpu = 16 / sizeof(T);        // elements per 16-byte vector
  constexpr int kRowUnits = DH / kEpu;        // 16-byte vectors per token row
  constexpr int kStride = kRowUnits + 1;      // padded row, in 16-byte vectors
  constexpr int kHalfUnits = kRowUnits / 2;   // one lane reads half a row
  constexpr int kGStride = kThreads / DH;     // PV: threads sharing one dim
  constexpr int kAcc = (KG + kGStride - 1) / kGStride;
  constexpr int kScaleTile = kQuant ? kTile : 1;

  __shared__ uint4 k_s[kTile * kStride];
  __shared__ uint4 v_s[kTile * kStride];
  __shared__ __align__(16) float q_s[KG * DH];
  __shared__ __align__(16) float p_s[KG * kTile];
  __shared__ float ksc_s[kScaleTile];
  __shared__ float vsc_s[kScaleTile];
  __shared__ float m_s[KG];
  __shared__ float l_s[KG];
  __shared__ float alpha_s[KG];

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // This block's token range: the row's tiles are dealt out evenly over the
  // splits, so every split of a row gets the same share of its live KV.
  const int kv_len = kv_lens[b];
  const int n_tiles = (kv_len + kTile - 1) / kTile;
  const int tiles_per_split = (n_tiles + num_splits - 1) / num_splits;
  const int tok_begin = split * tiles_per_split * kTile;
  const int tok_end = min(kv_len, tok_begin + tiles_per_split * kTile);

  // q for the G heads of this kv head, fp32, pre-scaled (head = kvh*G + g).
  const __nv_bfloat16* qb = q + ((long long)b * H + (long long)kvh * G) * DH;
  for (int i = tid; i < G * DH; i += kThreads) q_s[i] = __bfloat162float(qb[i]) * scale;
  if (tid < G) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) acc[i] = 0.f;
  const int d = tid % DH;
  const int g0 = tid / DH;
  // Score mapping: warp w takes tokens 16w..16w+15; lane tl + 16*half
  // reads half `half` of token 16w + tl's row.
  const int tl = lane & 15;
  const int half = lane >> 4;
  const int tt_mine = warp * 16 + tl;
  __syncthreads();

  const long long head_base = ((long long)layer * Hkv + kvh) * num_slots;
  const int* bt = block_tables + (long long)b * mb;
  const T* v_rows = reinterpret_cast<const T*>(v_s);

  for (int t0 = tok_begin; t0 < tok_end; t0 += kTile) {
    const int n_valid = min(kTile, tok_end - t0);

    // 1. K/V tile -> shared memory, every copy in flight at once; tokens
    //    past the range are zero-filled (their block-table entry unread).
    for (int c = tid; c < kTile * kRowUnits; c += kThreads) {
      const int tt = c / kRowUnits;
      const int vec = c % kRowUnits;
      const bool valid = tt < n_valid;
      long long off = 0;
      if (valid) {
        const int tok = t0 + tt;
        const long long slot = (long long)bt[tok / bs] * bs + tok % bs;
        off = (head_base + slot) * DH + vec * kEpu;
      }
      cp_async16(&k_s[tt * kStride + vec], k_pool + off, valid);
      cp_async16(&v_s[tt * kStride + vec], v_pool + off, valid);
    }
    if constexpr (kQuant) {
      // The tile's per-slot scales (threads 0..63: K, 64..127: V), read
      // while the payload copies are in flight. Positions past the range
      // get scale 0: a stale slot's scale may be NaN.
      const int tt = tid % kTile;
      float sc = 0.f;
      if (tt < n_valid) {
        const int tok = t0 + tt;
        const long long slot = (long long)bt[tok / bs] * bs + tok % bs;
        sc = __bfloat162float((tid < kTile ? k_scale : v_scale)[head_base + slot]);
      }
      (tid < kTile ? ksc_s : vsc_s)[tt] = sc;
    }
    cp_async_wait_all();
    __syncthreads();

    // 2. Scores: each lane dots half a key row with every query head; the
    //    two halves meet in one shuffle. Int8: times the slot's K scale.
    {
      float s[KG];
#pragma unroll
      for (int g = 0; g < KG; ++g) s[g] = 0.f;
      const uint4* krow = k_s + tt_mine * kStride + half * kHalfUnits;
      const float* qh = q_s + half * (DH / 2);
#pragma unroll
      for (int j = 0; j < kHalfUnits; ++j) {
        float kf[kEpu];
        if constexpr (kQuant) {
          unpack_i8x16(krow[j], kf);
        } else {
          unpack_bf16x8(krow[j], kf);
        }
#pragma unroll
        for (int g = 0; g < KG; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < kEpu; e += 8) s[g] += dot8(qh + g * DH + j * kEpu + e, kf + e);
          }
        }
      }
      float ksc = 1.f;
      if constexpr (kQuant) ksc = ksc_s[tt_mine];
#pragma unroll
      for (int g = 0; g < KG; ++g) {
        if (g < G) {
          float v = s[g] + __shfl_xor_sync(0xffffffffu, s[g], 16);
          if constexpr (kQuant) v *= ksc;
          if (half == 0) p_s[g * kTile + tt_mine] = (tt_mine < n_valid) ? v : -INFINITY;
        }
      }
    }
    __syncthreads();

    // 3. Online softmax: one warp per query head. l sums the weights p;
    //    int8 stores p * v_scale for PV.
    for (int g = warp; g < G; g += kWarps) {
      const float s0 = p_s[g * kTile + lane];
      const float s1 = p_s[g * kTile + lane + 32];
      const float m_old = m_s[g];
      // The tile holds >= 1 valid token, so m_new is finite.
      const float m_new = fmaxf(m_old, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new);
      const float p1 = expf(s1 - m_new);
      if constexpr (kQuant) {
        p_s[g * kTile + lane] = p0 * vsc_s[lane];
        p_s[g * kTile + lane + 32] = p1 * vsc_s[lane + 32];
      } else {
        p_s[g * kTile + lane] = p0;
        p_s[g * kTile + lane + 32] = p1;
      }
      const float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[g] = alpha;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
      }
    }
    __syncthreads();

    // 4. acc = acc * alpha + p @ V, four tokens at a time (tokens past
    //    n_valid have p = 0 and zero-filled V).
#pragma unroll
    for (int i = 0; i < kAcc; ++i) {
      const int g = g0 + i * kGStride;
      if (g < G) acc[i] *= alpha_s[g];
    }
    for (int tt = 0; tt < n_valid; tt += 4) {
      const float v0 = to_float(v_rows[(tt + 0) * kStride * kEpu + d]);
      const float v1 = to_float(v_rows[(tt + 1) * kStride * kEpu + d]);
      const float v2 = to_float(v_rows[(tt + 2) * kStride * kEpu + d]);
      const float v3 = to_float(v_rows[(tt + 3) * kStride * kEpu + d]);
#pragma unroll
      for (int i = 0; i < kAcc; ++i) {
        const int g = g0 + i * kGStride;
        if (g < G) {
          const float4 p = *reinterpret_cast<const float4*>(p_s + g * kTile + tt);
          acc[i] += p.x * v0 + p.y * v1 + p.z * v2 + p.w * v3;
        }
      }
    }
    __syncthreads();
  }

  const int S = num_splits;
#pragma unroll
  for (int i = 0; i < kAcc; ++i) {
    const int g = g0 + i * kGStride;
    if (g < G) {
      const long long row = (long long)b * H + (long long)kvh * G + g;
      part_acc[(row * S + split) * DH + d] = acc[i];
    }
  }
  if (tid < G) {
    const long long row = (long long)b * H + (long long)kvh * G + tid;
    part_m[row * S + split] = m_s[tid];
    part_l[row * S + split] = l_s[tid];
  }
}

// Merge the splits of one (row, head): global max, rescaled sums, then the
// normalized output in bf16. All splits empty -> (0, -inf, 0).
template <int DH>
__global__ void __launch_bounds__(DH)
paged_decode_merge_kernel(const float* __restrict__ part_acc,
                          const float* __restrict__ part_m,
                          const float* __restrict__ part_l,
                          __nv_bfloat16* __restrict__ out,   // [B, H, DH]
                          float* __restrict__ m_out,         // [B, H]
                          float* __restrict__ l_out,         // [B, H]
                          int H, int num_splits) {
  const long long row = (long long)blockIdx.y * H + blockIdx.x;
  const int d = threadIdx.x;
  const float* pm = part_m + row * num_splits;
  const float* pl = part_l + row * num_splits;
  const float* pa = part_acc + row * num_splits * DH;
  float m = -INFINITY;
  for (int s = 0; s < num_splits; ++s) m = fmaxf(m, pm[s]);
  float l = 0.f;
  float a = 0.f;
  if (m > -INFINITY) {
    for (int s = 0; s < num_splits; ++s) {
      const float w = expf(pm[s] - m);
      l += pl[s] * w;
      a += pa[s * DH + d] * w;
    }
  }
  out[row * DH + d] = __float2bfloat16(a / fmaxf(l, 1e-30f));
  if (d == 0) {
    m_out[row] = m;
    l_out[row] = l;
  }
}

template <typename T, int DH, int KG>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const void* k_scale, const void* v_scale,
                   const void* block_tables, const void* kv_lens, void* out,
                   void* m_out, void* l_out, void* part_acc, void* part_m,
                   void* part_l, int B, int H, int Hkv, long long num_slots,
                   int layer, int mb, int bs, int num_splits, float scale,
                   cudaStream_t stream) {
  dim3 grid(num_splits, Hkv, B);
  paged_decode_split_kernel<T, DH, KG><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k_pool),
      static_cast<const T*>(v_pool), static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(block_tables), static_cast<const int*>(kv_lens),
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), H, Hkv, num_slots, layer, mb, bs,
      num_splits, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dim3 grid2(H, B);
  paged_decode_merge_kernel<DH><<<grid2, DH, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_m),
      static_cast<const float*>(part_l), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(m_out), static_cast<float*>(l_out), H, num_splits);
  return cudaGetLastError();
}

// Head dim and query heads per kv head -> the template instance (the
// smallest accumulator width that holds G).
template <typename T>
cudaError_t dispatch(const void* q, const void* k_pool, const void* v_pool,
                     const void* k_scale, const void* v_scale,
                     const void* block_tables, const void* kv_lens, void* out,
                     void* m_out, void* l_out, void* part_acc, void* part_m,
                     void* part_l, int B, int H, int Hkv, int Dh,
                     long long num_slots, int layer, int mb, int bs,
                     int num_splits, float scale, void* stream) {
  if (B < 1 || Hkv < 1 || H % Hkv != 0 || H / Hkv > kMaxGroup || bs < 1 ||
      mb < 1 || num_splits < 1 || B > 65535 || Hkv > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int G = H / Hkv;
#define PSTPU_LAUNCH(DH_, KG_)                                                       \
  return launch<T, DH_, KG_>(q, k_pool, v_pool, k_scale, v_scale, block_tables,     \
                             kv_lens, out, m_out, l_out, part_acc, part_m, part_l,  \
                             B, H, Hkv, num_slots, layer, mb, bs, num_splits, scale, \
                             st)
  if (Dh == 64) {
    if (G <= 4) PSTPU_LAUNCH(64, 4);
    if (G <= 8) PSTPU_LAUNCH(64, 8);
    PSTPU_LAUNCH(64, kMaxGroup);
  }
  if (Dh == 128) {
    if (G <= 4) PSTPU_LAUNCH(128, 4);
    if (G <= 8) PSTPU_LAUNCH(128, 8);
    PSTPU_LAUNCH(128, kMaxGroup);
  }
#undef PSTPU_LAUNCH
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" int pstpu_paged_decode_bf16(
    const void* q, const void* k_pool, const void* v_pool,
    const void* block_tables, const void* kv_lens, void* out, void* m_out,
    void* l_out, void* part_acc, void* part_m, void* part_l, int B, int H,
    int Hkv, int Dh, long long num_slots, int layer, int mb, int bs,
    int num_splits, float scale, void* stream) {
  return static_cast<int>(dispatch<__nv_bfloat16>(
      q, k_pool, v_pool, nullptr, nullptr, block_tables, kv_lens, out, m_out,
      l_out, part_acc, part_m, part_l, B, H, Hkv, Dh, num_slots, layer, mb, bs,
      num_splits, scale, stream));
}

// int8 pools [L, Hkv, NS, Dh] with bf16 per-slot scales [L, Hkv, NS].
extern "C" int pstpu_paged_decode_int8(
    const void* q, const void* k_pool, const void* v_pool, const void* k_scale,
    const void* v_scale, const void* block_tables, const void* kv_lens,
    void* out, void* m_out, void* l_out, void* part_acc, void* part_m,
    void* part_l, int B, int H, int Hkv, int Dh, long long num_slots,
    int layer, int mb, int bs, int num_splits, float scale, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(dispatch<int8_t>(
      q, k_pool, v_pool, k_scale, v_scale, block_tables, kv_lens, out, m_out,
      l_out, part_acc, part_m, part_l, B, H, Hkv, Dh, num_slots, layer, mb, bs,
      num_splits, scale, stream));
}

extern "C" const char* pstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
