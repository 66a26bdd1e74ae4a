// Decode attention: one new token's grouped-query attention over the
// serving cache. q (B, 1, H, hd) against the cache's unrepeated K and V
// (B, S_max, KV, hd), each row b read only up to its own length
// min(kv_len[b], S_max); q head h reads kv head h / G, G = H / KV. The
// output o (B, 1, H, hd) is in q's dtype.
//
// Replaces no TPU kernel: the reference's decode attention is XLA's einsum
// over the GQA-repeated cache (src/repro/model/attention.py). The port's
// plain version of that (the repeat, an f32 cast of the whole cache and an
// einsum over all S_max positions, model/attention.py) made a Yi-9B
// decode tick about 98% attention and moved some ten times the cache's
// valid bytes each layer. model/attention.py::attn_apply reaches this
// kernel for every decode layer with attn_impl == "flash" (self-attention,
// a cache, no cross K/V): the dense, MoE, hybrid (Zamba2-7B's shared block,
// hd 112), vision and audio LMs, and the "model" split's kv shares.
//
// What it computes, as kernels/decode_attention/ref.py does: scores
// s = (q . k) * hd^-0.5 in f32 over the keys j < L = min(kv_len[b], S_max);
// softmax in f32; o = sum_j p_j v_j / sum_j p_j. bf16: the products from
// bf16 operands summed in f32, p rounded to bf16 for the PV product, which
// sums in f32, while the denominator sums p unrounded (as B5 does). f32:
// every step in f32 on the CUDA cores. Rows with kv_len > S_max (a free
// slot's position keeps counting) read all S_max keys, as the plain path's
// mask does. kv_len >= 1 in every decode step; a row with none reads
// nothing and gets zeros.
//
// What bounds it on an H100: bytes. Each valid key costs 2 * KV * hd
// elements of K and V for 4 * H * hd flops, G flops a byte at bf16 (8 for
// Yi-9B), far below the 295 at which the tensor cores would bind. At
// Yi-9B's long_decode tick (32 slots at a mean of about 1,300 keys, KV 4,
// hd 128) one layer reads about 85 MB, 0.025 ms at 3.35 TB/s. The design
// moves those bytes once and nothing else of size:
//
// Grid (B * KV, splits). A block takes one (row, kv head) and one split of
// `chunk` keys; a split that starts at or past L exits at once, so the
// host never reads kv_len and nothing waits for it. The wrapper picks
// splits from B * KV, S_max and the SM count alone (kernels/
// decode_attention/ops.py::split_plan), enough blocks that the live ones
// fill the SMs whatever the lengths are. A second pass (combine) merges
// each row's live splits' (m, l, o); with one split the main kernel writes
// o itself.
//
// "mma" (bf16, hd % 8 == 0, 16-byte aligned K/V rows): 4 warps; K/V tiles
// of 64 keys stream through a two-stage cp.async ring into shared memory
// (16-byte chunks, zero-filled past the split's end and past hd), rows
// padded by 16 bytes so every ldmatrix hits 8 distinct bank groups. Each
// warp owns 16 keys of a tile: S = Q K^T by mma.sync m16n8k16 with the G q
// heads of the group as the 16 rows (G <= 16, the rest zero), so the G
// heads share one read of the tile; an online softmax per warp on the f32
// accumulators (exp2, the scale folded with log2 e); P, rounded to bf16,
// stays in registers as the A operand of O += P V (V by ldmatrix.trans).
// The four warps' (m, l, O) merge through shared memory at the end.
// Compiled head widths 16, 32, 64, 80, 96, 112, 128, 160, 192 and 256; a
// head dim between them runs in the next wider one with zero dims.
//
// "simt" (f32): the same grid, splits and combine; 32-key tiles staged in
// shared memory by plain loads, scores, softmax and PV on the CUDA cores,
// the accumulator in shared memory. Any hd <= 256.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr float LOG2E = 1.4426950408889634f;
constexpr int MAX_GROUP = 16;    // q heads a kv head: the mma's 16 rows
constexpr int MAX_HD = 256;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const int* kv_len;
  void* o;
  float* o_part;                 // (B * KV, splits, G, hd): unnormalised o
  float* ml_part;                // (B * KV, splits, G, 2): (m, l), log2
  long long qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh;  // elements
  int KV, G, S_max, hd, chunk, splits;
  float scale_log2;              // hd^-0.5 * log2 e
};

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);      // round to nearest even
}

// The row's keys and this block's share of them: [start, end), and whether
// the block has any (split 0 always runs, so that every row's o is
// written).
struct Span {
  int start, end;
  bool live;
};

__device__ __forceinline__ Span block_span(const Args& a, int b, int split) {
  const int L = max(0, min(a.kv_len[b], a.S_max));
  const int n_live = max(1, (L + a.chunk - 1) / a.chunk);
  const int start = split * a.chunk;
  return {start, min(start + a.chunk, L), split < n_live};
}

// The block's result for q row r, dim d: o itself where the row has one
// split, else the partial for the combine pass.
template <typename T>
__device__ __forceinline__ void write_result(const Args& a, int blk, int b,
                                             int kvh, int split, int r,
                                             int d, float M, float num,
                                             float den) {
  if (a.splits == 1) {
    T* o = static_cast<T*>(a.o);
    o[b * a.osb + static_cast<long long>(kvh * a.G + r) * a.osh + d] =
        from_f32<T>(den > 0.f ? num / den : 0.f);
    return;
  }
  const long long row =
      (static_cast<long long>(blk) * a.splits + split) * a.G + r;
  a.o_part[row * a.hd + d] = num;
  if (d == 0) {
    a.ml_part[2 * row] = M;
    a.ml_part[2 * row + 1] = den;
  }
}

// ---- combine: each row's live splits into o ------------------------------

template <typename T>
__global__ void __launch_bounds__(128) decode_attn_combine(Args a) {
  const int blk = blockIdx.x;
  const int b = blk / a.KV, kvh = blk - b * a.KV;
  const int L = max(0, min(a.kv_len[b], a.S_max));
  const int n_live = min(a.splits, max(1, (L + a.chunk - 1) / a.chunk));
  T* o = static_cast<T*>(a.o);
  for (int i = threadIdx.x; i < a.G * a.hd; i += blockDim.x) {
    const int r = i / a.hd, d = i - r * a.hd;
    const long long row0 = static_cast<long long>(blk) * a.splits * a.G + r;
    float M = -INFINITY;
    for (int s = 0; s < n_live; ++s)
      M = fmaxf(M, a.ml_part[2 * (row0 + s * a.G)]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
      for (int s = 0; s < n_live; ++s) {
        const long long row = row0 + s * a.G;
        const float f = exp2f(a.ml_part[2 * row] - M);
        num += f * a.o_part[row * a.hd + d];
        den += f * a.ml_part[2 * row + 1];
      }
    }
    o[b * a.osb + static_cast<long long>(kvh * a.G + r) * a.osh + d] =
        from_f32<T>(den > 0.f ? num / den : 0.f);
  }
}

// ---- mma: bf16 on the tensor cores ---------------------------------------

namespace mma {

constexpr int BN = 64;           // keys a tile: 16 a warp
constexpr int NW = 4;            // warps
constexpr int NT = 32 * NW;
constexpr int STAGES = 2;        // the cp.async ring
constexpr int QROWS = 16;        // the mma's M: the group's q heads, padded

template <int HD>
struct Plan {
  static constexpr int LDS = HD + 8;      // row pitch: 16 bytes of pad
  static constexpr int CH = HD / 8;       // 16-byte chunks a row
  static constexpr int TILE = BN * LDS;   // elements of a K or V tile
  static constexpr int Q_BYTES = QROWS * LDS * 2;
  static constexpr int SMEM = Q_BYTES + STAGES * 2 * TILE * 2;
  // the epilogue's per-warp (o, m, l) reuse the ring
  static_assert(NW * QROWS * (HD + 2) * 4 <= STAGES * 2 * TILE * 2,
                "epilogue does not fit the ring");
  static_assert(BN * CH % NT == 0, "a tile is whole 16-byte chunks a thread");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, bypassing L1; `bytes` < 16 zero-fills the rest
// (0: nothing read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col); bf16 in, f32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane = 4 g + t.
// A: {a0, a1, a2, a3} = rows (g, g + 8, g, g + 8), columns (2t, 2t + 1)
// (+ 8 for a2, a3). B: b0 = rows 2t, 2t + 1 of column g, b1 the same + 8.
// C: {c0, c1} = row g, columns 2t, 2t + 1; {c2, c3} row g + 8.
template <int HD>
__global__ void __launch_bounds__(NT) decode_attn_mma(Args a) {
  using P = Plan<HD>;
  constexpr int LDS = P::LDS, CH = P::CH, TILE = P::TILE;
  const int blk = blockIdx.x, split = blockIdx.y;
  const int b = blk / a.KV, kvh = blk - b * a.KV;
  const Span sp = block_span(a, b, split);
  if (!sp.live) return;
  const int n_tiles = (sp.end - sp.start + BN - 1) / BN;

  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* ring = reinterpret_cast<bf16*>(smem + P::Q_BYTES);

  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ksb + kvh * a.ksh;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vsb + kvh * a.vsh;
  auto load_tile = [&](int t) {
    bf16* sk = ring + (t % STAGES) * 2 * TILE;
    bf16* sv = sk + TILE;
    const int key0 = sp.start + t * BN;
#pragma unroll
    for (int it = 0; it < BN * CH / NT; ++it) {
      const int i = threadIdx.x + it * NT;
      const int r = i / CH, c = i - r * CH;
      const bool ok = key0 + r < sp.end && c * 8 < a.hd;
      const long long key = ok ? key0 + r : 0;
      const int col = ok ? c * 8 : 0;
      cp_async16(smem_u32(sk + r * LDS + c * 8), kb + key * a.kss + col,
                 ok ? 16 : 0);
      cp_async16(smem_u32(sv + r * LDS + c * 8), vb + key * a.vss + col,
                 ok ? 16 : 0);
    }
  };
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  // the group's q heads as 16 rows, zeros past G and past hd
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.qsb +
                   static_cast<long long>(kvh) * a.G * a.qsh;
  for (int i = threadIdx.x; i < QROWS * HD; i += NT) {
    const int r = i / HD, d = i - r * HD;
    sQ[r * LDS + d] = (r < a.G && d < a.hd) ? qb[r * a.qsh + d]
                                            : __float2bfloat16(0.f);
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4, mi = lane / 8;
  const int kw = warp * 16;                  // the warp's keys in a tile
  float acc[HD / 8][4];
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m_row[2] = {-INFINITY, -INFINITY};   // rows g, g + 8 (log2 units)
  float l_row[2] = {0.f, 0.f};               // this lane's share of l

  for (int t = 0; t < n_tiles; ++t) {
    if (t + STAGES - 1 < n_tiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const bf16* sk = ring + (t % STAGES) * 2 * TILE;
    const bf16* sv = sk + TILE;

    // S = Q K^T over the warp's 16 keys: two n8 tiles
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t qa[4], kf[4];
      ldmatrix_x4(qa, smem_u32(sQ + (lane % 16) * LDS + ks * 16 +
                               (lane / 16) * 8));
      ldmatrix_x4(kf, smem_u32(sk + (kw + (mi / 2) * 8 + lane % 8) * LDS +
                               ks * 16 + (mi % 2) * 8));
      mma_bf16(s[0], qa, kf[0], kf[1]);
      mma_bf16(s[1], qa, kf[2], kf[3]);
    }

    // scale and mask, then the online softmax of rows g (h = 0), g + 8
    const int key_base = sp.start + t * BN + kw + 2 * t4;
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[n][e] = key_base + n * 8 + (e & 1) < sp.end ? s[n][e] * a.scale_log2
                                                       : -INFINITY;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = fmaxf(fmaxf(s[0][2 * h], s[0][2 * h + 1]),
                       fmaxf(s[1][2 * h], s[1][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_row[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_row[h] - m_use);
      m_row[h] = m_new;
      l_row[h] *= alpha;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        acc[j][2 * h] *= alpha;
        acc[j][2 * h + 1] *= alpha;
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * h + e] - m_use);
          s[n][2 * h + e] = p;
          l_row[h] += p;
        }
    }

    // O += P V: P's C fragments are the A fragment of a k16 step
    const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                            pack_bf16(s[0][2], s[0][3]),
                            pack_bf16(s[1][0], s[1][1]),
                            pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int j = 0; j < HD / 16; ++j) {
      uint32_t vf[4];
      ldmatrix_x4_trans(vf, smem_u32(sv + (kw + (mi % 2) * 8 + lane % 8) *
                                              LDS +
                                     j * 16 + (mi / 2) * 8));
      mma_bf16(acc[2 * j], pa, vf[0], vf[1]);
      mma_bf16(acc[2 * j + 1], pa, vf[2], vf[3]);
    }
    __syncthreads();                 // this stage is refilled next
  }
  cp_async_wait<0>();
  __syncthreads();

  // the four warps' (m, l, O) through shared memory, then merged
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
  }
  float* sO = reinterpret_cast<float*>(ring);       // [NW][16][HD]
  float* sM = sO + NW * QROWS * HD;                 // [NW][16]
  float* sL = sM + NW * QROWS;
  float* my = sO + warp * QROWS * HD;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    my[g * HD + j * 8 + 2 * t4] = acc[j][0];
    my[g * HD + j * 8 + 2 * t4 + 1] = acc[j][1];
    my[(g + 8) * HD + j * 8 + 2 * t4] = acc[j][2];
    my[(g + 8) * HD + j * 8 + 2 * t4 + 1] = acc[j][3];
  }
  if (t4 == 0) {
    sM[warp * QROWS + g] = m_row[0];
    sM[warp * QROWS + g + 8] = m_row[1];
    sL[warp * QROWS + g] = l_row[0];
    sL[warp * QROWS + g + 8] = l_row[1];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < a.G * a.hd; i += NT) {
    const int r = i / a.hd, d = i - r * a.hd;
    float M = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) M = fmaxf(M, sM[w * QROWS + r]);
    float num = 0.f, den = 0.f;
    if (M != -INFINITY) {
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        const float f = exp2f(sM[w * QROWS + r] - M);
        num += f * sO[(w * QROWS + r) * HD + d];
        den += f * sL[w * QROWS + r];
      }
    }
    write_result<bf16>(a, blk, b, kvh, split, r, d, M, num, den);
  }
}

template <int HD>
cudaError_t launch(const Args& a, dim3 grid, cudaStream_t stream) {
  constexpr int smem = Plan<HD>::SMEM;
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_mma<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  decode_attn_mma<HD><<<grid, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t run(const Args& a, dim3 grid, cudaStream_t stream) {
  const int hd = a.hd;
  if (hd <= 16) return launch<16>(a, grid, stream);
  if (hd <= 32) return launch<32>(a, grid, stream);
  if (hd <= 64) return launch<64>(a, grid, stream);
  if (hd <= 80) return launch<80>(a, grid, stream);
  if (hd <= 96) return launch<96>(a, grid, stream);
  if (hd <= 112) return launch<112>(a, grid, stream);
  if (hd <= 128) return launch<128>(a, grid, stream);
  if (hd <= 160) return launch<160>(a, grid, stream);
  if (hd <= 192) return launch<192>(a, grid, stream);
  return launch<256>(a, grid, stream);
}

}  // namespace mma

// ---- simt: f32 on the CUDA cores ------------------------------------------

namespace simt {

constexpr int BN = 32;           // keys a tile: one a lane
constexpr int NW = 4;
constexpr int NT = 32 * NW;

// sQ [G][hd], sK [BN][hd + 1], sV [BN][hd], sS [G][BN], sAcc [G][hd],
// sM, sL, sAlpha [G]
__host__ __device__ inline size_t smem_bytes(int G, int hd) {
  return sizeof(float) *
         (static_cast<size_t>(G) * hd * 2 + BN * (hd + 1) + BN * hd +
          G * BN + 3 * G);
}

__global__ void __launch_bounds__(NT) decode_attn_simt(Args a) {
  const int blk = blockIdx.x, split = blockIdx.y;
  const int b = blk / a.KV, kvh = blk - b * a.KV;
  const Span sp = block_span(a, b, split);
  if (!sp.live) return;
  const int G = a.G, hd = a.hd;
  extern __shared__ __align__(16) unsigned char smem_simt[];
  float* sQ = reinterpret_cast<float*>(smem_simt);
  float* sK = sQ + G * hd;
  float* sV = sK + BN * (hd + 1);
  float* sS = sV + BN * hd;
  float* sAcc = sS + G * BN;
  float* sM = sAcc + G * hd;
  float* sL = sM + G;
  float* sAlpha = sL + G;

  const float* qb = static_cast<const float*>(a.q) + b * a.qsb +
                    static_cast<long long>(kvh) * G * a.qsh;
  const float* kb = static_cast<const float*>(a.k) + b * a.ksb + kvh * a.ksh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vsb + kvh * a.vsh;
  for (int i = threadIdx.x; i < G * hd; i += NT) {
    const int r = i / hd;
    sQ[i] = qb[r * a.qsh + (i - r * hd)];
    sAcc[i] = 0.f;
  }
  for (int r = threadIdx.x; r < G; r += NT) {
    sM[r] = -INFINITY;
    sL[r] = 0.f;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int key0 = sp.start; key0 < sp.end; key0 += BN) {
    __syncthreads();               // the last tile's readers are done
    for (int i = threadIdx.x; i < BN * hd; i += NT) {
      const int r = i / hd, d = i - r * hd;
      const bool ok = key0 + r < sp.end;
      sK[r * (hd + 1) + d] = ok ? kb[(key0 + r) * a.kss + d] : 0.f;
      sV[i] = ok ? vb[(key0 + r) * a.vss + d] : 0.f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * BN; i += NT) {
      const int r = i / BN, j = i - r * BN;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += sQ[r * hd + d] * sK[j * (hd + 1) + d];
      sS[i] = key0 + j < sp.end ? dot * a.scale_log2 : -INFINITY;
    }
    __syncthreads();
    for (int r = warp; r < G; r += NW) {
      const float x = sS[r * BN + lane];
      const float m_old = sM[r];
      float mx = x;
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_old, mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p = exp2f(x - m_use);
      float sum = p;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      sS[r * BN + lane] = p;
      if (lane == 0) {
        const float alpha = exp2f(m_old - m_use);
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
        sAlpha[r] = alpha;
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < G * hd; i += NT) {
      const int r = i / hd, d = i - r * hd;
      float o = sAcc[i] * sAlpha[r];
      for (int j = 0; j < BN; ++j) o += sS[r * BN + j] * sV[j * hd + d];
      sAcc[i] = o;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < G * hd; i += NT) {
    const int r = i / hd, d = i - r * hd;
    write_result<float>(a, blk, b, kvh, split, r, d, sM[r], sAcc[i], sL[r]);
  }
}

cudaError_t run(const Args& a, dim3 grid, cudaStream_t stream) {
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attn_simt, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem_bytes(MAX_GROUP, MAX_HD)));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  decode_attn_simt<<<grid, NT, smem_bytes(a.G, a.hd), stream>>>(a);
  return cudaGetLastError();
}

}  // namespace simt

}  // namespace

// dtype: 0 = float32 ("simt"), 1 = bfloat16 ("mma"). Strides in elements:
// q's and o's (b, h), k's and v's (b, s, h); the head dim contiguous in
// all. kv_len: B int32 on the device. o_part and ml_part: scratch of
// B * KV * splits * G * hd and * 2 floats, unused (may be null) when
// splits == 1. Launches the main kernel and, for splits > 1, the combine
// pass, on `stream`; returns a cudaError_t.
extern "C" int decode_attention_launch(
    const void* q, const void* k, const void* v, const void* kv_len, void* o,
    void* o_part, void* ml_part, int B, int KV, int G, int S_max, int hd,
    int splits, int chunk, long long qsb, long long qsh, long long ksb,
    long long kss, long long ksh, long long vsb, long long vss,
    long long vsh, long long osb, long long osh, float scale, int dtype,
    void* stream) {
  const long long rows = static_cast<long long>(B) * KV;
  if (B <= 0 || KV <= 0 || G <= 0 || G > MAX_GROUP || S_max <= 0 ||
      hd <= 0 || hd > MAX_HD || splits <= 0 || splits > 65535 ||
      chunk <= 0 || static_cast<long long>(splits) * chunk < S_max ||
      rows > 2147483647LL || (splits > 1 && (!o_part || !ml_part)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1) {
    // cp.async moves 16-byte chunks of K and V
    const uintptr_t mis = reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v);
    if (hd % 8 || mis % 16 || (ksb | kss | ksh | vsb | vss | vsh) % 8)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if (dtype != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a{q, k, v, static_cast<const int*>(kv_len), o,
         static_cast<float*>(o_part), static_cast<float*>(ml_part),
         qsb, qsh, ksb, kss, ksh, vsb, vss, vsh, osb, osh,
         KV, G, S_max, hd, chunk, splits, scale * LOG2E};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(rows), splits);
  cudaError_t err =
      dtype == 1 ? mma::run(a, grid, st) : simt::run(a, grid, st);
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  if (dtype == 1)
    decode_attn_combine<bf16><<<static_cast<unsigned>(rows), 128, 0, st>>>(a);
  else
    decode_attn_combine<float><<<static_cast<unsigned>(rows), 128, 0, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}
