// B5: flash attention forward. Online-softmax attention over q, k, v in
// the reference layout (B, S, H, hd), K/V already GQA-repeated; f32 or bf16
// in, f32 accumulation, causal or not; the output in the input dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _flash_kernel, launched by kernel.py::flash_attention_pallas through
// ops.py::flash_attention. model/attention.py reaches it when
// attn_impl == "flash" for every causal attention with Sq == Sk: each layer
// of each LM prefill.
//
// What it computes, as the TPU kernel does: s = (q . k) * hd^-0.5 in f32,
// masked to -1e30 above the causal diagonal; a running max m, sum l and
// accumulator acc per query row over key tiles; p = exp(s - m_new) rounded
// to v's dtype before the PV product (kernel.py:56) while l sums p
// unrounded; out = acc / max(l, 1e-30). The TPU wrapper's lane trick (pad
// hd to 128, pre-scale q, divide by the padded width) cancels out and is
// not carried over: the scale is the real hd^-0.5. Ragged tiles are masked
// here, so any S >= 1 and any hd <= 256 go through a kernel.
//
// What bounds it on an H100: at the main path's shape, one Yi-9B prefill
// layer of 2,048 tokens ((1, 2048, 32, 128) bf16, causal), the work is
// 34.4 GFLOP against 67 MB of q/k/v/o, so on the tensor cores (989 TFLOP/s
// bf16) it is bound by operations at 0.035 ms, above the 0.020 ms that
// HBM (3.35 TB/s) needs.
//
// Two variants; kernels/flash_attention/ops.py::variant picks one from
// dtype, head dim, strides and alignment alone, and a failure of either
// raises (neither stands in for the other):
//
// "sm90" (bf16, hd <= 128 with hd % 8 == 0, 16-byte strides and bases):
// the tensor cores, fed by TMA. A block of 384 threads takes 128 query rows
// of one (batch, head): warpgroup 0 is the producer (one thread issues
// TMA loads), warpgroups 1 and 2 each own 64 rows. Q is loaded once; K and
// V tiles of 128 keys cycle through a 2-stage ring guarded by "full"
// (TMA bytes landed) and "empty" (both consumers done) mbarriers. TMA
// writes 64-column boxes with the 128-byte swizzle and zero-fills rows
// past S and columns past hd, so hd 80/112 ride in the 128-wide instance
// and ragged S needs only the score mask. S = Q K^T is a
// wgmma.m64n128k16 with both operands K-major in shared memory; the
// softmax runs on the f32 accumulator fragment in registers (the row max
// and sum over the 4 threads of a row by shuffles, exp2 with scale*log2 e
// folded into the scores); P, rounded to bf16 pairwise, is the register A
// operand of O += P V (V MN-major in shared memory, the transpose bit
// set), so P never touches shared memory. setmaxnreg gives the producer
// 40 registers and the consumers 232. Compiled head widths 64 and 128.
//
// "simt" (f32, hd > 128, or operands TMA cannot read): the products on the
// CUDA cores in f32 (67 TFLOP/s peak: 0.51 ms at the shape above), with
// about one shared-memory load per two FMAs, so shared-memory bandwidth
// caps it near half that peak. One block of 256 threads per
// (batch*head, 64-row query tile), heaviest causal tiles launched first.
// The q tile is staged in shared memory once; the block loops over 64-key
// K/V tiles staged in shared memory, only up to the diagonal when causal.
// Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16i (i < 4): it
// computes s for keys tx + 16j (j < 4) and holds acc for dims tx + 16c
// (c < HD/16), so the 16 threads of a row form a half-warp and reduce the
// row max and sum with shuffles; m, l and acc stay in registers. p goes
// through shared memory for the PV product. Row strides are padded by one
// 32-bit word, so the strided key and p reads fall in distinct banks. HD
// is the head dim rounded up to one of the compiled widths; the extra dims
// are zeros in q, k and v.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error_string.cuh"
#include "hopper.cuh"
#include "tensor_map.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads per block: a 16 x 16 grid
constexpr float NEG = -1e30f;    // the reference's NEG_INF

struct Strides {                 // in elements; the head dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);      // round to nearest even
}

// Shared-memory row stride in elements: HD plus one 32-bit word.
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ + 2 * BK) * row_stride<T, HD>() * sizeof(T) +
         static_cast<size_t>(BQ) * (BK + 1) * sizeof(float);
}

// rows [row0, row0 + 64) of one (b, h) slice into dst, zeros past n_rows
// and past hd.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, Strides st,
                                          int row0, int n_rows, int hd) {
  constexpr int LD = row_stride<T, HD>();
  for (int i = threadIdx.x; i < BK * HD; i += NT) {
    const int r = i / HD;
    const int d = i - r * HD;
    T val = from_f32<T>(0.f);
    if (row0 + r < n_rows && d < hd)
      val = src[static_cast<long long>(row0 + r) * st.s + d];
    dst[r * LD + d] = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sq,
                     Strides sk, Strides sv, Strides so, int H, int Sq,
                     int Sk, int hd, float scale, int causal) {
  constexpr int LD = row_stride<T, HD>();
  constexpr int KD = HD / 16;      // head dims per thread in acc
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<T, HD>(Qs, q + b * sq.b + h * sq.h, sq, q0, Sq, hd);
  const T* kbase = k + b * sk.b + h * sk.h;
  const T* vbase = v + b * sv.b + h * sv.h;

  float m[4], l[4], acc[4][KD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KD; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the last tile's readers are done
    load_tile<T, HD>(Ks, kbase, sk, k0, Sk, hd);
    load_tile<T, HD>(Vs, vbase, sv, k0, Sk, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f32(Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f32(Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Sk || (causal && kpos > qpos)) x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[row * (BK + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < KD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        const float vv = to_f32(Vs[j * LD + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + static_cast<long long>(qpos) * so.s + h * so.h;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int Sq, int Sk, int hd, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  // opt in to more than 48 KB once per instantiation, before any launch
  // (so never inside a CUDA-graph capture after the first call)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H, Sq,
      Sk, hd, scale, causal);
  return cudaGetLastError();
}

// The compiled head widths: the smallest one >= hd is launched.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     Strides sq, Strides sk, Strides sv, Strides so, int B,
                     int H, int Sq, int Sk, int hd, float scale, int causal,
                     cudaStream_t st) {
#define REPRO_FLASH_HD(W)                                                    \
  if (hd <= W)                                                               \
    return launch<T, W>(q, k, v, o, sq, sk, sv, so, B, H, Sq, Sk, hd, scale, \
                        causal, st);
  REPRO_FLASH_HD(32)
  REPRO_FLASH_HD(64)
  REPRO_FLASH_HD(80)
  REPRO_FLASH_HD(96)
  REPRO_FLASH_HD(128)
  REPRO_FLASH_HD(160)
  REPRO_FLASH_HD(192)
  REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// ---- the sm90 variant ----------------------------------------------------
namespace sm90 {

using bf16 = __nv_bfloat16;

constexpr int BM = 128;          // query rows per block: 2 consumers x 64
constexpr int BN = 128;          // keys per K/V tile
constexpr int STAGES = 2;        // depth of the K/V ring
constexpr int NT = 384;          // producer warpgroup + 2 consumer warpgroups
constexpr int BOX = 64;          // columns per TMA box: one 128-byte row
constexpr float NEG = -1e30f;    // the reference's NEG_INF
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory, in bytes from a 1,024-byte-aligned base: Q, then the K
// stages, then the V stages, each tile HD/64 boxes of (128 rows x 128 B)
// one after the other; then the mbarriers q_full, full[], empty[].
template <int HD>
struct Plan {
  static constexpr int kBox = 128 * 128;
  static constexpr int kTile = HD / BOX * kBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + STAGES * kTile;
  static constexpr int kBars = kV + STAGES * kTile;
  static constexpr int kSmem = kBars + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // lo: low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

template <int HD>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ o, Strides so, int H, int Sq, int Sk,
                   int hd, float scale_log2, int causal) {
  using P = Plan<HD>;
  extern __shared__ __align__(1024) unsigned char smem_sm90[];
  const uint32_t base = (hopper::smem_u32(smem_sm90) + 1023) & ~1023u;
  const uint32_t bar_q = base + P::kBars;
  auto full = [&](int s) { return bar_q + 8 * (1 + s); };
  auto empty = [&](int s) { return bar_q + 8 * (1 + STAGES + s); };

  const int n_qt = (Sq + BM - 1) / BM;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BM;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int kv_end = causal ? min(Sk, q0 + BM) : Sk;
  const int n_kt = (kv_end + BN - 1) / BN;

  if (threadIdx.x == 0) {
    hopper::mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full(s), 1);
      hopper::mbar_init(empty(s), 2 * 128);   // every consumer thread
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread keeps the ring full ----
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      hopper::prefetch_tmap(&tq);
      hopper::prefetch_tmap(&tk);
      hopper::prefetch_tmap(&tv);
      hopper::mbar_arrive_expect_tx(bar_q, P::kTile);
#pragma unroll
      for (int c = 0; c < HD / BOX; ++c)
        hopper::tma_load_4d(base + P::kQ + c * P::kBox, &tq, bar_q, c * BOX,
                            q0, h, b);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % STAGES;
        const int use = kt / STAGES;
        if (use > 0) hopper::mbar_wait(empty(s), (use - 1) & 1);
        hopper::mbar_arrive_expect_tx(full(s), 2 * P::kTile);
#pragma unroll
        for (int c = 0; c < HD / BOX; ++c) {
          hopper::tma_load_4d(base + P::kK + s * P::kTile + c * P::kBox, &tk,
                              full(s), c * BOX, kt * BN, h, b);
          hopper::tma_load_4d(base + P::kV + s * P::kTile + c * P::kBox, &tv,
                              full(s), c * BOX, kt * BN, h, b);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    hopper::setmaxnreg_inc<232>();
    constexpr int NO = HD / 2;       // acc floats a thread: HD/8 tiles x 4
    const int w = threadIdx.x / 128 - 1;
    const int t = threadIdx.x % 128;
    const int lane = t % 32;
    // this thread's rows of the accumulator fragments: r and r + 8; its
    // columns in each 8-wide tile: c and c + 1
    const int qpos0 = q0 + 64 * w + 16 * (t / 32) + lane / 4;
    const int qpos1 = qpos0 + 8;
    const int c = 2 * (lane % 4);
    const uint32_t q_tile = base + P::kQ + w * 64 * 128;

    float acc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] = 0.f;
    float m[2] = {NEG, NEG};
    float l[2] = {0.f, 0.f};         // this thread's share of the row sums

    hopper::mbar_wait(bar_q, 0);
    for (int kt = 0; kt < n_kt; ++kt) {
      const int s = kt % STAGES;
      const int k0 = kt * BN;
      const uint32_t k_tile = base + P::kK + s * P::kTile;
      const uint32_t v_tile = base + P::kV + s * P::kTile;
      hopper::mbar_wait(full(s), (kt / STAGES) & 1);

      // S = Q K^T: hd/16 k-steps, both operands K-major; the first one
      // overwrites sc
      float sc[64];
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const uint32_t off = (kk / 4) * P::kBox + (kk % 4) * 32;
        hopper::wgmma_m64n128k16_ss(
            sc, hopper::desc_sw128(q_tile + off, 16, 1024),
            hopper::desc_sw128(k_tile + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(sc);

      // online softmax on the fragment, in log2 units
      const bool edge =
          k0 + BN > Sk || (causal && k0 + BN - 1 > q0 + 64 * w);
      float mx[2] = {NEG, NEG};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * j + e] * scale_log2;
          if (edge) {
            const int kpos = k0 + 8 * j + c + (e & 1);
            const int qpos = e < 2 ? qpos0 : qpos1;
            if (kpos >= Sk || (causal && kpos > qpos)) x = NEG;
          }
          sc[4 * j + e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
      // p, summed unrounded into l, and rounded to bf16 as the A fragment
      // of the PV product: the accumulator tiles 2k and 2k+1 (keys
      // 16k .. 16k+15) are k-step k's registers {r, r+8} x {lo, hi}
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = exp2f(sc[4 * j] - m[0]);
        const float p1 = exp2f(sc[4 * j + 1] - m[0]);
        const float p2 = exp2f(sc[4 * j + 2] - m[1]);
        const float p3 = exp2f(sc[4 * j + 3] - m[1]);
        l[0] += p0 + p1;
        l[1] += p2 + p3;
        pa[j / 2][2 * (j % 2)] = pack_bf16(p0, p1);
        pa[j / 2][2 * (j % 2) + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int i = 0; i < NO; i += 4) {
        acc[i] *= alpha[0];
        acc[i + 1] *= alpha[0];
        acc[i + 2] *= alpha[1];
        acc[i + 3] *= alpha[1];
      }

      // O += P V: 8 k-steps over the keys, V MN-major
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        const uint64_t dv =
            hopper::desc_sw128(v_tile + kk * 16 * 128, P::kBox, 1024);
        if constexpr (HD == 128)
          hopper::wgmma_m64n128k16_rs_tb(acc, pa[kk], dv);
        else
          hopper::wgmma_m64n64k16_rs_tb(acc, pa[kk], dv);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operand(acc);
      hopper::mbar_arrive(empty(s));
    }

    // out = acc / max(l, 1e-30), rows < Sq and dims < hd
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    bf16* o0 = o + b * so.b + static_cast<long long>(qpos0) * so.s + h * so.h;
    bf16* o1 = o0 + 8 * so.s;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int d = 8 * j + c;
      if (d >= hd) continue;
      if (qpos0 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o0 + d) = __floats2bfloat162_rn(
            acc[4 * j] / l[0], acc[4 * j + 1] / l[0]);
      if (qpos1 < Sq)
        *reinterpret_cast<__nv_bfloat162*>(o1 + d) = __floats2bfloat162_rn(
            acc[4 * j + 2] / l[1], acc[4 * j + 3] / l[1]);
    }
  }
}

// A 4-D map over (hd, S, H, B) of a (B, S, H, hd) bf16 tensor with element
// strides `st`: boxes of 64 columns x 128 rows, 128-byte swizzle, zeros
// outside the tensor. Returns 0 or an error code.
int make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd,
             Strides st) {
  const tma::EncodeTiled encode = tma::encode_tiled();
  if (encode == nullptr) return static_cast<int>(cudaErrorSymbolNotFound);
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {BOX, BM, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : tma::kError + static_cast<int>(r);
}

template <int HD>
cudaError_t launch(const CUtensorMap& tq, const CUtensorMap& tk,
                   const CUtensorMap& tv, void* o, Strides so, int B, int H,
                   int Sq, int Sk, int hd, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int smem = Plan<HD>::kSmem;
  static bool opted_in = false;      // once, before any graph capture
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_sm90<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + BM - 1) / BM, B * H);
  flash_fwd_sm90<HD><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), so, H, Sq, Sk, hd, scale * LOG2E,
      causal);
  return cudaGetLastError();
}

int run(const void* q, const void* k, const void* v, void* o, Strides sq,
        Strides sk, Strides sv, Strides so, int B, int H, int Sq, int Sk,
        int hd, float scale, int causal, cudaStream_t stream) {
  // ops.py::variant owns the routing; here only what keeps the kernel in
  // bounds: the widest instance, and hd even for the epilogue's paired
  // stores. The encoder itself refuses bases and strides TMA cannot read.
  if (hd > 128 || hd % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, B, Sq, H, hd, sq);
  if (err == 0) err = make_map(&tk, k, B, Sk, H, hd, sk);
  if (err == 0) err = make_map(&tv, v, B, Sk, H, hd, sv);
  if (err != 0) return err;
  return static_cast<int>(
      hd <= 64 ? launch<64>(tq, tk, tv, o, so, B, H, Sq, Sk, hd, scale,
                            causal, stream)
               : launch<128>(tq, tk, tv, o, so, B, H, Sq, Sk, hd, scale,
                             causal, stream));
}

}  // namespace sm90

// dtype: 0 = float32, 1 = bfloat16; variant: 0 = simt, 1 = sm90 (bf16
// only). Strides are in elements, (b, s, h) for each of q, k, v, o; the
// head dim is contiguous in all four. Returns a cudaError_t, or
// 100000 + the CUresult of a failed tensor-map encoding.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int hd, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, float scale, int causal, int dtype, int variant,
    void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd > 256 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh},
      so{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (variant == 1)
    return dtype == 1 ? sm90::run(q, k, v, o, sq, sk, sv, so, B, H, Sq, Sk,
                                  hd, scale, causal, st)
                      : static_cast<int>(cudaErrorInvalidValue);
  if (variant != 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, sq, sk, sv, so, B, H, Sq, Sk, hd, scale,
                          causal, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, B, H, Sq, Sk,
                                  hd, scale, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
