// B3: the float LSTM window — every timestep of one gate-fused LSTM cell
// for a batch of windows in one launch, returning the final hidden state.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell/kernel.py::
// _lstm_kernel, launched by kernel.py::lstm_window_pallas through
// ops.py::lstm_window.
//
// What it computes, as the TPU kernel does: h = c = 0; for t < S,
//   z = [x_t, h] . W + b                        (W is (d_in+H) x 4H, f32)
//   i, f, g, o = z split in four (gate order i, f, g, o)
//   c = sigmoid(f) * c + sigmoid(i) * tanh(g);  h = sigmoid(o) * tanh(c)
// and writes the final h, (B, H). The gate product is f32-accurate (IEEE
// f32 FMAs in `simt`, split TF32 in `mma`, never plain TF32). `simt`'s
// sigmoid is 1 / (1 + expf(-z)) and its tanh tanhf, both accurate to a few
// ulp (no fast-math), as jax.nn.sigmoid / jnp.tanh are on the CPU; `mma`'s
// are one MUFU exponential and one MUFU reciprocal with a Newton step each
// (see sigmoid_mufu), within 2.4e-7 of those over [-30, 30]. A NaN in a
// window's x gives that row of h NaN in both, as in the plain version; an
// Inf does in `mma` too (split TF32's lo part of Inf is Inf - Inf), where
// the plain version may saturate to a finite h.
//
// What bounds it on an H100: at the paper's Table-I cell (S = 6, d_in = 1,
// H = 20) a window takes 6 * 21 * 80 = 10,080 multiply-adds against 24 B in
// and 80 B out, so 65,536 windows are bound by operations, not by HBM (6.8
// MB: 0.002 ms): in f32 FMAs 0.020 ms at 67 TFLOP/s; in split TF32 (three
// products each) 0.008 ms at 495 TFLOP/s; and the activations, which no
// form of the product removes: five exponentials a (window, step, unit)
// and, over common denominators, two reciprocals (7 MUFU operations: 0.013
// ms at 16 a clock an SM; `mma` issues 10, one reciprocal an activation).
//
// Two kernels, chosen by the wrapper from the shapes alone
// (kernels/lstm_cell/ops.py::variant):
//
// `mma` — the gate product on the tensor cores in split TF32 (csrc/
// tf32.cuh: mma.sync.m16n8k8, three products a term, each k-step's summed
// from zero and added on the CUDA cores), for H <= 64 and K = d_in + H <=
// 128.
//   Tiles. One warp owns TILES tiles of 16 windows (the mma's M) and walks
//   their S steps with the tiles' steps interleaved (independent chains of
//   mma -> shuffle -> activations); blocks of 4 warps, no __syncthreads()
//   after the prologue. At Table I x 65,536 windows the instance takes two
//   tiles a warp: 512 blocks of 128 registers a thread, which fit on
//   the 132 SMs in one wave.
//   Weights. The block stages W once as B fragments [k8 step][n8 tile]
//   [lane], zero past K and H, split into TF32 hi and lo parts once (one
//   conflict-free 16-byte load a fragment; 15 KB at Table I) — or, for the
//   one instance whose split fragments would not fit (64 units, K > 64),
//   as f32 split at each use. W's and b's columns are interleaved by unit,
//   [i_u, f_u, g_u, o_u, i_u+1, ...]: in an n8 tile lane 4g+q holds
//   columns 2q, 2q+1 of rows g and g+8, so lanes q = 0, 2 hold (i, f) and
//   lanes q = 1, 3 hold (g, o) of units 2j and 2j+1; one __shfl_xor(1) of
//   two floats gives the even lane all four gates of row g and the odd lane
//   those of row g+8. Each (row, unit) is updated by exactly one lane, and
//   its c stays in that lane's registers for the whole window.
//   Feeding h back. Each tile has an f32 A tile, 16 rows of [x_t | h | 0]
//   with a pitch of 8 KT + 4 floats (so the A-fragment loads hit 32
//   distinct banks); each lane writes its h there for the next step. The
//   window's x is staged per chunk of steps with coalesced loads; only the
//   final h is stored, from the A tile, 16 rows at a time.
//   Instances: NT n8 tiles (10, 16 or 32: H up to 20, 32, 64) by KT k8
//   steps (3, 5, 8 or 16: K up to 24, 40, 64, 128; 3 only below 33
//   units), the loops over both unrolled and branch-free over the padded
//   widths (zero weights), so ptxas can overlap the tiles' mma chains; two
//   tiles a warp for NT x KT <= 50, one above.
//
// `simt` — every other shape (and any shape when launched directly): one
// block per tile of bb windows (the wrapper's block_b, lowered only where
// shared memory is short). W and b are staged in shared memory once per
// block (read from global memory only when W alone would not fit); h
// (double-buffered: every gate reads the whole previous h) and c stay in
// shared memory for all S steps. Each thread owns (window, hidden unit)
// pairs and computes that unit's four gates in f32 FMAs. The ragged last
// tile is masked in both kernels; nothing is padded in memory.
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"
#include "tf32.cuh"

namespace {

// The accurate activations (`simt`): expf, an IEEE reciprocal, tanhf.
__device__ __forceinline__ float sigmoidf(float z) {
  return 1.f / (1.f + expf(-z));
}

// The MUFU activations (`mma`): 2^v by ex2.approx, 1 / d by rcp.approx and
// one Newton step, so each activation is one MUFU exponential and one MUFU
// reciprocal and no branch. Within 1.2e-7 (sigmoid) and 2.4e-7 (tanh) of
// the accurate forms over [-30, 30]; chip_smoke.py phase 9 sweeps it
// densely (lstm_cell_act_sweep) and fails above 1e-6.
__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float rcp_approx(float v) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// min(v, m), NaN if v is NaN (fminf would return m, saturating a gate)
__device__ __forceinline__ float min_nan(float v, float m) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(m));
  return r;
}

// 1 / (1 + 2^v); v is clamped to 126 so that 1 + 2^v stays finite, and a
// NaN passes through
__device__ __forceinline__ float inv_1p_ex2(float v) {
  const float d = 1.f + ex2_approx(min_nan(v, 126.f));
  const float r = rcp_approx(d);
  return fmaf(r, fmaf(-d, r, 1.f), r);
}

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float sigmoid_mufu(float z) {
  return inv_1p_ex2(-kLog2e * z);
}

__device__ __forceinline__ float tanh_mufu(float z) {    // 2 sigmoid(2z) - 1
  return fmaf(2.f, inv_1p_ex2((-2.f * kLog2e) * z), -1.f);
}

// one cell update from a unit's four gate pre-activations: updates c,
// returns h; Mufu picks the activations' form
template <bool Mufu>
__device__ __forceinline__ float unit_update(float zi, float zf, float zg,
                                             float zo, float& c) {
  if constexpr (Mufu) {
    c = sigmoid_mufu(zf) * c + sigmoid_mufu(zi) * tanh_mufu(zg);
    return sigmoid_mufu(zo) * tanh_mufu(c);
  } else {
    c = sigmoidf(zf) * c + sigmoidf(zi) * tanhf(zg);
    return sigmoidf(zo) * tanhf(c);
  }
}

int smem_optin() {
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  return smem_max;
}

// ---------------------------------------------------------------- mma ----
namespace mma {

using tf32::Split;
using tf32::split;

constexpr int kWarps = 4;              // warps a block
constexpr int kStageFloats = 1024;     // x a tile stages per chunk (4 KB)
constexpr int kMaxNt = 32;             // H <= 64
constexpr int kMaxKt = 16;             // K = d_in + H <= 128
constexpr size_t kPreSplitMax = 160 * 1024;

// W's B fragments pre-split (one uint4 a lane: both hi parts, then both lo
// parts, each pair the two consecutive registers an mma operand takes)
// unless they would pass kPreSplitMax; then f32 (one float2 a lane), split
// at each use
template <int NT, int KT>
__host__ __device__ constexpr bool presplit() {
  return static_cast<size_t>(KT) * NT * 32 * sizeof(uint4) <= kPreSplitMax;
}

template <int NT, int KT>
__host__ __device__ constexpr size_t w_bytes() {
  return static_cast<size_t>(KT) * NT * 32 *
         (presplit<NT, KT>() ? sizeof(uint4) : sizeof(float2));
}

// blocks an SM must hold (__launch_bounds__): registers grow with the
// A fragments (8 KT a tile) and the c of NT units a tile
template <int NT, int KT, int TILES>
constexpr int min_blocks() {
  return NT * KT * TILES <= 30 ? 6
       : NT * KT * TILES <= 64 ? 4
       : NT * KT * TILES <= 128 ? 3
       : NT * KT * TILES <= 256 ? 2 : 1;
}

struct Geometry {
  int ts;              // steps a chunk stages
  int pitch;           // floats of an A-tile row: 8 KT + 4
  int tile_floats;     // a tile's A tile and x stage
  size_t smem;
};

template <int NT, int KT, int TILES>
Geometry geometry(int S, int d_in) {
  Geometry g{};
  g.ts = d_in > 0 ? kStageFloats / (16 * d_in) : S;
  if (g.ts > S) g.ts = S;
  if (g.ts < 1) g.ts = 1;
  g.pitch = 8 * KT + 4;
  g.tile_floats = 16 * g.pitch + ((16 * g.ts * d_in + 3) & ~3);
  g.smem = w_bytes<NT, KT>() + NT * 8 * sizeof(float) +
           static_cast<size_t>(kWarps) * TILES * g.tile_floats *
               sizeof(float);
  return g;
}

template <int NT, int KT, int TILES>
__global__ void __launch_bounds__(32 * kWarps, min_blocks<NT, KT, TILES>())
lstm_mma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ b, float* __restrict__ out,
                long long B, int S, int d_in, int H, Geometry geo) {
  constexpr bool kPre = presplit<NT, KT>();
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = d_in + H, G = 4 * H;
  uint4* w_pre = reinterpret_cast<uint4*>(smem);           // [KT][NT][32]
  float2* w_f32 = reinterpret_cast<float2*>(smem);         // or this
  float* bias_s = reinterpret_cast<float*>(smem + w_bytes<NT, KT>());
  float* tiles = bias_s + NT * 8;

  // prologue: W to B fragments, interleaved column n = 4u + gate
  for (int e = threadIdx.x; e < KT * NT * 32; e += blockDim.x) {
    const int lane = e & 31, j = (e >> 5) % NT, kk = (e >> 5) / NT;
    const int n = j * 8 + (lane >> 2), u = n >> 2, col = (n & 3) * H + u;
    const int k0 = kk * 8 + (lane & 3), k1 = k0 + 4;
    const float v0 = u < H && k0 < K ? w[k0 * G + col] : 0.f;
    const float v1 = u < H && k1 < K ? w[k1 * G + col] : 0.f;
    if constexpr (kPre) {
      const Split s0 = split(v0), s1 = split(v1);
      w_pre[e] = make_uint4(s0.hi, s1.hi, s0.lo, s1.lo);
    } else {
      w_f32[e] = make_float2(v0, v1);
    }
  }
  for (int n = threadIdx.x; n < NT * 8; n += blockDim.x)
    bias_s[n] = (n >> 2) < H ? b[(n & 3) * H + (n >> 2)] : 0.f;
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long r0 =
      (static_cast<long long>(blockIdx.x) * kWarps + warp) * TILES * 16;
  if (r0 >= B) return;
  const int g = lane >> 2, q = lane & 3, pitch = geo.pitch, ts = geo.ts;
  const bool odd = q & 1;
  const int my_row = g + (odd ? 8 : 0);
  const long long SD = static_cast<long long>(S) * d_in;
  float* at[TILES];                    // [16][pitch]: [x_t | h | 0]
  float* xs[TILES];                    // [16][ts * d_in]: x of a chunk
  int rows[TILES];
#pragma unroll
  for (int tile = 0; tile < TILES; ++tile) {
    at[tile] = tiles + (warp * TILES + tile) * geo.tile_floats;
    xs[tile] = at[tile] + 16 * pitch;
    const long long left = B - r0 - 16 * tile;
    rows[tile] = left <= 0 ? 0 : (left < 16 ? static_cast<int>(left) : 16);
    for (int i = lane; i < 16 * pitch; i += 32) at[tile][i] = 0.f;
  }
  float c[TILES][NT];
#pragma unroll
  for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
    for (int j = 0; j < NT; ++j) c[tile][j] = 0.f;

  for (int t0 = 0; t0 < S; t0 += ts) {
    const int ns = S - t0 < ts ? S - t0 : ts;
    const int span = ns * d_in;            // x floats of a row, this chunk
    __syncwarp();                          // the last chunk's x read
#pragma unroll
    for (int tile = 0; tile < TILES; ++tile)
      for (int e = lane; e < 16 * span; e += 32) {
        const int row = e / span, rem = e - row * span;
        xs[tile][row * ts * d_in + rem] = row < rows[tile]
            ? x[(r0 + 16 * tile + row) * SD +
                static_cast<long long>(t0) * d_in + rem] : 0.f;
      }
    __syncwarp();
#pragma unroll 1
    for (int s = 0; s < ns; ++s) {
#pragma unroll
      for (int tile = 0; tile < TILES; ++tile)       // lane: row, k parity
        for (int k = lane >> 4; k < d_in; k += 2)
          at[tile][(lane & 15) * pitch + k] =
              xs[tile][((lane & 15) * ts + s) * d_in + k];
      __syncwarp();                        // x_t and h in place
      Split af[TILES][KT][4];
#pragma unroll
      for (int tile = 0; tile < TILES; ++tile)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const float* p = at[tile] + g * pitch + kk * 8 + q;
          af[tile][kk][0] = split(p[0]);
          af[tile][kk][1] = split(p[8 * pitch]);
          af[tile][kk][2] = split(p[4]);
          af[tile][kk][3] = split(p[8 * pitch + 4]);
        }
      __syncwarp();                        // A read before h is written
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const float2 bj =
            *reinterpret_cast<const float2*>(bias_s + j * 8 + 2 * q);
        float z[TILES][4];
#pragma unroll
        for (int tile = 0; tile < TILES; ++tile) {
          z[tile][0] = z[tile][2] = bj.x;
          z[tile][1] = z[tile][3] = bj.y;
        }
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const int e = (kk * NT + j) * 32 + lane;
          Split b0, b1;
          if constexpr (kPre) {
            const uint4 v = w_pre[e];
            b0 = Split{v.x, v.z};
            b1 = Split{v.y, v.w};
          } else {
            const float2 v = w_f32[e];
            b0 = split(v.x);
            b1 = split(v.y);
          }
#pragma unroll
          for (int tile = 0; tile < TILES; ++tile)
            tf32::mma3(z[tile], af[tile][kk], b0, b1);
        }
        // even lanes keep row g's (i, f), odd lanes row g+8's (g, o)
        const int u = 2 * j + (q >> 1);
#pragma unroll
        for (int tile = 0; tile < TILES; ++tile) {
          const float (&zt)[4] = z[tile];
          const float s0 = __shfl_xor_sync(0xffffffffu,
                                           odd ? zt[0] : zt[2], 1);
          const float s1 = __shfl_xor_sync(0xffffffffu,
                                           odd ? zt[1] : zt[3], 1);
          const float h = unit_update<true>(
              odd ? s0 : zt[0], odd ? s1 : zt[1], odd ? zt[2] : s0,
              odd ? zt[3] : s1, c[tile][j]);
          if (u < H) at[tile][my_row * pitch + d_in + u] = h;
        }
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int tile = 0; tile < TILES; ++tile)
    for (int e = lane; e < rows[tile] * H; e += 32) {
      const int row = e / H, u = e - row * H;
      out[(r0 + 16 * tile + row) * H + u] =
          at[tile][row * pitch + d_in + u];
    }
}

template <int NT, int KT, int TILES>
cudaError_t launch(const float* x, const float* w, const float* b,
                   float* out, long long B, int S, int d_in, int H,
                   cudaStream_t stream) {
  const Geometry geo = geometry<NT, KT, TILES>(S, d_in);
  // opt in to all of the card's shared memory once, before any launch
  // (so never inside a CUDA-graph capture after the first call)
  static int smem_max = 0;
  if (smem_max == 0) {
    const int optin = smem_optin();
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_mma_kernel<NT, KT, TILES>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (err != cudaSuccess) return err;
    smem_max = optin;
  }
  if (geo.smem > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  const long long per_block = 16LL * kWarps * TILES;
  const long long blocks = (B + per_block - 1) / per_block;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  lstm_mma_kernel<NT, KT, TILES>
      <<<static_cast<unsigned>(blocks), 32 * kWarps, geo.smem, stream>>>(
          x, w, b, out, B, S, d_in, H, geo);
  return cudaGetLastError();
}

// tiles a warp: two where NT x KT <= 50 (Table I's instance, where two
// were faster than one), one above, for registers
template <int NT, int KT>
cudaError_t launch_instance(const float* x, const float* w, const float* b,
                            float* out, long long B, int S, int d_in, int H,
                            cudaStream_t stream) {
  return launch<NT, KT, NT * KT <= 50 ? 2 : 1>(x, w, b, out, B, S, d_in, H,
                                                stream);
}

template <int NT>
cudaError_t launch_kt(int kt, const float* x, const float* w, const float* b,
                      float* out, long long B, int S, int d_in, int H,
                      cudaStream_t stream) {
  if constexpr (NT < kMaxNt) {       // more than 32 units: K > 24
    if (kt <= 3)
      return launch_instance<NT, 3>(x, w, b, out, B, S, d_in, H, stream);
  }
  if (kt <= 5)
    return launch_instance<NT, 5>(x, w, b, out, B, S, d_in, H, stream);
  if (kt <= 8)
    return launch_instance<NT, 8>(x, w, b, out, B, S, d_in, H, stream);
  return launch_instance<NT, kMaxKt>(x, w, b, out, B, S, d_in, H, stream);
}

cudaError_t launch_any(const float* x, const float* w, const float* b,
                       float* out, long long B, int S, int d_in, int H,
                       cudaStream_t stream) {
  const int nt = (H + 1) / 2, kt = (d_in + H + 7) / 8;
  if (nt > kMaxNt || kt > kMaxKt) return cudaErrorInvalidValue;
  if (nt <= 10) return launch_kt<10>(kt, x, w, b, out, B, S, d_in, H, stream);
  if (nt <= 16) return launch_kt<16>(kt, x, w, b, out, B, S, d_in, H, stream);
  return launch_kt<kMaxNt>(kt, x, w, b, out, B, S, d_in, H, stream);
}

}  // namespace mma

// --------------------------------------------------------------- simt ----
namespace simt {

struct Args {
  long long B;
  int S, d_in, H, bb, w_in_smem;
};

__global__ void lstm_cell_kernel(const float* __restrict__ x,
                                 const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 float* __restrict__ out, Args a) {
  extern __shared__ float smem[];
  const int H = a.H, d_in = a.d_in, K = d_in + H, G = 4 * H;
  const int T = blockDim.x, tid = threadIdx.x;
  const int pairs = a.bb * H;
  float* b_s = smem;                                  // G
  float* h_cur = b_s + G;                             // bb * H
  float* h_nxt = h_cur + pairs;                       // bb * H
  float* c_s = h_nxt + pairs;                         // bb * H
  float* w_s = c_s + pairs;                           // K * G, if staged
  const float* W = w;
  if (a.w_in_smem) {
    for (int i = tid; i < K * G; i += T) w_s[i] = w[i];
    W = w_s;
  }
  for (int i = tid; i < G; i += T) b_s[i] = b[i];
  for (int i = tid; i < pairs; i += T) {
    h_cur[i] = 0.f;
    c_s[i] = 0.f;
  }
  __syncthreads();

  const long long b0 = static_cast<long long>(blockIdx.x) * a.bb;
  for (int t = 0; t < a.S; ++t) {
    for (int idx = tid; idx < pairs; idx += T) {
      const int wl = idx / H;
      const int j = idx - wl * H;
      const long long row = b0 + wl;
      if (row >= a.B) continue;
      float zi = b_s[j], zf = b_s[H + j], zg = b_s[2 * H + j],
            zo = b_s[3 * H + j];
      const float* xt = x + (row * a.S + t) * d_in;
      for (int k = 0; k < d_in; ++k) {
        const float v = xt[k];
        const float* wk = W + k * G + j;
        zi = fmaf(v, wk[0], zi);
        zf = fmaf(v, wk[H], zf);
        zg = fmaf(v, wk[2 * H], zg);
        zo = fmaf(v, wk[3 * H], zo);
      }
      const float* hw = h_cur + wl * H;
      for (int k = 0; k < H; ++k) {
        const float v = hw[k];
        const float* wk = W + (d_in + k) * G + j;
        zi = fmaf(v, wk[0], zi);
        zf = fmaf(v, wk[H], zf);
        zg = fmaf(v, wk[2 * H], zg);
        zo = fmaf(v, wk[3 * H], zo);
      }
      float c = c_s[idx];
      h_nxt[idx] = unit_update<false>(zi, zf, zg, zo, c);
      c_s[idx] = c;
    }
    __syncthreads();                 // every h of step t is written
    float* tmp = h_cur;
    h_cur = h_nxt;
    h_nxt = tmp;
  }
  for (int idx = tid; idx < pairs; idx += T) {
    const long long row = b0 + idx / H;
    if (row < a.B) out[row * H + idx % H] = h_cur[idx];
  }
}

size_t smem_bytes(int H, int d_in, int bb, bool w_in_smem) {
  const size_t G = 4 * static_cast<size_t>(H);
  return (G + 3 * static_cast<size_t>(bb) * H +
          (w_in_smem ? (d_in + static_cast<size_t>(H)) * G : 0)) *
         sizeof(float);
}

cudaError_t launch(const float* x, const float* w, const float* b,
                   float* out, long long B, int S, int d_in, int H,
                   int block_b, cudaStream_t stream) {
  const int smem_max = smem_optin();
  const bool w_in_smem =
      smem_bytes(H, d_in, 1, true) <= static_cast<size_t>(smem_max);
  long long bb = block_b < B ? block_b : B;
  while (bb > 1 &&
         smem_bytes(H, d_in, static_cast<int>(bb), w_in_smem) >
             static_cast<size_t>(smem_max))
    bb = (bb + 1) / 2;
  const size_t smem = smem_bytes(H, d_in, static_cast<int>(bb), w_in_smem);
  if (smem > static_cast<size_t>(smem_max))
    return cudaErrorInvalidValue;                      // cell too wide
  // opt in to all of the card's shared memory once, before any launch
  // (so never inside a CUDA-graph capture after the first call)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_max);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const long long pairs = bb * H;
  const int threads =
      static_cast<int>(pairs >= 256 ? 256 : ((pairs + 31) / 32) * 32);
  const long long blocks = (B + bb - 1) / bb;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Args a{B, S, d_in, H, static_cast<int>(bb), w_in_smem ? 1 : 0};
  lstm_cell_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                     stream>>>(x, w, b, out, a);
  return cudaGetLastError();
}

}  // namespace simt

// both forms of both activations at each z: out[i] = {sigmoid_mufu,
// sigmoidf, tanh_mufu, tanhf}
__global__ void act_sweep_kernel(const float* __restrict__ z,
                                 float4* __restrict__ out, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i < n)
    out[i] = make_float4(sigmoid_mufu(z[i]), sigmoidf(z[i]), tanh_mufu(z[i]),
                         tanhf(z[i]));
}

}  // namespace

// z (n,), out (n, 4): float32, contiguous
extern "C" int lstm_cell_act_sweep(const void* z, void* out, long long n,
                                   void* stream) {
  const long long blocks = (n + 255) / 256;
  if (n <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  act_sweep_kernel<<<static_cast<unsigned>(blocks), 256, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<float4*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

// x (B, S, d_in), w (d_in + H, 4H), b (4H,), out (B, H): float32,
// contiguous. variant 0 is `simt` (block_b the most windows one block
// takes), 1 is `mma` (block_b not read); a shape outside `mma`'s envelope
// is refused with cudaErrorInvalidValue.
extern "C" int lstm_cell_launch(const void* x, const void* w, const void* b,
                                void* out, long long B, int S, int d_in,
                                int H, int block_b, int variant,
                                void* stream) {
  if (B <= 0 || S < 0 || d_in < 0 || H <= 0 || block_b <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* wf = static_cast<const float*>(w);
  const auto* bf = static_cast<const float*>(b);
  auto* of = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (variant == 0)
    return static_cast<int>(
        simt::launch(xf, wf, bf, of, B, S, d_in, H, block_b, st));
  if (variant == 1)
    return static_cast<int>(
        mma::launch_any(xf, wf, bf, of, B, S, d_in, H, st));
  return static_cast<int>(cudaErrorInvalidValue);
}
