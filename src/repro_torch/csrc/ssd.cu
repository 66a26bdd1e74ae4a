// B6: the Mamba-2 SSD scan (n_groups = 1) — y and the final state of every
// (batch, head), as a chunk-parallel scan in three passes.
//
// Replaces the TPU kernel src/repro/kernels/mamba2/kernel.py::_ssd_kernel,
// launched by kernel.py::ssd_pallas through ops.py::ssd.
//
// What it computes, as the reference's chunked form does
// (src/repro/model/ssm.py::ssd_chunked): with a = dt * A, a_cs its running
// sum inside a chunk of L steps and a_tot = a_cs[L-1], chunk c's own state
//   T_c = sum_j (dt_j x_j) (B_j e^{a_tot - a_cs[j]})^T          (P x N),
// the carry S_{c+1} = e^{a_tot} S_c + T_c from S_0 = h0, and
//   y_i = sum_{j <= i} (C_i . B_j) e^{a_cs[i] - a_cs[j]} dt_j x_j
//         + e^{a_cs[i]} C_i . S_c.
// The decay between two positions of a chunk is applied to the score tile
// elementwise, j <= i only, so no exponent is ever positive (A < 0, dt > 0):
// factoring it as e^{a_cs[i]} e^{-a_cs[j]} would overflow, since a_cs
// passes -100 inside a chunk of 128. a_cs is kept in f64: an f32
// difference of two sums near -100 loses about 1e-5 of each decay; each
// exponent is rounded to f32 once, after the difference. The result does
// not depend on the chunk, so the kernel takes its own, L = 128; a ragged
// last chunk is masked as the reference pads it (dt = 0: decay 1, no
// contribution).
//
// Three launches a call (the carry pass is csrc/chunk_carry.cuh):
//   1. chunk state, grid (H, nc, B): T_c and e^{a_tot} into the scratch
//      `states` (B, nc, H, P, N) and `decay` (B, nc, H); the blocks of head
//      0 also write the chunk's C B^T, the same for every head (n_groups =
//      1), into `cb` (B, nc, L, L): all f32;
//   2. carry, grid (B * H, state tiles): in place, so `states` then holds
//      each chunk's start state S_c; the final state to `hout`;
//   3. output, grid (H, nc, B): y of the chunk from S_c and C B^T.
// At Zamba2-7B's SSD (112 heads, P = N = 64, S = 4,096) passes 1 and 3
// launch 32 x 112 = 3,584 blocks each, 9 waves at 3 blocks an SM; the
// scratch is 60.8 MB.
//
// What bounds it on an H100: the function moves 241 MB (0.072 ms at 3.35
// TB/s); the chunked form's products are 11.3 GFLOP (the causal half of
// C.B^T, once, and of scores.(dt x), the state read and the chunk states),
// 0.17 ms in f32 FMAs. So the products go to the tensor cores, in split
// TF32 for f32 accuracy (plain TF32 keeps about three decimal digits, far
// from the 1e-4 bar at |y| in the tens): each operand is
// a = a_hi + a_lo, both TF32, and a b takes three mma.sync.m16n8k8
// products, lo.hi + hi.lo + hi.hi, summed in f32 (3 x 7.5 GFLOP of TF32 at
// 495 TFLOP/s: 0.046 ms, under the bytes); the helpers are csrc/tf32.cuh's.
//
// Design: blocks of 4 warps; each warp owns 16-row tiles of the chunk.
// Pass 1: the chunk's dt x e^{a_tot - a_cs} and B rows staged in shared
// memory, T = (dt x)^T B over k = 128 steps, one warp per 16 rows of P.
// Pass 3: dt x rows and S_c (split into TF32 parts once) staged; warp w
// takes row tiles w and 7 - w (equal causal work); C's fragments stay in
// registers, split once; y starts from C S_c^T scaled by e^{a_cs[i]}; then
// for each pair of 8-column tiles left of or on the diagonal the scores,
// read from `cb` in L2, are decayed and masked in registers and fed
// straight back as the A operand of scores . (dt x): the accumulator holds
// columns (2t, 2t+1) where the A operand wants (t, t + 4), so the k index
// of that product is permuted and the dt x rows are read in the same
// order. No loop over a tile holds a branch: one would keep ptxas from
// overlapping the tiles' dependent mma chains. x and y stay in the public
// (B, S, H, P) layout; P and N up to 64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "chunk_carry.cuh"
#include "error_string.cuh"
#include "tf32.cuh"

namespace {

using tf32::mma6;
using tf32::Split;
using tf32::split;

constexpr int L = 128;         // the kernel's chunk (steps)
constexpr int DM = 64;         // the largest P and N compiled for
constexpr int NW = 4;          // warps a block
constexpr int NT = 32 * NW;    // == L: one thread per step for the scan
constexpr int LD1 = DM + 8;    // pass 1 row stride: (t * LD + g) conflict-free

static_assert(NT == L, "the scan takes one thread per step");

struct Dims {
  int S, H, P, N, nc;
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}

// ROWS rows of up to DM floats, row j at src + j * stride (zero past row
// nrows and column W), held in registers between load and put: a thread
// holds columns n .. n + 3 of ROWS / 8 rows, all loaded at once, with
// 16-byte loads where the rows are 16-byte aligned; put(j, n, v) then hands
// each group of four on.
template <int ROWS>
struct Rows {
  static constexpr int G = DM / 4, SWEEP = NT / G, BATCH = ROWS / SWEEP;
  float4 v[BATCH];

  template <bool Vec>
  __device__ __forceinline__ void load_as(const float* __restrict__ src,
                                          long long stride, int W,
                                          int nrows) {
    const int n = 4 * (threadIdx.x % G), jr = threadIdx.x / G;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) {
      const int j = SWEEP * u + jr;
      const float* row = src + j * stride;
      const bool ok = j < nrows;
      if (Vec)
        v[u] = ok && n < W ? *reinterpret_cast<const float4*>(row + n)
                           : zero4();
      else
        v[u] = make_float4(ok && n < W ? row[n] : 0.f,
                           ok && n + 1 < W ? row[n + 1] : 0.f,
                           ok && n + 2 < W ? row[n + 2] : 0.f,
                           ok && n + 3 < W ? row[n + 3] : 0.f);
    }
  }

  __device__ __forceinline__ void load(const float* __restrict__ src,
                                       long long stride, int W, int nrows) {
    if (W % 4 == 0 && stride % 4 == 0 &&
        reinterpret_cast<uintptr_t>(src) % 16 == 0)
      load_as<true>(src, stride, W, nrows);
    else
      load_as<false>(src, stride, W, nrows);
  }

  template <typename Put>
  __device__ __forceinline__ void put(Put f) const {
    const int n = 4 * (threadIdx.x % G), jr = threadIdx.x / G;
#pragma unroll
    for (int u = 0; u < BATCH; ++u) f(SWEEP * u + jr, n, v[u]);
  }
};

// The chunk's running sum a_cs[t] = sum_{s <= t} dt_s A, in f64, one
// thread per step (steps past S have dt = 0); dts[t] gets dt. Ends synced.
__device__ void chunk_cumsum(const float* __restrict__ dt, float Ah,
                             long long row0, int c0, const Dims& d,
                             int h, double* acs, float* dts) {
  __shared__ double warp_sum[NW];
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const float dv = c0 + t < d.S ? dt[(row0 + c0 + t) * d.H + h] : 0.f;
  double v = static_cast<double>(__fmul_rn(dv, Ah));
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double n = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) warp_sum[w] = v;
  __syncthreads();
  for (int i = 0; i < w; ++i) v += warp_sum[i];
  acs[t] = v;
  dts[t] = dv;
  __syncthreads();
}

// The products over n (C B^T, C S_c^T) take their k index permuted: in each
// 16 columns n0 .. n0 + 15 lane t holds n0 + 4t .. n0 + 4t + 3, the k = t
// and k = t + 4 slots of two k-steps (a dot product does not depend on the
// order of its terms, and both operands follow the same map), so each lane
// reads its four with one 16-byte load.

// row[n .. n + 3] (n a multiple of 4), zero past N; one 16-byte load where
// rows are 16-byte aligned (vec: N % 4 == 0)
__device__ __forceinline__ float4 load4(const float* row, int n, int N,
                                        bool vec) {
  if (vec) return n < N ? *reinterpret_cast<const float4*>(row + n)
                        : zero4();
  return make_float4(n < N ? row[n] : 0.f, n + 1 < N ? row[n + 1] : 0.f,
                     n + 2 < N ? row[n + 2] : 0.f,
                     n + 3 < N ? row[n + 3] : 0.f);
}

// C rows i0 + g and i0 + g + 8 of the chunk as A fragments of k-steps 2qq
// and 2qq + 1 over n, k permuted as above
__device__ __forceinline__ void load_c2(Split (&ca)[4], Split (&cb)[4],
                                        const float* __restrict__ Cm,
                                        long long row0, int c0, int i0,
                                        int qq, const Dims& d) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const bool vec = d.N % 4 == 0;
  const int n = 16 * qq + 4 * tq;
  const float4 lo = c0 + i0 + g < d.S
      ? load4(Cm + (row0 + c0 + i0 + g) * d.N, n, d.N, vec) : zero4();
  const float4 hi = c0 + i0 + g + 8 < d.S
      ? load4(Cm + (row0 + c0 + i0 + g + 8) * d.N, n, d.N, vec) : zero4();
  ca[0] = split(lo.x);
  ca[1] = split(hi.x);
  ca[2] = split(lo.y);
  ca[3] = split(hi.y);
  cb[0] = split(lo.z);
  cb[1] = split(hi.z);
  cb[2] = split(lo.w);
  cb[3] = split(hi.w);
}

// ---- pass 1: the chunk's own state T_c, from zero --------------------------
__global__ void __launch_bounds__(NT)
    ssd_state_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ Bm,
                     const float* __restrict__ Cm, float* __restrict__ states,
                     float* __restrict__ decay, float* __restrict__ cb,
                     Dims d) {
  extern __shared__ double smem1[];
  double* acs = smem1;                           // L
  float* dts = reinterpret_cast<float*>(acs + L);  // L
  float* dec = dts + L;                          // L: dt e^{a_tot - a_cs}
  float* Xs = dec + L;                           // L x LD1: [j][p]
  float* Bs = Xs + L * LD1;                      // L x LD1: [j][n]

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L, P = d.P, N = d.N;
  const long long row0 = static_cast<long long>(b) * d.S;
  chunk_cumsum(dt, A[h], row0, c0, d, h, acs, dts);
  const double a_tot = acs[L - 1];
  dec[threadIdx.x] = dts[threadIdx.x] *
      expf(static_cast<float>(a_tot - acs[threadIdx.x]));
  __syncthreads();
  Rows<L> rows;
  rows.load(x + ((row0 + c0) * d.H + h) * P, static_cast<long long>(d.H) * P,
            P, d.S - c0);
  rows.put([&](int j, int n, float4 v) {
    const float f = dec[j];
    *reinterpret_cast<float4*>(Xs + j * LD1 + n) =
        make_float4(v.x * f, v.y * f, v.z * f, v.w * f);
  });
  rows.load(Bm + (row0 + c0) * N, N, N, d.S - c0);
  rows.put([&](int j, int n, float4 v) {
    *reinterpret_cast<float4*>(Bs + j * LD1 + n) = v;
  });
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int m0 = 16 * (threadIdx.x >> 5);        // this warp's rows of P
  float* T = states + ((static_cast<long long>(b) * d.nc + c) * d.H + h)
                      * P * N;
  if (m0 < P) {
    float acc[8][4] = {};
    for (int k0 = 0; k0 < L; k0 += 16) {   // k-steps k0 and k0 + 8
      const float* x0 = Xs + (k0 + tq) * LD1 + m0 + g;
      const Split a0[4] = {split(x0[0]), split(x0[8]), split(x0[4 * LD1]),
                           split(x0[4 * LD1 + 8])};
      const Split a1[4] = {split(x0[8 * LD1]), split(x0[8 * LD1 + 8]),
                           split(x0[12 * LD1]), split(x0[12 * LD1 + 8])};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float* b0 = Bs + (k0 + tq) * LD1 + nt * 8 + g;
        mma6(acc[nt], a0, split(b0[0]), split(b0[4 * LD1]), a1,
             split(b0[8 * LD1]), split(b0[12 * LD1]));
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int p = m0 + g + (e >> 1) * 8, n = nt * 8 + 2 * tq;
        if (p >= P) continue;
        if (N % 2 == 0 && n < N) {   // 8-byte aligned pairs
          *reinterpret_cast<float2*>(T + p * N + n) =
              make_float2(acc[nt][e], acc[nt][e + 1]);
        } else {
          if (n < N) T[p * N + n] = acc[nt][e];
          if (n + 1 < N) T[p * N + n + 1] = acc[nt][e + 1];
        }
      }
  }
  if (threadIdx.x == 0)
    decay[(static_cast<long long>(b) * d.nc + c) * d.H + h] =
        expf(static_cast<float>(a_tot));
  if (h != 0) return;
  // C B^T of the chunk, the same for every head (n_groups = 1), once: the
  // lower 8-column tiles of each 16-row tile, into `cb` (B, nc, L, L). Warp
  // w takes row tiles w and 7 - w (equal causal work); B's staged rows are
  // read k-permuted.
  float* cbc = cb + (static_cast<long long>(b) * d.nc + c) * L * L;
  const int w = threadIdx.x >> 5;
  for (int half = 0; half < 2; ++half) {
    const int rt = half == 0 ? w : 2 * NW - 1 - w, i0 = 16 * rt;
    Split ca[8][4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
      load_c2(ca[2 * qq], ca[2 * qq + 1], Cm, row0, c0, i0, qq, d);
    for (int jt = 0; jt <= 2 * rt + 1; ++jt) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const float4 b4 = *reinterpret_cast<const float4*>(
            Bs + (jt * 8 + g) * LD1 + 16 * qq + 4 * tq);
        mma6(sc, ca[2 * qq], split(b4.x), split(b4.y), ca[2 * qq + 1],
             split(b4.z), split(b4.w));
      }
      float* out = cbc + (i0 + g) * L + jt * 8 + 2 * tq;
      *reinterpret_cast<float2*>(out) = make_float2(sc[0], sc[1]);
      *reinterpret_cast<float2*>(out + 8 * L) = make_float2(sc[2], sc[3]);
    }
  }
}

// ---- pass 3: y of the chunk from its start state S_c -----------------------
// S_c sits in shared memory in 16-byte chunks XOR-swizzled by the row's
// parity, so the two rows of a k-permuted load phase fall in disjoint banks;
// dt x rows sit in pairs of steps (j, j + 1) side by side, so the permuted
// (2t, 2t + 1) rows of scores . (dt x) come in one 8-byte load. The scores
// are pass 1's C B^T, read from L2 (every head of a chunk reads the same).
constexpr int LDX2 = 2 * DM + 8;   // floats a pair of dt x rows

__device__ __forceinline__ int swz(int row, int n) {
  return row * DM + (((n >> 2) ^ ((row & 1) << 2)) << 2) + (n & 3);
}

__global__ void __launch_bounds__(NT, 3)
    ssd_output_kernel(const float* __restrict__ x,
                      const float* __restrict__ dt,
                      const float* __restrict__ A,
                      const float* __restrict__ Cm,
                      const float* __restrict__ states,
                      const float* __restrict__ cb,
                      float* __restrict__ y, Dims d) {
  extern __shared__ double smem3[];
  double* acs = smem3;                           // L
  float* dts = reinterpret_cast<float*>(acs + L);  // L
  float* Xs = dts + L;                           // L / 2 x LDX2: dt x pairs
  // S_c split once into TF32 hi and lo parts, DM x DM each, swizzled
  uint32_t* Sh = reinterpret_cast<uint32_t*>(Xs + L / 2 * LDX2);
  uint32_t* Sl = Sh + DM * DM;

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int c0 = c * L, P = d.P, N = d.N;
  const long long row0 = static_cast<long long>(b) * d.S;
  const long long bc = static_cast<long long>(b) * d.nc + c;
  chunk_cumsum(dt, A[h], row0, c0, d, h, acs, dts);
  Rows<L> xr;
  Rows<DM> sr;
  xr.load(x + ((row0 + c0) * d.H + h) * P, static_cast<long long>(d.H) * P,
          P, d.S - c0);
  sr.load(states + (bc * d.H + h) * P * N, N, N, P);
  xr.put([&](int j, int n, float4 v) {   // dt x, pairs of rows
    const float f = dts[j];
    float* o = Xs + (j >> 1) * LDX2 + 2 * n + (j & 1);
    o[0] = v.x * f;
    o[2] = v.y * f;
    o[4] = v.z * f;
    o[6] = v.w * f;
  });
  sr.put([&](int p, int n, float4 v) {   // S_c [p][n], swizzled
    const Split e[4] = {split(v.x), split(v.y), split(v.z), split(v.w)};
    *reinterpret_cast<uint4*>(Sh + swz(p, n)) =
        make_uint4(e[0].hi, e[1].hi, e[2].hi, e[3].hi);
    *reinterpret_cast<uint4*>(Sl + swz(p, n)) =
        make_uint4(e[0].lo, e[1].lo, e[2].lo, e[3].lo);
  });
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int w = threadIdx.x >> 5;
  const float* cbc = cb + bc * L * L;
  for (int half = 0; half < 2; ++half) {
    const int rt = half == 0 ? w : 2 * NW - 1 - w;   // 16-row tile
    const int i0 = 16 * rt;
    Split ca[8][4];
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
      load_c2(ca[2 * qq], ca[2 * qq + 1], Cm, row0, c0, i0, qq, d);
    // y = e^{a_cs[i]} C_i . S_c: B fragment (k = n, col = p) = S_c[p][n]
    float yacc[8][4] = {};
#pragma unroll
    for (int qq = 0; qq < 4; ++qq)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int at = swz(nt * 8 + g, 16 * qq + 4 * tq);
        const uint4 hi = *reinterpret_cast<const uint4*>(Sh + at);
        const uint4 lo = *reinterpret_cast<const uint4*>(Sl + at);
        mma6(yacc[nt], ca[2 * qq], {hi.x, lo.x}, {hi.y, lo.y},
             ca[2 * qq + 1], {hi.z, lo.z}, {hi.w, lo.w});
      }
    const double ai0 = acs[i0 + g], ai1 = acs[i0 + g + 8];
    const float e0 = expf(static_cast<float>(ai0));
    const float e1 = expf(static_cast<float>(ai1));
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      yacc[nt][0] *= e0;
      yacc[nt][1] *= e0;
      yacc[nt][2] *= e1;
      yacc[nt][3] *= e1;
    }
    // the diagonal part, column tiles jt and jt + 1 at a time; the scores
    // of the next pair are loaded while this one is computed
    const float* cb0 = cbc + (i0 + g) * L + 2 * tq;       // row i0 + g
    float2 next[2][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      next[u][0] = *reinterpret_cast<const float2*>(cb0 + u * 8);
      next[u][1] = *reinterpret_cast<const float2*>(cb0 + 8 * L + u * 8);
    }
    for (int jt = 0; jt <= 2 * rt; jt += 2) {
      float s[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        s[u][0] = next[u][0].x;
        s[u][1] = next[u][0].y;
        s[u][2] = next[u][1].x;
        s[u][3] = next[u][1].y;
      }
      const int jn = min(jt + 2, 2 * rt);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        next[u][0] = *reinterpret_cast<const float2*>(cb0 + (jn + u) * 8);
        next[u][1] = *reinterpret_cast<const float2*>(cb0 + 8 * L
                                                      + (jn + u) * 8);
      }
      Split sa[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          // decay and mask (j <= i only: every exponent <= 0)
          const int i = i0 + g + (e >> 1) * 8;
          const int j = (jt + u) * 8 + 2 * tq + (e & 1);
          const float f = j <= i ? expf(static_cast<float>(
                                       (e >> 1 ? ai1 : ai0) - acs[j]))
                                 : 0.f;
          // accumulator (g + 8(e/2), 2t + e%2) -> A operand k = t + 4(e%2)
          sa[u][(e & 1) * 2 + (e >> 1)] = split(s[u][e] * f);
        }
      // dt x rows (jt + u) * 8 + 2t and + 1, one pair each
      const float* x0 = Xs + (jt * 4 + tq) * LDX2 + 2 * g;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float2 x2 = *reinterpret_cast<const float2*>(x0 + 16 * nt);
        const float2 x3 = *reinterpret_cast<const float2*>(x0 + 4 * LDX2
                                                           + 16 * nt);
        mma6(yacc[nt], sa[0], split(x2.x), split(x2.y), sa[1], split(x3.x),
             split(x3.y));
      }
    }
#pragma unroll
    for (int e = 0; e < 4; e += 2) {
      const int i = i0 + g + (e >> 1) * 8;
      if (c0 + i >= d.S) continue;
      float* yrow = y + ((row0 + c0 + i) * d.H + h) * P;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int p = nt * 8 + 2 * tq;
        if (P % 2 == 0 && p < P) {   // 8-byte aligned pairs
          *reinterpret_cast<float2*>(yrow + p) =
              make_float2(yacc[nt][e], yacc[nt][e + 1]);
        } else {
          if (p < P) yrow[p] = yacc[nt][e];
          if (p + 1 < P) yrow[p + 1] = yacc[nt][e + 1];
        }
      }
    }
  }
}

constexpr size_t kSmem1 = L * sizeof(double) + (2 * L + 2 * L * LD1)
                                                   * sizeof(float);
constexpr size_t kSmem3 = L * sizeof(double)
                          + (L + L / 2 * LDX2 + 2 * DM * DM) * sizeof(float);

int chunks(int S) { return (S + L - 1) / L; }

}  // namespace

// The plan of a call: out[0] the kernel's chunk, out[1] the chunks, out[2..4]
// the blocks of passes 1-3, out[5..7] the floats of `states`, `decay` and
// `cb`.
extern "C" int ssd_plan(int Bsz, int S, int H, int P, int N, long long* out) {
  const long long nc = chunks(S);
  const dim3 carry = chunk_carry::grid(Bsz, H, P, N);
  out[0] = L;
  out[1] = nc;
  out[2] = out[4] = nc * H * Bsz;
  out[3] = static_cast<long long>(carry.x) * carry.y;
  out[5] = nc * Bsz * H * P * N;
  out[6] = nc * Bsz * H;
  out[7] = nc * Bsz * L * L;
  return 0;
}

// x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N), h0 (B, H, P, N)
// or null, y (B, S, H, P), hout (B, H, P, N), scratch states (B, nc, H, P,
// N), decay (B, nc, H) and cb (B, nc, 128, 128) with nc = ceil(S / 128)
// (ssd_plan): float32, contiguous. Three launches on `stream`.
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, const void* h0,
                          void* y, void* hout, void* states, void* decay,
                          void* cb, int Bsz, int S, int H, int P, int N,
                          void* stream) {
  const int nc = S > 0 ? chunks(S) : 0;
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || P > DM || N <= 0 ||
      N > DM || nc > 65535 || Bsz > 65535 ||
      static_cast<long long>(Bsz) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // once, before any launch (so never inside a CUDA-graph capture after
  // the first call)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = chunk_carry::opt_in(ssd_state_kernel, kSmem1);
    if (err == cudaSuccess)
      err = chunk_carry::opt_in(ssd_output_kernel, kSmem3);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const Dims d{S, H, P, N, nc};
  const dim3 chunk_grid(H, nc, Bsz);
  ssd_state_kernel<<<chunk_grid, NT, kSmem1, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(states),
      static_cast<float*>(decay), static_cast<float*>(cb), d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = chunk_carry::launch<false>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<const float*>(h0), static_cast<float*>(hout), Bsz, nc, H,
      P, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_output_kernel<<<chunk_grid, NT, kSmem3, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Cm),
      static_cast<const float*>(states), static_cast<const float*>(cb),
      static_cast<float*>(y), d);
  return static_cast<int>(cudaGetLastError());
}
