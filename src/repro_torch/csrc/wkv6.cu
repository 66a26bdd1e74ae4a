// B7: the RWKV-6 WKV recurrence — y and the final (N, N) key -> value state
// of every (batch, head), as a chunk-parallel scan in three passes.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py::_wkv6_kernel,
// launched by kernel.py::wkv6_pallas through ops.py::wkv6.
//
// What it computes, as the reference's chunked form does
// (src/repro/model/rwkv.py::wkv6_chunked): 16-step subchunks chained
// through the state S; with csub the running sum of the log-decays w (all
// <= 0) inside a subchunk, cprev = csub - w and tot = csub[15],
//   A_ij = sum_n r_in k_jn e^{cprev_in - csub_jn}   for j < i
//   A_ii = sum_n r_in u_n k_in                      (the bonus)
//   y_i  = sum_j A_ij v_j + (r_i e^{cprev_i}) . S
//   S   <- diag(e^{tot}) S + sum_j (k_j e^{tot - csub_j}) v_j^T
// Only the j < i pairs are ever evaluated, and every factor across
// subchunks is a product of per-subchunk decays, so every exponent is <= 0
// (the masked pairs would overflow to inf and turn into inf * 0 = NaN).
// The chunk of the caller only tiles the reference's grid; the kernel takes
// its own, L = 128 (8 subchunks), and masks a ragged last chunk as the
// reference pads it (w = 0, k = 0: decay 1, no contribution).
//
// Three launches a call (the carry pass is csrc/chunk_carry.cuh):
//   1. chunk state, grid (H, nc, B): the chunk's subchunks chained from a
//      zero state, T_c (N x N), and its per-row total decay e^{tot_c} (the
//      product of the subchunks') into the scratch `states` (B, nc, H, N,
//      N) and `decay` (B, nc, H, N), f32;
//   2. carry, grid (B * H, state tiles): S_{c+1} = diag(e^{tot_c}) S_c +
//      T_c in place from S_0 = h0, so `states` then holds each chunk's start
//      state; the final state to `hout`;
//   3. output, grid (H, nc, B): the chunk's subchunks chained again from
//      S_c, writing y.
// At RWKV6-7B's WKV (64 heads of N = 64, S = 4,096) passes 1 and 3 launch
// 32 x 64 = 2,048 blocks each; the scratch is 34.1 MB.
//
// What bounds it on an H100: the function moves 336 MB (r, k, v, w read
// once, y and the state written once), 0.100 ms at 3.35 TB/s, above its 4.3
// GFLOP of f32 FMAs for the state read and update (0.064 ms). Three passes
// read k, v, w twice and the scratch three times, about 670 MB: 0.20 ms.
// So the products stay f32 FMAs on the CUDA cores; shared memory, read
// about 3 times per FMA in a subchunk's small products, binds before them,
// so every phase is tiled to reuse what it reads.
//
// Design: blocks of 256 threads, the state in registers (pass 1) or in
// shared memory (pass 3), rows of 68 floats so a thread reads four
// neighbours in one 16-byte load; the next subchunk's rows are loaded into
// registers while this one is computed, zero-padded to 64 channels so no
// loop over channels branches. Per subchunk: the 16 rows of r, k, v, w
// staged; 64 threads take the running sums; the 16 x 16 pair matrix in 2 x
// 2 blocks of pairs, 4 lanes a block summing every 4th channel, with a
// shuffle reduction (each value read serves two terms); r e^{cprev}
// (stored channel-major) and k e^{tot - csub}; y as 4 x 4 tiles of (rows,
// values), each over a quarter of the sums, the quarters added by
// shuffles; then a 4 x 4 tile of the state update per thread. The
// subchunk's decays take __expf (at most 2 + 1.17|x| ulps, by CUDA's
// documentation, for the exponents x in (-16, 0] that matter). r, k, v, w
// and y stay in the public (B, S, H, N) layout; N up to 64.
#include <cuda_runtime.h>

#include "chunk_carry.cuh"
#include "error_string.cuh"

namespace {

constexpr int SUB = 16;        // steps per subchunk (kernel.py:18)
constexpr int L = 128;         // the kernel's chunk: 8 subchunks
constexpr int DM = 64;         // the largest N compiled for
constexpr int LD = DM + 4;     // row stride, in floats: 16-byte rows
constexpr int NT = 256;        // 16 x 16 threads
constexpr int NBLK = SUB / 2 * (SUB / 2 + 1) / 2;  // 2 x 2 pair blocks
constexpr int PAIR_THREADS = (4 * NBLK + 31) / 32 * 32;  // whole warps

struct Dims {
  int S, H, N, nc;
};

// The rows (b, t0 .. t0 + 15, h, :) of up to four arrays into registers,
// zero past S and past N, so the shared rows are zero-padded to DM and the
// loops over channels take no branch: a thread holds channels n .. n + 3
// of row tid / 16, n = 4 (tid % 16), one 16-byte load where rows are
// 16-byte aligned (N % 4 == 0), else four 4-byte ones.
static_assert(SUB * DM == 4 * NT, "a thread holds four channels of a row");

struct Rows {
  float4 v[4];

  __device__ __forceinline__ void load(const float* const (&src)[4],
                                       int narr, long long base, int t0,
                                       const Dims& d) {
    const int row = threadIdx.x / 16, n = 4 * (threadIdx.x % 16);
    const bool ok = t0 + row < d.S;
    const long long g = (base + static_cast<long long>(t0 + row) * d.H)
                        * d.N + n;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a >= narr) break;
      const float* p = src[a] + g;
      if (d.N % 4 == 0)
        v[a] = ok && n < d.N ? *reinterpret_cast<const float4*>(p)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
      else
        v[a] = make_float4(ok && n < d.N ? p[0] : 0.f,
                           ok && n + 1 < d.N ? p[1] : 0.f,
                           ok && n + 2 < d.N ? p[2] : 0.f,
                           ok && n + 3 < d.N ? p[3] : 0.f);
    }
  }

  __device__ __forceinline__ void store(float* const (&dst)[4],
                                        int narr) const {
    const int row = threadIdx.x / 16, n = 4 * (threadIdx.x % 16);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (a >= narr) break;
      *reinterpret_cast<float4*>(dst[a] + row * LD + n) = v[a];
    }
  }
};

// s[a][cc], the state at (n0 + a, p0 + cc), <- s e^{tot_n} + sum_j kd[j][n]
// vs[j][p]: a thread's 4 x 4 tile of the rank-16 update, two 16-byte loads
// a step. Entries past N read stale rows and are never stored.
__device__ __forceinline__ void fold(float (&s)[4][4], const float* kd,
                                     const float* vs, const float* etot,
                                     int n0, int p0) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) s[a][cc] *= etot[n0 + a];
#pragma unroll 4
  for (int j = 0; j < SUB; ++j) {
    const float4 k4 = *reinterpret_cast<const float4*>(kd + j * LD + n0);
    const float4 v4 = *reinterpret_cast<const float4*>(vs + j * LD + p0);
    const float kv[4] = {k4.x, k4.y, k4.z, k4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[a][cc] = fmaf(kv[a], vv[cc], s[a][cc]);
  }
}

// ---- pass 1: the chunk's own state T_c, from zero --------------------------
__global__ void __launch_bounds__(NT, 3)
    wkv6_state_kernel(const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ w,
                      float* __restrict__ states, float* __restrict__ decay,
                      Dims d) {
  __shared__ __align__(16) float ks[SUB * LD];  // k, then k e^{tot - csub}
  __shared__ __align__(16) float vs[SUB * LD];
  __shared__ __align__(16) float cs[SUB * LD];  // w, then csub
  __shared__ float etot[DM];

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, N = d.N;
  const int tid = threadIdx.x, n0 = 4 * (tid / 16), p0 = 4 * (tid % 16);
  const int c0 = c * L;
  // (b, t, h, :) lies at ((b * S + t) * H + h) * N
  const long long base = static_cast<long long>(b) * d.S * d.H + h;
  const float* const src[4] = {k, v, w, nullptr};
  float* const dst[4] = {ks, vs, cs, nullptr};
  float s[4][4] = {};                // [n = n0 + a][p = p0 + cc]
  float E = 1.f;                     // thread n < N: the chunk's decay
  Rows next;
  next.load(src, 3, base, c0, d);
  for (int t0 = c0; t0 < c0 + L && t0 < d.S; t0 += SUB) {
    __syncthreads();                 // the last subchunk's readers are done
    next.store(dst, 3);
    if (t0 + SUB < c0 + L && t0 + SUB < d.S) next.load(src, 3, base,
                                                        t0 + SUB, d);
    __syncthreads();
    if (tid < DM) {                  // padded channels: w = 0, decay 1
      float run = 0.f;
      for (int row = 0; row < SUB; ++row) {
        run += cs[row * LD + tid];
        cs[row * LD + tid] = run;
      }
      etot[tid] = expf(run);
      E *= etot[tid];
    }
    __syncthreads();
    for (int i = tid; i < SUB * DM; i += NT) {
      const int row = i / DM, n = i % DM;
      ks[row * LD + n] *= expf(cs[(SUB - 1) * LD + n] - cs[row * LD + n]);
    }
    __syncthreads();
    fold(s, ks, vs, etot, n0, p0);
  }
  const long long bch = (static_cast<long long>(b) * d.nc + c) * d.H + h;
  float* T = states + bch * N * N;
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int n = n0 + a, p = p0 + cc;
      if (n < N && p < N) T[n * N + p] = s[a][cc];
    }
  if (tid < N) decay[bch * N + tid] = E;
}

// ---- pass 3: y of the chunk from its start state S_c -----------------------
__global__ void __launch_bounds__(NT, 4)
    wkv6_output_kernel(const float* __restrict__ r,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ w,
                       const float* __restrict__ u,
                       const float* __restrict__ states,
                       float* __restrict__ y, Dims d) {
  extern __shared__ float4 smem3[];
  float* St = reinterpret_cast<float*>(smem3);  // DM x LD: [n (key)][p]
  float* rs = St + DM * LD;          // SUB x LD each:
  float* ks = rs + SUB * LD;
  float* vs = ks + SUB * LD;
  float* cp = vs + SUB * LD;         // w, then cprev = csub - w
  float* cs = cp + SUB * LD;         // csub
  float* rdT = cs + SUB * LD;        // DM x SUB: r e^{cprev}, [n][i]
  float* kd = rdT + SUB * LD;        // k e^{tot - csub}
  float* AmT = kd + SUB * LD;        // SUB x SUB: the pair matrix, [j][i]
  float* us = AmT + SUB * (SUB + 1); // DM
  float* etot = us + DM;             // DM

  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, N = d.N;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int n0 = 4 * ty, p0 = 4 * tx;
  // the y tile of a thread: rows yi .. yi + 3 (warp / 2), columns yp .. yp
  // + 3, and the quarter yq of the sums (lane / 8), so the 8 lanes of a
  // shared-memory phase read 8 neighbouring column groups of one row
  const int yi = 4 * (tid / 64), yp = 4 * ((tid / 32) % 2 * 8 + tid % 8);
  const int yq = (tid % 32) / 8;
  const int c0 = c * L;
  const long long base = static_cast<long long>(b) * d.S * d.H + h;
  const long long bch = (static_cast<long long>(b) * d.nc + c) * d.H + h;
  const float* S0 = states + bch * N * N;
  for (int i = tid; i < DM * DM; i += NT) {    // zero-padded to DM x DM
    const int n = i / DM, p = i % DM;
    St[n * LD + p] = n < N && p < N ? S0[n * N + p] : 0.f;
  }
  for (int n = tid; n < DM; n += NT)
    us[n] = n < N ? u[static_cast<long long>(h) * N + n] : 0.f;
  for (int e = tid; e < SUB * SUB; e += NT) AmT[e] = 0.f;   // j > i stay 0
  const float* const src[4] = {r, k, v, w};
  float* const dst[4] = {rs, ks, vs, cp};
  Rows next;
  next.load(src, 4, base, c0, d);
  for (int t0 = c0; t0 < c0 + L && t0 < d.S; t0 += SUB) {
    const bool last = t0 + SUB >= c0 + L || t0 + SUB >= d.S;
    __syncthreads();                 // the last subchunk's readers are done
    next.store(dst, 4);
    if (!last) next.load(src, 4, base, t0 + SUB, d);
    __syncthreads();
    if (tid < DM) {                  // padded channels: w = 0, decay 1
      float run = 0.f;
      for (int row = 0; row < SUB; ++row) {
        const float wv = cp[row * LD + tid];
        run += wv;
        cs[row * LD + tid] = run;
        cp[row * LD + tid] = run - wv;
      }
      etot[tid] = expf(run);
    }
    __syncthreads();
    // the pair matrix in 2 x 2 blocks of pairs (rows 2I, 2I + 1, columns
    // 2J, 2J + 1, J <= I), 4 lanes a block, each summing every 4th channel:
    // each value read from shared memory serves two terms. j < i: r_i k_j
    // e^{cprev_i - csub_j}, the exponent masked to <= 0 before the exp;
    // j = i: r_i k_i u (the bonus); j > i: 0. No branch, so the terms of a
    // lane are independent. The first 5 warps take the 36 blocks; the
    // spare groups of the fifth repeat the last block and store nothing.
    if (tid < PAIR_THREADS) {
      const int blk = tid / 4, l4 = tid % 4, bb = min(blk, NBLK - 1);
      int I = static_cast<int>((sqrtf(8.f * bb + 1.f) - 1.f) * 0.5f);
      if ((I + 1) * (I + 2) / 2 <= bb) ++I;
      const int i0 = 2 * I, j0 = 2 * (bb - I * (I + 1) / 2);
      float acc[2][2] = {};
#pragma unroll
      for (int kq = 0; kq < DM / 4; ++kq) {
        const int n = l4 + 4 * kq;
        const float ri[2] = {rs[i0 * LD + n], rs[(i0 + 1) * LD + n]};
        const float ci[2] = {cp[i0 * LD + n], cp[(i0 + 1) * LD + n]};
        const float kj[2] = {ks[j0 * LD + n], ks[(j0 + 1) * LD + n]};
        const float cj[2] = {cs[j0 * LD + n], cs[(j0 + 1) * LD + n]};
        const float un = us[n];
#pragma unroll
        for (int di = 0; di < 2; ++di)
#pragma unroll
          for (int dj = 0; dj < 2; ++dj) {
            const int i = i0 + di, j = j0 + dj;
            const float e = __expf(j < i ? ci[di] - cj[dj] : 0.f);
            const float f = j < i ? e : j == i ? un : 0.f;
            acc[di][dj] = fmaf(ri[di] * kj[dj], f, acc[di][dj]);
          }
      }
#pragma unroll
      for (int di = 0; di < 2; ++di)
#pragma unroll
        for (int dj = 0; dj < 2; ++dj) {
          float a = acc[di][dj];
          a += __shfl_xor_sync(0xffffffffu, a, 1);
          a += __shfl_xor_sync(0xffffffffu, a, 2);
          if (blk < NBLK && l4 == 0 && j0 + dj <= i0 + di)
            AmT[(j0 + dj) * SUB + i0 + di] = a;
        }
    }
    for (int e = tid; e < SUB * DM; e += NT) {
      const int row = e / DM, n = e % DM;
      kd[row * LD + n] = ks[row * LD + n] *
                         __expf(cs[(SUB - 1) * LD + n] - cs[row * LD + n]);
    }
    for (int e = tid; e < SUB * DM; e += NT) {   // rows fastest: [n][i]
      const int row = e % SUB, n = e / SUB;
      rdT[e] = rs[row * LD + n] * __expf(cp[row * LD + n]);
    }
    __syncthreads();
    {  // y rows yi .. yi + 3, values yp .. yp + 3, over a quarter of the
       // sums (j and n), the quarters then added across lanes 8 apart
      float acc[4][4] = {};
      const auto add = [&acc](float4 a4, float4 b4) {
        const float av[4] = {a4.x, a4.y, a4.z, a4.w};
        const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int ii = 0; ii < 4; ++ii)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc)
            acc[ii][cc] = fmaf(av[ii], bv[cc], acc[ii][cc]);
      };
#pragma unroll
      for (int jj = 0; jj < SUB / 4; ++jj) {
        const int j = yq * (SUB / 4) + jj;
        add(*reinterpret_cast<const float4*>(AmT + j * SUB + yi),
            *reinterpret_cast<const float4*>(vs + j * LD + yp));
      }
#pragma unroll
      for (int nn = 0; nn < DM / 4; ++nn) {
        const int n = yq * (DM / 4) + nn;
        add(*reinterpret_cast<const float4*>(rdT + n * SUB + yi),
            *reinterpret_cast<const float4*>(St + n * LD + yp));
      }
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
          acc[ii][cc] += __shfl_xor_sync(0xffffffffu, acc[ii][cc], 8);
          acc[ii][cc] += __shfl_xor_sync(0xffffffffu, acc[ii][cc], 16);
        }
      // quarter yq writes row yi + yq
      float out[4];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
        out[cc] = yq == 0 ? acc[0][cc] : yq == 1 ? acc[1][cc]
                : yq == 2 ? acc[2][cc] : acc[3][cc];
      if (t0 + yi + yq < d.S) {
        float* yrow = y + (base + static_cast<long long>(t0 + yi + yq) * d.H)
                          * N;
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          if (yp + cc < N) yrow[yp + cc] = out[cc];
      }
    }
    if (last) break;
    __syncthreads();                 // every read of S is done
    float sv[4][4];                  // S[n0 + a][p0 + cc]
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float4 s4 = *reinterpret_cast<const float4*>(St + (n0 + a) * LD
                                                         + p0);
      sv[a][0] = s4.x;
      sv[a][1] = s4.y;
      sv[a][2] = s4.z;
      sv[a][3] = s4.w;
    }
    fold(sv, kd, vs, etot, n0, p0);
#pragma unroll
    for (int a = 0; a < 4; ++a)
      *reinterpret_cast<float4*>(St + (n0 + a) * LD + p0) =
          make_float4(sv[a][0], sv[a][1], sv[a][2], sv[a][3]);
  }
}

constexpr size_t kSmem3 = ((DM + 8 * SUB) * LD + SUB * (SUB + 1) + 2 * DM)
                          * sizeof(float);

int chunks(int S) { return (S + L - 1) / L; }

}  // namespace

// The plan of a call: out[0] the kernel's chunk, out[1] the chunks, out[2..4]
// the blocks of passes 1-3, out[5] the floats of `states`, out[6] of `decay`.
extern "C" int wkv6_plan(int Bsz, int S, int H, int N, long long* out) {
  const long long nc = chunks(S);
  const dim3 carry = chunk_carry::grid(Bsz, H, N, N);
  out[0] = L;
  out[1] = nc;
  out[2] = out[4] = nc * H * Bsz;
  out[3] = static_cast<long long>(carry.x) * carry.y;
  out[5] = nc * Bsz * H * N * N;
  out[6] = nc * Bsz * H * N;
  return 0;
}

// r, k, v, w (B, S, H, N), u (H, N), h0 (B, H, N, N) or null, y (B, S, H,
// N), hout (B, H, N, N), scratch states (B, nc, H, N, N) and decay (B, nc,
// H, N) with nc = ceil(S / 128) (wkv6_plan): float32, contiguous. Three
// launches on `stream`.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, const void* h0,
                           void* y, void* hout, void* states, void* decay,
                           int Bsz, int S, int H, int N, void* stream) {
  const int nc = S > 0 ? chunks(S) : 0;
  if (Bsz <= 0 || S <= 0 || H <= 0 || N <= 0 || N > DM || nc > 65535 ||
      Bsz > 65535 || static_cast<long long>(Bsz) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  // once, before any launch (so never inside a CUDA-graph capture after
  // the first call)
  static bool opted_in = false;
  if (!opted_in) {
    cudaError_t err = chunk_carry::opt_in(wkv6_state_kernel, 0);
    if (err == cudaSuccess)
      err = chunk_carry::opt_in(wkv6_output_kernel, kSmem3);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const auto st = static_cast<cudaStream_t>(stream);
  const Dims d{S, H, N, nc};
  const dim3 chunk_grid(H, nc, Bsz);
  wkv6_state_kernel<<<chunk_grid, NT, 0, st>>>(
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(w), static_cast<float*>(states),
      static_cast<float*>(decay), d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = chunk_carry::launch<true>(
      static_cast<float*>(states), static_cast<const float*>(decay),
      static_cast<const float*>(h0), static_cast<float*>(hout), Bsz, nc, H,
      N, N, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_output_kernel<<<chunk_grid, NT, kSmem3, st>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(states),
      static_cast<float*>(y), d);
  return static_cast<int>(cudaGetLastError());
}
