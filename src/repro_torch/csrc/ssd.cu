// B6: the Mamba-2 SSD chunk scan (n_groups = 1) — y and the final state
// of every (batch, head) in one launch, from a zero initial state.
//
// Replaces the TPU kernel src/repro/kernels/mamba2/kernel.py::_ssd_kernel,
// launched by kernel.py::ssd_pallas through ops.py::ssd.
//
// What it computes, as the TPU kernel does, chunk by chunk of L steps
// carrying the (P, N) state S of the chunk's start: with a = dt * A and
// a_cs its running sum inside the chunk,
//   y_i = sum_{j <= i} (C_i . B_j) e^{a_cs[i] - a_cs[j]} dt_j x_j
//         + e^{a_cs[i]} C_i . S
//   S  <- e^{a_cs[L-1]} S + sum_j (dt_j x_j) (B_j e^{a_cs[L-1] - a_cs[j]})^T
// Only the j <= i half of the decays is ever evaluated, so no exponent is
// positive (A < 0, dt > 0) and nothing overflows; the reference masks
// before its exp (kernel.py:42) for the same reason. The running sum a_cs
// is kept in f64: at chunk 256 it reaches several hundred, and an f32
// difference a_cs[i] - a_cs[j] of two such sums loses about 1e-5 of each
// decay, 10x the error of the per-step oracle; each exponent is rounded to
// f32 once, after the difference.
//
// What bounds it on an H100: at Zamba2-7B's SSD (112 heads, P = N = 64,
// S = 4,096, chunk 128) the work is about 15 GFLOP of f32 FMAs (the causal
// half of C.B^T and of scores.(dt x), the state read and the state update)
// against 241 MB, so the f32 FMA rate (67 TFLOP/s: 0.23 ms) bounds it more
// than HBM (0.072 ms).
//
// Design (simple and right): one block of 256 threads (a 16 x 16 grid,
// each thread a 4 x 4 register tile) per (batch, head), looping over the
// chunks in order with S in shared memory. A chunk is taken in 64-row
// blocks: for each row block, the C rows are staged once; y starts from
// the state read, then for each 64-column block at or left of the diagonal
// the B rows and dt * x rows are staged, the 64 x 64 score tile is formed,
// decayed and masked into shared memory, and multiplied into y. The
// diagonal block also feeds the state update, kept in registers until the
// chunk ends. So shared memory holds five 64 x 65 tiles (83 KB) whatever
// the chunk: 128 and 256 run alike. The running sum a_cs is taken by one
// thread per chunk, in order. x and y are read and written in the public
// (B, S, H, P) layout; P and N up to 64.
#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int R = 64;          // rows (and columns) of a score tile
constexpr int DM = 64;         // the largest P and N compiled for
constexpr int LD = DM + 1;     // padded row stride, in floats
constexpr int NT = 256;        // a 16 x 16 thread grid

struct Args {
  int S, H, P, N, L;
};

__global__ void __launch_bounds__(NT)
    ssd_kernel(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, float* __restrict__ y,
               float* __restrict__ hout, Args a) {
  extern __shared__ double sm[];
  double* acs = sm;                  // L: a_cs of the chunk, in f64
  float* St = reinterpret_cast<float*>(acs + a.L);  // DM x LD: [p][n]
  float* Ci = St + DM * LD;          // R x LD: C rows of the row block
  float* Bj = Ci + R * LD;           // R x LD: B rows of the column block
  float* Xj = Bj + R * LD;           // R x LD: dt * x rows [j][p]
  float* Sc = Xj + R * LD;           // R x LD: decayed scores [i][j]
  float* dec = Sc + R * LD;          // R: e^{a_tot - a_cs[j]}, diagonal block
  float* dts = dec + R;              // L: dt of the chunk

  const int S = a.S, H = a.H, P = a.P, N = a.N, L = a.L;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float Ah = A[h];
  const long long row0 = static_cast<long long>(b) * S;   // (b, t = 0)

  for (int i = tid; i < DM * LD; i += NT) St[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += L) {
    __syncthreads();                 // the last chunk's readers are done
    for (int t = tid; t < L; t += NT) dts[t] = dt[(row0 + c0 + t) * H + h];
    __syncthreads();
    if (tid == 0) {
      double run = 0.0;
      for (int t = 0; t < L; ++t) {
        run += __fmul_rn(dts[t], Ah);
        acs[t] = run;
      }
    }
    __syncthreads();
    const double a_tot = acs[L - 1];
    float upd[4][4] = {};            // state update, [p = ty+16u][n = tx+16v]

    for (int i0 = 0; i0 < L; i0 += R) {
      const int rows = min(R, L - i0);
      __syncthreads();               // Ci's last readers are done
      for (int i = tid; i < R * DM; i += NT) {
        const int r = i / DM, n = i % DM;
        Ci[r * LD + n] = (r < rows && n < N)
                             ? Cm[(row0 + c0 + i0 + r) * N + n] : 0.f;
      }
      __syncthreads();
      // y = e^{a_cs[i]} C_i . S, rows i = ty + 16u, dims p = tx + 16v
      float yacc[4][4] = {};
      for (int n = 0; n < N; ++n) {
        float cv[4], sv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) cv[u] = Ci[(ty + 16 * u) * LD + n];
#pragma unroll
        for (int v = 0; v < 4; ++v) sv[v] = St[(tx + 16 * v) * LD + n];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) yacc[u][v] = fmaf(cv[u], sv[v],
                                                        yacc[u][v]);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ty + 16 * u;
        const float e = r < rows ? expf(static_cast<float>(acs[i0 + r]))
                                 : 0.f;
#pragma unroll
        for (int v = 0; v < 4; ++v) yacc[u][v] *= e;
      }

      for (int j0 = 0; j0 <= i0; j0 += R) {
        const int cols = min(R, L - j0);
        __syncthreads();             // Bj, Xj, Sc's last readers are done
        for (int i = tid; i < R * DM; i += NT) {
          const int r = i / DM, d = i % DM;
          const long long t = row0 + c0 + j0 + r;
          Bj[r * LD + d] = (r < cols && d < N) ? Bm[t * N + d] : 0.f;
          Xj[r * LD + d] = (r < cols && d < P)
                               ? x[(t * H + h) * P + d] * dts[j0 + r] : 0.f;
        }
        if (j0 == i0)
          for (int r = tid; r < R; r += NT)
            dec[r] = r < cols ? expf(static_cast<float>(a_tot - acs[j0 + r]))
                              : 0.f;
        __syncthreads();
        // scores, rows i = ty + 16u, columns j = tx + 16v
        float s[4][4] = {};
        for (int n = 0; n < N; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) cv[u] = Ci[(ty + 16 * u) * LD + n];
#pragma unroll
          for (int v = 0; v < 4; ++v) bv[v] = Bj[(tx + 16 * v) * LD + n];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) s[u][v] = fmaf(cv[u], bv[v], s[u][v]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            const int gi = i0 + ty + 16 * u, gj = j0 + tx + 16 * v;
            // only j <= i inside the chunk: every exponent is <= 0
            Sc[(ty + 16 * u) * LD + tx + 16 * v] =
                (gi < L && gj <= gi)
                    ? s[u][v] * expf(static_cast<float>(acs[gi] - acs[gj]))
                    : 0.f;
          }
        __syncthreads();
        for (int j = 0; j < cols; ++j) {
          float pv[4], xv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) pv[u] = Sc[(ty + 16 * u) * LD + j];
#pragma unroll
          for (int v = 0; v < 4; ++v) xv[v] = Xj[j * LD + tx + 16 * v];
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int v = 0; v < 4; ++v) yacc[u][v] = fmaf(pv[u], xv[v],
                                                          yacc[u][v]);
        }
        if (j0 == i0) {
          // state update from this column block, [p = ty+16u][n = tx+16v]
          for (int j = 0; j < cols; ++j) {
            const float f = dec[j];
            float xv[4], bv[4];
#pragma unroll
            for (int u = 0; u < 4; ++u) xv[u] = Xj[j * LD + ty + 16 * u] * f;
#pragma unroll
            for (int v = 0; v < 4; ++v) bv[v] = Bj[j * LD + tx + 16 * v];
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int v = 0; v < 4; ++v) upd[u][v] = fmaf(xv[u], bv[v],
                                                           upd[u][v]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = ty + 16 * u;
        if (r >= rows) continue;
        float* yrow = y + ((row0 + c0 + i0 + r) * H + h) * P;
#pragma unroll
        for (int v = 0; v < 4; ++v)
          if (tx + 16 * v < P) yrow[tx + 16 * v] = yacc[u][v];
      }
    }
    __syncthreads();                 // every read of the chunk-start S done
    const float e_tot = expf(static_cast<float>(a_tot));
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        float* sp = St + (ty + 16 * u) * LD + tx + 16 * v;
        *sp = *sp * e_tot + upd[u][v];
      }
  }
  __syncthreads();
  float* hb = hout + static_cast<long long>(blockIdx.x) * P * N;
  for (int i = tid; i < P * N; i += NT) hb[i] = St[(i / N) * LD + i % N];
}

}  // namespace

// x (B, S, H, P), dt (B, S, H), A (H,), Bm / Cm (B, S, N), y (B, S, H, P),
// hout (B, H, P, N): float32, contiguous. L is the chunk (S % L == 0).
extern "C" int ssd_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, void* y, void* hout,
                          int Bsz, int S, int H, int P, int N, int L,
                          void* stream) {
  if (Bsz <= 0 || S <= 0 || H <= 0 || P <= 0 || P > DM || N <= 0 ||
      N > DM || L <= 0 || S % L != 0 ||
      static_cast<long long>(Bsz) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t Ls = static_cast<size_t>(L);
  const size_t smem =
      Ls * sizeof(double) + (5 * R * LD + R + Ls) * sizeof(float);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (smem > static_cast<size_t>(smem_max))
    return static_cast<int>(cudaErrorInvalidValue);     // chunk too long
  // opt in to all of the card's shared memory once, before any launch
  // (so never inside a CUDA-graph capture after the first call)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_max);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const Args a{S, H, P, N, L};
  ssd_kernel<<<Bsz * H, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(Bm),
      static_cast<const float*>(Cm), static_cast<float*>(y),
      static_cast<float*>(hout), a);
  return static_cast<int>(cudaGetLastError());
}
