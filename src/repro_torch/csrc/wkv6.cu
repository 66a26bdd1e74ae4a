// B7: the RWKV-6 WKV recurrence — y and the final (N, N) key -> value state
// of every (batch, head) in one launch, from a zero initial state.
//
// Replaces the TPU kernel src/repro/kernels/rwkv6/kernel.py::_wkv6_kernel,
// launched by kernel.py::wkv6_pallas through ops.py::wkv6.
//
// What it computes, as the TPU kernel does, 16-step subchunk by subchunk
// chained through the state S: with csub the running sum of the log-decays
// w (all <= 0) inside the subchunk, cprev = csub - w and tot = csub[15],
//   A_ij = sum_n r_in k_jn e^{cprev_in - csub_jn}   for j < i
//   A_ii = sum_n r_in u_n k_in                      (the bonus)
//   y_i  = sum_j A_ij v_j + (r_i e^{cprev_i}) . S
//   S   <- diag(e^{tot}) S + sum_j (k_j e^{tot - csub_j}) v_j^T
// (kernel.py:43-63). Only the j < i pairs are ever evaluated, so every
// exponent is <= 0: the masked j >= i pairs would overflow to inf and turn
// into inf * 0 = NaN. The reference's chunk only tiles its grid; the
// subchunks chain the same way whatever it is, so it does not enter here.
//
// What bounds it on an H100: at RWKV6-7B's WKV (64 heads of N = 64,
// S = 4,096) the work is about 5.3 GFLOP against 336 MB (r, k, v, w read
// once, y and the state written once), so HBM bounds it (3.35 TB/s:
// 0.100 ms), above the f32 FMA rate (0.080 ms).
//
// Design (simple and right): one block of 256 threads per (batch, head),
// the state in shared memory (16 KB at N = 64, rows padded by one word so
// strided reads fall in distinct banks) for all S / 16 subchunks. Per
// subchunk: the 16 rows of r, k, v, w are staged; N threads take the
// running sums; the 16 x 16 pair matrix A takes one thread per pair; r and
// k are then decayed in place; each thread writes four y values and
// updates sixteen state entries. r, k, v, w and y stay in the public
// (B, S, H, N) layout; N up to 64.
#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int SUB = 16;        // steps per subchunk (kernel.py:18)
constexpr int DM = 64;         // the largest N compiled for
constexpr int LD = DM + 1;     // padded row stride, in floats
constexpr int NT = 256;        // 16 x 16 threads

struct Args {
  int S, H, N;
};

__global__ void __launch_bounds__(NT)
    wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, float* __restrict__ y,
                float* __restrict__ hout, Args a) {
  __shared__ float St[DM * LD];      // state [n (key)][p (value)]
  __shared__ float rs[SUB * LD];     // r, then r e^{cprev}
  __shared__ float ks[SUB * LD];     // k, then k e^{tot - csub}
  __shared__ float vs[SUB * LD];
  __shared__ float cp[SUB * LD];     // w, then cprev = csub - w
  __shared__ float cs[SUB * LD];     // csub
  __shared__ float Am[SUB * (SUB + 1)];
  __shared__ float us[DM], etot[DM];

  const int S = a.S, H = a.H, N = a.N;
  const int h = blockIdx.x % H;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  // (b, t, h, :) lies at ((b * S + t) * H + h) * N
  const long long base = static_cast<long long>(blockIdx.x / H) * S * H + h;

  for (int i = tid; i < DM * LD; i += NT) St[i] = 0.f;
  for (int n = tid; n < N; n += NT) us[n] = u[static_cast<long long>(h) * N
                                               + n];

  for (int t0 = 0; t0 < S; t0 += SUB) {
    __syncthreads();                 // the last subchunk's readers are done
    for (int i = tid; i < SUB * N; i += NT) {
      const int row = i / N, n = i % N;
      const long long g = (base + static_cast<long long>(t0 + row) * H) * N
                          + n;
      rs[row * LD + n] = r[g];
      ks[row * LD + n] = k[g];
      vs[row * LD + n] = v[g];
      cp[row * LD + n] = w[g];
    }
    __syncthreads();
    for (int n = tid; n < N; n += NT) {
      float run = 0.f;
      for (int row = 0; row < SUB; ++row) {
        const float wv = cp[row * LD + n];
        run += wv;
        cs[row * LD + n] = run;
        cp[row * LD + n] = run - wv;
      }
      etot[n] = expf(run);
    }
    __syncthreads();
    {  // A, one pair (i = ty, j = tx) per thread
      float acc = 0.f;
      if (tx < ty) {
        for (int n = 0; n < N; ++n)
          acc += rs[ty * LD + n] * ks[tx * LD + n] *
                 expf(cp[ty * LD + n] - cs[tx * LD + n]);
      } else if (tx == ty) {
        for (int n = 0; n < N; ++n)
          acc += rs[ty * LD + n] * us[n] * ks[ty * LD + n];
      }
      Am[ty * (SUB + 1) + tx] = acc;
    }
    __syncthreads();
    for (int i = tid; i < SUB * N; i += NT) {
      const int row = i / N, n = i % N;
      rs[row * LD + n] *= expf(cp[row * LD + n]);
      ks[row * LD + n] *= expf(cs[(SUB - 1) * LD + n] - cs[row * LD + n]);
    }
    __syncthreads();
    {  // y row ty, values p = tx + 16c
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < SUB; ++j) {
        const float av = Am[ty * (SUB + 1) + j];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(av, vs[j * LD + tx + 16 * c],
                                                  acc[c]);
      }
      for (int n = 0; n < N; ++n) {
        const float rv = rs[ty * LD + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(rv, St[n * LD + tx + 16 * c],
                                                  acc[c]);
      }
      const long long g = (base + static_cast<long long>(t0 + ty) * H) * N;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx + 16 * c < N) y[g + tx + 16 * c] = acc[c];
    }
    __syncthreads();                 // every read of S is done
    // S[n][p] for n = ty + 16a, p = tx + 16c
#pragma unroll
    for (int ia = 0; ia < 4; ++ia) {
      const int n = ty + 16 * ia;
      if (n >= N) continue;
      float acc[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[c] = St[n * LD + tx + 16 * c] * etot[n];
      for (int j = 0; j < SUB; ++j) {
        const float kv = ks[j * LD + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[c] = fmaf(kv, vs[j * LD + tx + 16 * c],
                                                  acc[c]);
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (tx + 16 * c < N) St[n * LD + tx + 16 * c] = acc[c];
    }
  }
  __syncthreads();
  float* hb = hout + static_cast<long long>(blockIdx.x) * N * N;
  for (int i = tid; i < N * N; i += NT) hb[i] = St[(i / N) * LD + i % N];
}

}  // namespace

// r, k, v, w (B, S, H, N), u (H, N), y (B, S, H, N), hout (B, H, N, N):
// float32, contiguous; S % 16 == 0.
extern "C" int wkv6_launch(const void* r, const void* k, const void* v,
                           const void* w, const void* u, void* y, void* hout,
                           int Bsz, int S, int H, int N, void* stream) {
  if (Bsz <= 0 || S <= 0 || S % SUB != 0 || H <= 0 || N <= 0 || N > DM ||
      static_cast<long long>(Bsz) * H > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{S, H, N};
  wkv6_kernel<<<Bsz * H, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<float*>(y),
      static_cast<float*>(hout), a);
  return static_cast<int>(cudaGetLastError());
}
