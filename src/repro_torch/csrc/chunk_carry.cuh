// The carry pass of the chunk-parallel scans B6 (ssd.cu) and B7 (wkv6.cu):
// over the chunks of one (batch, head), in order,
//   S_0 = h0 (zero without one),   S_{c+1} = diag(e^{tot_c}) S_c + T_c,
// where T_c is chunk c's own contribution to the state, computed from a
// zero state by the chunk-state pass, and e^{tot_c} its total decay: one
// scalar per (batch, chunk, head) for B6, one per state row for B7. It
// works in place: `states` holds T_c on entry and S_c, the state at chunk
// c's start, on exit, which the output pass reads; `hout` gets S_nc.
//
// Elementwise work, O(nc * R * C) per (batch, head), bound by bytes: each
// thread carries PER elements of the (R, C) state in registers and keeps
// the loads of U chunks in flight ahead of the dependent multiply-adds.
#pragma once

#include <cuda_runtime.h>

namespace chunk_carry {

constexpr int NT = 256;        // threads a block
constexpr int PER = 4;         // state elements a thread
constexpr int U = 4;           // chunks loaded ahead
constexpr int TILE = NT * PER;

// states (B, nc, H, R, C); decay (B, nc, H, R) if PerRow else (B, nc, H);
// h0 (B, H, R, C) or null; hout (B, H, R, C). Grid (B * H, tiles).
template <bool PerRow>
__global__ void __launch_bounds__(NT)
    carry_kernel(float* __restrict__ states, const float* __restrict__ decay,
                 const float* __restrict__ h0, float* __restrict__ hout,
                 int nc, int H, int R, int C) {
  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const long long RC = static_cast<long long>(R) * C;
  int e[PER], row[PER];
  float s[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    e[q] = blockIdx.y * TILE + q * NT + threadIdx.x;
    row[q] = e[q] < RC ? e[q] / C : 0;
    s[q] = (h0 != nullptr && e[q] < RC) ? h0[bh * RC + e[q]] : 0.f;
  }
  for (int c0 = 0; c0 < nc; c0 += U) {
    float t[U][PER], d[U][PER];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long bch = (static_cast<long long>(b) * nc + c0 + u) * H + h;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const bool ok = c0 + u < nc && e[q] < RC;
        t[u][q] = ok ? states[bch * RC + e[q]] : 0.f;
        d[u][q] = ok ? decay[PerRow ? bch * R + row[q] : bch] : 1.f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long bch = (static_cast<long long>(b) * nc + c0 + u) * H + h;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        if (c0 + u < nc && e[q] < RC) states[bch * RC + e[q]] = s[q];
        s[q] = fmaf(s[q], d[u][q], t[u][q]);
      }
    }
  }
#pragma unroll
  for (int q = 0; q < PER; ++q)
    if (e[q] < RC) hout[bh * RC + e[q]] = s[q];
}

// Lets `kernel` take `bytes` of dynamic shared memory and asks for the
// SM's largest shared-memory carveout, so that as many of the scans' blocks
// as their registers allow sit on an SM side by side (left to itself, the
// driver may pick a smaller carveout). Call once, before any launch.
template <typename Kernel>
inline cudaError_t opt_in(Kernel kernel, size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// Blocks of the carry pass for B * H states of R x C.
inline dim3 grid(int Bsz, int H, int R, int C) {
  return dim3(static_cast<unsigned>(Bsz * H),
              static_cast<unsigned>((R * C + TILE - 1) / TILE));
}

template <bool PerRow>
inline cudaError_t launch(float* states, const float* decay, const float* h0,
                          float* hout, int Bsz, int nc, int H, int R, int C,
                          cudaStream_t stream) {
  carry_kernel<PerRow><<<grid(Bsz, H, R, C), NT, 0, stream>>>(
      states, decay, h0, hout, nc, H, R, C);
  return cudaGetLastError();
}

}  // namespace chunk_carry
