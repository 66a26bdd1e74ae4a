// B4: the int8 x int8 -> int32 matmul with the per-tensor x per-channel
// rescale on the way out: out = (f32(xq . wq) * x_scale) * w_scale[col].
//
// Replaces the TPU kernel src/repro/kernels/quant_matmul/kernel.py::
// _qmm_kernel, launched by kernel.py::quant_matmul_pallas through
// ops.py::quant_matmul (the `quantized` impl of `mlp` in the reference's
// registry).
//
// What it computes, as the TPU kernel does: an exact int32 accumulator
// over K (|sum| <= 127 * 127 * K stays far inside int32 for any K a model
// has), then the epilogue in the reference's order, each multiply rounded
// to f32 (kernel.py:39-40), so the result is bit-for-bit the plain
// version's. Ragged M, N and K are masked here instead of the wrapper's
// zero padding: a padded code is 0, so the sums are the same.
//
// What bounds it on an H100: at Yi-9B's MLP with a 2,048-token prefill,
// (2048 x 4096) . (4096 x 11008), the work is 185 G int8 operations
// against 59 MB, so it is bound by the int8 tensor-core rate (1,979 TOP/s:
// 0.093 ms), well above HBM's 0.018 ms. A 4-row decode tick is bound by
// reading the 45 MB of weights (0.013 ms).
//
// Design (simple and right; wgmma, TMA and a pipelined ring of tiles are
// later work): one block of 256 threads per 128 x 128 output tile, looping
// over K in steps of 64. Each step stages the xq tile row-major and the wq
// tile transposed (k contiguous per output column, a 4 x 4 byte transpose
// in registers with __byte_perm) in shared memory; eight warps, 2 x 4, each
// own a 64 x 32 sub-tile and issue mma.sync.m16n8k32 s8 x s8 -> s32 on the
// tensor cores, whose fragments are single 32-bit shared-memory loads. Row
// strides are padded to 80 bytes, so the fragment loads fall in distinct
// banks. Word-wide global loads are used where K (for xq) or N (for wq) is
// a multiple of 4, byte loads otherwise.
#include <cuda_runtime.h>
#include <stdint.h>

#include "error_string.cuh"

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int NT = 256;          // 8 warps: 2 along M x 4 along N
constexpr int LDS = BK + 16;     // shared row stride in bytes (20 words)

__device__ __forceinline__ uint32_t ld_s32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(NT)
    qmm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
               const float* __restrict__ x_scale,
               const float* __restrict__ w_scale, float* __restrict__ out,
               int M, int N, int K, int vec_a, int vec_b) {
  __shared__ __align__(16) int8_t As[BM * LDS];    // [m][k]
  __shared__ __align__(16) int8_t Bs[BN * LDS];    // [n][k], transposed
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / 4, wn = warp % 4;          // 64 x 32 warp tiles
  const int g = lane / 4, tq = lane % 4;           // mma fragment coords

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0;

  for (int k0 = 0; k0 < K; k0 += BK) {
    // xq tile: BM rows x BK/4 words, zeros past M and K
    for (int i = tid; i < BM * (BK / 4); i += NT) {
      const int r = i / (BK / 4), kw = i % (BK / 4);
      const int m = m0 + r, k = k0 + kw * 4;
      uint32_t word = 0;
      if (m < M) {
        const int8_t* src = xq + static_cast<long long>(m) * K + k;
        if (vec_a) {
          if (k < K) word = ld_s32(src);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k + e < K)
              word |= static_cast<uint32_t>(static_cast<uint8_t>(src[e]))
                      << (8 * e);
        }
      }
      *reinterpret_cast<uint32_t*>(As + r * LDS + kw * 4) = word;
    }
    // wq tile transposed, one 4 (k) x 4 (n) block per thread and pass:
    // w[r] holds wq[k + r][n .. n + 3]; column c of it becomes the word
    // Bs[n + c][k .. k + 3]
    for (int i = tid; i < (BK / 4) * (BN / 4); i += NT) {
      const int ng = (i / 32) % 4 * 8 + i % 8;          // 8 lanes along n
      const int kg = (i / 128) * 4 + (i / 8) % 4;       // 4 lanes along k
      const int k = k0 + kg * 4, n = n0 + ng * 4;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (k + r >= K) continue;
        const int8_t* src = wq + static_cast<long long>(k + r) * N + n;
        if (vec_b) {
          if (n < N) w[r] = ld_s32(src);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (n + c < N)
              w[r] |= static_cast<uint32_t>(static_cast<uint8_t>(src[c]))
                      << (8 * c);
        }
      }
      const uint32_t t0 = __byte_perm(w[0], w[1], 0x5140);
      const uint32_t t1 = __byte_perm(w[2], w[3], 0x5140);
      const uint32_t t2 = __byte_perm(w[0], w[1], 0x7362);
      const uint32_t t3 = __byte_perm(w[2], w[3], 0x7362);
      int8_t* dst = Bs + (ng * 4) * LDS + kg * 4;
      *reinterpret_cast<uint32_t*>(dst) = __byte_perm(t0, t1, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + LDS) = __byte_perm(t0, t1, 0x7632);
      *reinterpret_cast<uint32_t*>(dst + 2 * LDS) =
          __byte_perm(t2, t3, 0x5410);
      *reinterpret_cast<uint32_t*>(dst + 3 * LDS) =
          __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* p = As + (wm * 64 + mi * 16 + g) * LDS + kk + tq * 4;
        a[mi][0] = ld_s32(p);
        a[mi][1] = ld_s32(p + 8 * LDS);
        a[mi][2] = ld_s32(p + 16);
        a[mi][3] = ld_s32(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* p = Bs + (wn * 32 + ni * 8 + g) * LDS + kk + tq * 4;
        b[ni][0] = ld_s32(p);
        b[ni][1] = ld_s32(p + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();               // the tiles' readers are done
  }

  const float xs = *x_scale;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + wm * 64 + mi * 16 + g + (e >= 2 ? 8 : 0);
        const int n = n0 + wn * 32 + ni * 8 + tq * 2 + (e & 1);
        if (m < M && n < N)
          out[static_cast<long long>(m) * N + n] = __fmul_rn(
              __fmul_rn(__int2float_rn(acc[mi][ni][e]), xs), w_scale[n]);
      }
}

}  // namespace

// xq (M, K) int8, wq (K, N) int8, x_scale (1,) f32, w_scale (N,) f32,
// out (M, N) f32; all contiguous.
extern "C" int quant_matmul_launch(const void* xq, const void* wq,
                                   const void* x_scale, const void* w_scale,
                                   void* out, int M, int N, int K,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K < 0 || (M + BM - 1) / BM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int vec_a = K % 4 == 0 && reinterpret_cast<uintptr_t>(xq) % 4 == 0;
  const int vec_b = N % 4 == 0 && reinterpret_cast<uintptr_t>(wq) % 4 == 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  qmm_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), static_cast<const int8_t*>(wq),
      static_cast<const float*>(x_scale), static_cast<const float*>(w_scale),
      static_cast<float*>(out), M, N, K, vec_a, vec_b);
  return static_cast<int>(cudaGetLastError());
}
