// B2: the integer MAC template — out = clip(requant(xh @ w + b, shift),
// lo, hi) on (B, K) int32 x (K, N) int32 + (N,) int32 -> (B, N) int32.
//
// Replaces the TPU kernel src/repro/rtl/oplib.py::_mac_kernel, launched by
// oplib.py::mac_int_pallas (the "DSP array" shared by the linear head, the
// conv1d im2col frames and the per-step LSTM gate MAC).
//
// What bounds it on an H100: at the main path's shapes the product is thin
// (K <= 21, N <= 80; the linear head is (B, 20) @ (20, 1)), so the bytes
// dominate: each row reads K int32 and writes N, against K*N multiply-adds.
// For the head at B = 65,536 that is 5.5 MB against 1.3 M MACs — bound by
// HBM bandwidth, not by the CUDA cores.
//
// Design (the simple, correct one): one thread per output element, the
// int32 dot product accumulated in registers with two's-complement wrap,
// then the requant and clip of fxp_requant_int. Exact int32 has no tensor
// core path (wgmma and mma.sync take int8/int4 inputs, not int32), so this
// runs on the CUDA cores. Threads of a warp walk consecutive outputs, so
// their stores coalesce; w and b are tiny and stay in L1.
#include "fxp_int.cuh"

namespace {

__global__ void mac_int_kernel(const int32_t* __restrict__ xh,
                               const int32_t* __restrict__ w,
                               const int32_t* __restrict__ b,
                               int32_t* __restrict__ out, long long rows,
                               int K, int N, int shift, int lo, int hi) {
  const long long idx =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= rows * N) return;
  const long long r = idx / N;
  const int n = static_cast<int>(idx - r * N);
  const int32_t* x = xh + r * K;
  int32_t acc = __ldg(b + n);
  for (int k = 0; k < K; ++k)
    acc = repro::wrap_add(acc, repro::wrap_mul(__ldg(x + k),
                                               __ldg(w + k * N + n)));
  out[idx] = repro::requant(acc, shift, lo, hi);
}

}  // namespace

extern "C" int mac_int_launch(const void* xh, const void* w, const void* b,
                              void* out, long long rows, int K, int N,
                              int shift, int lo, int hi, void* stream) {
  const long long total = rows * N;
  if (total == 0) return static_cast<int>(cudaSuccess);
  const int threads = 256;
  const long long blocks = (total + threads - 1) / threads;
  mac_int_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(xh), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(b), static_cast<int32_t*>(out), rows, K, N,
      shift, lo, hi);
  return static_cast<int>(cudaGetLastError());
}
