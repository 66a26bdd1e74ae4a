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
// and writes the final h, (B, H). Every product is an IEEE f32 FMA (never
// TF32); sigmoid is 1 / (1 + expf(-z)) and tanh is tanhf, both accurate to a
// few ulp (no fast-math), as jax.nn.sigmoid / jnp.tanh are on the CPU.
//
// What bounds it on an H100: at the paper's Table-I cell (S = 6, d_in = 1,
// H = 20) a window takes 6 * 21 * 80 = 10,080 FMAs against 24 B in and 80 B
// out, so 65,536 windows are bound by the f32 FMA rate (1.32 GFLOP at
// 67 TFLOP/s: 0.020 ms), not by HBM (6.8 MB: 0.002 ms).
//
// Design (simple and right): one block per tile of bb windows (the
// wrapper's block_b, lowered only where shared memory is short). W and b
// are staged in shared memory once per block (read from global memory only
// when W alone would not fit); h (double-buffered: every gate reads the
// whole previous h) and c stay in shared memory for all S steps, so the
// window is read once and only the final h is written. Each thread owns
// (window, hidden unit) pairs and computes that unit's four gates, reading
// its weights from consecutive banks and h as a broadcast. The ragged last
// tile is masked; nothing is padded.
#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

struct Args {
  long long B;
  int S, d_in, H, bb, w_in_smem;
};

__device__ __forceinline__ float sigmoidf(float z) {
  return 1.f / (1.f + expf(-z));
}

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
      const float c = sigmoidf(zf) * c_s[idx] + sigmoidf(zi) * tanhf(zg);
      c_s[idx] = c;
      h_nxt[idx] = sigmoidf(zo) * tanhf(c);
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

}  // namespace

// x (B, S, d_in), w (d_in + H, 4H), b (4H,), out (B, H): float32,
// contiguous. block_b is the most windows one block takes.
extern "C" int lstm_cell_launch(const void* x, const void* w, const void* b,
                                void* out, long long B, int S, int d_in,
                                int H, int block_b, void* stream) {
  if (B <= 0 || S < 0 || d_in < 0 || H <= 0 || block_b <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const bool w_in_smem =
      smem_bytes(H, d_in, 1, true) <= static_cast<size_t>(smem_max);
  long long bb = block_b < B ? block_b : B;
  while (bb > 1 &&
         smem_bytes(H, d_in, static_cast<int>(bb), w_in_smem) >
             static_cast<size_t>(smem_max))
    bb = (bb + 1) / 2;
  const size_t smem = smem_bytes(H, d_in, static_cast<int>(bb), w_in_smem);
  if (smem > static_cast<size_t>(smem_max))
    return static_cast<int>(cudaErrorInvalidValue);    // cell too wide
  // opt in to all of the card's shared memory once, before any launch
  // (so never inside a CUDA-graph capture after the first call)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_max);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const long long pairs = bb * H;
  const int threads =
      static_cast<int>(pairs >= 256 ? 256 : ((pairs + 31) / 32) * 32);
  const long long blocks = (B + bb - 1) / bb;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{B, S, d_in, H, static_cast<int>(bb), w_in_smem ? 1 : 0};
  lstm_cell_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(b), static_cast<float*>(out), a);
  return static_cast<int>(cudaGetLastError());
}
