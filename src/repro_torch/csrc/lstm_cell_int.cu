// B1: the fused integer LSTM window — every timestep of one lstm_cell node
// for a batch of windows in one launch.
//
// Replaces the TPU kernel src/repro/kernels/lstm_cell_int/kernel.py::
// _lstm_int_kernel, launched by kernel.py::lstm_window_int_pallas.
//
// At each step t, for every row (DESIGN.md §4, integer for integer):
//   z  = requant_A([x_t, h] . W + b)          shift wf, round half even
//   si, sf, so = sig_rom[z_{i,f,o} - sig_lo];  tg = tanh_rom[z_g - tanh_lo]
//   c  = requant_C(sf*c + (si*tg) << (cf-af))  shift af
//   h  = requant_A(so * tanh_rom[requant_A(c) - tanh_lo])
// and the whole (B, S, H) hidden sequence is written out (stacked cells and
// the emulator's trace read it).
//
// What bounds it on an H100: at the paper's Table-I cell (S=6, d_in=1,
// H=20) a window takes (1+20)*80*6 = 10,080 int32 multiply-adds and moves
// 24 B in and 480 B out, so it is bound by the CUDA cores' IMAD rate, not by
// HBM. wgmma does not apply: it has no exact int32 x int32 path.
//
// Design (the simple, correct one): one thread per batch row. Each block
// stages W ((d_in+H) x 4H int32, 6.7 KB at Table-I), b and both ROMs in
// shared memory once; every MAC then reads its weight as a warp-wide
// broadcast. Each thread keeps h (double-buffered: every gate reads the
// whole previous h) and c in its own shared-memory slots, laid out
// [unit][thread] so a warp touches consecutive banks. The ragged last block
// is masked here; nothing is padded.
#include "fxp_int.cuh"

namespace {

struct CellArgs {
  long long B;
  int S, d_in, H;
  int wf, af, cf;
  int a_lo, a_hi, c_lo, c_hi;
  int sig_lo, tanh_lo, sig_depth, tanh_depth;
};

__global__ void lstm_cell_int_kernel(const int32_t* __restrict__ x,
                                     const int32_t* __restrict__ w,
                                     const int32_t* __restrict__ b,
                                     const int32_t* __restrict__ sig,
                                     const int32_t* __restrict__ tanh_rom,
                                     int32_t* __restrict__ out,
                                     CellArgs a) {
  extern __shared__ int32_t smem[];
  const int H = a.H, d_in = a.d_in, K = d_in + H, G = 4 * H;
  const int T = blockDim.x, tid = threadIdx.x;
  int32_t* w_s = smem;                        // K * G
  int32_t* b_s = w_s + K * G;                 // G
  int32_t* sig_s = b_s + G;                   // sig_depth
  int32_t* tanh_s = sig_s + a.sig_depth;      // tanh_depth
  int32_t* h_cur = tanh_s + a.tanh_depth;     // H * T
  int32_t* h_nxt = h_cur + H * T;             // H * T
  int32_t* c_s = h_nxt + H * T;               // H * T

  for (int i = tid; i < K * G; i += T) w_s[i] = w[i];
  for (int i = tid; i < G; i += T) b_s[i] = b[i];
  for (int i = tid; i < a.sig_depth; i += T) sig_s[i] = sig[i];
  for (int i = tid; i < a.tanh_depth; i += T) tanh_s[i] = tanh_rom[i];
  __syncthreads();

  const long long row = static_cast<long long>(blockIdx.x) * T + tid;
  if (row >= a.B) return;                     // ragged last block
  for (int u = 0; u < H; ++u) {
    h_cur[u * T + tid] = 0;
    c_s[u * T + tid] = 0;
  }
  const int32_t* xr = x + row * a.S * d_in;
  int32_t* orow = out + row * a.S * H;
  const int align = a.cf - a.af;              // si*tg (2af) -> sf*c (af+cf)

  for (int t = 0; t < a.S; ++t) {
    const int32_t* xt = xr + t * d_in;
    for (int u = 0; u < H; ++u) {
      int32_t z[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        const int col = gate * H + u;
        int32_t acc = b_s[col];
        for (int k = 0; k < d_in; ++k)
          acc = repro::wrap_add(acc, repro::wrap_mul(xt[k], w_s[k * G + col]));
        for (int k = 0; k < H; ++k)
          acc = repro::wrap_add(
              acc, repro::wrap_mul(h_cur[k * T + tid],
                                   w_s[(d_in + k) * G + col]));
        z[gate] = repro::requant(acc, a.wf, a.a_lo, a.a_hi);
      }
      const int32_t si = sig_s[z[0] - a.sig_lo];
      const int32_t sf = sig_s[z[1] - a.sig_lo];
      const int32_t tg = tanh_s[z[2] - a.tanh_lo];
      const int32_t so = sig_s[z[3] - a.sig_lo];
      const int32_t term = repro::wrap_add(
          repro::wrap_mul(sf, c_s[u * T + tid]),
          repro::shift_left(repro::wrap_mul(si, tg), align));
      const int32_t c = repro::requant(term, a.af, a.c_lo, a.c_hi);
      const int32_t c_a = repro::requant(c, a.cf - a.af, a.a_lo, a.a_hi);
      const int32_t tc = tanh_s[c_a - a.tanh_lo];
      const int32_t h = repro::requant(repro::wrap_mul(so, tc), a.af, a.a_lo,
                                       a.a_hi);
      c_s[u * T + tid] = c;
      h_nxt[u * T + tid] = h;
      orow[t * H + u] = h;
    }
    int32_t* swap = h_cur;
    h_cur = h_nxt;
    h_nxt = swap;
  }
}

size_t smem_bytes(const CellArgs& a, int threads) {
  const size_t K = a.d_in + a.H, G = 4 * a.H;
  return sizeof(int32_t) * (K * G + G + a.sig_depth + a.tanh_depth +
                            3 * static_cast<size_t>(a.H) * threads);
}

}  // namespace

extern "C" int lstm_cell_int_launch(
    const void* x, const void* w, const void* b, const void* sig,
    const void* tanh_rom, void* out, long long B, int S, int d_in, int H,
    int wf, int af, int cf, int a_lo, int a_hi, int c_lo, int c_hi,
    int sig_lo, int tanh_lo, int sig_depth, int tanh_depth, void* stream) {
  if (B == 0) return static_cast<int>(cudaSuccess);
  const CellArgs a{B, S, d_in, H, wf, af, cf, a_lo, a_hi, c_lo, c_hi,
                   sig_lo, tanh_lo, sig_depth, tanh_depth};
  int dev = 0, smem_max = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int threads = 128;
  const size_t smem = smem_bytes(a, threads);
  if (smem > static_cast<size_t>(smem_max))
    return static_cast<int>(cudaErrorInvalidValue);   // cell too wide
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        lstm_cell_int_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (B + threads - 1) / threads;
  lstm_cell_int_kernel<<<static_cast<unsigned>(blocks), threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(x), static_cast<const int32_t*>(w),
      static_cast<const int32_t*>(b), static_cast<const int32_t*>(sig),
      static_cast<const int32_t*>(tanh_rom), static_cast<int32_t*>(out), a);
  return static_cast<int>(cudaGetLastError());
}
