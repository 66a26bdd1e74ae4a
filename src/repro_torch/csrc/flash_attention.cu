// B5: flash attention forward. Online-softmax attention over q, k, v in
// the reference layout (B, S, H, hd), K/V already GQA-repeated; f32 or bf16
// in, f32 accumulation, causal or not; the output in the input dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// _flash_kernel, launched by kernel.py::flash_attention_pallas through
// ops.py::flash_attention. model/attention.py reaches it when
// attn_impl == "flash" for every causal attention with Sq == Sk: each layer
// of each LM prefill.
//
// What it computes, as the TPU kernel does: s = (q . k) * hd^-0.5 in f32,
// masked to -1e30 above the causal diagonal; a running max m, sum l and
// accumulator acc per query row over key tiles; p = exp(s - m_new) rounded
// to v's dtype before the PV product (kernel.py:56) while l sums p
// unrounded; out = acc / max(l, 1e-30). The TPU wrapper's lane trick (pad
// hd to 128, pre-scale q, divide by the padded width) cancels out and is
// not carried over: the scale is the real hd^-0.5. Ragged tiles are masked
// here, so any S >= 1 and any hd <= 256 go through the kernel.
//
// What bounds it on an H100: at the main path's shape, one Yi-9B prefill
// layer of 2,048 tokens ((1, 2048, 32, 128) bf16, causal), the work is
// 34.4 GFLOP against 67 MB of q/k/v/o, so on the tensor cores (989 TFLOP/s
// bf16) it would be bound by operations at 0.035 ms, above the 0.020 ms
// that HBM (3.35 TB/s) needs. This first version runs its products on the
// CUDA cores in f32 (67 TFLOP/s peak: 0.51 ms), and its inner loops issue
// about one shared-memory load per two FMAs, so shared-memory bandwidth
// caps it near half that peak.
//
// Design (simple and right; mma.sync/wgmma, TMA and pipelining are later
// work): one block of 256 threads per (batch*head, 64-row query tile),
// heaviest causal tiles launched first. The q tile is staged in shared
// memory once; the block loops over 64-key K/V tiles staged in shared
// memory, only up to the diagonal when causal. Thread (ty, tx) of a 16 x 16
// grid owns rows ty + 16i (i < 4): it computes s for keys tx + 16j (j < 4)
// and holds acc for dims tx + 16c (c < HD/16), so the 16 threads of a row
// form a half-warp and reduce the row max and sum with shuffles; m, l and
// acc stay in registers. p goes through shared memory for the PV product.
// Row strides are padded by one 32-bit word, so the strided key and p
// reads fall in distinct banks. HD is the head dim rounded up to one of
// the compiled widths; the extra dims are zeros in q, k and v.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "error_string.cuh"

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per tile
constexpr int NT = 256;          // threads per block: a 16 x 16 grid
constexpr float NEG = -1e30f;    // the reference's NEG_INF

struct Strides {                 // in elements; the head dim is contiguous
  long long b, s, h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);      // round to nearest even
}

// Shared-memory row stride in elements: HD plus one 32-bit word.
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int HD>
__host__ __device__ constexpr size_t smem_bytes() {
  return static_cast<size_t>(BQ + 2 * BK) * row_stride<T, HD>() * sizeof(T) +
         static_cast<size_t>(BQ) * (BK + 1) * sizeof(float);
}

// rows [row0, row0 + 64) of one (b, h) slice into dst, zeros past n_rows
// and past hd.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, Strides st,
                                          int row0, int n_rows, int hd) {
  constexpr int LD = row_stride<T, HD>();
  for (int i = threadIdx.x; i < BK * HD; i += NT) {
    const int r = i / HD;
    const int d = i - r * HD;
    T val = from_f32<T>(0.f);
    if (row0 + r < n_rows && d < hd)
      val = src[static_cast<long long>(row0 + r) * st.s + d];
    dst[r * LD + d] = val;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, Strides sq,
                     Strides sk, Strides sv, Strides so, int H, int Sq,
                     int Sk, int hd, float scale, int causal) {
  constexpr int LD = row_stride<T, HD>();
  constexpr int KD = HD / 16;      // head dims per thread in acc
  extern __shared__ __align__(16) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + BQ * LD;
  T* Vs = Ks + BK * LD;
  float* Ps = reinterpret_cast<float*>(Vs + BK * LD);

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * BQ;
  const int b = blockIdx.y / H;
  const int h = blockIdx.y - b * H;
  const int ty = threadIdx.x / 16;
  const int tx = threadIdx.x % 16;

  load_tile<T, HD>(Qs, q + b * sq.b + h * sq.h, sq, q0, Sq, hd);
  const T* kbase = k + b * sk.b + h * sk.h;
  const T* vbase = v + b * sv.b + h * sv.h;

  float m[4], l[4], acc[4][KD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < KD; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(Sk, q0 + BQ) : Sk;
  const int n_kt = (kv_end + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();               // the last tile's readers are done
    load_tile<T, HD>(Ks, kbase, sk, k0, Sk, hd);
    load_tile<T, HD>(Vs, vbase, sv, k0, Sk, hd);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = to_f32(Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = to_f32(Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int qpos = q0 + row;
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (kpos >= Sk || (causal && kpos > qpos)) x = NEG;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[row * (BK + 1) + tx + 16 * j] = to_f32(from_f32<T>(p));
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < KD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < KD; ++c) {
        const float vv = to_f32(Vs[j * LD + tx + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty + 16 * i;
    if (qpos >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* orow = o + b * so.b + static_cast<long long>(qpos) * so.s + h * so.h;
#pragma unroll
    for (int c = 0; c < KD; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = from_f32<T>(acc[i][c] / den);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   Strides sq, Strides sk, Strides sv, Strides so, int B,
                   int H, int Sq, int Sk, int hd, float scale, int causal,
                   cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, HD>();
  // opt in to more than 48 KB once per instantiation, before any launch
  // (so never inside a CUDA-graph capture after the first call)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  const dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, sv, so, H, Sq,
      Sk, hd, scale, causal);
  return cudaGetLastError();
}

// The compiled head widths: the smallest one >= hd is launched.
template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     Strides sq, Strides sk, Strides sv, Strides so, int B,
                     int H, int Sq, int Sk, int hd, float scale, int causal,
                     cudaStream_t st) {
#define REPRO_FLASH_HD(W)                                                    \
  if (hd <= W)                                                               \
    return launch<T, W>(q, k, v, o, sq, sk, sv, so, B, H, Sq, Sk, hd, scale, \
                        causal, st);
  REPRO_FLASH_HD(32)
  REPRO_FLASH_HD(64)
  REPRO_FLASH_HD(80)
  REPRO_FLASH_HD(96)
  REPRO_FLASH_HD(128)
  REPRO_FLASH_HD(160)
  REPRO_FLASH_HD(192)
  REPRO_FLASH_HD(256)
#undef REPRO_FLASH_HD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Strides are in elements, (b, s, h) for
// each of q, k, v, o; the head dim is contiguous in all four.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* o, int B, int H,
    int Sq, int Sk, int hd, long long qsb, long long qss, long long qsh,
    long long ksb, long long kss, long long ksh, long long vsb,
    long long vss, long long vsh, long long osb, long long oss,
    long long osh, float scale, int causal, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || hd <= 0 || hd > 256 ||
      B * H > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{qsb, qss, qsh}, sk{ksb, kss, ksh}, sv{vsb, vss, vsh},
      so{osb, oss, osh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(q, k, v, o, sq, sk, sv, so, B, H, Sq, Sk, hd, scale,
                          causal, st);
  else if (dtype == 1)
    err = dispatch<__nv_bfloat16>(q, k, v, o, sq, sk, sv, so, B, H, Sq, Sk,
                                  hd, scale, causal, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
