// Host side of TMA: the tensor-map encoder, shared by the kernels that
// feed shared memory through TMA (flash_attention.cu, quant_matmul.cu).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

namespace tma {

// the C entry points return this plus the CUresult of a failed encoding
constexpr int kError = 100000;

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (CUDA 12.0 ABI), looked up in the libcuda the
// runtime has loaded, so the library needs no -lcuda; null where that
// libcuda lacks it
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

}  // namespace tma
