// The C entry point every kernel library exports beside its launcher:
// kernels/build.py reads it to turn the launcher's cudaError_t into text.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
