// Shared by the kernel sources of repro_torch: each source is built on its
// own into a shared library with a plain C interface (loaded with ctypes by
// repro_torch/kernels/_build.py).  Every launch function returns the
// cudaError_t of cudaGetLastError() right after its launch, so a refused
// launch (too many threads, too much shared memory) reaches the wrapper,
// which raises with the text that <prefix>_error_string gives.
#pragma once
#include <cuda_runtime.h>

#define REPRO_EXPORT_ERROR_STRING(prefix)                          \
  extern "C" const char* prefix##_error_string(int code) {         \
    return cudaGetErrorString(static_cast<cudaError_t>(code));     \
  }
