// The text of a CUDA error code, for the Python wrappers' exceptions.

#include <cuda_runtime.h>

extern "C" const char* airjax_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}
