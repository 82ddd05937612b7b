// The kernel library's one error-message entry point: every launch
// function returns a cudaError_t code, and the Python side
// (kernels/build.py) turns it into text here.
#include <cuda_runtime.h>

extern "C" const char* kernels_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
