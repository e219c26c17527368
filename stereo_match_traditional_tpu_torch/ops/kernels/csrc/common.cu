// Shared C entry points of the port's kernel library.
#include <cuda_runtime.h>

// The text of a CUDA error code that an entry point returned.
extern "C" const char* stereo_kernels_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
