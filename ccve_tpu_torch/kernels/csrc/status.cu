// The C interface's error text: the message for a cudaError_t that one of
// the entry points returned. No kernel lives here.

#include <cuda_runtime.h>

extern "C" const char* ccve_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
