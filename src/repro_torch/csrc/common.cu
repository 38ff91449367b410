// C interface helpers shared by the kernel wrappers.
#include "common.cuh"

extern "C" const char* fo_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
