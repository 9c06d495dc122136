// The message of a CUDA error code the launchers return, for the Python
// wrappers' errors (ops/_cuda_build.py check). Built into both of the
// package's kernel libraries, the product's and the labs'.

#include <cuda_runtime.h>

extern "C" {

const char* banded_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
