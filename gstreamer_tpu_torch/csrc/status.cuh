// The C entry points of every library return a cudaError_t as an int (0 on
// success); the Python side turns a non-zero one into an exception with
// this string.
#pragma once

#include <cuda_runtime.h>

extern "C" const char* gst_cuda_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}
