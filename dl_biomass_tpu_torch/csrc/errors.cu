// Error text for the codes the kernel entry points return (cudaGetLastError()).
#include <cuda_runtime.h>

extern "C" const char* dlbt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
