// code_grad_wide.cu — the tensor-core bodies of code_grad_dx and
// code_grad_dw at head dims 80 (hubert-xlarge, code width 16) and 256
// (paligemma-3b, code width 32 on the RoPE pair closure): the compact
// seam's projection backward at these widths. They replace
// repro/kernels/code_grad.py::code_grad_dx and ::code_grad_dw there; the
// design and the bound: code_grad_tc.cuh (DwRows, DxSteps: a head of 80
// takes all 128 feature rows of a dW block, rows 80-127 zero, and three dx
// steps of 32 features, the last half zero; a head of 256 spans two dW
// blocks, each densifying its own 128 features from the same packed rows,
// and four dx steps of 64). f32 codes at these d run code_grad.cu's
// CUDA-core bodies, which take any d <= 256. A source of its own, so that
// its build runs beside code_grad.cu's.
#define CODE_GRAD_TC_DIMS 80, 256
#include "code_grad_tc.cuh"

extern "C" const char* sfa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
