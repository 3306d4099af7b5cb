// flash_sfa_tc_wide.cu — the bf16 tensor-core FlashSFA bodies at d = dv 80
// (hubert-xlarge: tiles of 96 columns, columns 80-95 zero) and 256
// (paligemma-3b: two warpgroups a block, a 128-column half of every output
// accumulator each): the forward, both schedules (block skip on the compact
// seam), and the backward, all three emits. They replace
// repro/kernels/flash_sfa.py::flash_sfa and
// repro/kernels/flash_sfa_bwd.py::flash_sfa_bwd at these widths; the design
// and the bound: flash_sfa_tc.cuh and attention_tc.cuh (Width). A source of
// its own, so that its build runs beside flash_sfa_tc.cu's.
#define SFA_TC_DIMS 80, 256
#include "flash_sfa_tc.cuh"
