// flash_sfa_tc.cu — the bf16 tensor-core FlashSFA bodies at d = dv in {32,
// 64, 128}: the forward (both schedules) and backward (all three emits).
// What they replace, their design and their bound: flash_sfa_tc.cuh. The
// widths 80 and 256 are instantiated apart, in flash_sfa_tc_wide.cu, so that
// the two sources compile in parallel.
#define SFA_TC_DIMS 32, 64, 128
#include "flash_sfa_tc.cuh"
