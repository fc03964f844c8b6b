// The tensor-core paged-decode kernel's instances for bf16 q over bf16 pools
// (paged_decode.cuh), one translation unit so that nvcc builds them beside
// the others.

#include "paged_decode.cuh"

namespace pstpu {

PSTPU_MMA_BF16(PSTPU_MMA_DEFINE)

}  // namespace pstpu
