// The tensor-core paged-decode kernel's instances for f16 q over f16 pools
// (paged_decode.cuh), one translation unit so that nvcc builds them beside
// the others.

#include "paged_decode.cuh"

namespace pstpu {

PSTPU_MMA_F16(PSTPU_MMA_DEFINE)

}  // namespace pstpu
