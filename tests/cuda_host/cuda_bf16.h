// Host emulation of <cuda_bf16.h>: __nv_bfloat16 and its conversions live
// beside the rest of the emulated runtime in cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
