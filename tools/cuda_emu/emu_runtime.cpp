#include "emu_runtime.h"
thread_local uint3s threadIdx, blockIdx;
uint3s blockDim, gridDim;
thread_local BlockCtx* emu_ctx;
