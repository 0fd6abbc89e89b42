// Batched flash attention at D = 64 over a bf16 cache (batched_attention.cu
// holds the design and the entry; batched_attention.cuh the code), in a
// translation unit of its own so that nvcc compiles the parts in parallel.
#include "batched_attention.cuh"

BFLASH_PART(bflash_launch_d64_bf16, 64, __nv_bfloat16)
