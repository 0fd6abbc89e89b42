// Batched flash attention at D = 64 over an int8 cache (batched_attention.cu
// holds the design and the entry; batched_attention.cuh the code), in a
// translation unit of its own so that nvcc compiles the parts in parallel.
#include "batched_attention.cuh"

BFLASH_PART(bflash_launch_d64_int8, 64, int8_t)
