// The Q5_K entry of the K-quant dequant-matmul (kquant_matmul.cu
// holds the design; kquant_matmul.cuh the code), in a translation unit
// of its own so that nvcc compiles the formats in parallel.
#include "kquant_matmul.cuh"

KQUANT_ENTRY(q5_k_matmul, Q45K<true>, TileQ45K<true>)
