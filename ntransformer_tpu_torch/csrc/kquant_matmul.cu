// Fused Q4_0, Q4_K, Q5_K and Q6_K dequant-matmul for Hopper (sm_90a), plain
// C interface: the GGUF nibble formats (the Q4_K_M pair, Q6_K for ffn_down
// and the head and Q4_K for the rest; Q5_K, the fifth-bit format of Q5_K_M
// files; Q4_0, the legacy 32-element block format).
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/matmul.py::
// _quant_matmul_impl with its _q4_0_tile, _q4_k_tile (and _group_sums),
// _q5_k_tile and _q6_k_tile bodies (entry quant_matmul_pallas, reached from
// ops/linear.py::qmatmul): every Q4_0, Q4_K, Q5_K and Q6_K product of a
// model, at T = 1 (decode), at the serving T (batched steps, verify
// windows) and at prefill T.
//
// What it computes. y[T,N] f32 = bf16(x)[T,K] @ W with W[k,n] the bf16 of
// the weight exactly as the plain dequant (ops/dequant_torch.py) computes
// it in f32:
//   Q4_0:  (q - 8) * d   (an f16 d times a 4-bit integer: exact in f32)
//   Q4_K:  q * (d * sc) - dmin * mn   (the products exact in f32, so the
//          subtraction rounds once: one fma of the exact q, then bf16)
//   Q5_K:  the same with q = nib | hb << 4 (q <= 31: still exact)
//   Q6_K:  ((nib | hb << 4) - 32) * (d * sc)   (d * sc exact; the one
//          multiply rounds, then bf16)
// Products are summed in f32; kernel and plain twin differ only in the
// order of the sums. The TPU kernel's group-partial dot and min-correction
// dot are not carried over: they never round the weight to bf16.
//
// Plane layout (core/layout.py; transposed, N contiguous). Plane row r of
// Q4_0 holds element 32 (r / 16) + r % 16 in its low nibble and that + 16
// in its high one; d row r / 16. Q4_K: plane row r holds element
// 64 (r / 32) + r % 32 in its low nibble and that + 32 in its high one;
// sc_lo / mn_lo (low nibble), sc_hi / mn_hi (high) row r / 32, d / dmin
// row r / 128. Q5_K: Q4_K's planes and qh [K/8, N] row
// 32 (r / 128) + r % 32, bit 2c (low) and 2c + 1 (high), c = r % 128 / 32.
// Q6_K: ql row r holds element 128 (r / 64) + r % 64 (low) and that + 64
// (high); qh [K/4, N] row 32 (r / 64) + r % 32, bit pair 2e (low) and 4 +
// 2e (high), e = r % 64 / 32; sc_lo / sc_hi (int8) row r / 16, d row
// r / 128. f16 planes hold the raw bits.
//
// What bounds it on the H100. At small T it streams the planes once:
// 0.5625 (Q4_0, Q4_K), 0.703125 (Q5_K) and 0.8203125 (Q6_K) bytes a weight
// over 3.35 TB/s (8B fused gate|up in Q4_K, 117.4 M weights in 67.9 MB:
// 20.3 us; in Q5_K 82.6 MB: 24.7 us). Unlike Q8_0 the dequant nearly keeps
// pace: a weight costs a byte permute, a subtract, an fma (Q4_0, Q6_K: a
// multiply) and half a bf16x2 convert, plus the nibble masks (~3.5-4
// operations, Q5_K's fifth bit ~1 more; 12-15 us of the CUDA cores at the
// 8B gate|up). At prefill T it is bound by operations: 2 T K N on the bf16
// tensor cores (989 TFLOP/s).
//
// What the design does about it.
//  * T <= 32 (plans.SKINNY_ROWS): skinny_kernel, one launch, the shape of
//    q8_0_matmul.cu's. The weight is the M side of mma.sync m16n8k16 and
//    the tokens its N side (padded to 8, 16 or 32). A block owns a strip of
//    128 columns and a K split of whole steps (the K-quants' plan: whole
//    superblocks); its 4 warps (3 for Q5_K and Q6_K at 17-32 tokens, so
//    two blocks fit an SM) take
//    interleaved steps of 32 plane rows, each warp keeping its next step in
//    a ring of two cp.async slots (codes, Q5_K's and Q6_K's qh rows, the
//    step's scale rows, the tokens' x), so the bytes in flight cost no
//    registers; slots small enough for two blocks an SM measured faster
//    than deeper rings (experiments/kquant_skinny_variants.py) or Q6_K
//    steps of 64 rows that read each qh row once. The K order inside an mma
//    k-block is free: a k16 block is 16 consecutive elements, the low
//    nibbles of 16 plane rows or the high nibbles of the same rows, so x is
//    staged in its own order (Q4_0: with two 16-element pieces swapped) and
//    the same 16-byte code loads (4 rows x a lane's 16 columns) feed both
//    blocks; the mma rows are permuted as in
//    q8_0_matmul.cu so every byte lands in the lane's own fragments. A
//    step's scales are decoded once a column into the warp's shared memory
//    (each lane 4 columns) and read back tile by tile, so no lane holds 16
//    columns' scales in registers beside its accumulators. The splits of a
//    strip form one thread-block cluster (at most 8), added in rank order
//    through distributed shared memory (a fixed order: runs repeat bit for
//    bit). There is no split-K pass.
//  * T > 32: the warp-specialized wgmma tile of hopper_tile.cuh with the
//    formats below: the producer warpgroup dequantizes each
//    32-plane-row stage (64 k-values: Q4_0's, Q4_K's and Q5_K's 64
//    consecutive elements, Q6_K's two 32-element pieces 64 apart) once for
//    256 or 128 rows of x into the 128-byte-swizzled K-major tile.
//  * Q4_0 admits K % 64 == 32: its last step or stage is then half, its
//    second 16 plane rows, second d row and x past K zero-filled (a zero d
//    gives an exact 0 weight); a step checks the rows once, and only the
//    copies of its second half.
#include "kquant_matmul.cuh"

KQUANT_ENTRY(q4_0_matmul, Q40, TileQ40)

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
