// W4A8 int8 decode matmul (T = 1) for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/w4a8.py::
// _w4a8_decode_impl (with _blockdiag_i8 and _idot; entry w4a8_decode_pallas,
// reached from ops/linear.py::qmatmul at T = 1): every decode product of a
// model requantized with --w4a8. T > 1 is the w4a8_matmul entry of
// nibble_matmul.cu.
//
// What it computes. For each column n and each pair c of 256-groups (plane
// rows [256c, 256c + 256): the low nibbles are group 2c, the high nibbles
// group 2c + 1, core/w4a8.py):
//   P_lo = sum_r a_lo[r] * (qs[r,n] & 15)
//   P_hi = sum_r a_hi[r] * (qs[r,n] >> 4)
// exactly in int32 (|P| <= 127 * 15 * 256), then the f32 fixup
//   part[c,n] = (alpha_lo[c] * (f32(P_lo) * s_lo) - xsum_lo[c] * m_lo)
//             + (alpha_hi[c] * (f32(P_hi) * s_hi) - xsum_hi[c] * m_hi)
// with the planes s_lo, m_lo, s_hi and m_hi read at [c, n], and
// y[n] = part[0,n] + part[1,n] + ... in that order. a_lo / a_hi are the
// int8 activation codes of each group, alpha their scales and xsum the
// exact group sums of x (ops/dequant_torch.quantize_activations_torch). Each
// operation is an explicit _rn intrinsic, so nothing contracts and the
// kernel is bit-equal to its plain twin, which takes the same steps in
// PyTorch. The TPU kernel's block-diagonal activation matrix and its four
// HIGHEST-precision fixup dots are tricks for the TPU's matrix unit and are
// not carried over; the arithmetic they compute is.
//
// What bounds it on the H100. Bytes: 0.53125 a weight (codes and the four
// f32 planes), read once (fused gate|up of an 8B model, 62.4 MB: 18.6 us at
// 3.35 TB/s; down, K 14336 x N 4096, 31.2 MB: 9.3 us). The integer work is
// two dp4a per four codes.
//
// What the simple design does about it. A block takes one group pair and a
// strip of 256 columns; each lane owns 8 neighbouring columns (a warp reads
// 256 contiguous bytes of a plane row) and each of the four warps 64 of the
// pair's 256 plane rows. A lane transposes the 4 x 4 byte blocks of 4 rows
// with __byte_perm so that one dp4a takes 4 codes of one column, keeps the
// two int32 sums of each column, and the block adds its warps' sums in
// shared memory (integers: any order is exact). The fixup runs once per
// (pair, column), 256 times fewer than the weights, and a second kernel
// sums the pairs in a fixed order, so runs repeat bit for bit. K is thus
// split on 512-element units, which also gives the 8 to 56 column strips of
// the 8B products enough blocks for the 132 SMs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DW_WARPS = 4;
constexpr int DW_COLS = 8;                   // columns per lane
constexpr int DW_BLOCK_COLS = 32 * DW_COLS;  // 256 columns per block
constexpr int PAIR_ROWS = 256;               // plane rows of a group pair
constexpr int WARP_ROWS = PAIR_ROWS / DW_WARPS;

__device__ __forceinline__ void transpose4(const uint32_t (&r)[4],
                                           uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t2, 0x5410);
  c[1] = __byte_perm(t0, t2, 0x7632);
  c[2] = __byte_perm(t1, t3, 0x5410);
  c[3] = __byte_perm(t1, t3, 0x7632);
}

// 8 bytes of a qs row from column c0, zero beyond N
__device__ __forceinline__ uint2 ld_row8(const uint8_t* __restrict__ row,
                                         int c0, int N, bool full) {
  if (full) return __ldg(reinterpret_cast<const uint2*>(row + c0));
  union {
    uint2 v;
    uint8_t b[8];
  } u;
#pragma unroll
  for (int j = 0; j < 8; ++j) u.b[j] = (c0 + j < N) ? row[c0 + j] : 0;
  return u.v;
}

__device__ __forceinline__ float half_fix(int p, float alpha, float s,
                                          float xsum, float m) {
  return __fsub_rn(__fmul_rn(alpha, __fmul_rn(__int2float_rn(p), s)),
                   __fmul_rn(xsum, m));
}

// blockIdx.x: column strip, blockIdx.y: group pair. Writes part[pair, n]
// (y itself when there is one pair).
__global__ void __launch_bounds__(DW_WARPS * 32)
w4_decode_kernel(const int8_t* __restrict__ a_lo,
                 const int8_t* __restrict__ a_hi,
                 const float* __restrict__ alpha_lo,
                 const float* __restrict__ alpha_hi,
                 const float* __restrict__ xsum_lo,
                 const float* __restrict__ xsum_hi,
                 const uint8_t* __restrict__ qs,
                 const float* __restrict__ s_lo,
                 const float* __restrict__ s_hi,
                 const float* __restrict__ m_lo,
                 const float* __restrict__ m_hi, float* __restrict__ part,
                 int N, int vec) {
  __shared__ int red[2][DW_WARPS][DW_BLOCK_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pair = blockIdx.y;
  const int c0 = blockIdx.x * DW_BLOCK_COLS + lane * DW_COLS;
  const int r0 = pair * PAIR_ROWS + warp * WARP_ROWS;
  const bool full = vec && (c0 + DW_COLS <= N);

  int plo[DW_COLS], phi[DW_COLS];
#pragma unroll
  for (int j = 0; j < DW_COLS; ++j) plo[j] = phi[j] = 0;
  if (c0 < N) {
#pragma unroll 4
    for (int i = 0; i < WARP_ROWS; i += 4) {
      const int r = r0 + i;
      uint2 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = ld_row8(qs + (size_t)(r + e) * N, c0, N, full);
      const int alo = __ldg(reinterpret_cast<const int*>(a_lo + r));
      const int ahi = __ldg(reinterpret_cast<const int*>(a_hi + r));
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const uint32_t rw[4] = {b ? v[0].y : v[0].x, b ? v[1].y : v[1].x,
                                b ? v[2].y : v[2].x, b ? v[3].y : v[3].x};
        uint32_t cw[4];
        transpose4(rw, cw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lo = static_cast<int>(cw[j] & 0x0F0F0F0Fu);
          const int hi = static_cast<int>((cw[j] >> 4) & 0x0F0F0F0Fu);
          plo[4 * b + j] = __dp4a(lo, alo, plo[4 * b + j]);
          phi[4 * b + j] = __dp4a(hi, ahi, phi[4 * b + j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < DW_COLS; ++j) {
    red[0][warp][lane * DW_COLS + j] = plo[j];
    red[1][warp][lane * DW_COLS + j] = phi[j];
  }
  __syncthreads();
  const float al = alpha_lo[pair], ah = alpha_hi[pair];
  const float xl = xsum_lo[pair], xh = xsum_hi[pair];
  for (int c = threadIdx.x; c < DW_BLOCK_COLS; c += blockDim.x) {
    const int n = blockIdx.x * DW_BLOCK_COLS + c;
    if (n >= N) continue;
    int pl = 0, ph = 0;
#pragma unroll
    for (int w = 0; w < DW_WARPS; ++w) {
      pl += red[0][w][c];
      ph += red[1][w][c];
    }
    const size_t o = (size_t)pair * N + n;
    part[o] = __fadd_rn(half_fix(pl, al, s_lo[o], xl, m_lo[o]),
                        half_fix(ph, ah, s_hi[o], xh, m_hi[o]));
  }
}

// y[n] = part[0, n] + part[1, n] + ... in pair order
__global__ void w4_pairs_kernel(const float* __restrict__ part,
                                float* __restrict__ y, int pairs, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float t = part[n];
  for (int p = 1; p < pairs; ++p) t = __fadd_rn(t, part[(size_t)p * N + n]);
  y[n] = t;
}

}  // namespace

// y [1,N] f32 = the W4A8 decode product. a_lo / a_hi int8 [K/2];
// alpha_* / xsum_* f32 [K/512]; qs u8 [K/2, N]; s_* / m_* f32 [K/512, N].
// work: [K/512, N] f32 scratch when K > 512. vec: 1 when N % 8 == 0 and qs
// is 8-byte aligned. K % 512 == 0.
extern "C" int w4a8_decode(const void* a_lo, const void* a_hi,
                           const void* alpha_lo, const void* alpha_hi,
                           const void* xsum_lo, const void* xsum_hi,
                           const void* qs, const void* s_lo, const void* s_hi,
                           const void* m_lo, const void* m_hi, void* y,
                           void* work, int K, int N, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int pairs = K / 512;
  float* out = static_cast<float*>(y);
  float* part = pairs > 1 ? static_cast<float*>(work) : out;
  const dim3 grid((N + DW_BLOCK_COLS - 1) / DW_BLOCK_COLS, pairs);
  w4_decode_kernel<<<grid, DW_WARPS * 32, 0, st>>>(
      static_cast<const int8_t*>(a_lo), static_cast<const int8_t*>(a_hi),
      static_cast<const float*>(alpha_lo), static_cast<const float*>(alpha_hi),
      static_cast<const float*>(xsum_lo), static_cast<const float*>(xsum_hi),
      static_cast<const uint8_t*>(qs), static_cast<const float*>(s_lo),
      static_cast<const float*>(s_hi), static_cast<const float*>(m_lo),
      static_cast<const float*>(m_hi), part, N, vec);
  if (pairs > 1)
    w4_pairs_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, out, pairs, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
