// W4A8 int8 decode matmul (T = 1) for Hopper (sm_90a), plain C interface,
// with the activation quantization folded in.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/w4a8.py::
// _w4a8_decode_impl (with _blockdiag_i8 and _idot; entry w4a8_decode_pallas,
// reached from ops/linear.py::qmatmul at T = 1), and the XLA activation
// quantization in front of it (core/w4a8.quantize_activations): every decode
// product of a model requantized with --w4a8. T > 1 is the w4a8_matmul entry
// of nibble_matmul.cu.
//
// What it computes. x [1, K] (bf16 or f32, any stride) is quantized per
// 256-group g: amax_g = max |x|, alpha_g = max(amax_g / 127, 1e-30) (an
// IEEE division), codes a = rint(x / alpha_g) (half to even, as
// torch.round) and the group sum xsum_g in a fixed tree: the 256 values are
// halved 8 times, v[i] + v[i + h] for h = 128, 64, ..., 1. For each column n
// and each pair c of 256-groups (plane rows [256c, 256c + 256): the low
// nibbles are group 2c, the high nibbles group 2c + 1, core/w4a8.py):
//   P_lo = sum_r a_lo[r] * (qs[r,n] & 15)
//   P_hi = sum_r a_hi[r] * (qs[r,n] >> 4)
// exactly in int32 (|P| <= 127 * 15 * 256), then the f32 fixup
//   part[c,n] = (alpha_lo[c] * (f32(P_lo) * s_lo) - xsum_lo[c] * m_lo)
//             + (alpha_hi[c] * (f32(P_hi) * s_hi) - xsum_hi[c] * m_hi)
// with the planes s_lo, m_lo, s_hi and m_hi read at [c, n], and
// y[n] = part[0,n] + part[1,n] + ... in that order. Each f32 operation is
// an explicit _rn intrinsic, so nothing contracts and the kernel is
// bit-equal to its plain twin (ops/cuda/w4a8.py), which takes the same steps
// in PyTorch, the tree sum included. The TPU kernel's block-diagonal
// activation matrix and its four HIGHEST-precision fixup dots are tricks
// for the TPU's matrix unit and are not carried over; the arithmetic they
// compute is.
//
// What bounds it on the H100. Bytes: 0.53125 a weight (codes and the four
// f32 planes), read once (fused gate|up of an 8B model, 62.4 MB: 18.6 us at
// 3.35 TB/s; down, K 14336 x N 4096, 31.2 MB: 9.3 us). x is 8 KB. The
// integer work is two dp4a per four codes.
//
// What the design does about it.
//  * One launch, no PyTorch op around it: a block quantizes the x of its
//    own group pairs (one warp per pair: a 256-group is 8 values a lane,
//    the amax a warp max, the tree sum 3 register levels and 5 shuffles)
//    into shared memory; the 512 x values of a pair are read from L2 by
//    every column strip, ~1/16 of the codes' bytes.
//  * A block owns a strip of 64 columns and a run of group pairs, one warp
//    per pair. Lane (s, c) of a warp reads 16-byte rows (16 columns) of
//    the plane rows [32s, 32s + 32) of the pair, 8 rows in flight, so a
//    warp load is 8 segments of 64 contiguous bytes. 4 x 4 byte blocks are
//    transposed with __byte_perm so one dp4a takes 4 codes of one column.
//    The 8 lanes that share a column chunk hold partial integer sums; a
//    butterfly reduce-scatter (28 shuffles a lane) leaves each lane the
//    whole pair's sums of 2 columns, whose fixup it runs.
//  * The pairs are summed in order in shared memory by the block, so a
//    strip whose block holds all of K (8 pairs at most: K <= 4096) writes y
//    in one pass; the first 8 code rows of a pair are loaded while its x is
//    quantized. A longer K (the 8B down: 28 pairs) is split into runs of at
//    most 8 pairs, one warp each; each block then writes its pairs' parts
//    and a second kernel adds them in pair order, so runs repeat bit for
//    bit.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DW_STRIP = 64;      // columns per block
constexpr int DW_MAX_WARPS = 8;   // pairs in flight per block
constexpr int PAIR_ROWS = 256;    // plane rows of a group pair
constexpr int LANE_ROWS = 32;     // plane rows of a lane within a pair

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

// 16 bytes of a qs row from column c0, zero beyond N
__device__ __forceinline__ uint4 ld_row16(const uint8_t* __restrict__ row,
                                          int c0, int N, bool full) {
  if (full) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  union {
    uint4 v;
    uint8_t b[16];
  } u;
#pragma unroll
  for (int j = 0; j < 16; ++j) u.b[j] = (c0 + j < N) ? row[c0 + j] : 0;
  return u.v;
}

// 32-bit word b (a compile-time constant) of a 16-byte load
__device__ __forceinline__ uint32_t word(const uint4& v, int b) {
  return b == 0 ? v.x : (b == 1 ? v.y : (b == 2 ? v.z : v.w));
}

__device__ __forceinline__ float ldx(const __nv_bfloat16* x, int64_t i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ float ldx(const float* x, int64_t i) {
  return x[i];
}

__device__ __forceinline__ float half_fix(int p, float alpha, float s,
                                          float xsum, float m) {
  return __fsub_rn(__fmul_rn(alpha, __fmul_rn(__int2float_rn(p), s)),
                   __fmul_rn(xsum, m));
}

// One 256-group of x quantized by a warp: codes to smem (byte i = element
// i of the group), alpha and the tree sum returned to every lane.
template <typename XT>
__device__ __forceinline__ void quant_group(const XT* __restrict__ x,
                                            int64_t xs, int e0, int lane,
                                            int8_t* __restrict__ codes,
                                            float& alpha, float& xsum) {
  float v[8];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    v[j] = ldx(x, (int64_t)(e0 + lane + 32 * j) * xs);
    amax = fmaxf(amax, fabsf(v[j]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  alpha = fmaxf(__fdiv_rn(amax, 127.f), 1e-30f);
#pragma unroll
  for (int j = 0; j < 8; ++j)
    codes[lane + 32 * j] =
        static_cast<int8_t>(__float2int_rn(__fdiv_rn(v[j], alpha)));
  // the tree: element i = lane + 32 j; h = 128, 64, 32 in registers
  float a[4], b[2];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = __fadd_rn(v[j], v[j + 4]);
#pragma unroll
  for (int j = 0; j < 2; ++j) b[j] = __fadd_rn(a[j], a[j + 2]);
  float c = __fadd_rn(b[0], b[1]);
  // h = 16, 8, 4, 2, 1 across lanes: lane i < h adds lane i + h
#pragma unroll
  for (int h = 16; h > 0; h >>= 1)
    c = __fadd_rn(c, __shfl_down_sync(0xffffffffu, c, h));
  xsum = __shfl_sync(0xffffffffu, c, 0);
}

// v[0..2H) -> v[0..H): this lane keeps the half its bit selects and adds
// the partner's copy of the same half
template <int H>
__device__ __forceinline__ void keep_half(int (&v)[32], bool upper, int xr) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const int keep = upper ? v[i + H] : v[i];
    const int send = upper ? v[i] : v[i + H];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, xr);
  }
}

// blockIdx.x: column strip, blockIdx.y: run of pairs [y * pps, ...). With
// part == nullptr the block sums its pairs in order and writes y;
// otherwise it writes part[pair, n] for the pair-sum pass. SEL: sel is
// the device index of a matrix in stacked planes that start at qs and the
// four f32 planes, read once by every block (the TPU kernel's
// scalar-prefetch select), matrix m qs_stride / f_stride m bytes on; a
// template flag, as in q8_0_matmul.cu.
template <typename XT, bool SEL>
__global__ void __launch_bounds__(DW_MAX_WARPS * 32)
w4_decode_kernel(const XT* __restrict__ x, int64_t xs,
                 const uint8_t* __restrict__ qs,
                 const float* __restrict__ s_lo,
                 const float* __restrict__ s_hi,
                 const float* __restrict__ m_lo,
                 const float* __restrict__ m_hi, float* __restrict__ y,
                 float* __restrict__ part, int K, int N, int pps, int vec,
                 const int* __restrict__ sel, long long qs_stride,
                 long long f_stride) {
  if constexpr (SEL) {
    const long long e = __ldg(sel);
    qs += e * qs_stride;
    const long long fo = e * f_stride / 4;
    s_lo += fo, s_hi += fo, m_lo += fo, m_hi += fo;
  }
  __shared__ __align__(16) int8_t codes[DW_MAX_WARPS][2 * PAIR_ROWS];
  __shared__ float parts[DW_MAX_WARPS][DW_STRIP];  // one pass: pair parts
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s8 = lane >> 2, c4 = lane & 3;
  const int n0 = blockIdx.x * DW_STRIP;
  const int cl = n0 + 16 * c4;  // this lane's 16 columns
  const bool full = vec && (cl + 16 <= N);
  const int p_begin = blockIdx.y * pps;
  const int p_end = min(p_begin + pps, K / 512);
  int8_t* my = codes[warp];

  const int p = p_begin + warp;  // this warp's pair
  if (p < p_end) {
    const uint8_t* base = qs + (size_t)(PAIR_ROWS * p + LANE_ROWS * s8) * N;
    const bool live = cl < N;
    // the pair's first 8 code rows are in flight while x is quantized
    uint4 nxt[8];
#pragma unroll
    for (int e = 0; e < 8; ++e)
      nxt[e] = live ? ld_row16(base + (size_t)e * N, cl, N, full)
                    : make_uint4(0u, 0u, 0u, 0u);
    float al, ah, xl, xh;
    quant_group(x, xs, 512 * p, lane, my, al, xl);
    quant_group(x, xs, 512 * p + 256, lane, my + PAIR_ROWS, ah, xh);
    __syncwarp();

    int v[32];  // v[2j]: P_lo of column j, v[2j + 1]: P_hi
#pragma unroll
    for (int j = 0; j < 32; ++j) v[j] = 0;
#pragma unroll
    for (int i = 0; i < LANE_ROWS; i += 4) {
      uint4 q[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) q[e] = nxt[(i + e) % 8];
      if (live && i + 8 < LANE_ROWS) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          nxt[(i + e) % 8] =
              ld_row16(base + (size_t)(i + 8 + e) * N, cl, N, full);
      }
      const int alo =
          *reinterpret_cast<const int*>(my + LANE_ROWS * s8 + i);
      const int ahi = *reinterpret_cast<const int*>(
          my + PAIR_ROWS + LANE_ROWS * s8 + i);
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const uint32_t rw[4] = {word(q[0], b), word(q[1], b),
                                word(q[2], b), word(q[3], b)};
        uint32_t cw[4];
        transpose4(rw, cw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int lo = static_cast<int>(cw[j] & 0x0F0F0F0Fu);
          const int hi = static_cast<int>((cw[j] >> 4) & 0x0F0F0F0Fu);
          v[2 * (4 * b + j)] = __dp4a(lo, alo, v[2 * (4 * b + j)]);
          v[2 * (4 * b + j) + 1] = __dp4a(hi, ahi, v[2 * (4 * b + j) + 1]);
        }
      }
    }
    // lanes s = 0..7 of column chunk c4: reduce-scatter over lane bits
    // 4, 3, 2; lane s then holds columns 2s, 2s + 1 of its chunk
    keep_half<16>(v, (s8 >> 2) & 1, 16);
    keep_half<8>(v, (s8 >> 1) & 1, 8);
    keep_half<4>(v, s8 & 1, 4);

#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int n = cl + 2 * s8 + j;
      if (n >= N) continue;
      const size_t o = (size_t)p * N + n;
      const float r = __fadd_rn(half_fix(v[2 * j], al, s_lo[o], xl, m_lo[o]),
                                half_fix(v[2 * j + 1], ah, s_hi[o], xh,
                                         m_hi[o]));
      if (part)
        part[o] = r;
      else
        parts[warp][n - n0] = r;
    }
  }
  if (part) return;
  __syncthreads();
  for (int c = threadIdx.x; c < DW_STRIP; c += blockDim.x) {
    const int n = n0 + c;
    if (n >= N) continue;
    float t = parts[0][c];
    for (int w = 1; w < p_end - p_begin; ++w)
      t = __fadd_rn(t, parts[w][c]);
    y[n] = t;
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

template <typename XT>
int launch(const void* x, long long xs, const void* qs, const void* s_lo,
           const void* s_hi, const void* m_lo, const void* m_hi, void* y,
           void* work, int K, int N, int pps, int vec, const int* sel,
           long long qs_stride, long long f_stride, cudaStream_t st) {
  const int pairs = K / 512;
  const int nsplit = (pairs + pps - 1) / pps;
  float* out = static_cast<float*>(y);
  float* part = nsplit > 1 ? static_cast<float*>(work) : nullptr;
  const dim3 grid((N + DW_STRIP - 1) / DW_STRIP, nsplit);
  const auto kernel = sel != nullptr ? w4_decode_kernel<XT, true>
                                      : w4_decode_kernel<XT, false>;
  kernel<<<grid, pps * 32, 0, st>>>(
      static_cast<const XT*>(x), static_cast<int64_t>(xs),
      static_cast<const uint8_t*>(qs), static_cast<const float*>(s_lo),
      static_cast<const float*>(s_hi), static_cast<const float*>(m_lo),
      static_cast<const float*>(m_hi), out, part, K, N, pps, vec, sel,
      qs_stride, f_stride);
  if (part) {
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    w4_pairs_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, out, pairs, N);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [1,N] f32 = the W4A8 decode product of x [1,K] (x_f32: 1 for f32, 0 for
// bf16; xs: its element stride along K). qs u8 [K/2, N]; s_* / m_* f32
// [K/512, N]. pps: group pairs per block, 1 to 8, one warp each; when it
// is below K/512, work is [K/512, N] f32 scratch and a second kernel sums
// the pairs. vec: 1 when N % 16 == 0 and qs is 16-byte aligned.
// K % 512 == 0. sel: null, or a device int32 index into stacked planes
// [M, K/2, N] and [M, K/512, N] that start at the given pointers, matrix m
// at qs + m qs_stride and each f32 plane + m f_stride bytes (with vec,
// qs_stride a multiple of 16; f_stride a multiple of 4); the decode kernel
// reads it, the pair-sum pass reads no plane.
extern "C" int w4a8_decode(const void* x, int x_f32, long long xs,
                           const void* qs, const void* s_lo, const void* s_hi,
                           const void* m_lo, const void* m_hi, void* y,
                           void* work, int K, int N, int pps, int vec,
                           const void* sel, long long qs_stride,
                           long long f_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pps < 1 || pps > DW_MAX_WARPS || K % 512 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (sel != nullptr &&
      ((vec && qs_stride % 16 != 0) || f_stride % 4 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  const int* si = static_cast<const int*>(sel);
  return x_f32 ? launch<float>(x, xs, qs, s_lo, s_hi, m_lo, m_hi, y, work, K,
                               N, pps, vec, si, qs_stride, f_stride, st)
               : launch<__nv_bfloat16>(x, xs, qs, s_lo, s_hi, m_lo, m_hi, y,
                                       work, K, N, pps, vec, si, qs_stride,
                                       f_stride, st);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
