// Fused dequant-matmul of the GGUF nibble formats (Q4_0, Q4_K, Q5_K, Q6_K)
// and of the engine-native W4A8 format for Hopper (sm_90a), plain C
// interface: one entry point per format.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/matmul.py::
// _quant_matmul_impl with its _q4_0_tile, _q4_k_tile, _q5_k_tile,
// _q6_k_tile and _w4a8_tile bodies (entry quant_matmul_pallas, reached from
// ops/linear.py::qmatmul): every quantized product of a Q4_0, Q4_K_M, Q5_K
// or Q6_K model, at T = 1 (decode) and at T > 1 (prefill chunks, batched
// steps, verify windows), and the T > 1 products of a W4A8 model (its T = 1
// product is w4a8_decode.cu).
//
// What it computes. y[T,N] f32 = bf16(x)[T,K] @ W with W[k,n] the bf16 of
// the weight exactly as the plain dequant (ops/dequant_torch.py, the JAX
// package's dequant_jnp.py) computes it in f32:
//   Q4_0:        (nib - 8) * d
//   Q4_K, Q5_K:  q * (d * sc) - dmin * mn      (Q5_K: q = nib | hb << 4)
//   Q6_K:        ((nib | hb << 4) - 32) * (d * sc)
//   W4A8:        nib * s - m                  (s, m f32 planes)
// with f32 accumulation. For Q4_0, Q4_K and Q5_K every product is exact in
// f32 (at most 11 + 6 + 5 significant bits), so only the one subtraction
// rounds, as in the plain dequant; for Q6_K (d * sc) is exact and the one
// multiply by q rounds, in the plain dequant's order. Kernel and plain twin
// thus see the same bf16 weights and differ only in the order of the f32
// sums. W4A8's nib * s is not exact in f32 for an arbitrary s, so an FMA
// contraction of nib * s - m would round once where the plain dequant
// rounds twice and change the bf16 weight: its body multiplies and
// subtracts with __fmul_rn and __fsub_rn. The TPU kernel's group-sum
// correction dot for the min term (a VPU trade with its own rounding) is not
// carried over.
//
// Plane layout (core/layout.py): transposed planes, N contiguous. Nibble
// plane row r of a format with split unit u (32 / 64 / 64 / 128) holds
// element u * (r / (u/2)) + r % (u/2) in its low nibble and that element
// + u/2 in its high nibble; the kernel reads x at those two positions.
//   Q4_0: d row r / 16.
//   Q4_K, Q5_K: sc_lo / mn_lo (low nibble) and sc_hi / mn_hi (high) row
//     r / 32, d / dmin row r / 128; Q5_K's qh [K/8, N] row
//     32 * (r / 128) + r % 32, bit 2c (low) and 2c + 1 (high), c = r%128/32.
//   Q6_K: sc_lo / sc_hi (signed int8) row r / 16, d row r / 128; qh [K/4, N]
//     row 32 * (r / 64) + r % 32, whose bit pair at shift 2e belongs to the
//     low nibble and the one at 4 + 2e to the high, e = r % 64 / 32.
//   W4A8 (split unit 512): s_lo / m_lo (low nibble) and s_hi / m_hi (high)
//     f32 row r / 256, passed in the sc_* / mn_* slots.
// f16 planes hold the raw bits (int16 on the PyTorch side).
//
// What bounds it on the H100. At T = 1 it streams the planes once: bytes
// over 3.35 TB/s (0.5625 / 0.578125 / 0.703125 / 0.8203125 bytes per
// weight; Q4_K fused gate|up of an 8B model, K 4096 x N 28672, 67.9 MB:
// ~20 us). The per-weight dequant (a nibble, a convert, one or two f32 ops
// and a bf16 round) is ~7 integer/f32 operations, so unlike Q8_0 the CUDA
// cores come close to the memory as the limit. At T > 1 it is bound by
// operations: 2*T*K*N on the bf16 tensor cores plus the dequant of every
// weight once per 64-row tile of x.
//
// What the simple design does about it.
//  * T == 1: nib_gemv_kernel. Each lane owns 16 neighbouring columns and
//    reads 16-byte row segments of each plane (a warp covers 512
//    contiguous bytes of a row: coalesced). The scales of a lane's columns
//    are decoded once per scale group (16 or 32 plane rows) into f32
//    registers. x of the block's K range is staged in shared memory as
//    bf16 (8 KB at K = 4096). Four warps take interleaved chunks of 16 (Q4_0)
//    or 32 plane rows. K is split across blocks on superblock boundaries
//    (so each split reads whole d / dmin rows) to cover the 132 SMs, and a
//    second kernel sums the partial rows in a fixed order: no atomics, runs
//    repeat bit for bit.
//  * T > 1: nib_mma_kernel. 64x128 output tiles, K stepped 32 plane rows
//    (64 elements) at a time. Each step stages the 64 x values the step's
//    planes multiply (two 32-element pieces for Q6_K, whose low and high
//    nibbles are 64 elements apart), dequantizes the 32 plane rows x 128
//    columns to bf16 in shared memory (transposed, with the XOR swizzle of
//    q8_0_matmul.cu), and runs mma.sync m16n8k16 bf16 -> f32 on the tensor
//    cores. No TMA, wgmma or pipelining yet: that is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Kind { KQ4_0 = 0, KQ4_K = 1, KQ5_K = 2, KQ6_K = 3, KW4A8 = 4 };

struct Planes {
  const uint8_t* q;      // qs / ql: nibble pairs [K/2, N]
  const uint8_t* qh;     // high bits: Q5_K [K/8, N], Q6_K [K/4, N]
  const uint8_t* sc_lo;  // u8 [K/64, N] (K-quants) or int8 [K/32, N] (Q6_K);
  const uint8_t* sc_hi;  //   W4A8: s_lo / s_hi, f32 [K/512, N]
  const uint8_t* mn_lo;  // u8 [K/64, N]; W4A8: m_lo / m_hi, f32 [K/512, N]
  const uint8_t* mn_hi;
  const uint16_t* d;     // f16 bits: [K/32, N] (Q4_0) or [K/256, N]
  const uint16_t* dmin;  // f16 bits [K/256, N]
};

// plane rows per half unit (u / 2): the high nibble's element is this far on
template <int KIND>
struct Fmt {
  static constexpr int HALF =
      KIND == KQ4_0 ? 16 : (KIND == KQ6_K ? 64 : (KIND == KW4A8 ? 256 : 32));
  // plane rows that share one set of decoded scales
  static constexpr int SCALE_ROWS =
      KIND == KQ4_0 || KIND == KQ6_K ? 16 : (KIND == KW4A8 ? 256 : 32);
  // plane rows a warp takes at a time in the GEMV
  static constexpr int CHUNK_ROWS = KIND == KQ4_0 ? 16 : 32;
};

// element of plane row r's low nibble (the high one is + HALF)
template <int KIND>
__device__ __forceinline__ int elem_lo(int r) {
  constexpr int H = Fmt<KIND>::HALF;
  return 2 * H * (r / H) + r % H;
}

__device__ __forceinline__ float f16(uint16_t bits) {
  return __half2float(__ushort_as_half(bits));
}

__device__ __forceinline__ float bf16r(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

union U8x16 {
  uint4 v;
  uint8_t b[16];
};

union H16 {
  uint4 v[2];
  uint16_t h[16];
};

// bytes [c0, c0 + 16) of a u8 plane row, zero beyond N
__device__ __forceinline__ U8x16 ld8(const uint8_t* __restrict__ row, int c0,
                                     int N, bool full) {
  U8x16 r;
  if (full) {
    r.v = __ldg(reinterpret_cast<const uint4*>(row + c0));
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) r.b[j] = (c0 + j < N) ? row[c0 + j] : 0;
  }
  return r;
}

// f16 bits [c0, c0 + 16) of a u16 plane row, zero beyond N
__device__ __forceinline__ H16 ld16(const uint16_t* __restrict__ row, int c0,
                                    int N, bool full) {
  H16 r;
  if (full) {
    const uint4* p = reinterpret_cast<const uint4*>(row + c0);
    r.v[0] = __ldg(p);
    r.v[1] = __ldg(p + 1);
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) r.h[j] = (c0 + j < N) ? row[c0 + j] : 0;
  }
  return r;
}

// ------------------------------------------------- per-format dequant bodies
// Scales<KIND>: the decoded f32 scales of 16 columns for one scale group;
// load_scales(r) fills them for plane row r's group; row_weights(r) gives
// the f32 weights (before the bf16 round) of row r's low and high elements.
template <int KIND>
struct Scales;

template <>
struct Scales<KQ4_0> {
  float d[16];
};

template <>
struct Scales<KQ4_K> {
  float sl[16], sh[16], ml[16], mh[16];
};

template <>
struct Scales<KQ5_K> : Scales<KQ4_K> {};

template <>
struct Scales<KQ6_K> {
  float sl[16], sh[16];
};

template <>
struct Scales<KW4A8> : Scales<KQ4_K> {};

template <int KIND>
__device__ __forceinline__ void load_scales(const Planes& p, int r, int c0,
                                            int N, bool full, Scales<KIND>& s);

template <>
__device__ __forceinline__ void load_scales<KQ4_0>(const Planes& p, int r,
                                                   int c0, int N, bool full,
                                                   Scales<KQ4_0>& s) {
  const H16 dh = ld16(p.d + (size_t)(r / 16) * N, c0, N, full);
#pragma unroll
  for (int j = 0; j < 16; ++j) s.d[j] = f16(dh.h[j]);
}

__device__ __forceinline__ void load_kscales(const Planes& p, int r, int c0,
                                             int N, bool full,
                                             Scales<KQ4_K>& s) {
  const size_t g = (size_t)(r / 32) * N, sb = (size_t)(r / 128) * N;
  const H16 dh = ld16(p.d + sb, c0, N, full);
  const H16 mh = ld16(p.dmin + sb, c0, N, full);
  const U8x16 a = ld8(p.sc_lo + g, c0, N, full);
  const U8x16 b = ld8(p.sc_hi + g, c0, N, full);
  const U8x16 c = ld8(p.mn_lo + g, c0, N, full);
  const U8x16 e = ld8(p.mn_hi + g, c0, N, full);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float dv = f16(dh.h[j]), mv = f16(mh.h[j]);
    s.sl[j] = dv * static_cast<float>(a.b[j]);  // exact: 11 + 6 bits
    s.sh[j] = dv * static_cast<float>(b.b[j]);
    s.ml[j] = mv * static_cast<float>(c.b[j]);
    s.mh[j] = mv * static_cast<float>(e.b[j]);
  }
}

template <>
__device__ __forceinline__ void load_scales<KQ4_K>(const Planes& p, int r,
                                                   int c0, int N, bool full,
                                                   Scales<KQ4_K>& s) {
  load_kscales(p, r, c0, N, full, s);
}

template <>
__device__ __forceinline__ void load_scales<KQ5_K>(const Planes& p, int r,
                                                   int c0, int N, bool full,
                                                   Scales<KQ5_K>& s) {
  load_kscales(p, r, c0, N, full, s);
}

template <>
__device__ __forceinline__ void load_scales<KQ6_K>(const Planes& p, int r,
                                                   int c0, int N, bool full,
                                                   Scales<KQ6_K>& s) {
  const H16 dh = ld16(p.d + (size_t)(r / 128) * N, c0, N, full);
  const size_t g = (size_t)(r / 16) * N;
  const U8x16 a = ld8(p.sc_lo + g, c0, N, full);
  const U8x16 b = ld8(p.sc_hi + g, c0, N, full);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float dv = f16(dh.h[j]);  // signed 8-bit scales: exact products
    s.sl[j] = dv * static_cast<float>(static_cast<int8_t>(a.b[j]));
    s.sh[j] = dv * static_cast<float>(static_cast<int8_t>(b.b[j]));
  }
}

// f32 [c0, c0 + 16) of an f32 plane row, zero beyond N
__device__ __forceinline__ void ldf(const uint8_t* plane, size_t off, int c0,
                                    int N, bool full, float (&v)[16]) {
  const float* row = reinterpret_cast<const float*>(plane) + off;
  if (full) {
    const float4* p = reinterpret_cast<const float4*>(row + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = __ldg(p + i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = (c0 + j < N) ? row[c0 + j] : 0.f;
  }
}

template <>
__device__ __forceinline__ void load_scales<KW4A8>(const Planes& p, int r,
                                                   int c0, int N, bool full,
                                                   Scales<KW4A8>& s) {
  const size_t g = (size_t)(r / 256) * N;
  ldf(p.sc_lo, g, c0, N, full, s.sl);
  ldf(p.sc_hi, g, c0, N, full, s.sh);
  ldf(p.mn_lo, g, c0, N, full, s.ml);
  ldf(p.mn_hi, g, c0, N, full, s.mh);
}

template <int KIND>
__device__ __forceinline__ void row_weights(const Planes& p, int r, int c0,
                                            int N, bool full,
                                            const Scales<KIND>& s,
                                            float (&wl)[16], float (&wh)[16]);

template <>
__device__ __forceinline__ void row_weights<KQ4_0>(
    const Planes& p, int r, int c0, int N, bool full, const Scales<KQ4_0>& s,
    float (&wl)[16], float (&wh)[16]) {
  const U8x16 q = ld8(p.q + (size_t)r * N, c0, N, full);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    wl[j] = static_cast<float>((q.b[j] & 15) - 8) * s.d[j];
    wh[j] = static_cast<float>((q.b[j] >> 4) - 8) * s.d[j];
  }
}

template <bool Q5>
__device__ __forceinline__ void krow(const Planes& p, int r, int c0, int N,
                                     bool full, const Scales<KQ4_K>& s,
                                     float (&wl)[16], float (&wh)[16]) {
  const U8x16 q = ld8(p.q + (size_t)r * N, c0, N, full);
  U8x16 h;
  int sh = 0;
  if (Q5) {
    h = ld8(p.qh + (size_t)(32 * (r / 128) + r % 32) * N, c0, N, full);
    sh = 2 * ((r % 128) / 32);
  }
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    int lo = q.b[j] & 15, hi = q.b[j] >> 4;
    if (Q5) {
      lo |= ((h.b[j] >> sh) & 1) << 4;
      hi |= ((h.b[j] >> (sh + 1)) & 1) << 4;
    }
    // q * s is exact, so the one rounding is the subtraction's (an FMA
    // contraction gives the same value)
    wl[j] = static_cast<float>(lo) * s.sl[j] - s.ml[j];
    wh[j] = static_cast<float>(hi) * s.sh[j] - s.mh[j];
  }
}

template <>
__device__ __forceinline__ void row_weights<KQ4_K>(
    const Planes& p, int r, int c0, int N, bool full, const Scales<KQ4_K>& s,
    float (&wl)[16], float (&wh)[16]) {
  krow<false>(p, r, c0, N, full, s, wl, wh);
}

template <>
__device__ __forceinline__ void row_weights<KQ5_K>(
    const Planes& p, int r, int c0, int N, bool full, const Scales<KQ5_K>& s,
    float (&wl)[16], float (&wh)[16]) {
  krow<true>(p, r, c0, N, full, s, wl, wh);
}

template <>
__device__ __forceinline__ void row_weights<KQ6_K>(
    const Planes& p, int r, int c0, int N, bool full, const Scales<KQ6_K>& s,
    float (&wl)[16], float (&wh)[16]) {
  const U8x16 q = ld8(p.q + (size_t)r * N, c0, N, full);
  const U8x16 h = ld8(p.qh + (size_t)(32 * (r / 64) + r % 32) * N, c0, N,
                      full);
  const int sh = 2 * ((r % 64) / 32);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int lo = ((q.b[j] & 15) | (((h.b[j] >> sh) & 3) << 4)) - 32;
    const int hi = ((q.b[j] >> 4) | (((h.b[j] >> (sh + 4)) & 3) << 4)) - 32;
    wl[j] = static_cast<float>(lo) * s.sl[j];
    wh[j] = static_cast<float>(hi) * s.sh[j];
  }
}

template <>
__device__ __forceinline__ void row_weights<KW4A8>(
    const Planes& p, int r, int c0, int N, bool full, const Scales<KW4A8>& s,
    float (&wl)[16], float (&wh)[16]) {
  const U8x16 q = ld8(p.q + (size_t)r * N, c0, N, full);
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    // two roundings, in the plain dequant's order: no FMA contraction
    wl[j] = __fsub_rn(__fmul_rn(static_cast<float>(q.b[j] & 15), s.sl[j]),
                      s.ml[j]);
    wh[j] = __fsub_rn(__fmul_rn(static_cast<float>(q.b[j] >> 4), s.sh[j]),
                      s.mh[j]);
  }
}

// ---------------------------------------------------------------- T == 1
constexpr int GV_WARPS = 4;
constexpr int GV_COLS = 16;                  // columns per lane
constexpr int GV_BLOCK_COLS = 32 * GV_COLS;  // 512 columns per block

// blockIdx.y takes plane rows [y * split_rows, (y + 1) * split_rows); the
// block's x range is staged in dynamic shared memory
template <int KIND>
__global__ void __launch_bounds__(GV_WARPS * 32)
nib_gemv_kernel(const __nv_bfloat16* __restrict__ x, Planes p,
                float* __restrict__ out, int K, int N, int split_rows,
                int vec) {
  extern __shared__ __align__(16) unsigned char xs_raw[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(xs_raw);
  __shared__ float red[GV_WARPS][GV_BLOCK_COLS];
  constexpr int H = Fmt<KIND>::HALF;
  constexpr int CR = Fmt<KIND>::CHUNK_ROWS;
  constexpr int SR = Fmt<KIND>::SCALE_ROWS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * GV_BLOCK_COLS + lane * GV_COLS;
  const int r_begin = blockIdx.y * split_rows;
  const int r_end = min(r_begin + split_rows, K / 2);
  // the split's elements are [2 * r_begin, 2 * r_end): whole units
  const int kb = 2 * r_begin;
  const int n_vec = (2 * (r_end - r_begin)) / 8;
  const uint4* xsrc = reinterpret_cast<const uint4*>(x + kb);
  for (int i = threadIdx.x; i < n_vec; i += blockDim.x)
    reinterpret_cast<uint4*>(xs)[i] = xsrc[i];
  __syncthreads();

  const bool full = vec && (c0 + GV_COLS <= N);
  float acc[GV_COLS];
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) acc[j] = 0.f;

  if (c0 < N) {
    for (int r0 = r_begin + warp * CR; r0 < r_end; r0 += GV_WARPS * CR) {
#pragma unroll
      for (int g0 = 0; g0 < CR; g0 += SR) {
        Scales<KIND> s;
        load_scales<KIND>(p, r0 + g0, c0, N, full, s);
#pragma unroll 4
        for (int i = 0; i < SR; ++i) {
          const int r = r0 + g0 + i;
          const int e = elem_lo<KIND>(r) - kb;
          const float xl = __bfloat162float(xs[e]);
          const float xh = __bfloat162float(xs[e + H]);
          float wl[GV_COLS], wh[GV_COLS];
          row_weights<KIND>(p, r, c0, N, full, s, wl, wh);
#pragma unroll
          for (int j = 0; j < GV_COLS; ++j) {
            acc[j] = fmaf(xl, bf16r(wl[j]), acc[j]);
            acc[j] = fmaf(xh, bf16r(wh[j]), acc[j]);
          }
        }
      }
    }
  }
  // sum the four warps in a fixed order (deterministic)
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) red[warp][lane * GV_COLS + j] = acc[j];
  __syncthreads();
  for (int c = threadIdx.x; c < GV_BLOCK_COLS; c += blockDim.x) {
    const int n = blockIdx.x * GV_BLOCK_COLS + c;
    if (n < N) {
      float t = red[0][c];
#pragma unroll
      for (int w = 1; w < GV_WARPS; ++w) t += red[w][c];
      out[(size_t)blockIdx.y * N + n] = t;
    }
  }
}

__global__ void splitk_reduce_kernel(const float* __restrict__ part,
                                     float* __restrict__ y, int nsplit,
                                     int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float t = 0.f;
  for (int s = 0; s < nsplit; ++s) t += part[(size_t)s * N + n];
  y[n] = t;
}

// ----------------------------------------------------------------- T > 1
constexpr int MM_BM = 64;
constexpr int MM_BN = 128;
constexpr int MM_BK = 64;          // elements per K step: 32 plane rows
constexpr int MM_LDS = MM_BK + 8;  // smem row stride (bf16): 36 words

// Bs[n][k] column swizzle: XOR k with 4 * ((n / 16) % 8), as in
// q8_0_matmul.cu: (k, k+1) pairs stay adjacent and inside their 32-half,
// and both the dequant stores and the fragment loads avoid bank conflicts.
__device__ __forceinline__ int swz(int n, int k) {
  return k ^ (((n >> 4) & 7) << 2);
}

// x element of tile column kc (0..63) at K step st. Q4_0, Q4_K and Q5_K
// step over 64 contiguous elements; a Q6_K step's 32 plane rows hold the
// low nibbles of 32 elements and the high nibbles of the 32 that lie 64 on,
// a W4A8 step's those of 32 elements and of the 32 that lie 256 on.
template <int KIND>
__device__ __forceinline__ int tile_elem(int st, int kc) {
  if (KIND == KQ6_K) {
    const int lo_base = 128 * (st / 2) + 32 * (st % 2);
    return lo_base + (kc < 32 ? kc : kc + 32);
  }
  if (KIND == KW4A8) {
    const int lo_base = 512 * (st / 8) + 32 * (st % 8);
    return lo_base + (kc < 32 ? kc : kc + 224);
  }
  return MM_BK * st + kc;
}

// tile column of the low (hi = 0) or high element of the step's plane row
// rr (0..31)
template <int KIND>
__device__ __forceinline__ int tile_col(int rr, int hi) {
  if (KIND == KQ4_0) return 32 * (rr / 16) + rr % 16 + 16 * hi;
  return rr + 32 * hi;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int KIND>
__global__ void __launch_bounds__(128)
nib_mma_kernel(const __nv_bfloat16* __restrict__ x, Planes p,
               float* __restrict__ y, int T, int K, int N, int vec) {
  __shared__ __align__(16) __nv_bfloat16 As[MM_BM][MM_LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[MM_BN][MM_LDS];  // [n][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;
  const int rows = K / 2;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const int steps = (rows + 31) / 32;
  for (int st = 0; st < steps; ++st) {
    // x tile: 64 rows x 64 bf16, as 512 chunks of 8 (a chunk never
    // straddles a Q6_K piece or the end of K: K % 32 == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = tid + i * 128, row = c >> 3, col = (c & 7) * 8;
      const int e = tile_elem<KIND>(st, col);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < T && e < K)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + e);
      *reinterpret_cast<uint4*>(&As[row][col]) = v;
    }
    // weight tile: 32 plane rows x 128 columns, as 256 pieces of 16
    // columns, dequantized to bf16 and stored transposed
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, rr = c >> 3, col = (c & 7) * 16;
      const int n = n0 + col, r = st * 32 + rr;
      float wl[16], wh[16];
      if (r < rows && n < N) {
        const bool full = vec && n + 16 <= N;
        Scales<KIND> s;
        load_scales<KIND>(p, r, n, N, full, s);
        row_weights<KIND>(p, r, n, N, full, s, wl, wh);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) wl[j] = wh[j] = 0.f;
      }
      const int kl = tile_col<KIND>(rr, 0), kh = tile_col<KIND>(rr, 1);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        Bs[col + j][swz(col + j, kl)] = __float2bfloat16_rn(wl[j]);
        Bs[col + j][swz(col + j, kh)] = __float2bfloat16_rn(wh[j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MM_BK; ks += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + g;
        a[mt][0] = ld32(&As[r][ks + 2 * t4]);
        a[mt][1] = ld32(&As[r + 8][ks + 2 * t4]);
        a[mt][2] = ld32(&As[r][ks + 2 * t4 + 8]);
        a[mt][3] = ld32(&As[r + 8][ks + 2 * t4 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int cn = wn + nt * 8 + g;
        const uint32_t b0 = ld32(&Bs[cn][swz(cn, ks + 2 * t4)]);
        const uint32_t b1 = ld32(&Bs[cn][swz(cn, ks + 2 * t4 + 8)]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_16816(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = m0 + wm + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = n0 + wn + nt * 8 + 2 * t4;
      if (r < T) {
        if (c < N) y[(size_t)r * N + c] = acc[mt][nt][0];
        if (c + 1 < N) y[(size_t)r * N + c + 1] = acc[mt][nt][1];
      }
      if (r + 8 < T) {
        if (c < N) y[(size_t)(r + 8) * N + c] = acc[mt][nt][2];
        if (c + 1 < N) y[(size_t)(r + 8) * N + c + 1] = acc[mt][nt][3];
      }
    }
  }
}

template <int KIND>
int launch(const void* x, const void* q, const void* qh, const void* sc_lo,
           const void* sc_hi, const void* mn_lo, const void* mn_hi,
           const void* d, const void* dmin, void* y, void* work, int T, int K,
           int N, int split_rows, int nsplit, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  Planes p;
  p.q = static_cast<const uint8_t*>(q);
  p.qh = static_cast<const uint8_t*>(qh);
  p.sc_lo = static_cast<const uint8_t*>(sc_lo);
  p.sc_hi = static_cast<const uint8_t*>(sc_hi);
  p.mn_lo = static_cast<const uint8_t*>(mn_lo);
  p.mn_hi = static_cast<const uint8_t*>(mn_hi);
  p.d = static_cast<const uint16_t*>(d);
  p.dmin = static_cast<const uint16_t*>(dmin);
  float* out = static_cast<float*>(y);
  if constexpr (KIND == KW4A8) {
    // T = 1 is the quantized-activation product of w4a8_decode.cu
    if (T == 1) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((N + MM_BN - 1) / MM_BN, (T + MM_BM - 1) / MM_BM);
    nib_mma_kernel<KIND><<<grid, 128, 0, st>>>(xb, p, out, T, K, N, vec);
  } else if (T == 1) {
    const int smem = 2 * split_rows * 2;  // the split's x, bf16
    if (smem > 40 * 1024) {  // beyond the default 48 KB with `red`
      const cudaError_t e = cudaFuncSetAttribute(
          nib_gemv_kernel<KIND>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    const dim3 grid((N + GV_BLOCK_COLS - 1) / GV_BLOCK_COLS, nsplit);
    float* part = nsplit > 1 ? static_cast<float*>(work) : out;
    nib_gemv_kernel<KIND><<<grid, GV_WARPS * 32, smem, st>>>(
        xb, p, part, K, N, split_rows, vec);
    if (nsplit > 1)
      splitk_reduce_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, out, nsplit,
                                                            N);
  } else {
    const dim3 grid((N + MM_BN - 1) / MM_BN, (T + MM_BM - 1) / MM_BM);
    nib_mma_kernel<KIND><<<grid, 128, 0, st>>>(xb, p, out, T, K, N, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y [T,N] f32 = x [T,K] bf16 @ dequant(planes). Plane pointers a format does
// not have are null. work: [nsplit, N] f32 scratch when T == 1 and
// nsplit > 1. split_rows: plane rows per split at T == 1 (whole scale units;
// superblocks for the K-quants). vec: 1 when N % 16 == 0 and every plane is
// 16-byte aligned (vector loads).
#define NIBBLE_ENTRY(fn, KIND)                                                \
  extern "C" int fn(const void* x, const void* q, const void* qh,             \
                    const void* sc_lo, const void* sc_hi, const void* mn_lo,  \
                    const void* mn_hi, const void* d, const void* dmin,       \
                    void* y, void* work, int T, int K, int N, int split_rows, \
                    int nsplit, int vec, void* stream) {                      \
    return launch<KIND>(x, q, qh, sc_lo, sc_hi, mn_lo, mn_hi, d, dmin, y,     \
                        work, T, K, N, split_rows, nsplit, vec, stream);      \
  }

NIBBLE_ENTRY(q4_0_matmul, KQ4_0)
NIBBLE_ENTRY(q4_k_matmul, KQ4_K)
NIBBLE_ENTRY(q5_k_matmul, KQ5_K)
NIBBLE_ENTRY(q6_k_matmul, KQ6_K)
NIBBLE_ENTRY(w4a8_matmul, KW4A8)

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
