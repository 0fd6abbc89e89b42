// The shared code of the Q4_0, Q4_K, Q5_K and Q6_K dequant-matmul
// kernels (the design is in kquant_matmul.cu). Each format's entry
// (KQUANT_ENTRY) instantiates its skinny kernel and wgmma tile in a
// translation unit of its own: kquant_matmul.cu (Q4_0) and
// kquant_matmul.<format>.cu, compiled in parallel and linked into one
// library (ops/cuda/build.py).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace cg = cooperative_groups;

namespace {
using namespace hop;

struct Planes {
  const uint8_t* q;      // qs (Q4_K, Q5_K) / ql (Q6_K): nibbles [K/2, N]
  const uint8_t* qh;     // Q5_K high bits [K/8, N]; Q6_K bit pairs [K/4, N]
  const uint8_t* sc_lo;  // Q4_K, Q5_K u8 [K/64, N]; Q6_K int8 [K/32, N]
  const uint8_t* sc_hi;
  const uint8_t* mn_lo;  // Q4_K, Q5_K u8 [K/64, N]
  const uint8_t* mn_hi;
  const uint16_t* d;     // f16 bits [K/256, N]
  const uint16_t* dmin;  // Q4_K, Q5_K f16 bits [K/256, N]
  // 0x4B000000 (the f32 2^23), given at run time: held in a register, it
  // leaves the byte permutes' selectors to their immediate operand (as a
  // known constant it takes that operand, and the compiler copies each
  // selector into a register of its own: ~0.9 more instructions a weight)
  uint32_t magic;
};

// bytes from one matrix of a stacked [M, K, N] plane set to the next, for
// each Planes pointer in its order (0 for a plane the format lacks)
struct Strides {
  long long q, qh, sc_lo, sc_hi, mn_lo, mn_hi, d, dmin;
};

template <typename T>
__device__ __forceinline__ const T* offset_plane(const T* p, long long e,
                                                 long long stride) {
  return p == nullptr ? p
                      : reinterpret_cast<const T*>(
                            reinterpret_cast<const uint8_t*>(p) + e * stride);
}

// the planes of matrix sel[0] of a stacked set, the index read on the card
// (the TPU kernel's scalar-prefetch select)
__device__ __forceinline__ Planes select_planes(const Planes& p,
                                                const int* sel,
                                                const Strides& s) {
  const long long e = __ldg(sel);
  Planes o = p;
  o.q = offset_plane(p.q, e, s.q);
  o.qh = offset_plane(p.qh, e, s.qh);
  o.sc_lo = offset_plane(p.sc_lo, e, s.sc_lo);
  o.sc_hi = offset_plane(p.sc_hi, e, s.sc_hi);
  o.mn_lo = offset_plane(p.mn_lo, e, s.mn_lo);
  o.mn_hi = offset_plane(p.mn_hi, e, s.mn_hi);
  o.d = offset_plane(p.d, e, s.d);
  o.dmin = offset_plane(p.dmin, e, s.dmin);
  return o;
}

constexpr uint32_t NIB = 0x0F0F0F0Fu;
constexpr uint32_t HB = 0x30303030u;
constexpr uint32_t B5 = 0x10101010u;  // Q5_K's fifth bit of four codes

__device__ __forceinline__ float f16f(uint16_t bits) {
  return __half2float(__ushort_as_half(bits));
}

// the f32 2^23 + b, b byte j of u (a nibble or a 6-bit code); mg holds
// the bits 0x4B000000
__device__ __forceinline__ float magic(uint32_t u, int j, uint32_t mg) {
  return __uint_as_float(__byte_perm(u, mg, 0x7650 | j));
}

// Q4_K and Q5_K: fl(q s - m) (q s exact, so one fma of the exact q rounds
// as the plain dequant's subtraction does)
__device__ __forceinline__ float q4k_w(uint32_t u, int j, uint32_t mg,
                                       float s, float m) {
  return __fmaf_rn(__fsub_rn(magic(u, j, mg), 8388608.f), s, -m);
}

// Q6_K: fl((q - 32) s), q - 32 exact
__device__ __forceinline__ float q6k_w(uint32_t u, int j, uint32_t mg,
                                       float s) {
  return __fmul_rn(__fsub_rn(magic(u, j, mg), 8388640.f), s);
}

// Q4_0: (q - 8) d, exact (q - 8 exact, an f16 d times a 4-bit integer)
__device__ __forceinline__ float q40_w(uint32_t u, int j, uint32_t mg,
                                       float d) {
  return __fmul_rn(__fsub_rn(magic(u, j, mg), 8388616.f), d);
}

// 16 bytes of a u8 plane, row `row`, columns [col, col + 16), zero past N
// and where the row is not in the plane (row_in false: Q4_0's half step):
// cp.async, or plain loads when the planes are not 16-byte aligned
__device__ __forceinline__ void copy_u8(uint8_t* dst,
                                        const uint8_t* __restrict__ plane,
                                        int row, int col, int N, int vec,
                                        bool row_in = true) {
  const uint8_t* src = plane + (size_t)row * N + col;
  if (vec) {
    const bool in = row_in && col < N;
    cp_async16(smem_u32(dst), in ? src : plane, in ? 16 : 0);
  } else {
#pragma unroll
    for (int e = 0; e < 16; ++e) dst[e] = row_in && col + e < N ? src[e] : 0;
  }
}

// 8 values of a u16 (f16 bits) plane, columns [col, col + 8)
__device__ __forceinline__ void copy_u16(uint8_t* dst,
                                         const uint16_t* __restrict__ plane,
                                         int row, int col, int N, int vec,
                                         bool row_in = true) {
  const uint16_t* src = plane + (size_t)row * N + col;
  if (vec) {
    const bool in = row_in && col < N;
    cp_async16(smem_u32(dst), in ? src : plane, in ? 16 : 0);
  } else {
    uint16_t* dd = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
    for (int e = 0; e < 8; ++e) dd[e] = row_in && col + e < N ? src[e] : 0;
  }
}

// 8 bf16 of x row r from element k, zeros where k_in is false (past K);
// rows past T are left alone (the skinny kernel zeroes them once in every
// slot)
__device__ __forceinline__ void copy_x(uint8_t* dst,
                                       const __nv_bfloat16* __restrict__ x,
                                       int r, int k, int T, int K,
                                       bool k_in = true) {
  if (r < T)
    cp_async16(smem_u32(dst), k_in ? x + (size_t)r * K + k : x,
               k_in ? 16 : 0);
}

// ------------------------------------------------------------- T <= 32
constexpr int SK_MAX_CLUSTER = 8;
constexpr int SC = 128;           // strip columns: 8 lanes x 16
constexpr int SMEM_MAX = 232448;  // a block's shared memory (227 KB)
constexpr int SMEM_TWO = 115712;  // each of two blocks an SM (228 KB less
                                  // 1 KB reserved a block, halved)

// byte offset of 16-byte chunk c of code row r in a slot: the chunks of a
// row are rotated by 2 ((r >> 1) & 3), so the 8 lanes of a 16-byte load
// phase (two column chunks x the four rows 2 t + ...) hit 8 bank groups
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * SC + ((c ^ (2 * ((r >> 1) & 3))) << 4);
}

// the words of code rows 16 h + 2 t + {0, 1, 8, 9} (from row0) of a
// lane's 16 columns: the k pairs of its m16n8k16 fragments
__device__ __forceinline__ void load_rows(const uint8_t* base, int row0,
                                          int t, int g,
                                          uint32_t (&w)[4][4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int r = row0 + 2 * t + (e & 1) + 8 * (e >> 1);
    const uint4 v = *reinterpret_cast<const uint4*>(base + chunk_at(r, g));
    w[e][0] = v.x, w[e][1] = v.y, w[e][2] = v.z, w[e][3] = v.w;
  }
}

// A fragment of tile j (j = 4 wq + b): row g is column 16 g + j (word wq,
// byte b of a row), row g + 8 column 16 g + 8 + j (word 2 + wq); nb[e]
// hold the two words of row e, f(word, byte, column 0 or 1) its weight
template <class Fn>
__device__ __forceinline__ void a_frag(const uint32_t (&nb)[4][2], int b,
                                       Fn f, uint32_t (&a)[4]) {
  a[0] = bf16x2(f(nb[0][0], b, 0), f(nb[1][0], b, 0));
  a[1] = bf16x2(f(nb[0][1], b, 1), f(nb[1][1], b, 1));
  a[2] = bf16x2(f(nb[2][0], b, 0), f(nb[3][0], b, 0));
  a[3] = bf16x2(f(nb[2][1], b, 1), f(nb[3][1], b, 1));
}

// Q4_K (QH = false) and Q5_K (QH = true): a warp step is 32 plane rows,
// 64 consecutive elements (k = 64 s: rows 32 s .. 32 s + 31). Q5_K adds the
// step's 32 qh rows (32 G + r, G = k / 256), whose bits 2 c (the low
// nibble's element) and 2 c + 1 (the high one's), c = k / 64 % 4, are the
// codes' fifth; the superblock's four steps read the same 32 rows, each
// again from L2 (Q6_K's trade: slots small enough for two blocks an SM)
template <bool QH>
struct Q45K {
  static constexpr int STEP = 64;
  static constexpr int K_UNIT = 256;  // K: whole superblocks
  static constexpr int QH_OFF = 32 * SC;                  // Q5_K qh rows
  static constexpr int SC_OFF = QH_OFF + (QH ? 32 * SC : 0);  // sc_lo,
  static constexpr int D_OFF = SC_OFF + 4 * SC;    // sc_hi, mn_lo, mn_hi
                                                   // rows; d, dmin
  static constexpr int X_OFF = D_OFF + 2 * SC * 2;  // x [8 NT][64] bf16,
  static constexpr int X_LD = 144;                  // rows 144 bytes apart
  // decoded scales: [lo, hi][tile j][g] float4 {s, m} of columns 16 g + j
  // and 16 g + 8 + j
  static constexpr int SCR = 2 * 8 * 8 * 16;

  template <int NT>
  __device__ static void issue(uint8_t* slot, const __nv_bfloat16* x,
                               const Planes& p, int k, int n0, int T, int K,
                               int N, int vec, int lane) {
    const int pr = k >> 1;  // the step's first plane row
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // 32 rows x 8 chunks of 16 codes
      const int id = lane + 32 * i, r = id >> 3, c = id & 7;
      copy_u8(slot + chunk_at(r, c), p.q, pr + r, n0 + 16 * c, N, vec);
      if constexpr (QH)
        copy_u8(slot + QH_OFF + chunk_at(r, c), p.qh, 32 * (k >> 8) + r,
                n0 + 16 * c, N, vec);
    }
    {  // the step's scale and min rows: 4 planes x 8 chunks
      const int pl = lane >> 3, c = lane & 7;
      const uint8_t* plane =
          pl == 0 ? p.sc_lo
                  : (pl == 1 ? p.sc_hi : (pl == 2 ? p.mn_lo : p.mn_hi));
      copy_u8(slot + SC_OFF + SC * pl + 16 * c, plane, k >> 6, n0 + 16 * c, N,
              vec);
    }
    {  // its superblock's d and dmin rows: 2 x 16 chunks of 8
      const int pl = lane >> 4, c = lane & 15;
      copy_u16(slot + D_OFF + 2 * SC * pl + 16 * c, pl ? p.dmin : p.d, k >> 8,
               n0 + 8 * c, N, vec);
    }
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {  // 8 NT tokens x 8 chunks of 8 bf16
      const int id = lane + 32 * i, r = id >> 3, c = id & 7;
      copy_x(slot + X_OFF + r * X_LD + 16 * c, x, r, k + 8 * c, T, K);
    }
  }

  // lane l decodes (j, g) = (l / 8 + 4 i, l % 8): 4 columns a lane
  __device__ static void scales(const uint8_t* slot, uint8_t* scr, int lane) {
    const uint16_t* dd = reinterpret_cast<const uint16_t*>(slot + D_OFF);
    const uint8_t* sc = slot + SC_OFF;
    float4* out = reinterpret_cast<float4*>(scr);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = lane & 7, j = (lane >> 3) + 4 * i;
      const int c1 = 16 * g + j, c2 = c1 + 8;
      const float d1 = f16f(dd[c1]), d2 = f16f(dd[c2]);
      const float m1 = f16f(dd[SC + c1]), m2 = f16f(dd[SC + c2]);
      out[j * 8 + g] = make_float4(
          __fmul_rn(d1, sc[c1]), __fmul_rn(m1, sc[2 * SC + c1]),
          __fmul_rn(d2, sc[c2]), __fmul_rn(m2, sc[2 * SC + c2]));
      out[(8 + j) * 8 + g] = make_float4(
          __fmul_rn(d1, sc[SC + c1]), __fmul_rn(m1, sc[3 * SC + c1]),
          __fmul_rn(d2, sc[SC + c2]), __fmul_rn(m2, sc[3 * SC + c2]));
    }
  }

  // per accumulator, in order: the low nibbles' block of rows 0-15
  // (elements 0-15 of the step), their high nibbles' (32-47), then rows
  // 16-31 (16-31, 48-63)
  template <int NT>
  __device__ static void compute(const uint8_t* slot, const uint8_t* scr,
                                 float (&acc)[8][NT][4], int lane,
                                 uint32_t mg, int k) {
    const int g = lane >> 2, t = lane & 3;
    const int c2 = 2 * ((k >> 6) & 3);  // Q5_K: the step's bit pair
    const float4* sv = reinterpret_cast<const float4*>(scr);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t cw[4][4], hw[4][4];
      load_rows(slot, 16 * h, t, g, cw);
      if constexpr (QH) load_rows(slot + QH_OFF, 16 * h, t, g, hw);
      uint32_t b[2][NT][2];  // [lo, hi block][token tile]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* xr =
            slot + X_OFF + (8 * nt + g) * X_LD + 32 * h + 4 * t;
        b[0][nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[0][nt][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
        b[1][nt][0] = *reinterpret_cast<const uint32_t*>(xr + 64);
        b[1][nt][1] = *reinterpret_cast<const uint32_t*>(xr + 80);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int wq = 0; wq < 2; ++wq) {
          // 4-bit codes, and Q5_K's fifth bit moved from bit 2 c (low
          // nibble) or 2 c + 1 (high) of the qh byte to bit 4
          uint32_t nb[4][2];
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const uint32_t w = cw[e][wq + 2 * u];
              nb[e][u] = hi ? (w >> 4) & NIB : w & NIB;
              if constexpr (QH) {
                const uint32_t hb = hw[e][wq + 2 * u] >> c2;
                nb[e][u] |= (hi ? hb << 3 : hb << 4) & B5;
              }
            }
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int j = 4 * wq + bb;
            const float4 s = sv[(8 * hi + j) * 8 + g];
            uint32_t a[4];
            a_frag(nb, bb,
                   [&](uint32_t w, int by, int c) {
                     return c ? q4k_w(w, by, mg, s.z, s.w)
                              : q4k_w(w, by, mg, s.x, s.y);
                   },
                   a);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16_16816(acc[j][nt], a, b[hi][nt][0], b[hi][nt][1]);
          }
        }
      }
    }
  }
};

// Q6_K: a warp step is 32 plane rows (k = 64 s: rows 32 s .. 32 s + 31, G
// = k / 128, e = k / 64 % 2), the low nibbles of elements 128 G + 32 e +
// 0-31 and their high nibbles 64 on; the step's 32 qh rows (32 G + r) are
// those of the other e too, read again from L2 by the warp that takes it
// (a 64-row step that reads them once needs slots too large for two blocks
// an SM, and measured slower at every shape)
struct Q6K {
  static constexpr int STEP = 64;
  static constexpr int K_UNIT = 256;
  static constexpr int QH_OFF = 32 * SC;           // qh rows [32][128]
  static constexpr int SC_OFF = QH_OFF + 32 * SC;  // sc_lo [2][128], sc_hi
  static constexpr int D_OFF = SC_OFF + 4 * SC;    // d [128] f16
  static constexpr int X_OFF = D_OFF + 2 * SC;     // x [8 NT][64] bf16: the
  static constexpr int X_LD = 144;                 // low piece, the high one
  // decoded scales: [h][tile j][g] float4 {s_lo, s_hi} of columns 16 g + j
  // and 16 g + 8 + j
  static constexpr int SCR = 2 * 8 * 8 * 16;

  template <int NT>
  __device__ static void issue(uint8_t* slot, const __nv_bfloat16* x,
                               const Planes& p, int k, int n0, int T, int K,
                               int N, int vec, int lane) {
    const int pr = k >> 1, G = k >> 7, e = (k >> 6) & 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // 32 ql and 32 qh rows x 8 chunks
      const int id = lane + 32 * i, r = id >> 3, c = id & 7;
      copy_u8(slot + chunk_at(r, c), p.q, pr + r, n0 + 16 * c, N, vec);
      copy_u8(slot + QH_OFF + chunk_at(r, c), p.qh, 32 * G + r, n0 + 16 * c,
              N, vec);
    }
    {  // 2 sc_lo, then 2 sc_hi rows x 8 chunks
      const int pl = lane >> 4, rr = (lane >> 3) & 1, c = lane & 7;
      copy_u8(slot + SC_OFF + 2 * SC * pl + SC * rr + 16 * c,
              pl ? p.sc_hi : p.sc_lo, (k >> 5) + rr, n0 + 16 * c, N, vec);
    }
    if (lane < 16)  // the superblock's d row: 16 chunks of 8
      copy_u16(slot + D_OFF + 16 * lane, p.d, k >> 8, n0 + 8 * lane, N, vec);
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {  // 8 NT tokens x 2 pieces x 4 chunks
      const int id = lane + 32 * i, r = id >> 3, c = id & 7;
      const int el = 128 * G + 32 * e + (c < 4 ? 8 * c : 64 + 8 * (c - 4));
      copy_x(slot + X_OFF + r * X_LD + 16 * c, x, r, el, T, K);
    }
  }

  __device__ static void scales(const uint8_t* slot, uint8_t* scr, int lane) {
    const uint16_t* dd = reinterpret_cast<const uint16_t*>(slot + D_OFF);
    const int8_t* sc = reinterpret_cast<const int8_t*>(slot + SC_OFF);
    float4* out = reinterpret_cast<float4*>(scr);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = lane & 7, j = (lane >> 3) + 4 * i;
      const int c1 = 16 * g + j, c2 = c1 + 8;
      const float d1 = f16f(dd[c1]), d2 = f16f(dd[c2]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // scale rows of plane rows 16 h + ...
        const int8_t* lo = sc + SC * h;
        const int8_t* hi = sc + 2 * SC + SC * h;
        out[(h * 8 + j) * 8 + g] = make_float4(
            __fmul_rn(d1, lo[c1]), __fmul_rn(d1, hi[c1]),
            __fmul_rn(d2, lo[c2]), __fmul_rn(d2, hi[c2]));
      }
    }
  }

  // per accumulator, in order: the low nibbles' block of rows 0-15
  // (elements 32 e + 0-15 of the superblock half), their high nibbles'
  // (64 on), then rows 16-31
  template <int NT>
  __device__ static void compute(const uint8_t* slot, const uint8_t* scr,
                                 float (&acc)[8][NT][4], int lane,
                                 uint32_t mg, int k) {
    const int g = lane >> 2, t = lane & 3;
    const int e = (k >> 6) & 1;
    const float4* sv = reinterpret_cast<const float4*>(scr);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t hw[4][4], qw[4][4];
      load_rows(slot + QH_OFF, 16 * h, t, g, hw);
      load_rows(slot, 16 * h, t, g, qw);
      uint32_t b[2][NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* xr =
            slot + X_OFF + (8 * nt + g) * X_LD + 32 * h + 4 * t;
        b[0][nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[0][nt][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
        b[1][nt][0] = *reinterpret_cast<const uint32_t*>(xr + 64);
        b[1][nt][1] = *reinterpret_cast<const uint32_t*>(xr + 80);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int wq = 0; wq < 2; ++wq) {
          // 6-bit codes: the nibble, and the bit pair of the qh byte at
          // 2 e (low nibble) or 4 + 2 e (high) moved to bits 4-5
          uint32_t nb[4][2];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const uint32_t q = qw[r][wq + 2 * u], hb = hw[r][wq + 2 * u];
              nb[r][u] = hi ? ((q >> 4) & NIB) | ((hb >> (2 * e)) & HB)
                            : (q & NIB) | ((hb << (4 - 2 * e)) & HB);
            }
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int j = 4 * wq + bb;
            const float4 s = sv[(h * 8 + j) * 8 + g];
            const float s1 = hi ? s.y : s.x, s2 = hi ? s.w : s.z;
            uint32_t a[4];
            a_frag(nb, bb,
                   [&](uint32_t w, int by, int c) {
                     return q6k_w(w, by, mg, c ? s2 : s1);
                   },
                   a);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16_16816(acc[j][nt], a, b[hi][nt][0], b[hi][nt][1]);
          }
        }
      }
    }
  }
};

// Q4_0: a warp step is 32 plane rows at element k = 64 s, two Q4_0 blocks:
// rows 0-15 hold elements k + 0-15 in their low nibbles and k + 16-31 in
// their high ones, rows 16-31 the next 32; d rows 2 s (rows 0-15) and
// 2 s + 1. x is staged with its 16-element pieces 1 and 2 swapped, so
// compute reads the k16 blocks where Q4_K's reads its own: per
// accumulator, in order, elements k + 0-15, 16-31, 32-47, 48-63. Where
// K % 64 == 32 the last step is half: its rows 16-31, second d row and x
// past K are zero-filled
struct Q40 {
  static constexpr int STEP = 64;
  static constexpr int K_UNIT = 32;                 // K: whole blocks
  static constexpr int D_OFF = 32 * SC;             // d [2][128] f16
  static constexpr int X_OFF = D_OFF + 2 * SC * 2;  // x [8 NT][64] bf16,
  static constexpr int X_LD = 144;                  // rows 144 bytes apart
  // decoded scales: [h][tile j][g] float2 {d} of columns 16 g + j and
  // 16 g + 8 + j
  static constexpr int SCR = 2 * 8 * 8 * 8;

  template <int NT, bool HALF>
  __device__ static void fill(uint8_t* slot, const __nv_bfloat16* x,
                              const Planes& p, int k, int n0, int T, int K,
                              int N, int vec, int lane) {
    const int pr = k >> 1;
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // 32 rows x 8 chunks (i < 4: rows 0-15)
      const int id = lane + 32 * i, r = id >> 3, c = id & 7;
      copy_u8(slot + chunk_at(r, c), p.q, pr + r, n0 + 16 * c, N, vec,
              !HALF || i < 4);
    }
    {  // d rows 2 s and 2 s + 1: 2 x 16 chunks of 8
      const int rr = lane >> 4, c = lane & 15;
      copy_u16(slot + D_OFF + 2 * SC * rr + 16 * c, p.d, (k >> 5) + rr,
               n0 + 8 * c, N, vec, !HALF || rr == 0);
    }
#pragma unroll
    for (int i = 0; i < 2 * NT; ++i) {  // 8 NT tokens x 8 chunks of 8 bf16
      const int id = lane + 32 * i, r = id >> 3, c = id & 7;
      const int xc = c >= 2 && c < 6 ? c ^ 6 : c;  // x chunk of slot chunk c
      copy_x(slot + X_OFF + r * X_LD + 16 * c, x, r, k + 8 * xc, T, K,
             !HALF || xc < 4);
    }
  }

  template <int NT>
  __device__ static void issue(uint8_t* slot, const __nv_bfloat16* x,
                               const Planes& p, int k, int n0, int T, int K,
                               int N, int vec, int lane) {
    if (k + STEP <= K)
      fill<NT, false>(slot, x, p, k, n0, T, K, N, vec, lane);
    else
      fill<NT, true>(slot, x, p, k, n0, T, K, N, vec, lane);
  }

  // lane l decodes (j, g) = (l / 8 + 4 i, l % 8) of both d rows
  __device__ static void scales(const uint8_t* slot, uint8_t* scr, int lane) {
    const uint16_t* dd = reinterpret_cast<const uint16_t*>(slot + D_OFF);
    float2* out = reinterpret_cast<float2*>(scr);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int g = lane & 7, j = (lane >> 3) + 4 * i;
      const int c1 = 16 * g + j, c2 = c1 + 8;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        out[(8 * h + j) * 8 + g] =
            make_float2(f16f(dd[SC * h + c1]), f16f(dd[SC * h + c2]));
    }
  }

  template <int NT>
  __device__ static void compute(const uint8_t* slot, const uint8_t* scr,
                                 float (&acc)[8][NT][4], int lane,
                                 uint32_t mg, int) {
    const int g = lane >> 2, t = lane & 3;
    const float2* sv = reinterpret_cast<const float2*>(scr);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t cw[4][4];
      load_rows(slot, 16 * h, t, g, cw);
      uint32_t b[2][NT][2];  // [lo, hi block][token tile]
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* xr =
            slot + X_OFF + (8 * nt + g) * X_LD + 32 * h + 4 * t;
        b[0][nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[0][nt][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
        b[1][nt][0] = *reinterpret_cast<const uint32_t*>(xr + 64);
        b[1][nt][1] = *reinterpret_cast<const uint32_t*>(xr + 80);
      }
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int wq = 0; wq < 2; ++wq) {
          uint32_t nb[4][2];
#pragma unroll
          for (int e = 0; e < 4; ++e)
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const uint32_t w = cw[e][wq + 2 * u];
              nb[e][u] = hi ? (w >> 4) & NIB : w & NIB;
            }
#pragma unroll
          for (int bb = 0; bb < 4; ++bb) {
            const int j = 4 * wq + bb;
            const float2 d = sv[(8 * h + j) * 8 + g];
            uint32_t a[4];
            a_frag(nb, bb,
                   [&](uint32_t w, int by, int c) {
                     return q40_w(w, by, mg, c ? d.y : d.x);
                   },
                   a);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma_bf16_16816(acc[j][nt], a, b[hi][nt][0], b[hi][nt][1]);
          }
        }
      }
    }
  }
};

template <class F, int NT>
struct Skinny {
  static constexpr int SLOT = F::X_OFF + 8 * NT * F::X_LD;
  // two slots a warp: one step in flight while one is computed (a third
  // slot measured no faster at T = 1 and slower at T = 32, where it leaves
  // one block an SM; experiments/kquant_skinny_variants.py "slots3")
  static constexpr int STAGES = 2;
  // 4 warps a block, or 3 where 4 warps' slots would leave one block an SM
  // (Q5_K and Q6_K at 17-32 tokens, whose qh rows fill the slots: Q6_K's 8B
  // down would run its 160 blocks in two waves)
  static constexpr int WARPS =
      4 * (STAGES * SLOT + F::SCR) <= SMEM_TWO ? 4 : 3;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int RING = WARPS * STAGES * SLOT;
  static constexpr int USED = RING + WARPS * F::SCR;
  static constexpr int RED = 8 * NT * SC * 4;  // the block's sums
  static constexpr int SMEM = USED > RED ? USED : RED;
  static_assert(SMEM <= SMEM_MAX, "skinny shared memory over the 227 KB");
  static_assert(SLOT % 16 == 0 && F::SCR % 16 == 0, "16-byte slots");
};

// y rows [0, T) x the 128 columns of this cluster's strip; blockIdx.x: the
// K split (the cluster's rank), blockIdx.y: the strip. Dynamic shared
// memory: the warps' rings and scale scratch, later the block's sums.
// SEL: the planes are the first matrix of a stacked set, and every block
// reads the index sel[0] and offsets them by it before its first copy (a
// template flag, as in q8_0_matmul.cu).
template <class F, int NT, bool SEL>
__global__ void __launch_bounds__(Skinny<F, NT>::THREADS)
skinny_kernel(const __nv_bfloat16* __restrict__ x, const Planes p_in,
              float* __restrict__ y, int T, int K, int N, int split_k,
              int vec, const int* __restrict__ sel, const Strides ps) {
  const Planes p = SEL ? select_planes(p_in, sel, ps) : p_in;
  using L = Skinny<F, NT>;
  constexpr int MT = 8;         // m16 tiles: a lane's 16 columns
  constexpr int ROWS = 8 * NT;  // padded tokens
  constexpr int SLOT = L::SLOT, STAGES = L::STAGES;
  constexpr int WARPS = L::WARPS, THREADS = L::THREADS;
  constexpr int STRIDE = F::STEP * WARPS;
  extern __shared__ __align__(1024) uint8_t dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * SC;
  const int kb = blockIdx.x * split_k;
  const int ke = min(kb + split_k, K);
  uint8_t* ring = dyn + warp * STAGES * SLOT;
  uint8_t* scr = dyn + L::RING + warp * F::SCR;
  // this warp's steps: elements kb + STEP (warp + 4 i)
  const int k0 = kb + F::STEP * warp;
  const int steps = k0 < ke ? (ke - k0 + STRIDE - 1) / STRIDE : 0;

  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  // the padded token rows [T, ROWS) of every slot's x, zeroed once (no
  // step copies them: at T = 1 that spares 7 of every 8 x copies)
  for (int st = 0; st < STAGES; ++st)
    for (int o = T * F::X_LD + 16 * lane; o < ROWS * F::X_LD; o += 512)
      *reinterpret_cast<uint4*>(ring + st * SLOT + F::X_OFF + o) =
          make_uint4(0u, 0u, 0u, 0u);

#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps)
      F::template issue<NT>(ring + i * SLOT, x, p, k0 + STRIDE * i, n0, T, K,
                            N, vec, lane);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    __syncwarp();  // every lane is done with the slot refilled next
    const int nx = i + STAGES - 1;
    if (nx < steps)
      F::template issue<NT>(ring + (nx % STAGES) * SLOT, x, p,
                            k0 + STRIDE * nx, n0, T, K, N, vec, lane);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this lane's copies of step i
    __syncwarp();                 // and every lane's
    const uint8_t* slot = ring + (i % STAGES) * SLOT;
    F::scales(slot, scr, lane);
    __syncwarp();
    F::template compute<NT>(slot, scr, acc, lane, p.magic, k0 + STRIDE * i);
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are dead: the block's sums take their place

  // the warps' sums in warp order into one [ROWS][128] array; the
  // fragment's columns are tokens 2 t, 2 t + 1
  float* red = reinterpret_cast<float*>(dyn);
  for (int w = 0; w < WARPS; ++w) {
    if (warp == w) {
#pragma unroll
      for (int j = 0; j < MT; ++j)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const int tok = 8 * nt + 2 * t;
          const int ca = 16 * g + j, cb = 16 * g + MT + j;
          const int o[4] = {tok * SC + ca, (tok + 1) * SC + ca, tok * SC + cb,
                            (tok + 1) * SC + cb};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            red[o[e]] = w == 0 ? acc[j][nt][e]
                               : __fadd_rn(red[o[e]], acc[j][nt][e]);
        }
    }
    __syncthreads();
  }
  const int rows = min(T, ROWS);
  cluster.sync();  // every block's partial rows are in its red
  const int ranks = cluster.num_blocks();
  const int rank = cluster.block_rank();
  for (int e = rank * THREADS + threadIdx.x; e < rows * SC;
       e += ranks * THREADS) {
    const int n = n0 + e % SC;
    if (n >= N) continue;
    float v = cluster.map_shared_rank(red, 0)[e];
    for (int q = 1; q < ranks; ++q)
      v = __fadd_rn(v, cluster.map_shared_rank(red, q)[e]);
    y[(size_t)(e / SC) * N + n] = v;
  }
  cluster.sync();  // no block leaves while another reads its red
}

template <class F, int NT, bool SEL = false>
int launch_skinny(const __nv_bfloat16* x, const Planes& p, float* y, int T,
                  int K, int N, int nsplit, int split_k, int vec,
                  cudaStream_t st, const int* sel = nullptr,
                  const Strides& ps = Strides{}) {
  constexpr int SMEM = Skinny<F, NT>::SMEM;
  const cudaError_t ae = cudaFuncSetAttribute(
      skinny_kernel<F, NT, SEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (ae != cudaSuccess) return static_cast<int>(ae);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, (N + SC - 1) / SC, 1);
  cfg.blockDim = dim3(Skinny<F, NT>::THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, skinny_kernel<F, NT, SEL>,
                                           x, p, y, T, K, N, split_k, vec,
                                           sel, ps);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// ----------------------------------------------------------------- T > 32
// the K-quant formats of the hopper_tile.cuh tile: a stage is 32 plane
// rows, 64 k-values (128 bytes of bf16 a row): the low nibbles' 32 elements
// (chunks 0-3 of a B row), then the high nibbles' 32 (chunks 4-7)
struct TileBase {
  using Acc = float;
  struct Args {
    const __nv_bfloat16* x;
    Planes p;
    float* y;
    int T, K, N, vec;
  };
  static constexpr int X_AHEAD = 3, R_AHEAD = 3;
  static constexpr int CODE_BYTES = 32 * tile::BN;  // [32][128]

  // Q4_0's K % 64 == 32 ends in a half stage
  __device__ static int steps(const Args& a) { return (a.K + 63) / 64; }

  __device__ static void mma(float (&acc)[64], uint64_t da, uint64_t db) {
    wgmma_bf16_m64n128(acc, da, db);
  }

  __device__ static void store(const Args& a, int r, int c, float v0,
                               float v1) {
    if (r >= a.T) return;
    float* dst = a.y + (size_t)r * a.N + c;
    if ((a.N & 1) == 0 && c + 1 < a.N) {
      *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
    } else {
      if (c < a.N) dst[0] = v0;
      if (c + 1 < a.N) dst[1] = v1;
    }
  }

  // the stage's 32 code rows (plane rows row0 + r) of `plane`
  __device__ static void issue_codes(const Args& a, uint8_t* dst,
                                     const uint8_t* plane, int row0, int n0,
                                     int pt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 32 rows x 8 chunks of 16 codes
      const int id = pt + tile::PRODUCERS * i, r = id >> 3, c = id & 7;
      copy_u8(dst + r * tile::BN + 16 * c, plane, row0 + r, n0 + 16 * c, a.N,
              a.vec);
    }
  }
};

// Q4_K and Q5_K stage st: plane rows 32 st + r, elements 64 st + r (low
// nibble) and 64 st + 32 + r (high): x in its own order. Q5_K's qh rows are
// 32 (st / 4) + r, its fifth bits 2 c and 2 c + 1, c = st % 4, so its
// transform takes the stage
template <bool QH>
struct TileQ45K : TileBase {
  static constexpr bool STAGED = QH;
  static constexpr int QH_OFF = CODE_BYTES;
  static constexpr int SC_OFF = QH_OFF + (QH ? CODE_BYTES : 0);  // sc_lo,
  static constexpr int D_OFF = SC_OFF + 4 * tile::BN;  // sc_hi, mn_lo,
  static constexpr int RAW_BYTES = D_OFF + 2 * tile::BN * 2;  // mn_hi; d,
                                                              // dmin

  __device__ static const void* a_chunk(const Args& a, int row, int st,
                                        int c, int& bytes) {
    const bool in = row < a.T;
    bytes = in ? 16 : 0;
    return a.x + (in ? (size_t)row * a.K + 64 * st + 8 * c : 0);
  }

  __device__ static void issue_raw(const Args& a, uint8_t* raw, int st,
                                   int n0, int pt) {
    issue_codes(a, raw, a.p.q, 32 * st, n0, pt);
    if constexpr (QH)
      issue_codes(a, raw + QH_OFF, a.p.qh, 32 * (st >> 2), n0, pt);
    if (pt < 32) {  // the stage's scale and min rows: 4 planes x 8 chunks
      const int pl = pt >> 3, c = pt & 7;
      const uint8_t* plane =
          pl == 0 ? a.p.sc_lo
                  : (pl == 1 ? a.p.sc_hi : (pl == 2 ? a.p.mn_lo : a.p.mn_hi));
      copy_u8(raw + SC_OFF + tile::BN * pl + 16 * c, plane, st, n0 + 16 * c,
              a.N, a.vec);
    } else if (pt < 64) {  // its superblock's d and dmin: 2 x 16 chunks
      const int q = pt - 32, pl = q >> 4, c = q & 15;
      copy_u16(raw + D_OFF + 2 * tile::BN * pl + 16 * c,
               pl ? a.p.dmin : a.p.d, st >> 2, n0 + 8 * c, a.N, a.vec);
    }
  }

  // item pt: plane rows [8 rg, 8 rg + 8) x 4 columns from 4 cgp; column j
  // is taken at step q = j - rot, so the 8 lanes of a store phase write 8
  // rows n with 8 distinct n % 8 (distinct swizzled chunks)
  __device__ static void transform(const Args& a, const uint8_t* raw,
                                   uint8_t* bt, int, int pt, int st = 0) {
    const uint32_t mg = a.p.magic;
    const int cgp = pt & 31, rg = pt >> 5, rot = (cgp >> 1) & 3;
    const int c2 = 2 * (st & 3);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (8 * rg + i) * tile::BN + 4 * cgp;
      const uint32_t w = *reinterpret_cast<const uint32_t*>(raw + o);
      lo[i] = w & NIB;
      hi[i] = (w >> 4) & NIB;
      if constexpr (QH) {
        const uint32_t hb =
            *reinterpret_cast<const uint32_t*>(raw + QH_OFF + o) >> c2;
        lo[i] |= (hb << 4) & B5;
        hi[i] |= (hb << 3) & B5;
      }
    }
    const uint8_t* sc = raw + SC_OFF;
    const uint16_t* dd = reinterpret_cast<const uint16_t*>(raw + D_OFF);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = (q + rot) & 3, n = 4 * cgp + j;
      const float d = f16f(dd[n]), dm = f16f(dd[tile::BN + n]);
      const float sl = __fmul_rn(d, sc[n]);
      const float ml = __fmul_rn(dm, sc[2 * tile::BN + n]);
      const float sh = __fmul_rn(d, sc[tile::BN + n]),
                  mh = __fmul_rn(dm, sc[3 * tile::BN + n]);
      uint32_t ol[4], oh[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        ol[p] = bf16x2(q4k_w(lo[2 * p], j, mg, sl, ml),
                       q4k_w(lo[2 * p + 1], j, mg, sl, ml));
        oh[p] = bf16x2(q4k_w(hi[2 * p], j, mg, sh, mh),
                       q4k_w(hi[2 * p + 1], j, mg, sh, mh));
      }
      *reinterpret_cast<uint4*>(bt + sw128(n, rg)) =
          make_uint4(ol[0], ol[1], ol[2], ol[3]);
      *reinterpret_cast<uint4*>(bt + sw128(n, 4 + rg)) =
          make_uint4(oh[0], oh[1], oh[2], oh[3]);
    }
  }
};

// Q6_K stage st (G = st / 2, e = st % 2): plane rows 32 st + r, elements
// 128 G + 32 e + r (low nibble) and 64 on (high); the qh rows 32 G + r,
// the bit pairs at 2 e and 4 + 2 e, so its transform takes the stage
struct TileQ6K : TileBase {
  static constexpr bool STAGED = true;
  static constexpr int QH_OFF = CODE_BYTES;
  static constexpr int SC_OFF = QH_OFF + CODE_BYTES;    // sc_lo [2][128],
  static constexpr int D_OFF = SC_OFF + 4 * tile::BN;   // sc_hi [2][128]
  static constexpr int RAW_BYTES = D_OFF + 2 * tile::BN;  // d [128] f16

  __device__ static const void* a_chunk(const Args& a, int row, int st,
                                        int c, int& bytes) {
    const bool in = row < a.T;
    bytes = in ? 16 : 0;
    const int k = 128 * (st >> 1) + 32 * (st & 1) + (c < 4 ? 8 * c
                                                           : 64 + 8 * (c - 4));
    return a.x + (in ? (size_t)row * a.K + k : 0);
  }

  __device__ static void issue_raw(const Args& a, uint8_t* raw, int st,
                                   int n0, int pt) {
    issue_codes(a, raw, a.p.q, 32 * st, n0, pt);
    issue_codes(a, raw + QH_OFF, a.p.qh, 32 * (st >> 1), n0, pt);
    if (pt < 32) {  // the stage's 2 sc_lo and 2 sc_hi rows x 8 chunks
      const int pl = pt >> 4, rr = (pt >> 3) & 1, c = pt & 7;
      copy_u8(raw + SC_OFF + 2 * tile::BN * pl + tile::BN * rr + 16 * c,
              pl ? a.p.sc_hi : a.p.sc_lo, 2 * st + rr, n0 + 16 * c, a.N,
              a.vec);
    } else if (pt < 48) {  // its superblock's d row: 16 chunks of 8
      const int c = pt - 32;
      copy_u16(raw + D_OFF + 16 * c, a.p.d, st >> 2, n0 + 8 * c, a.N, a.vec);
    }
  }

  __device__ static void transform(const Args& a, const uint8_t* raw,
                                   uint8_t* bt, int, int pt, int st) {
    const uint32_t mg = a.p.magic;
    const int cgp = pt & 31, rg = pt >> 5, rot = (cgp >> 1) & 3;
    const int e = st & 1;
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int o = (8 * rg + i) * tile::BN + 4 * cgp;
      const uint32_t q = *reinterpret_cast<const uint32_t*>(raw + o);
      const uint32_t hb = *reinterpret_cast<const uint32_t*>(raw + QH_OFF + o);
      lo[i] = (q & NIB) | ((hb << (4 - 2 * e)) & HB);
      hi[i] = ((q >> 4) & NIB) | ((hb >> (2 * e)) & HB);
    }
    // plane rows 8 rg .. 8 rg + 7 share scale row rg / 2 of the stage
    const int8_t* scl =
        reinterpret_cast<const int8_t*>(raw + SC_OFF + tile::BN * (rg >> 1));
    const int8_t* sch = scl + 2 * tile::BN;
    const uint16_t* dd = reinterpret_cast<const uint16_t*>(raw + D_OFF);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = (q + rot) & 3, n = 4 * cgp + j;
      const float d = f16f(dd[n]);
      const float sl = __fmul_rn(d, scl[n]), sh = __fmul_rn(d, sch[n]);
      uint32_t ol[4], oh[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        ol[p] = bf16x2(q6k_w(lo[2 * p], j, mg, sl),
                       q6k_w(lo[2 * p + 1], j, mg, sl));
        oh[p] = bf16x2(q6k_w(hi[2 * p], j, mg, sh),
                       q6k_w(hi[2 * p + 1], j, mg, sh));
      }
      *reinterpret_cast<uint4*>(bt + sw128(n, rg)) =
          make_uint4(ol[0], ol[1], ol[2], ol[3]);
      *reinterpret_cast<uint4*>(bt + sw128(n, 4 + rg)) =
          make_uint4(oh[0], oh[1], oh[2], oh[3]);
    }
  }
};

// Q4_0 stage st: plane rows 32 st + r, the 64 elements from 64 st in x's
// own order: rows 0-15's low nibbles at k-values 0-15 and their high ones
// at 16-31, rows 16-31's at 32-47 and 48-63; d rows 2 st and 2 st + 1. A
// half stage (K % 64 == 32) zero-fills its rows 16-31, its second d row
// and x past K
struct TileQ40 : TileBase {
  static constexpr int D_OFF = CODE_BYTES;                    // d [2][128]
  static constexpr int RAW_BYTES = D_OFF + 2 * tile::BN * 2;  // f16

  __device__ static const void* a_chunk(const Args& a, int row, int st,
                                        int c, int& bytes) {
    const int k = 64 * st + 8 * c;
    const bool in = row < a.T && k < a.K;
    bytes = in ? 16 : 0;
    return a.x + (in ? (size_t)row * a.K + k : 0);
  }

  template <bool HALF>
  __device__ static void fill(const Args& a, uint8_t* raw, int st, int n0,
                              int pt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // 32 rows x 8 chunks (i = 0: rows 0-15)
      const int id = pt + tile::PRODUCERS * i, r = id >> 3, c = id & 7;
      copy_u8(raw + r * tile::BN + 16 * c, a.p.q, 32 * st + r, n0 + 16 * c,
              a.N, a.vec, !HALF || i == 0);
    }
    if (pt < 32) {  // d rows 2 st and 2 st + 1: 2 x 16 chunks of 8
      const int rr = pt >> 4, c = pt & 15;
      copy_u16(raw + D_OFF + 2 * tile::BN * rr + 16 * c, a.p.d, 2 * st + rr,
               n0 + 8 * c, a.N, a.vec, !HALF || rr == 0);
    }
  }

  __device__ static void issue_raw(const Args& a, uint8_t* raw, int st,
                                   int n0, int pt) {
    if (64 * st + 64 <= a.K)
      fill<false>(a, raw, st, n0, pt);
    else
      fill<true>(a, raw, st, n0, pt);
  }

  // item pt: plane rows [8 rg, 8 rg + 8) x 4 columns from 4 cgp (d row
  // rg / 2), their low nibbles to chunk (rg % 2) + 4 (rg / 2) of the B
  // row and their high ones two chunks on; column j is taken at step
  // q = j - rot, as in TileQ45K
  __device__ static void transform(const Args& a, const uint8_t* raw,
                                   uint8_t* bt, int, int pt) {
    const uint32_t mg = a.p.magic;
    const int cgp = pt & 31, rg = pt >> 5, rot = (cgp >> 1) & 3;
    const int cl = (rg & 1) + 4 * (rg >> 1);
    uint32_t lo[8], hi[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t w = *reinterpret_cast<const uint32_t*>(
          raw + (8 * rg + i) * tile::BN + 4 * cgp);
      lo[i] = w & NIB;
      hi[i] = (w >> 4) & NIB;
    }
    const uint16_t* dd =
        reinterpret_cast<const uint16_t*>(raw + D_OFF) + tile::BN * (rg >> 1);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = (q + rot) & 3, n = 4 * cgp + j;
      const float d = f16f(dd[n]);
      uint32_t ol[4], oh[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        ol[p] = bf16x2(q40_w(lo[2 * p], j, mg, d),
                       q40_w(lo[2 * p + 1], j, mg, d));
        oh[p] = bf16x2(q40_w(hi[2 * p], j, mg, d),
                       q40_w(hi[2 * p + 1], j, mg, d));
      }
      *reinterpret_cast<uint4*>(bt + sw128(n, cl)) =
          make_uint4(ol[0], ol[1], ol[2], ol[3]);
      *reinterpret_cast<uint4*>(bt + sw128(n, cl + 2)) =
          make_uint4(oh[0], oh[1], oh[2], oh[3]);
    }
  }
};

template <class F, class TF>
int run(const void* x, const void* q, const void* qh, const void* sc_lo,
        const void* sc_hi, const void* mn_lo, const void* mn_hi,
        const void* d, const void* dmin, void* y, int T, int K, int N,
        int path, int nsplit, int split_k, int bm, int vec, int magic,
        const void* sel, const long long* strides, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || N < 1 || K < F::K_UNIT || K % F::K_UNIT != 0 ||
      nsplit < 1 || nsplit > SK_MAX_CLUSTER ||
      (long long)nsplit * split_k < K ||
      (long long)(nsplit - 1) * split_k >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides ps{};
  if (sel != nullptr) {
    if (path != 0 || T > 8 || strides == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    ps = Strides{strides[0], strides[1], strides[2], strides[3],
                 strides[4], strides[5], strides[6], strides[7]};
    for (int i = 0; i < 8; ++i)
      if (strides[i] < 0 || (vec && strides[i] % 16 != 0))
        return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes p;
  p.q = static_cast<const uint8_t*>(q);
  p.qh = static_cast<const uint8_t*>(qh);
  p.sc_lo = static_cast<const uint8_t*>(sc_lo);
  p.sc_hi = static_cast<const uint8_t*>(sc_hi);
  p.mn_lo = static_cast<const uint8_t*>(mn_lo);
  p.mn_hi = static_cast<const uint8_t*>(mn_hi);
  p.d = static_cast<const uint16_t*>(d);
  p.dmin = static_cast<const uint16_t*>(dmin);
  p.magic = static_cast<uint32_t>(magic);
  if (p.magic != 0x4B000000u) return static_cast<int>(cudaErrorInvalidValue);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  float* out = static_cast<float*>(y);
  if (path == 0) {
    if (T > 32 || split_k % F::STEP != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    if (sel != nullptr)
      return launch_skinny<F, 1, true>(xb, p, out, T, K, N, nsplit, split_k,
                                       vec, st, static_cast<const int*>(sel),
                                       ps);
    if (T <= 8)
      return launch_skinny<F, 1>(xb, p, out, T, K, N, nsplit, split_k, vec,
                                 st);
    if (T <= 16)
      return launch_skinny<F, 2>(xb, p, out, T, K, N, nsplit, split_k, vec,
                                 st);
    return launch_skinny<F, 4>(xb, p, out, T, K, N, nsplit, split_k, vec,
                               st);
  }
  if (split_k % 64 != 0) return static_cast<int>(cudaErrorInvalidValue);
  typename TF::Args a;
  a.x = xb;
  a.p = p;
  a.y = out;
  a.T = T, a.K = K, a.N = N, a.vec = vec;
  if (bm == 256)
    return tile::launch<TF, 2>(a, T, N, nsplit, split_k / 64, false, st);
  if (bm == 128)
    return tile::launch<TF, 1>(a, T, N, nsplit, split_k / 64, false, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// y [T,N] f32 = x [T,K] bf16 @ dequant(planes). Plane pointers a format
// does not have are null (Q4_0: all but q and d; Q4_K: qh; Q6_K: mn_lo,
// mn_hi, dmin). x contiguous and 16-byte aligned, K % 256 == 0 (Q4_0:
// K % 32 == 0). path 0: the skinny kernel (T <= 32) on nsplit (1-8)
// clusters of split_k elements (a multiple of 64: whole steps, nsplit =
// ceil(K / split_k)); path 1: the wgmma tile with bm (256 or 128) rows,
// its K split likewise (split_k a multiple of 64). vec:
// 1 when N % 16 == 0 and every plane is 16-byte aligned (cp.async copies).
// magic: 0x4B000000 (Planes::magic). sel: null, or (path 0, T <= 8) a
// device int32 index into stacked [M, rows, N] planes that start at the
// given pointers, matrix m of each plane `strides[i]` m bytes on (a host
// array of 8 in the pointers' order, 0 for a null plane; with vec, each a
// multiple of 16).
#define KQUANT_ENTRY(fn, F, TF)                                               \
  extern "C" int fn(const void* x, const void* q, const void* qh,             \
                    const void* sc_lo, const void* sc_hi, const void* mn_lo,  \
                    const void* mn_hi, const void* d, const void* dmin,       \
                    void* y, int T, int K, int N, int path, int nsplit,       \
                    int split_k, int bm, int vec, int magic, const void* sel, \
                    const long long* strides, void* stream) {                 \
    return run<F, TF>(x, q, qh, sc_lo, sc_hi, mn_lo, mn_hi, d, dmin, y, T, K, \
                      N, path, nsplit, split_k, bm, vec, magic, sel, strides, \
                      stream);                                                \
  }
