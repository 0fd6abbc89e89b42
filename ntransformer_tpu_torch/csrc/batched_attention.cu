// Batched flash decode / verify attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/batched_attention.py::
// _impl / _kernel (entries flash_decode_batched and flash_verify_batched; the
// serving path's attention in models/batched.py) in all five of its cache-dot
// forms (`dot_impl`): "f32", "int8", "int8_s", "int8_v" and "bf16".
//
// What it computes. For every sequence b and kv head h, R = group * T query
// rows (row r belongs to window token t = r / group, at position pos + t)
// attend the cache keys of layer `layer` of a [L?, B, Hkv, S, D] cache plus T
// new k/v rows that are not written yet (the "virtual block"). An active
// slot sees cache keys [0, pos - 1] and virtual row i from window token i on;
// an inactive slot sees the frozen cache keys [0, pos + t] and no virtual
// row. A window keeps keys in (pos + t - window, pos + t]. The cache is bf16,
// or int8 codes with S-minor f32 scales [L?, B, Hkv, S]: the scales fold
// into the score columns (k) and the probability columns (v), which is exact
// because they are per (head, position), so no dequantized cache is written.
// Scores are scaled, then scale-folded, then soft-capped, as in the TPU
// kernel. The virtual block is always f32.
//
// The cache dots, as the TPU kernel defines them (_kernel, the int8 forms
// act on an int8 cache only):
//   f32     q and the cache values as f32.
//   int8_s  the score dot on the int8 codes: q is quantized per row
//           (qm = max|q| + 1e-30, round(q * (127 / qm)), half to even), the
//           int8 x int8 dot is exact in int32 (dp4a), then scaled by
//           qm * (scale / 127) and the key scale.
//   int8_v  the value dot on the int8 codes: p * vs is quantized per row
//           over one block of keys at that block's max (pm), the int32 dot
//           is scaled by pm / 127; the denominator keeps the exact f32 p.
//   int8    both.
//   bf16    q rounded to bf16 for the score dot, p (after the v-scale fold)
//           rounded to bf16 for the value dot, both summed in f32.
// "int8_v", "int8" and "bf16" round p relative to the running max of a block
// of block_s keys, so they depend on the TPU kernel's blocking: block_s is
// its _pick_block_s of the 128-rounded s_live (the wrapper computes it).
// They run the `group` kernel, whose blocks are exactly those key blocks;
// "f32" and "int8_s" do not depend on it and run the freely split kernel.
//
// What bounds it on the H100. The bytes: every live K and V row (and its
// scales) is read once; q, the new rows and the output are small. Decode
// (R = 4) does about 8 operations per cache byte, under the CUDA cores' 20
// (67 TFLOP/s over 3.35 TB/s): bytes set the time. A verify window of 16 or
// 32 rows does 32-64, and the f32 operations set it.
//
// The split kernel ("f32", "int8_s"). The live keys of each (sequence,
// head) are split over `nsplit` blocks, a count the wrapper takes from the
// shapes alone (never from s_live, so an s_live bucket changes no bit): a
// block an SM (B = 1 has Hkv = 8 (sequence, head) pairs for 132 SMs; at B =
// 32 one block a pair walks longest and measured fastest). A block walks its
// share in tiles of 128 keys through a two-stage cp.async ring of the raw
// cache rows (codes or bf16, with the codes' scales, and the virtual rows
// with the first tile), so one tile is in flight while the last is computed
// and no thread holds a byte in flight; values are converted to f32 in
// registers where they are used (int8 codes exactly, through the f32 2^23:
// one byte permute and one subtraction a value), never expanded in shared
// memory. One key a thread for the score dot (dp4a on the raw codes for
// "int8_s"), 8 query rows at a time into shared memory, the rows instanced
// at 4, 8 and 32. Warp w owns keys [32 w, 32 w + 32) of every tile and
// keeps its own online softmax over them, a row at a time (row r's running
// max and denominator in lane r, so any S works with no score kept), and
// its own value sums, a lane D / 32 columns, with p * vs broadcast from
// shared memory. After the walk the four warps are added in warp order,
// each scaled to the block's row max. Where the splits of a (sequence, head)
// fit one thread-block cluster (8 or fewer), every rank takes a share of the
// output and adds the splits in rank order through distributed shared
// memory, folds in the virtual rows and normalises: one launch a call.
// Otherwise each block writes its unnormalised partial (m, l, acc) and the
// combine pass merges them in split order: two launches. Every order is
// fixed, so runs repeat bit for bit.
//
// The group kernel (the per-block forms). Its clusters follow the key
// blocks of the TPU kernel: one cluster of csize blocks (csize <= 8) per
// (key block, head, sequence), each block a contiguous slice of the key
// block's live keys, so a (sequence, head) whose keys fit one key block
// (s_live <= 2048 at int8, Hkv 8, D 128: the 8B serving case) still fills
// the card (the wrapper sizes csize to cover the SMs twice). A block reads
// its K slice ONCE, through a cp.async ring of 128-key tiles, one key a
// thread, and keeps every f32 score of the slice in shared memory (masked
// keys as -inf). Then, from the kept scores:
//   1. the row max: the slice's, exchanged over the cluster through
//      distributed shared memory (exact, so any order); past the first key
//      block it is the prefix max of the per-block maxima that a max pass
//      wrote first (see below), which is the TPU kernel's running max;
//   2. p = exp(s - m), the slice's part of the f32 denominator, and the row
//      max of p * vs, exchanged over the cluster (exact), so p and its int8
//      codes are the TPU kernel's, relative to the block's running max;
//   3. the int8 codes of p * vs (int8, int8_v) or p * vs rounded to bf16
//      (bf16);
//   4. the value dot over the V slice, read ONCE through the same ring (its
//      first tiles load during steps 1-3): int8 as dp4a over four keys, V's
//      4 x 4 bytes of four keys and four columns transposed in registers by
//      byte permutes; bf16 as f32 FMAs over four columns a lane (bytes, not
//      operations, bound the step). The warps' int32 sums are added in a
//      fixed order, then rank 0 adds the cluster's in rank order (exact) and
//      the denominator parts in rank order (the one f32 sum whose order
//      differs from the TPU kernel's), and writes the block's partial.
// Past the first key block (nsplit > 1) a max pass runs first: the same
// kernel through step 1 over K, writing each key block's row max; the main
// pass takes the prefix max over blocks 0..g. K is read twice in all and V
// once: at s_live 2176 (17 blocks of 128 keys) 17 + 17 K block reads, where
// the old walk from the sequence's first live key read 153 (1 + 2 + ... +
// 17) for the row max alone. A call then runs three launches (max, main,
// combine); the wrapper's counters count them.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <type_traits>
#include <utility>

namespace {

constexpr int NT = 128;    // threads per block (4 warps)
constexpr int RMAX = 32;   // query rows per (sequence, kv head): group * T
constexpr int TMAX = 8;    // new (virtual) rows per sequence
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

// dot_impl codes, as the wrapper passes them
enum : int { DOT_F32 = 0, DOT_BF16 = 1, DOT_INT8 = 2, DOT_INT8_S = 3,
             DOT_INT8_V = 4 };
// the forms of the score dot and of the value dot
enum : int { SC_F32 = 0, SC_BF16 = 1, SC_I8 = 2 };
enum : int { PV_F32 = 0, PV_BF16 = 1, PV_I8 = 2 };

struct Params {
  const float* q;     // [B, Hkv, R, D] f32
  const void* k;      // cache [L?, B, Hkv, S, D]: bf16, or int8 codes
  const void* v;
  const float* ks;    // [L?, B, Hkv, S] f32 scales (int8 cache)
  const float* vs;
  const void* kn;     // [B, Hkv, T, D] new rows, the cache's dtype
  const void* vn;
  const float* kns;   // [B, Hkv, T] new rows' scales (int8 cache)
  const float* vns;
  const int* pos;     // [B] window base: cache keys [0, pos - 1] are live
  const int* active;  // [B]
  float* part_acc;    // [B, Hkv, nsplit, R, D]
  float* part_m;      // [B, Hkv, nsplit, R]
  float* part_l;      // [B, Hkv, nsplit, R]
  float* part_max;    // [B, Hkv, nsplit, R] per-block row max (group forms)
  float* out;         // [B, Hkv, R, D]
  int B, Hkv, S, R, T, group, layer, s_live, window, nsplit, block_s;
  int csize;          // blocks a cluster (split forms: 0, no cluster)
  int slice_cap;      // the group kernel's slice capacity
  float scale, softcap;
  float qscale;       // f32(scale / 127): the int8 score dot's fix-up
  float inv127;       // f32(1 / 127): the int8 value dot's fix-up
  uint32_t magic;     // 0x4B000000, the f32 2^23 (a run-time value keeps
                      // the byte permutes' selectors immediate)
};

template <typename Tc>
struct Chunk;  // 16 bytes of cache values, as floats

template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void load(float* f,
                                              const __nv_bfloat16* src) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
  __device__ __forceinline__ static float one(const __nv_bfloat16* src,
                                              int i) {
    return __bfloat162float(src[i]);
  }
};

template <>
struct Chunk<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void load(float* f, const int8_t* src) {
    const int4 u = *reinterpret_cast<const int4*>(src);
    const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
    for (int i = 0; i < 16; ++i) f[i] = static_cast<float>(c[i]);
  }
  __device__ __forceinline__ static float one(const int8_t* src, int i) {
    return static_cast<float>(src[i]);
  }
};

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float cap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s * (1.0f / softcap)) : s;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Is cache key kp (in_tile: within the walked range) seen from row r?
__device__ __forceinline__ bool visible(const Params& p, int r, int kp,
                                        bool in_tile, int pos, bool act) {
  const int qpos = pos + r / p.group;
  return in_tile && (act ? kp <= pos - 1 : kp <= qpos) &&
         kp > qpos - p.window;
}

// ------------------------------------------------------------ group kernel
// Pass 1 of "int8", "int8_v" and "bf16": the cluster (g, h, b) of csize
// blocks takes key block g of the TPU kernel ([g * block_s, (g + 1) *
// block_s), live keys only), each block a contiguous slice of it, and its
// rank-0 block writes the block's unnormalised partial. With MAXPASS it only
// writes the block's row max (part_max), which the main pass of every later
// block reads.
constexpr int G_TK = 128;  // keys per ring tile: one per thread
constexpr int G_SMALL = 14 * RMAX;  // floats of per-row scratch

__host__ __device__ constexpr int align16(int x) { return (x + 15) & ~15; }

// the group kernel's shared memory, in bytes: q (f32 [RB][D] and int8
// [RB][D]), the ring of K or V tiles (NST x [G_TK][D * esz + 16]), the
// slice's scores (f32 [RB][slice_cap], then p), its int8 codes of p
// ([RB][slice_cap]) and the per-row scratch
struct GSmem {
  int q8, ring, sc, c8, small, bytes;
  __host__ __device__ GSmem(int rb, int d, int esz, int slice_cap) {
    const int nst = esz == 1 ? 3 : 2;
    q8 = rb * d * 4;
    ring = align16(q8 + rb * d);
    sc = ring + nst * G_TK * (d * esz + 16);
    c8 = sc + rb * slice_cap * 4;
    small = align16(c8 + rb * slice_cap);
    bytes = small + G_SMALL * 4;
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// the 4 x 4 byte transpose: w[i] holds columns c..c+3 of key i; col[c]
// gets keys 0..3 of column c (byte i = key i), for dp4a over four keys
__device__ __forceinline__ void transpose4(const uint32_t (&w)[4],
                                           uint32_t (&col)[4]) {
  const uint32_t x0 = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t x1 = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t y0 = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t y1 = __byte_perm(w[2], w[3], 0x7362);
  col[0] = __byte_perm(x0, x1, 0x5410);
  col[1] = __byte_perm(x0, x1, 0x7632);
  col[2] = __byte_perm(y0, y1, 0x5410);
  col[3] = __byte_perm(y0, y1, 0x7632);
}

// four cache values of one row as floats (int8 codes or bf16)
__device__ __forceinline__ void four(float (&f)[4], const int8_t* src) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(u >> (8 * i)));
}

__device__ __forceinline__ void four(float (&f)[4], const __nv_bfloat16* src) {
  const uint2 u = *reinterpret_cast<const uint2*>(src);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 c = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  f[0] = a.x;
  f[1] = a.y;
  f[2] = c.x;
  f[3] = c.y;
}

template <int D, typename Tc, int SC, int PV, int RB, bool MAXPASS>
__global__ void __launch_bounds__(NT) group_kernel(const Params p) {
  namespace cg = cooperative_groups;
  constexpr bool QUANT = sizeof(Tc) == 1;
  constexpr int ESZ = sizeof(Tc);
  constexpr int ROW = D * ESZ + 16;  // ring row stride: conflict-free int4s
  constexpr int NST = QUANT ? 3 : 2;
  constexpr int CPR = D * ESZ / 16;  // 16-byte chunks per cache row
  constexpr int CN = Chunk<Tc>::N;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) uint8_t gsm[];
  const int R = p.R, cap_k = p.slice_cap;
  const GSmem L(RB, D, ESZ, cap_k);
  float* Qs = reinterpret_cast<float*>(gsm);
  int8_t* Q8 = reinterpret_cast<int8_t*>(gsm + L.q8);
  uint8_t* ring = gsm + L.ring;
  float* Sc = reinterpret_cast<float*>(gsm + L.sc);
  int8_t* C8 = reinterpret_cast<int8_t*>(gsm + L.c8);
  float* wred = reinterpret_cast<float*>(gsm + L.small);  // [4][RMAX]
  float* wred2 = wred + 4 * RMAX;                          // [4][RMAX]
  float* xmax = wred2 + 4 * RMAX;  // this block's row max (cluster-read)
  float* xpm = xmax + RMAX;        // its row max of p * vs (cluster-read)
  float* xl = xpm + RMAX;          // its part of the denominator
  float* mrow = xl + RMAX;         // the running row max at block g
  float* pmr = mrow + RMAX;        // pm of the int8 value dot
  float* qms = pmr + RMAX;         // qm * scale / 127 (int8 score dot)

  const int csz = p.csize;
  const int rank = blockIdx.x % csz, grp = blockIdx.x / csz;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * p.Hkv + h;
  const size_t row0 = (((size_t)p.layer * p.B + b) * p.Hkv + h) * p.S;
  const Tc* kb = static_cast<const Tc*>(p.k) + row0 * D;
  const Tc* vb = static_cast<const Tc*>(p.v) + row0 * D;

  // q: f32 (rounded to bf16 for the bf16 score dot), and per-row int8
  // codes for the int8 score dot
  for (int i = tid; i < R * D / 4; i += NT) {
    float4 x = reinterpret_cast<const float4*>(p.q + bh * R * D)[i];
    if constexpr (SC == SC_BF16) {
      x.x = bf16_round(x.x);
      x.y = bf16_round(x.y);
      x.z = bf16_round(x.z);
      x.w = bf16_round(x.w);
    }
    reinterpret_cast<float4*>(Qs)[i] = x;
  }
  if constexpr (SC == SC_I8) {
    __syncthreads();
    for (int r = warp; r < R; r += 4) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(Qs[r * D + d]));
      const float qm = warp_max(a) + 1e-30f;
      const float inv = 127.0f / qm;
      for (int d = lane; d < D; d += 32)
        Q8[r * D + d] = static_cast<int8_t>(rintf(Qs[r * D + d] * inv));
      if (lane == 0) qms[r] = qm * p.qscale;
    }
  }
  __syncthreads();

  // the TPU kernel visits key block g of sequence b iff it meets the live
  // range; inside it the position mask does the rest. This block takes the
  // slice [lo, hi) of the block's live keys [k0, k1).
  const int pos = p.pos[b];
  const bool act = p.active[b] != 0;
  const int last = act ? pos - 1 : pos + p.T - 1;
  const int g0 = grp * p.block_s, g1 = g0 + p.block_s - 1;
  const bool runs = g0 <= last && g1 >= pos - p.window + 1;
  const int k0 = max(g0, max(pos - p.window + 1, 0));
  const int k1 =
      runs ? min(min(g1, last), min(p.S, p.s_live) - 1) + 1 : k0;
  const int slice = (max(k1 - k0, 0) + csz - 1) / csz;
  const int lo = min(k0 + rank * slice, max(k1, k0));
  const int nk = max(0, min(k1, lo + slice) - lo);
  const int ntile = (nk + G_TK - 1) / G_TK;

  // tile t of the slice (cache rows of base) into ring slot t % NST; rows
  // past the slice read as zeros
  auto fetch = [&](const Tc* base, int t) {
    if (t < ntile) {
      const int key0 = lo + t * G_TK, cnt = min(G_TK, nk - t * G_TK);
      uint8_t* dst = ring + (t % NST) * G_TK * ROW;
      for (int c = tid; c < G_TK * CPR; c += NT) {
        const int j = c / CPR, cc = c % CPR;
        const bool in = j < cnt;
        const uint8_t* src = reinterpret_cast<const uint8_t*>(
                                 base + (size_t)(in ? key0 + j : lo) * D) +
                             16 * cc;
        cp_async16(dst + j * ROW + 16 * cc, src, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  // ---- one walk over K: every score of the slice, kept in Sc (masked
  // keys as -inf), and this thread's row maxima
  float mx[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) mx[r] = NEG_INF;
#pragma unroll
  for (int t = 0; t < NST - 1; ++t) fetch(kb, t);
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();  // tile t landed; slot (t - 1) % NST is free
    fetch(kb, t + NST - 1);
    const int j = t * G_TK + tid;
    if (j >= nk) continue;
    const int key = lo + j;
    const uint8_t* krow = ring + (t % NST) * G_TK * ROW + tid * ROW;
    float s[RB];
    if constexpr (SC == SC_I8) {
      int si[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) si[r] = 0;
#pragma unroll 2
      for (int d = 0; d < D; d += 16) {
        const int4 k4 = *reinterpret_cast<const int4*>(krow + d);
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) {
            const int4 q4 = *reinterpret_cast<const int4*>(Q8 + r * D + d);
            si[r] = __dp4a(q4.x, k4.x, si[r]);
            si[r] = __dp4a(q4.y, k4.y, si[r]);
            si[r] = __dp4a(q4.z, k4.z, si[r]);
            si[r] = __dp4a(q4.w, k4.w, si[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r)
        s[r] = r < R ? static_cast<float>(si[r]) * qms[r] : 0.f;
    } else {
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] = 0.f;
#pragma unroll 2
      for (int c = 0; c < CPR; ++c) {
        float f[CN];
        Chunk<Tc>::load(f, reinterpret_cast<const Tc*>(krow) + c * CN);
#pragma unroll
        for (int e = 0; e < CN; e += 4) {
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (r < R) {
              const float4 qv =
                  *reinterpret_cast<const float4*>(&Qs[r * D + c * CN + e]);
              s[r] = fmaf(qv.x, f[e], s[r]);
              s[r] = fmaf(qv.y, f[e + 1], s[r]);
              s[r] = fmaf(qv.z, f[e + 2], s[r]);
              s[r] = fmaf(qv.w, f[e + 3], s[r]);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) s[r] *= p.scale;
    }
    const float ksc = QUANT ? p.ks[row0 + key] : 1.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= R) break;
      float sc = s[r];
      if (QUANT) sc *= ksc;
      sc = cap(sc, p.softcap);
      const bool vis = visible(p, r, key, true, pos, act);
      Sc[r * cap_k + j] = vis ? sc : -INFINITY;
      if (vis) mx[r] = fmaxf(mx[r], sc);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free; every score is in Sc
  if constexpr (!MAXPASS) {
    // V's first tiles load while the softmax runs
#pragma unroll
    for (int t = 0; t < NST - 1; ++t) fetch(vb, t);
  }

  // ---- the row max: this block's, then the cluster's (exact), or, past
  // the first key block, the prefix max of the per-block maxima
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= R) break;
    const float v = warp_max(mx[r]);
    if (lane == 0) wred[warp * RMAX + r] = v;
  }
  __syncthreads();
  if (tid < R)
    xmax[tid] = fmaxf(fmaxf(wred[tid], wred[RMAX + tid]),
                      fmaxf(wred[2 * RMAX + tid], wred[3 * RMAX + tid]));
  cluster.sync();  // every block's xmax is written
  if (tid < R) {
    float m = NEG_INF;
    if (MAXPASS || p.nsplit == 1) {
      for (int q = 0; q < csz; ++q)
        m = fmaxf(m, cluster.map_shared_rank(xmax, q)[tid]);
    } else {
      const float* bm = p.part_max + bh * p.nsplit * R + tid;
      for (int g = 0; g <= grp; ++g) m = fmaxf(m, bm[(size_t)g * R]);
    }
    mrow[tid] = runs ? m : NEG_INF;
  }
  if constexpr (MAXPASS) {
    if (rank == 0 && tid < R)
      p.part_max[(bh * p.nsplit + grp) * R + tid] = mrow[tid];
    cluster.sync();  // no block leaves while another reads its xmax
    return;
  }
  __syncthreads();

  // ---- p against the running max; the denominator's part (exact f32 p)
  // and the row max of p * vs; p * vs (or p) kept in Sc; past the slice 0
  const int span = ntile * G_TK;
  float lp[RB], pmp[RB];
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    lp[r] = 0.f;
    pmp[r] = 0.f;
  }
  for (int j = tid; j < span; j += NT) {
    const bool in = j < nk;
    const float vsc = QUANT && in ? p.vs[row0 + lo + j] : 1.f;
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r >= R) break;
      const float pr = in ? expf(Sc[r * cap_k + j] - mrow[r]) : 0.f;
      lp[r] += pr;
      const float pv = QUANT ? pr * vsc : pr;
      if constexpr (PV == PV_I8) {
        pmp[r] = fmaxf(pmp[r], pv);
        Sc[r * cap_k + j] = pv;
      } else {
        Sc[r * cap_k + j] = bf16_round(pv);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    if (r >= R) break;
    const float a = warp_sum(lp[r]);
    const float c = warp_max(pmp[r]);
    if (lane == 0) {
      wred[warp * RMAX + r] = a;
      wred2[warp * RMAX + r] = c;
    }
  }
  __syncthreads();
  if (tid < R) {
    xl[tid] = ((wred[tid] + wred[RMAX + tid]) + wred[2 * RMAX + tid]) +
              wred[3 * RMAX + tid];
    xpm[tid] = fmaxf(fmaxf(wred2[tid], wred2[RMAX + tid]),
                     fmaxf(wred2[2 * RMAX + tid], wred2[3 * RMAX + tid]));
  }
  if constexpr (PV == PV_I8) {
    // pm over the whole key block (exact across the cluster), then the
    // int8 codes of p * vs
    cluster.sync();
    if (tid < R) {
      float pm = 0.f;
      for (int q = 0; q < csz; ++q)
        pm = fmaxf(pm, cluster.map_shared_rank(xpm, q)[tid]);
      pmr[tid] = pm + 1e-30f;
    }
    __syncthreads();
    for (int j = tid; j < span; j += NT) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= R) break;
        const float inv_q = 127.0f / pmr[r];
        C8[r * cap_k + j] =
            static_cast<int8_t>(rintf(Sc[r * cap_k + j] * inv_q));
      }
    }
  }
  __syncthreads();

  // ---- one walk over V: the value dot. Warp (rg, kp) takes rows
  // [8 rg, 8 rg + 8) and the kp-th part of each tile's keys; a lane takes 4
  // columns and every (32 / (D / 4))-th group of 4 keys. int8: dp4a over
  // four keys (V's 4 x 4 bytes transposed in registers); bf16: f32 FMAs of
  // the bf16-rounded p.
  constexpr int LPR = D / 4;         // lanes per key row
  constexpr int KLG = 32 / LPR;      // key groups a warp runs side by side
  constexpr int RG = RB < 8 ? RB : 8;
  constexpr int NRG = RB / RG;       // 1, 1, 4
  constexpr int KP = 4 / NRG;        // 4, 4, 1
  using Acc = typename std::conditional<PV == PV_I8, int, float>::type;
  const int rg = warp / KP, kp = warp % KP;
  const int col0 = 4 * (lane % LPR), ksub = lane / LPR;
  Acc acc[RG][4];
#pragma unroll
  for (int r = 0; r < RG; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0;
  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<NST - 2>();
    __syncthreads();
    fetch(vb, t + NST - 1);
    const uint8_t* vt = ring + (t % NST) * G_TK * ROW;
    for (int k4 = 4 * (kp * KLG + ksub); k4 < G_TK; k4 += 4 * KP * KLG) {
      const int j = t * G_TK + k4;
      if (j >= nk) break;
      if constexpr (PV == PV_I8) {
        uint32_t w[4], col[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          w[i] = *reinterpret_cast<const uint32_t*>(vt + (k4 + i) * ROW +
                                                    col0);
        transpose4(w, col);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const int rr = rg * RG + r;
          if (rr >= R) break;
          const int cw = *reinterpret_cast<const int*>(C8 + rr * cap_k + j);
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[r][c] = __dp4a(static_cast<int>(col[c]), cw, acc[r][c]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float f[4];
          four(f, reinterpret_cast<const Tc*>(vt + (k4 + i) * ROW) + col0);
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            const int rr = rg * RG + r;
            if (rr >= R) break;
            const float pv = Sc[rr * cap_k + j + i];
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(pv, f[c], acc[r][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: it takes the per-warp sums

  // ---- sums in a fixed order: the key parts of this block, then (rank 0)
  // the blocks of the cluster in rank order. int32 sums are exact.
  constexpr int PARTS = KP * KLG;
  Acc* red = reinterpret_cast<Acc*>(ring);  // [PARTS][RB][D]
#pragma unroll
  for (int r = 0; r < RG; ++r) {
    const int rr = rg * RG + r;
    if (rr >= R) break;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      red[((kp * KLG + ksub) * RB + rr) * D + col0 + c] = acc[r][c];
  }
  __syncthreads();
  for (int i = tid; i < R * D; i += NT) {
    const int rr = i / D, c = i % D;
    Acc a = red[rr * D + c];
#pragma unroll
    for (int q = 1; q < PARTS; ++q) a += red[(q * RB + rr) * D + c];
    red[rr * D + c] = a;  // part 0 holds the block's sum
  }
  cluster.sync();  // every block's sums and xl are final
  if (rank == 0) {
    const size_t pb = (bh * p.nsplit + grp) * R;
    for (int i = tid; i < R * D; i += NT) {
      const int rr = i / D;
      Acc a = red[i];
      for (int q = 1; q < csz; ++q) a += cluster.map_shared_rank(red, q)[i];
      float o;
      if constexpr (PV == PV_I8)
        o = static_cast<float>(a) * (pmr[rr] * p.inv127);
      else
        o = a;
      p.part_acc[(pb + rr) * D + i % D] = o;
    }
    if (tid < R) {
      float l = xl[tid];
      for (int q = 1; q < csz; ++q) l += cluster.map_shared_rank(xl, q)[tid];
      p.part_m[pb + tid] = mrow[tid];
      p.part_l[pb + tid] = l;
    }
  }
  cluster.sync();  // no block leaves while rank 0 reads its shared memory
}

// ------------------------------------------------------------ virtual rows
// The T new rows of (b, h) into shared memory as the cache stores them, KN
// and VN [T][D], and their scales Kns and Vns [T] (int8 cache). The caller
// syncs.
template <int D, typename Tc>
__device__ __forceinline__ void load_virtual(const Params& p, size_t bh,
                                             Tc* KN, Tc* VN, float* Kns,
                                             float* Vns, int tid) {
  const int T = p.T;
  const Tc* kn = static_cast<const Tc*>(p.kn) + bh * T * D;
  const Tc* vn = static_cast<const Tc*>(p.vn) + bh * T * D;
  for (int i = tid; i < T * D; i += NT) {
    KN[i] = kn[i];
    VN[i] = vn[i];
  }
  if (sizeof(Tc) == 1 && tid < T) {
    Kns[tid] = p.kns[bh * T + tid];
    Vns[tid] = p.vns[bh * T + tid];
  }
}

// Sv[r][i]: row r's score of virtual row i, scaled, scale-folded and
// capped, from q (f32 [R][D]): warp w takes the pairs w, w + 4, ..., its
// lanes split D. The caller syncs.
template <int D, typename Tc>
__device__ __forceinline__ void virtual_scores(const Params& p,
                                               const float* Qs, const Tc* KN,
                                               const float* Kns, float* Sv,
                                               int lane, int warp) {
  const int T = p.T;
  for (int c = warp; c < p.R * T; c += NT / 32) {
    const int r = c / T, i = c % T;
    float s = 0.f;
#pragma unroll
    for (int d = lane; d < D; d += 32)
      s = fmaf(Qs[r * D + d], Chunk<Tc>::one(KN, i * D + d), s);
    s = warp_sum(s) * p.scale;
    if (sizeof(Tc) == 1) s *= Kns[i];
    if (lane == 0) Sv[c] = cap(s, p.softcap);
  }
}

// Row r's virtual rows (row i sits at pos + i, seen from window token t >=
// i) against its merged cache part (m, l): alpha, the cache part's scale;
// den, the final denominator; pv[i], virtual row i's p times its v scale.
// The output at column c is then (a alpha + sum_i pv[i] VN[i][c]) / den.
__device__ __forceinline__ void virtual_row(const Params& p, bool act, int r,
                                            float m, float l,
                                            const float* Sv,
                                            const float* Vns, bool quant,
                                            float& alpha, float& den,
                                            float* pv) {
  const int T = p.T, t = r / p.group;
  float mv = m;
  for (int i = 0; i < T; ++i)
    if (act && i <= t && i > t - p.window) mv = fmaxf(mv, Sv[r * T + i]);
  alpha = expf(m - mv);
  float pl = 0.f;
  for (int i = 0; i < T; ++i) {
    float pr = 0.f;
    if (act && i <= t && i > t - p.window) {
      pr = expf(Sv[r * T + i] - mv);
      pl += pr;
      if (quant) pr *= Vns[i];
    }
    pv[i] = pr;
  }
  den = alpha * l + pl;
}

// The output of row r at column col: the merged cache part a scaled by
// alpha, the virtual rows' values added in order, normalised
template <int D, typename Tc>
__device__ __forceinline__ float finish(const Params& p, float a,
                                        float alpha, float den,
                                        const float* pv, const Tc* VN,
                                        int col) {
  float pa = 0.f;
  for (int i = 0; i < p.T; ++i)
    pa = fmaf(pv[i], Chunk<Tc>::one(VN, i * D + col), pa);
  return (a * alpha + pa) / den;
}

// ------------------------------------------------------------ split kernel
// "f32" and "int8_s": block (split, h, b) walks its share [k0, k1) of the
// live cache keys of (b, h). With csize > 0 the nsplit blocks of (b, h) are
// one cluster and rank 0 writes the output; with csize = 0 every block
// writes its unnormalised partial for the combine pass.
constexpr int S_TK = 128;  // keys per ring tile: one per thread
constexpr int S_NST = 2;   // ring stages
constexpr int S_WK = 32;   // the keys of a tile that one warp owns
constexpr int MAX_CLUSTER = 8;
constexpr float CODE_BIAS = 8388736.0f;  // 2^23 + 128

// The split kernel's shared memory, byte offsets: q (f32 [RB][D], its int8
// codes [RB][D] and qm * scale / 127 [RB]), the virtual rows as the cache
// stores them ([TMAX][D] each, with their scales [TMAX]) and their scores
// ([RB][TMAX] f32), each warp's scores, then p * vs, of its keys
// ([4][RB][S_WK] f32) and its rows' rescale of a tile ([4][RB]), each
// row's query position ([RB]), the ring
// (S_NST stages of a K tile, a V tile and, int8, their scales); after
// the walk, over the ring, the block's partial (acc [RB][D], m, l), the
// warps' (m, l), the splits' weights of each row, and each row's virtual
// fold (alpha, the final denominator, p of the virtual rows).
template <int RB, int D, int ESZ>
struct SplitSmem {
  static constexpr int ROW = D * ESZ + 16;  // ring row: conflict-free int4s
  static constexpr int KV = S_TK * ROW;     // a tile of K or of V
  static constexpr int STAGE = 2 * KV + (ESZ == 1 ? 2 * S_TK * 4 : 0);
  static constexpr int Q8 = RB * D * 4;
  static constexpr int QMS = Q8 + RB * D;
  static constexpr int KN = align16(QMS + RB * 4);
  static constexpr int VN = KN + TMAX * D * ESZ;
  static constexpr int KNS = VN + TMAX * D * ESZ;
  static constexpr int VNS = KNS + TMAX * 4;
  static constexpr int SV = VNS + TMAX * 4;
  static constexpr int PW = align16(SV + RB * TMAX * 4);
  static constexpr int AL = PW + 4 * RB * S_WK * 4;  // f32 [4][RB]
  static constexpr int QP = AL + 4 * RB * 4;  // int [RB]: each row's position
  static constexpr int RING = align16(QP + RB * 4);
  static constexpr int BUF = RING;
  static constexpr int WM = BUF + RB * D * 4;
  static constexpr int WL = WM + 4 * RB * 4;
  static constexpr int BM = WL + 4 * RB * 4;
  static constexpr int BL = BM + RB * 4;
  static constexpr int WQ = BL + RB * 4;
  static constexpr int ALPHA = WQ + MAX_CLUSTER * RB * 4;
  static constexpr int DEN = ALPHA + RB * 4;
  static constexpr int PV = DEN + RB * 4;
  static constexpr int POST = PV + RB * TMAX * 4;
  static constexpr int WALK = RING + S_NST * STAGE;
  static constexpr int BYTES = POST > WALK ? POST : WALK;
};

// 4 bytes global -> shared (a key's scale), zero-filled past src_bytes
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// int8 code i (0-3) of w as an exact f32: the code plus 128 is the low
// byte of the f32 2^23 + code + 128 (mg holds its bits 0x4B000000)
__device__ __forceinline__ float code_f32(uint32_t w_biased, int i,
                                          uint32_t mg) {
  return __uint_as_float(__byte_perm(w_biased, mg, 0x7650 | i)) - CODE_BIAS;
}

// A lane's CPL (2 or 4) cache values of one row, as f32
template <typename Tc, int CPL>
__device__ __forceinline__ void lane_vals(float (&f)[CPL],
                                          const uint8_t* src, uint32_t mg) {
  if constexpr (sizeof(Tc) == 1) {
    uint32_t w = CPL == 4 ? *reinterpret_cast<const uint32_t*>(src)
                          : *reinterpret_cast<const uint16_t*>(src);
    w ^= 0x80808080u;
#pragma unroll
    for (int i = 0; i < CPL; ++i) f[i] = code_f32(w, i, mg);
  } else if constexpr (CPL == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 c =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    f[0] = a.x;
    f[1] = a.y;
    f[2] = c.x;
    f[3] = c.y;
  } else {
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
    f[0] = a.x;
    f[1] = a.y;
  }
}

// The scores of one key (its ring row krow) for rows [0, min(RB, R)),
// scaled (the int8 dot by qm * scale / 127, the f32 one by scale); the key
// scale and the softcap are the caller's. The f32 dot adds d in order.
template <int D, typename Tc, int SC, int RB>
__device__ __forceinline__ void key_scores(float (&s)[RB],
                                           const uint8_t* krow,
                                           const float* Qs, const int8_t* Q8,
                                           const float* qms, int R,
                                           float scale, uint32_t mg) {
  if constexpr (SC == SC_I8) {
    int si[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) si[r] = 0;
#pragma unroll (RB <= 8 ? 2 : 1)
    for (int d = 0; d < D; d += 16) {
      const int4 k4 = *reinterpret_cast<const int4*>(krow + d);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < R) {
          const int4 q4 = *reinterpret_cast<const int4*>(Q8 + r * D + d);
          si[r] = __dp4a(q4.x, k4.x, si[r]);
          si[r] = __dp4a(q4.y, k4.y, si[r]);
          si[r] = __dp4a(q4.z, k4.z, si[r]);
          si[r] = __dp4a(q4.w, k4.w, si[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r)
      s[r] = r < R ? static_cast<float>(si[r]) * qms[r] : 0.f;
  } else {
    constexpr int CN = 16 / sizeof(Tc);  // values in 16 bytes
#pragma unroll
    for (int r = 0; r < RB; ++r) s[r] = 0.f;
#pragma unroll (RB <= 8 ? 2 : 1)
    for (int c = 0; c < D / CN; ++c) {
      float f[CN];
      if constexpr (sizeof(Tc) == 1) {
        const int4 u = *reinterpret_cast<const int4*>(krow + 16 * c);
        const uint32_t w[4] = {static_cast<uint32_t>(u.x) ^ 0x80808080u,
                               static_cast<uint32_t>(u.y) ^ 0x80808080u,
                               static_cast<uint32_t>(u.z) ^ 0x80808080u,
                               static_cast<uint32_t>(u.w) ^ 0x80808080u};
#pragma unroll
        for (int e = 0; e < 16; ++e) f[e] = code_f32(w[e >> 2], e & 3, mg);
      } else {
        Chunk<Tc>::load(f, reinterpret_cast<const Tc*>(krow) + c * CN);
      }
#pragma unroll
      for (int e = 0; e < CN; e += 4) {
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          if (r < R) {
            const float4 qv =
                *reinterpret_cast<const float4*>(&Qs[r * D + c * CN + e]);
            s[r] = fmaf(qv.x, f[e], s[r]);
            s[r] = fmaf(qv.y, f[e + 1], s[r]);
            s[r] = fmaf(qv.z, f[e + 2], s[r]);
            s[r] = fmaf(qv.w, f[e + 3], s[r]);
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) s[r] *= scale;
  }
}

template <int D, typename Tc, int SC, int RB>
__global__ void __launch_bounds__(NT) split_kernel(const Params p) {
  namespace cg = cooperative_groups;
  constexpr bool QUANT = sizeof(Tc) == 1;
  constexpr int ESZ = sizeof(Tc);
  using L = SplitSmem<RB, D, ESZ>;
  constexpr int ROW = L::ROW, KV = L::KV;
  constexpr int CPR = D * ESZ / 16;  // 16-byte chunks a cache row
  constexpr int CPL = D / 32;        // output columns a lane
  extern __shared__ __align__(16) uint8_t ssm[];
  float* Qs = reinterpret_cast<float*>(ssm);
  int8_t* Q8 = reinterpret_cast<int8_t*>(ssm + L::Q8);
  float* qms = reinterpret_cast<float*>(ssm + L::QMS);
  uint8_t* ring = ssm + L::RING;
  const int R = p.R;
  const uint32_t mg = p.magic;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * p.Hkv + h;
  const size_t row0 = (((size_t)p.layer * p.B + b) * p.Hkv + h) * p.S;
  const uint8_t* kb = static_cast<const uint8_t*>(p.k) + row0 * D * ESZ;
  const uint8_t* vb = static_cast<const uint8_t*>(p.v) + row0 * D * ESZ;

  // the live cache keys of (b, h), the union over the window tokens, and
  // this split's share: whole tiles but the last
  const int pos = p.pos[b];
  const bool act = p.active[b] != 0;
  int last = act ? pos - 1 : pos + p.T - 1;
  last = min(last, min(p.S, p.s_live) - 1);
  const int first = max(pos - p.window + 1, 0);
  const int n = last - first + 1;
  int chunk = n > 0 ? (n + p.nsplit - 1) / p.nsplit : 0;
  chunk = (chunk + S_TK - 1) / S_TK * S_TK;
  const int k0 = first + split * chunk;
  const int k1 = min(k0 + chunk, last + 1);
  const int ntile = k1 > k0 ? (k1 - k0 + S_TK - 1) / S_TK : 0;

  // tile t (keys k0 + 128 t ...) into ring stage t % S_NST: K and V rows,
  // zeros past k1, and (int8) each key's two scales
  auto fetch = [&](int t) {
    if (t < ntile) {
      const int kt = k0 + t * S_TK;
      uint8_t* dst = ring + (t % S_NST) * L::STAGE;
      for (int c = tid; c < S_TK * CPR; c += NT) {
        const int j = c / CPR, cc = c % CPR;
        const bool in = kt + j < k1;
        const size_t off = (size_t)(in ? kt + j : k0) * D * ESZ + 16 * cc;
        cp_async16(dst + j * ROW + 16 * cc, kb + off, in ? 16 : 0);
        cp_async16(dst + KV + j * ROW + 16 * cc, vb + off, in ? 16 : 0);
      }
      if constexpr (QUANT) {
        const bool in = kt + tid < k1;
        const size_t at = row0 + (in ? kt + tid : k0);
        cp_async4(dst + 2 * KV + 4 * tid, p.ks + at, in ? 4 : 0);
        cp_async4(dst + 2 * KV + 4 * S_TK + 4 * tid, p.vs + at, in ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // the virtual rows and their scales, with the first tile's copies
  {
    const int T = p.T;
    const uint8_t* kn = static_cast<const uint8_t*>(p.kn) + bh * T * D * ESZ;
    const uint8_t* vn = static_cast<const uint8_t*>(p.vn) + bh * T * D * ESZ;
    for (int c = tid; c < T * CPR; c += NT) {
      cp_async16(ssm + L::KN + 16 * c, kn + 16 * c, 16);
      cp_async16(ssm + L::VN + 16 * c, vn + 16 * c, 16);
    }
    if (QUANT && tid < T) {
      cp_async4(ssm + L::KNS + 4 * tid, p.kns + bh * T + tid, 4);
      cp_async4(ssm + L::VNS + 4 * tid, p.vns + bh * T + tid, 4);
    }
  }
#pragma unroll
  for (int t = 0; t < S_NST - 1; ++t) fetch(t);

  // q: f32, and per-row int8 codes for the int8 score dot; each row's
  // query position
  int* qp = reinterpret_cast<int*>(ssm + L::QP);
  if (tid < R) qp[tid] = pos + tid / p.group;
  for (int i = tid; i < R * D / 4; i += NT)
    reinterpret_cast<float4*>(Qs)[i] =
        reinterpret_cast<const float4*>(p.q + bh * R * D)[i];
  if constexpr (SC == SC_I8) {
    __syncthreads();
    for (int r = warp; r < R; r += 4) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(Qs[r * D + d]));
      const float qm = warp_max(a) + 1e-30f;
      const float inv = 127.0f / qm;
      for (int d = lane; d < D; d += 32)
        Q8[r * D + d] = static_cast<int8_t>(rintf(Qs[r * D + d] * inv));
      if (lane == 0) qms[r] = qm * p.qscale;
    }
  }

  // this warp's online softmax: lane r holds row r's running max and
  // denominator; a lane's value sums cover columns CPL lane ...
  float mreg = NEG_INF, lreg = 0.f;
  float acc[RB][CPL];
#pragma unroll
  for (int r = 0; r < RB; ++r)
#pragma unroll
    for (int c = 0; c < CPL; ++c) acc[r][c] = 0.f;
  float* pw = reinterpret_cast<float*>(ssm + L::PW) + warp * RB * S_WK;
  float* al = reinterpret_cast<float*>(ssm + L::AL) + warp * RB;

  for (int t = 0; t < ntile; ++t) {
    cp_async_wait<S_NST - 2>();
    __syncthreads();  // tile t landed; stage (t - 1) % S_NST is free
    fetch(t + S_NST - 1);
    const uint8_t* st = ring + (t % S_NST) * L::STAGE;
    const int kt = k0 + t * S_TK, wk0 = kt + S_WK * warp;
    if (wk0 >= k1) continue;  // warp-uniform: past the share
    const int key = kt + tid;
    const bool in = key < k1;
    {  // this thread's key: its scores, scaled, scale-folded and capped,
       // -inf where a row does not see it, into the warp's rows of pw; 8
       // rows at a time, so few registers hold scores beside acc
      constexpr int G = RB < 8 ? RB : 8;
      const float ksc =
          QUANT ? reinterpret_cast<const float*>(st + 2 * KV)[tid] : 1.f;
      for (int r0 = 0; r0 < R; r0 += G) {
        float s[G];
        key_scores<D, Tc, SC, G>(s, st + tid * ROW, Qs + r0 * D, Q8 + r0 * D,
                                 qms + r0, R - r0, p.scale, mg);
#pragma unroll
        for (int r = 0; r < G; ++r) {
          if (r0 + r < R) {
            float sc = s[r];
            if (QUANT) sc *= ksc;
            sc = cap(sc, p.softcap);
            const int q_at = qp[r0 + r];
            const bool vis = in && (act ? key <= pos - 1 : key <= q_at) &&
                             key > q_at - p.window;
            pw[(r0 + r) * S_WK + lane] = vis ? sc : -INFINITY;
          }
        }
      }
    }
    // the online softmax over the warp's keys, a row at a time: p, times
    // the key's v scale, back into pw, the row's rescale into al
    const float vsc =
        QUANT ? reinterpret_cast<const float*>(st + 2 * KV)[S_TK + tid] : 1.f;
#pragma unroll (RB <= 8 ? RB : 1)
    for (int r = 0; r < R; ++r) {
      const float x = pw[r * S_WK + lane];
      const float m_old = __shfl_sync(0xffffffffu, mreg, r);
      const float m_new = fmaxf(m_old, warp_max(x));
      const float alpha = expf(m_old - m_new);
      const float pr = expf(x - m_new);  // 0 where the row does not see it
      const float ls = warp_sum(pr);
      if (lane == r) {
        mreg = m_new;
        lreg = alpha * lreg + ls;
      }
      pw[r * S_WK + lane] = QUANT ? pr * vsc : pr;
      if (lane == 0) al[r] = alpha;
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      if (r < R) {
        const float a = al[r];
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[r][c] *= a;
      }
    }
    // P x V over the warp's keys, four at a time (past k1 both p and the
    // zero-filled V rows are 0), each row's four p one broadcast float4
    const int nk = min(S_WK, k1 - wk0);
    const uint8_t* vt = st + KV + S_WK * warp * ROW + lane * CPL * ESZ;
    for (int j = 0; j < nk; j += 4) {
      float v[4][CPL];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        lane_vals<Tc, CPL>(v[i], vt + (j + i) * ROW, mg);
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r < R) {
          const float4 pj = *reinterpret_cast<const float4*>(pw + r * S_WK + j);
#pragma unroll
          for (int c = 0; c < CPL; ++c) {
            acc[r][c] = fmaf(pj.x, v[0][c], acc[r][c]);
            acc[r][c] = fmaf(pj.y, v[1][c], acc[r][c]);
            acc[r][c] = fmaf(pj.z, v[2][c], acc[r][c]);
            acc[r][c] = fmaf(pj.w, v[3][c], acc[r][c]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the partials take its place

  // the block's partial: the warps in warp order, each scaled to the
  // block's row max
  float* buf = reinterpret_cast<float*>(ssm + L::BUF);
  float* wm = reinterpret_cast<float*>(ssm + L::WM);
  float* wl = reinterpret_cast<float*>(ssm + L::WL);
  float* bm = reinterpret_cast<float*>(ssm + L::BM);
  float* bl = reinterpret_cast<float*>(ssm + L::BL);
  if (lane < R) {
    wm[warp * RB + lane] = mreg;
    wl[warp * RB + lane] = lreg;
  }
  __syncthreads();
  for (int w = 0; w < 4; ++w) {
    if (warp == w) {
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= R) break;
        const float m = fmaxf(fmaxf(wm[r], wm[RB + r]),
                              fmaxf(wm[2 * RB + r], wm[3 * RB + r]));
        const float e = expf(wm[w * RB + r] - m);
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          float* o = buf + r * D + lane * CPL + c;
          const float v = acc[r][c] * e;
          *o = w == 0 ? v : *o + v;
        }
      }
    }
    __syncthreads();
  }
  if (tid < R) {
    const float m = fmaxf(fmaxf(wm[tid], wm[RB + tid]),
                          fmaxf(wm[2 * RB + tid], wm[3 * RB + tid]));
    float l = 0.f;
    for (int w = 0; w < 4; ++w)
      l += expf(wm[w * RB + tid] - m) * wl[w * RB + tid];
    bm[tid] = m;
    bl[tid] = l;
  }

  if (p.csize == 0) {  // the combine pass merges the splits
    const size_t pb = (bh * p.nsplit + split) * R;
    for (int i = tid; i < R * D; i += NT) p.part_acc[pb * D + i] = buf[i];
    if (tid < R) {
      p.part_m[pb + tid] = bm[tid];
      p.part_l[pb + tid] = bl[tid];
    }
    return;
  }
  // one cluster: the splits merged in rank order, the virtual rows folded
  // in, normalised; every rank takes a share of the output
  const Tc* KN = reinterpret_cast<const Tc*>(ssm + L::KN);
  const Tc* VN = reinterpret_cast<const Tc*>(ssm + L::VN);
  const float* Kns = reinterpret_cast<const float*>(ssm + L::KNS);
  const float* Vns = reinterpret_cast<const float*>(ssm + L::VNS);
  float* Sv = reinterpret_cast<float*>(ssm + L::SV);
  float* wq = reinterpret_cast<float*>(ssm + L::WQ);
  float* alpha = reinterpret_cast<float*>(ssm + L::ALPHA);
  float* den = reinterpret_cast<float*>(ssm + L::DEN);
  float* pv = reinterpret_cast<float*>(ssm + L::PV);
  virtual_scores<D, Tc>(p, Qs, KN, Kns, Sv, lane, warp);
  cg::cluster_group cluster = cg::this_cluster();
  const int csz = p.csize;
  cluster.sync();  // every split's partial is in its shared memory
  if (tid < R) {
    float mq[MAX_CLUSTER], lq[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q < csz) {
        mq[q] = cluster.map_shared_rank(bm, q)[tid];
        lq[q] = cluster.map_shared_rank(bl, q)[tid];
      }
    }
    float m = NEG_INF;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < csz) m = fmaxf(m, mq[q]);
    float l = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q) {
      if (q < csz) {
        const float w = expf(mq[q] - m);
        wq[q * RB + tid] = w;
        l += w * lq[q];
      }
    }
    virtual_row(p, act, tid, m, l, Sv, Vns, QUANT, alpha[tid], den[tid],
                pv + tid * TMAX);
  }
  __syncthreads();
  const int share = (R * D + csz - 1) / csz;
  const int e1 = min(R * D, (int)(cluster.block_rank() + 1) * share);
  for (int i = cluster.block_rank() * share + tid; i < e1; i += NT) {
    const int r = i / D;
    float x[MAX_CLUSTER];
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < csz) x[q] = cluster.map_shared_rank(buf, q)[i];
    float a = 0.f;
#pragma unroll
    for (int q = 0; q < MAX_CLUSTER; ++q)
      if (q < csz) a += wq[q * RB + r] * x[q];
    p.out[(bh * R + r) * D + i % D] =
        finish<D, Tc>(p, a, alpha[r], den[r], pv + r * TMAX, VN, i % D);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// Pass 2 (nsplit past a cluster, and the group forms): block (h, b) merges
// the splits in order, folds in the T virtual rows (always f32) and
// normalises.
template <int D, typename Tc>
__global__ void __launch_bounds__(NT) combine_kernel(const Params p) {
  constexpr bool QUANT = sizeof(Tc) == 1;
  constexpr int RSTRIDE = NT / D;
  constexpr int ACC = RMAX / RSTRIDE;
  __shared__ __align__(16) float Qs[RMAX * D];
  __shared__ __align__(16) Tc KN[TMAX * D];
  __shared__ __align__(16) Tc VN[TMAX * D];
  __shared__ float Sv[RMAX * TMAX];
  __shared__ float Kns[TMAX], Vns[TMAX];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int R = p.R;
  const size_t bh = (size_t)b * p.Hkv + h;
  for (int i = tid; i < R * D; i += NT) Qs[i] = p.q[bh * R * D + i];
  load_virtual<D, Tc>(p, bh, KN, VN, Kns, Vns, tid);
  __syncthreads();
  const bool act = p.active[b] != 0;
  virtual_scores<D, Tc>(p, Qs, KN, Kns, Sv, tid & 31, tid >> 5);
  __syncthreads();

  const int col = tid % D, r_first = tid / D;
#pragma unroll
  for (int ii = 0; ii < ACC; ++ii) {
    const int r = r_first + RSTRIDE * ii;
    if (r >= R) break;
    const size_t pr0 = bh * p.nsplit * R + r;  // split s at pr0 + s * R
    float m = NEG_INF;
#pragma unroll 8
    for (int s = 0; s < p.nsplit; ++s) m = fmaxf(m, p.part_m[pr0 + s * R]);
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int s = 0; s < p.nsplit; ++s) {
      const size_t pi = pr0 + (size_t)s * R;
      const float w = expf(p.part_m[pi] - m);
      l += w * p.part_l[pi];
      a += w * p.part_acc[pi * D + col];
    }
    float alpha, den, pv[TMAX];
    virtual_row(p, act, r, m, l, Sv, Vns, QUANT, alpha, den, pv);
    p.out[(bh * R + r) * D + col] =
        finish<D, Tc>(p, a, alpha, den, pv, VN, col);
  }
}

// the dynamic shared-memory limit of a kernel, raised once per (kernel,
// card) to the largest size asked for: the attribute is per function and
// card
int set_smem(const void* fn, int bytes) {
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> done;
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  std::lock_guard<std::mutex> lock(mu);
  int& have = done[{fn, dev}];
  if (have >= bytes) return 0;
  e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e == cudaSuccess) have = bytes;
  return static_cast<int>(e);
}

// a grid of clusters of csize blocks along x
template <typename K>
int launch_clusters(K kernel, const Params& p, dim3 grid, int csize,
                    int smem, cudaStream_t st) {
  const int se = set_smem(reinterpret_cast<const void*>(kernel), smem);
  if (se != cudaSuccess) return se;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// the split pass: one cluster of nsplit blocks a (sequence, head) when
// csize = nsplit (at most MAX_CLUSTER), which then writes the output; plain
// blocks writing partials when csize = 0
template <int D, typename Tc, int SC, int RB>
int launch_split(const Params& p, cudaStream_t st) {
  constexpr int SMEM = SplitSmem<RB, D, sizeof(Tc)>::BYTES;
  static_assert(SMEM <= 227 * 1024, "split kernel shared memory over 227 KB");
  const auto kernel = split_kernel<D, Tc, SC, RB>;
  const dim3 grid(p.nsplit, p.Hkv, p.B);
  if (p.csize != 0)
    return p.csize == p.nsplit && p.csize <= MAX_CLUSTER
               ? launch_clusters(kernel, p, grid, p.csize, SMEM, st)
               : static_cast<int>(cudaErrorInvalidValue);
  const int e = set_smem(reinterpret_cast<const void*>(kernel), SMEM);
  if (e != cudaSuccess) return e;
  kernel<<<grid, NT, SMEM, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename Tc, int SC>
int launch_split_rows(const Params& p, cudaStream_t st) {
  if (p.R <= 4) return launch_split<D, Tc, SC, 4>(p, st);
  if (p.R <= 8) return launch_split<D, Tc, SC, 8>(p, st);
  return launch_split<D, Tc, SC, RMAX>(p, st);
}

// past the first key block, a max pass first (the per-block row maxima
// whose prefix max is the TPU kernel's running max), then the main pass
template <int D, typename Tc, int SC, int PV, int RB>
int launch_group(const Params& p, cudaStream_t st) {
  const GSmem L(RB, D, sizeof(Tc), p.slice_cap);
  if (p.csize < 1 || p.csize > MAX_CLUSTER || p.slice_cap < G_TK ||
      p.slice_cap % G_TK || (long long)p.slice_cap * p.csize < p.block_s ||
      L.bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.nsplit * p.csize, p.Hkv, p.B);
  if (p.nsplit > 1) {
    const int e = launch_clusters(group_kernel<D, Tc, SC, PV, RB, true>, p,
                                  grid, p.csize, L.bytes, st);
    if (e != cudaSuccess) return e;
  }
  return launch_clusters(group_kernel<D, Tc, SC, PV, RB, false>, p, grid,
                         p.csize, L.bytes, st);
}

template <int D, typename Tc, int SC, int PV>
int launch_group_rows(const Params& p, cudaStream_t st) {
  if (p.R <= 4) return launch_group<D, Tc, SC, PV, 4>(p, st);
  if (p.R <= 8) return launch_group<D, Tc, SC, PV, 8>(p, st);
  return launch_group<D, Tc, SC, PV, RMAX>(p, st);
}

template <int D, typename Tc>
int launch(const Params& p, int dot, cudaStream_t st) {
  int e = static_cast<int>(cudaErrorInvalidValue);
  bool merged = false;  // the split pass wrote the output itself
  if (dot == DOT_F32) {
    e = launch_split_rows<D, Tc, SC_F32>(p, st);
    merged = p.csize > 0;
  } else if (dot == DOT_BF16) {
    e = launch_group_rows<D, Tc, SC_BF16, PV_BF16>(p, st);
  } else if constexpr (sizeof(Tc) == 1) {  // the int8 forms: int8 cache
    if (dot == DOT_INT8_S) {
      e = launch_split_rows<D, Tc, SC_I8>(p, st);
      merged = p.csize > 0;
    } else if (dot == DOT_INT8_V) {
      e = launch_group_rows<D, Tc, SC_F32, PV_I8>(p, st);
    } else if (dot == DOT_INT8) {
      e = launch_group_rows<D, Tc, SC_I8, PV_I8>(p, st);
    }
  }
  if (e != cudaSuccess || merged) return e;
  combine_kernel<D, Tc><<<dim3(p.Hkv, p.B), NT, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, Hkv, R, D] f32. q [B, Hkv, R, D] f32 (row r = t * group + g); the
// cache bf16 (is_int8 = 0) or int8 codes with f32 scales ks/vs (is_int8 =
// 1); kn/vn [B, Hkv, T, D] in the cache dtype, kns/vns [B, Hkv, T]; pos and
// active int32 [B]; window: keys kept in (qpos - window, qpos]; s_live: no
// key at or past it is read. dot: the cache-dot form (0 f32, 1 bf16, 2 int8,
// 3 int8_s, 4 int8_v; the int8 forms on an int8 cache only). The split
// forms (f32, int8_s) take nsplit blocks a (sequence, head) and csize =
// nsplit (one cluster, at most 8, whose rank 0 writes out) or 0 (the
// combine pass merges); they ignore block_s and slice_cap. The per-block
// forms (bf16, int8, int8_v) take block_s, their key block, nsplit = the
// number of key blocks, each on a cluster of csize blocks (1-8) whose
// slices hold at most slice_cap keys (a multiple of 128). Scratch: part_acc
// [B, Hkv, nsplit, R, D], part_m / part_l / part_max [B, Hkv, nsplit, R]
// f32. Launches: a split form one (csize > 0) or two (the split pass, then
// the combine pass); a per-block form the group pass and the combine pass,
// with its max pass first when nsplit > 1 (three).
extern "C" int batched_flash_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kn, const void* vn, const void* kns,
    const void* vns, const void* pos, const void* active, void* part_acc,
    void* part_m, void* part_l, void* part_max, void* out, int B, int Hkv,
    int S, int R, int T, int group, int D, int is_int8, int layer,
    int s_live, int window, int nsplit, int dot, int block_s, int csize,
    int slice_cap, float scale, float softcap, float qscale, float inv127,
    void* stream) {
  if (R < 1 || R > RMAX || T < 1 || T > TMAX || R != group * T ||
      nsplit < 1 || B < 1 || Hkv < 1 || S < 1 || layer < 0 || s_live < 1 ||
      window < 1 || block_s < 1 || dot < DOT_F32 || dot > DOT_INT8_V)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.kn = kn;
  p.vn = vn;
  p.kns = static_cast<const float*>(kns);
  p.vns = static_cast<const float*>(vns);
  p.pos = static_cast<const int*>(pos);
  p.active = static_cast<const int*>(active);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_max = static_cast<float*>(part_max);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.Hkv = Hkv;
  p.S = S;
  p.R = R;
  p.T = T;
  p.group = group;
  p.layer = layer;
  p.s_live = s_live;
  p.window = window;
  p.nsplit = nsplit;
  p.block_s = block_s;
  p.csize = csize;
  p.slice_cap = slice_cap;
  p.scale = scale;
  p.softcap = softcap;
  p.qscale = qscale;
  p.inv127 = inv127;
  p.magic = 0x4B000000u;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128 && !is_int8) return launch<128, __nv_bfloat16>(p, dot, st);
  if (D == 128) return launch<128, int8_t>(p, dot, st);
  if (D == 64 && !is_int8) return launch<64, __nv_bfloat16>(p, dot, st);
  if (D == 64) return launch<64, int8_t>(p, dot, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
