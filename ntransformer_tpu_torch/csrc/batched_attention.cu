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
// attention does a few operations per byte, far below the card's ratio.
//
// What the design does about it. One block cannot fill the card at small
// batch (B = 1 has Hkv = 8 (sequence, head) pairs for 132 SMs), so the live
// key range of each (sequence, head) is split over `nsplit` blocks; each
// writes an unnormalised partial (m, l, acc) and a second pass merges the
// partials in a fixed order, then folds in the virtual rows and normalises
// (deterministic, no atomics), as the Q8_0 GEMV splits K. A block stops at
// its sequence's own last live key, so a short sequence reads only its
// rows. Inside a block a tile of 32 keys is staged in shared memory; a lane
// computes one key's scores for the rows of its warp, the online softmax runs
// as warp reductions, and each thread then owns one output column. The TPU
// kernel's head-merged block-diagonal dot is a VPU trade of that chip and is
// not carried over. f32 FMAs on the CUDA cores for the f32 and bf16 forms,
// dp4a and int32 multiply-adds for the int8 forms: bytes, not operations,
// set the time.
//
// The group kernel. Its blocks follow the key blocks of the TPU kernel, one
// CUDA block per (key block, head, sequence), so at s_live <= 2048 (int8,
// Hkv 8, D 128) a (sequence, head) runs on one block. It needs the block's
// row max before it can form p, and the row max of p * vs before it can
// quantize p, so it walks its keys two or three times (max; denominator and
// p * vs max; p times V), recomputing the scores each time: at verify T = 8
// the 32 rows x 2048 keys of f32 scores would not fit in shared memory. Its
// row max is the TPU kernel's running max at that block: the first walk
// starts at the sequence's first live key, not at the block, so block g
// reads the keys of the blocks before it once more (nothing extra at one
// block, the 8B serving case). p is then the TPU kernel's p, and the
// combine pass merges the partials, each relative to its own max.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;    // threads per block (4 warps)
constexpr int BK = 32;     // cache keys per tile: one per lane
constexpr int RMAX = 32;   // query rows per (sequence, kv head): group * T
constexpr int TMAX = 8;    // new (virtual) rows per sequence
constexpr int WROWS = RMAX / 4;  // rows per warp in the score passes
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
  float* out;         // [B, Hkv, R, D]
  int B, Hkv, S, R, T, group, layer, s_live, window, nsplit, block_s;
  float scale, softcap;
  float qscale;       // f32(scale / 127): the int8 score dot's fix-up
  float inv127;       // f32(1 / 127): the int8 value dot's fix-up
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

// Shared memory of both split kernels: q (f32, and its int8 codes for the
// int8 score dot), one tile of K and of V (f32, or the raw int8 codes with a
// padded row), the tile's probabilities (f32, or int8 codes held as int) and
// per-row and per-key scalars.
struct Smem {
  float* Qs;     // [R][D]
  float* Ks;     // [BK][D + 4] f32, or int8 [BK][D + 16]
  float* Vs;     // [BK][D] f32, or int8 [BK][D]
  float* Ps;     // [R][BK] f32, or int
  float* Al;     // [RMAX] rescale of the running sums
  float* QMS;    // [RMAX] qm * scale / 127 of each row (int8 score dot)
  float* PM;     // [RMAX] pm of each row (int8 value dot)
  float* Ksc;    // [BK]
  float* Vsc;    // [BK]
  int8_t* Q8;    // [R][D]
  __device__ Smem(float* s, int R, int D) {
    Qs = s;
    Ks = Qs + R * D;
    Vs = Ks + BK * (D + 4);
    Ps = Vs + BK * D;
    Al = Ps + R * BK;
    QMS = Al + RMAX;
    PM = QMS + RMAX;
    Ksc = PM + 2 * RMAX;
    Vsc = Ksc + BK;
    Q8 = reinterpret_cast<int8_t*>(Vsc + BK);
  }
};

size_t smem_bytes(int R, int D) {
  return sizeof(float) * (size_t)(R * D + BK * (D + 4) + BK * D + R * BK +
                                  4 * RMAX + 2 * BK) +
         (size_t)R * D;
}

// q of (b, h) into shared memory: f32, rounded to bf16 for the bf16 score
// dot, and quantized per row for the int8 score dot. The caller syncs.
template <int D, int SC>
__device__ __forceinline__ void load_q(const Params& p, size_t bh,
                                       const Smem& sm, int tid) {
  const int R = p.R;
  const float4* q4 = reinterpret_cast<const float4*>(p.q + bh * R * D);
  for (int i = tid; i < R * D / 4; i += NT) {
    float4 x = q4[i];
    if constexpr (SC == SC_BF16) {
      x.x = bf16_round(x.x);
      x.y = bf16_round(x.y);
      x.z = bf16_round(x.z);
      x.w = bf16_round(x.w);
    }
    reinterpret_cast<float4*>(sm.Qs)[i] = x;
  }
  if constexpr (SC == SC_I8) {
    __syncthreads();
    const int lane = tid & 31, warp = tid >> 5;
    for (int r = warp; r < R; r += 4) {
      float a = 0.f;
      for (int d = lane; d < D; d += 32) a = fmaxf(a, fabsf(sm.Qs[r * D + d]));
      const float qm = warp_max(a) + 1e-30f;
      const float inv = 127.0f / qm;
      for (int d = lane; d < D; d += 32)
        sm.Q8[r * D + d] =
            static_cast<int8_t>(rintf(sm.Qs[r * D + d] * inv));
      if (lane == 0) sm.QMS[r] = qm * p.qscale;
    }
  }
}

// One tile of nk (<= BK) keys from kt into shared memory; rows past nk are
// zero. KRAW: K as raw int8 codes (int8 score dot), else as f32. VF: no V
// (0), V as f32 (1), V as raw int8 codes (2).
template <int D, typename Tc, bool KRAW, int VF>
__device__ __forceinline__ void load_tile(const Tc* kb, const Tc* vb, int kt,
                                          int nk, const Smem& sm, int tid) {
  constexpr int CN = Chunk<Tc>::N;
  constexpr int CPR = D / CN;       // 16-byte chunks per cache row
  constexpr int LDK = D + 4;        // f32 Ks row stride: conflict-free float4s
  constexpr int LDK8 = D + 16;      // int8 Ks row stride: conflict-free int4s
  for (int c = tid; c < BK * CPR; c += NT) {
    const int j = c / CPR, c0 = (c % CPR) * CN;
    const bool in = j < nk;
    const size_t off = (size_t)(kt + j) * D + c0;
    if constexpr (KRAW) {
      const int4 u = in ? *reinterpret_cast<const int4*>(kb + off)
                        : make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(reinterpret_cast<int8_t*>(sm.Ks) + j * LDK8 +
                               c0) = u;
    } else {
      float f[CN];
      if (in) {
        Chunk<Tc>::load(f, kb + off);
      } else {
#pragma unroll
        for (int e = 0; e < CN; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CN; e += 4)
        *reinterpret_cast<float4*>(&sm.Ks[j * LDK + c0 + e]) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
    if constexpr (VF == 2) {
      const int4 u = in ? *reinterpret_cast<const int4*>(vb + off)
                        : make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(reinterpret_cast<int8_t*>(sm.Vs) + j * D +
                               c0) = u;
    } else if constexpr (VF == 1) {
      float f[CN];
      if (in) {
        Chunk<Tc>::load(f, vb + off);
      } else {
#pragma unroll
        for (int e = 0; e < CN; ++e) f[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CN; e += 4)
        *reinterpret_cast<float4*>(&sm.Vs[j * D + c0 + e]) =
            make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
    }
  }
}

// The scores of this lane's key for the warp's rows (warp w: rows w, w + 4,
// ...), scaled (the int8 dot by qm * scale / 127, the others by scale);
// the key scale and the softcap are the caller's.
template <int D, int SC>
__device__ __forceinline__ void tile_scores(float (&s)[WROWS], const Smem& sm,
                                            int R, int lane, int warp,
                                            float scale) {
  if constexpr (SC == SC_I8) {
    constexpr int LDK8 = D + 16;
    const int8_t* K8 = reinterpret_cast<const int8_t*>(sm.Ks);
    int si[WROWS];
#pragma unroll
    for (int i = 0; i < WROWS; ++i) si[i] = 0;
#pragma unroll 2
    for (int d = 0; d < D; d += 16) {
      const int4 k4 = *reinterpret_cast<const int4*>(K8 + lane * LDK8 + d);
#pragma unroll
      for (int i = 0; i < WROWS; ++i) {
        const int r = warp + 4 * i;
        if (r < R) {
          const int4 q4 = *reinterpret_cast<const int4*>(sm.Q8 + r * D + d);
          si[i] = __dp4a(q4.x, k4.x, si[i]);
          si[i] = __dp4a(q4.y, k4.y, si[i]);
          si[i] = __dp4a(q4.z, k4.z, si[i]);
          si[i] = __dp4a(q4.w, k4.w, si[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int r = warp + 4 * i;
      s[i] = r < R ? static_cast<float>(si[i]) * sm.QMS[r] : 0.f;
    }
  } else {
    constexpr int LDK = D + 4;
#pragma unroll
    for (int i = 0; i < WROWS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&sm.Ks[lane * LDK + d]);
#pragma unroll
      for (int i = 0; i < WROWS; ++i) {
        const int r = warp + 4 * i;
        if (r < R) {
          const float4 qv = *reinterpret_cast<const float4*>(&sm.Qs[r * D + d]);
          s[i] = fmaf(qv.x, k4.x, s[i]);
          s[i] = fmaf(qv.y, k4.y, s[i]);
          s[i] = fmaf(qv.z, k4.z, s[i]);
          s[i] = fmaf(qv.w, k4.w, s[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < WROWS; ++i) s[i] *= scale;
  }
}

// Is key kp (lane < nk of its tile) seen from row r?
__device__ __forceinline__ bool visible(const Params& p, int r, int kp,
                                        bool in_tile, int pos, bool act) {
  const int qpos = pos + r / p.group;
  return in_tile && (act ? kp <= pos - 1 : kp <= qpos) &&
         kp > qpos - p.window;
}

__device__ __forceinline__ void scale_tile(const Params& p, const Smem& sm,
                                           size_t row0, int kt, int nk,
                                           int tid) {
  if (tid < BK)
    sm.Ksc[tid] = tid < nk ? p.ks[row0 + kt + tid] : 0.f;
  else if (tid < 2 * BK)
    sm.Vsc[tid - BK] = tid - BK < nk ? p.vs[row0 + kt + tid - BK] : 0.f;
}

// Pass 1 of "f32" and "int8_s": block (split, h, b) runs the online softmax
// over its share of the live cache keys of (b, h) and writes the
// unnormalised partial.
template <int D, typename Tc, int SC>
__global__ void __launch_bounds__(NT) split_kernel(const Params p) {
  constexpr bool QUANT = sizeof(Tc) == 1;
  constexpr int RSTRIDE = NT / D;   // threads per column in the PV pass
  constexpr int ACC = RMAX / RSTRIDE;
  extern __shared__ __align__(16) float smem[];
  const int R = p.R;
  const Smem sm(smem, R, D);

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * p.Hkv + h;
  const size_t row0 = (((size_t)p.layer * p.B + b) * p.Hkv + h) * p.S;
  const Tc* kb = static_cast<const Tc*>(p.k) + row0 * D;
  const Tc* vb = static_cast<const Tc*>(p.v) + row0 * D;
  load_q<D, SC>(p, bh, sm, tid);

  // the live cache keys of (b, h): the union over the window tokens
  const int pos = p.pos[b];
  const bool act = p.active[b] != 0;
  int last = act ? pos - 1 : pos + p.T - 1;
  last = min(last, min(p.S, p.s_live) - 1);
  const int first = max(pos - p.window + 1, 0);
  const int n = last - first + 1;
  int chunk = n > 0 ? (n + p.nsplit - 1) / p.nsplit : 0;
  chunk = (chunk + BK - 1) / BK * BK;
  const int k0 = first + split * chunk;
  const int k1 = min(k0 + chunk, last + 1);

  float m_run[WROWS], l_run[WROWS];
#pragma unroll
  for (int i = 0; i < WROWS; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
  }
  const int col = tid % D, r_first = tid / D;
  float acc[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int kt = k0; kt < k1; kt += BK) {
    const int nk = min(BK, k1 - kt);
    load_tile<D, Tc, SC == SC_I8, 1>(kb, vb, kt, nk, sm, tid);
    if (QUANT) scale_tile(p, sm, row0, kt, nk, tid);
    __syncthreads();

    float s[WROWS];
    tile_scores<D, SC>(s, sm, R, lane, warp, p.scale);
    const int kp = kt + lane;
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;  // warp-uniform
      float sc = s[i];
      if (QUANT) sc *= sm.Ksc[lane];
      sc = cap(sc, p.softcap);
      const bool vis = visible(p, r, kp, lane < nk, pos, act);
      const float m_new = fmaxf(m_run[i], warp_max(vis ? sc : NEG_INF));
      const float alpha = expf(m_run[i] - m_new);
      float pr = vis ? expf(sc - m_new) : 0.f;
      l_run[i] = alpha * l_run[i] + warp_sum(pr);
      m_run[i] = m_new;
      if (QUANT) pr *= sm.Vsc[lane];
      sm.Ps[r * BK + lane] = pr;
      if (lane == 0) sm.Al[r] = alpha;
    }
    __syncthreads();

    // P x V: this thread's column, its rows
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = r_first + RSTRIDE * i;
      if (r < R) acc[i] *= sm.Al[r];
    }
    for (int j = 0; j < nk; ++j) {
      const float vv = sm.Vs[j * D + col];
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int r = r_first + RSTRIDE * i;
        if (r < R) acc[i] = fmaf(sm.Ps[r * BK + j], vv, acc[i]);
      }
    }
    __syncthreads();
  }

  const size_t pb = (bh * p.nsplit + split) * R;
#pragma unroll
  for (int i = 0; i < WROWS; ++i) {
    const int r = warp + 4 * i;
    if (r < R && lane == 0) {
      p.part_m[pb + r] = m_run[i];
      p.part_l[pb + r] = l_run[i];
    }
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int r = r_first + RSTRIDE * i;
    if (r < R) p.part_acc[(pb + r) * D + col] = acc[i];
  }
}

// Pass 1 of "int8", "int8_v" and "bf16": block (g, h, b) takes key block g
// of the TPU kernel ([g * block_s, (g + 1) * block_s), live keys only) and
// writes its unnormalised partial.
template <int D, typename Tc, int SC, int PV>
__global__ void __launch_bounds__(NT) group_kernel(const Params p) {
  constexpr bool QUANT = sizeof(Tc) == 1;
  constexpr int RSTRIDE = NT / D;
  constexpr int ACC = RMAX / RSTRIDE;
  constexpr bool KRAW = SC == SC_I8;
  extern __shared__ __align__(16) float smem[];
  const int R = p.R;
  const Smem sm(smem, R, D);

  const int grp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * p.Hkv + h;
  const size_t row0 = (((size_t)p.layer * p.B + b) * p.Hkv + h) * p.S;
  const Tc* kb = static_cast<const Tc*>(p.k) + row0 * D;
  const Tc* vb = static_cast<const Tc*>(p.v) + row0 * D;
  load_q<D, SC>(p, bh, sm, tid);
  __syncthreads();

  // the TPU kernel visits key block g of sequence b iff it meets the live
  // range; inside it the position mask does the rest
  const int pos = p.pos[b];
  const bool act = p.active[b] != 0;
  const int last = act ? pos - 1 : pos + p.T - 1;
  const int g0 = grp * p.block_s, g1 = g0 + p.block_s - 1;
  const bool runs = g0 <= last && g1 >= pos - p.window + 1;
  const int k0 = max(g0, max(pos - p.window + 1, 0));
  const int k1 =
      runs ? min(min(g1, last), min(p.S, p.s_live) - 1) + 1 : k0;
  // the running max covers every live key up to the block's end
  const int w0 = runs ? max(pos - p.window + 1, 0) : k1;

  float m_run[WROWS], l_run[WROWS], inv_q[WROWS];
#pragma unroll
  for (int i = 0; i < WROWS; ++i) {
    m_run[i] = NEG_INF;
    l_run[i] = 0.f;
    inv_q[i] = 0.f;
  }

  // walk 1: the running row max at the end of the block
  for (int kt = w0; kt < k1; kt += BK) {
    const int nk = min(BK, k1 - kt);
    load_tile<D, Tc, KRAW, 0>(kb, vb, kt, nk, sm, tid);
    if (QUANT) scale_tile(p, sm, row0, kt, nk, tid);
    __syncthreads();
    float s[WROWS];
    tile_scores<D, SC>(s, sm, R, lane, warp, p.scale);
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;
      float sc = s[i];
      if (QUANT) sc *= sm.Ksc[lane];
      sc = cap(sc, p.softcap);
      const bool vis = visible(p, r, kt + lane, lane < nk, pos, act);
      m_run[i] = fmaxf(m_run[i], warp_max(vis ? sc : NEG_INF));
    }
    __syncthreads();
  }

  // walk 2 (int8 value dot): the denominator and the row max of p * vs
  if constexpr (PV == PV_I8) {
    float pm[WROWS];
#pragma unroll
    for (int i = 0; i < WROWS; ++i) pm[i] = 0.f;
    for (int kt = k0; kt < k1; kt += BK) {
      const int nk = min(BK, k1 - kt);
      load_tile<D, Tc, KRAW, 0>(kb, vb, kt, nk, sm, tid);
      scale_tile(p, sm, row0, kt, nk, tid);
      __syncthreads();
      float s[WROWS];
      tile_scores<D, SC>(s, sm, R, lane, warp, p.scale);
#pragma unroll
      for (int i = 0; i < WROWS; ++i) {
        const int r = warp + 4 * i;
        if (r >= R) break;
        const float sc = cap(s[i] * sm.Ksc[lane], p.softcap);
        const bool vis = visible(p, r, kt + lane, lane < nk, pos, act);
        const float pr = vis ? expf(sc - m_run[i]) : 0.f;
        l_run[i] += warp_sum(pr);
        pm[i] = fmaxf(pm[i], warp_max(pr * sm.Vsc[lane]));
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;
      const float pmr = pm[i] + 1e-30f;
      inv_q[i] = 127.0f / pmr;
      if (lane == 0) sm.PM[r] = pmr;
    }
  }

  // walk 3: p, rounded as the form says, times V
  const int col = tid % D, r_first = tid / D;
  int acc_i[ACC];
  float acc_f[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    acc_i[i] = 0;
    acc_f[i] = 0.f;
  }
  int* Pi = reinterpret_cast<int*>(sm.Ps);
  const int8_t* V8 = reinterpret_cast<const int8_t*>(sm.Vs);
  for (int kt = k0; kt < k1; kt += BK) {
    const int nk = min(BK, k1 - kt);
    load_tile<D, Tc, KRAW, PV == PV_I8 ? 2 : 1>(kb, vb, kt, nk, sm, tid);
    if (QUANT) scale_tile(p, sm, row0, kt, nk, tid);
    __syncthreads();
    float s[WROWS];
    tile_scores<D, SC>(s, sm, R, lane, warp, p.scale);
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;
      float sc = s[i];
      if (QUANT) sc *= sm.Ksc[lane];
      sc = cap(sc, p.softcap);
      const bool vis = visible(p, r, kt + lane, lane < nk, pos, act);
      const float pr = vis ? expf(sc - m_run[i]) : 0.f;
      if constexpr (PV != PV_I8) l_run[i] += warp_sum(pr);
      const float pv = QUANT ? pr * sm.Vsc[lane] : pr;
      if constexpr (PV == PV_I8)
        Pi[r * BK + lane] = static_cast<int>(rintf(pv * inv_q[i]));
      else
        sm.Ps[r * BK + lane] = bf16_round(pv);
    }
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      if constexpr (PV == PV_I8) {
        const int vv = V8[j * D + col];
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const int r = r_first + RSTRIDE * i;
          if (r < R) acc_i[i] += Pi[r * BK + j] * vv;
        }
      } else {
        const float vv = sm.Vs[j * D + col];
#pragma unroll
        for (int i = 0; i < ACC; ++i) {
          const int r = r_first + RSTRIDE * i;
          if (r < R) acc_f[i] = fmaf(sm.Ps[r * BK + j], vv, acc_f[i]);
        }
      }
    }
    __syncthreads();
  }
  __syncthreads();  // sm.PM of rows whose block had no tile

  const size_t pb = (bh * p.nsplit + grp) * R;
#pragma unroll
  for (int i = 0; i < WROWS; ++i) {
    const int r = warp + 4 * i;
    if (r < R && lane == 0) {
      p.part_m[pb + r] = m_run[i];
      p.part_l[pb + r] = l_run[i];
    }
  }
#pragma unroll
  for (int i = 0; i < ACC; ++i) {
    const int r = r_first + RSTRIDE * i;
    if (r >= R) continue;
    float a = acc_f[i];
    if constexpr (PV == PV_I8)
      a = static_cast<float>(acc_i[i]) * (sm.PM[r] * p.inv127);
    p.part_acc[(pb + r) * D + col] = a;
  }
}

// Pass 2: block (h, b) merges the splits in order, folds in the T virtual
// rows (always f32) and normalises.
template <int D, typename Tc>
__global__ void __launch_bounds__(NT) combine_kernel(const Params p) {
  constexpr bool QUANT = sizeof(Tc) == 1;
  constexpr int RSTRIDE = NT / D;
  constexpr int ACC = RMAX / RSTRIDE;
  __shared__ __align__(16) float Qs[RMAX * D];
  __shared__ __align__(16) float KN[TMAX * D];
  __shared__ __align__(16) float VN[TMAX * D];
  __shared__ float Sv[RMAX * TMAX];
  __shared__ float Kns[TMAX], Vns[TMAX];
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int R = p.R, T = p.T;
  const size_t bh = (size_t)b * p.Hkv + h;
  const Tc* kn = static_cast<const Tc*>(p.kn) + bh * T * D;
  const Tc* vn = static_cast<const Tc*>(p.vn) + bh * T * D;
  for (int i = tid; i < R * D; i += NT) Qs[i] = p.q[bh * R * D + i];
  for (int i = tid; i < T * D; i += NT) {
    KN[i] = Chunk<Tc>::one(kn, i);
    VN[i] = Chunk<Tc>::one(vn, i);
  }
  if (QUANT && tid < T) {
    Kns[tid] = p.kns[bh * T + tid];
    Vns[tid] = p.vns[bh * T + tid];
  }
  __syncthreads();
  const bool act = p.active[b] != 0;
  for (int c = tid; c < R * T; c += NT) {
    const int r = c / T, i = c % T;
    float s = 0.f;
    for (int d = 0; d < D; ++d) s = fmaf(Qs[r * D + d], KN[i * D + d], s);
    s *= p.scale;
    if (QUANT) s *= Kns[i];
    Sv[c] = cap(s, p.softcap);
  }
  __syncthreads();

  const int col = tid % D, r_first = tid / D;
#pragma unroll
  for (int ii = 0; ii < ACC; ++ii) {
    const int r = r_first + RSTRIDE * ii;
    if (r >= R) break;
    const size_t pr0 = bh * p.nsplit * R + r;  // split s at pr0 + s * R
    float m = NEG_INF;
    for (int s = 0; s < p.nsplit; ++s) m = fmaxf(m, p.part_m[pr0 + s * R]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < p.nsplit; ++s) {
      const size_t pi = pr0 + (size_t)s * R;
      const float w = expf(p.part_m[pi] - m);
      l += w * p.part_l[pi];
      a += w * p.part_acc[pi * D + col];
    }
    // the virtual rows: row i sits at pos + i, seen from window token t >= i
    const int t = r / p.group;
    float mv = m;
    for (int i = 0; i < T; ++i)
      if (act && i <= t && i > t - p.window) mv = fmaxf(mv, Sv[r * T + i]);
    const float alpha = expf(m - mv);
    float pl = 0.f, pa = 0.f;
    for (int i = 0; i < T; ++i) {
      if (!(act && i <= t && i > t - p.window)) continue;
      float pr = expf(Sv[r * T + i] - mv);
      pl += pr;
      if (QUANT) pr *= Vns[i];
      pa = fmaf(pr, VN[i * D + col], pa);
    }
    l = alpha * l + pl;
    a = a * alpha + pa;
    p.out[(bh * R + r) * D + col] = a / l;
  }
}

template <typename K>
int launch_split(K kernel, const Params& p, cudaStream_t st, int D) {
  const size_t smem = smem_bytes(p.R, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<dim3(p.nsplit, p.Hkv, p.B), NT, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename Tc>
int launch(const Params& p, int dot, cudaStream_t st) {
  int e = static_cast<int>(cudaErrorInvalidValue);
  if (dot == DOT_F32) {
    e = launch_split(split_kernel<D, Tc, SC_F32>, p, st, D);
  } else if (dot == DOT_BF16) {
    e = launch_split(group_kernel<D, Tc, SC_BF16, PV_BF16>, p, st, D);
  } else if constexpr (sizeof(Tc) == 1) {  // the int8 forms: int8 cache
    if (dot == DOT_INT8_S)
      e = launch_split(split_kernel<D, Tc, SC_I8>, p, st, D);
    else if (dot == DOT_INT8_V)
      e = launch_split(group_kernel<D, Tc, SC_F32, PV_I8>, p, st, D);
    else if (dot == DOT_INT8)
      e = launch_split(group_kernel<D, Tc, SC_I8, PV_I8>, p, st, D);
  }
  if (e != cudaSuccess) return e;
  combine_kernel<D, Tc><<<dim3(p.Hkv, p.B), NT, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, Hkv, R, D] f32. q [B, Hkv, R, D] f32 (row r = t * group + g); the
// cache bf16 (is_int8 = 0) or int8 codes with f32 scales ks/vs (is_int8 =
// 1); kn/vn [B, Hkv, T, D] in the cache dtype, kns/vns [B, Hkv, T]; pos and
// active int32 [B]; window: keys kept in (qpos - window, qpos]; s_live: no
// key at or past it is read. dot: the cache-dot form (0 f32, 1 bf16, 2 int8,
// 3 int8_s, 4 int8_v; the int8 forms on an int8 cache only); block_s: the
// key block of the bf16, int8 and int8_v forms, which take nsplit = the
// number of key blocks. Scratch: part_acc [B, Hkv, nsplit, R, D], part_m /
// part_l [B, Hkv, nsplit, R] f32. Two launches.
extern "C" int batched_flash_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kn, const void* vn, const void* kns,
    const void* vns, const void* pos, const void* active, void* part_acc,
    void* part_m, void* part_l, void* out, int B, int Hkv, int S, int R,
    int T, int group, int D, int is_int8, int layer, int s_live, int window,
    int nsplit, int dot, int block_s, float scale, float softcap,
    float qscale, float inv127, void* stream) {
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
  p.scale = scale;
  p.softcap = softcap;
  p.qscale = qscale;
  p.inv127 = inv127;
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
