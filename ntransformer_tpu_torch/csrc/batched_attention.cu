// Batched flash decode / verify attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/batched_attention.py::
// _impl / _kernel in its default dot_impl="f32" form (entries
// flash_decode_batched and flash_verify_batched; the serving path's
// attention in models/batched.py).
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
// kernel. All arithmetic is f32 over the cache values cast to f32.
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
// rows. Inside a block a tile of 32 keys is staged in shared memory as f32;
// a lane computes one key's scores for the rows of its warp, the online
// softmax runs as warp reductions, and each thread then owns one output
// column. The TPU kernel's head-merged block-diagonal dot is a VPU trade of
// that chip and is not carried over. f32 FMAs on the CUDA cores: rounding q
// or p to bf16 for the tensor cores would move the results away from the
// TPU kernel's, and bytes, not operations, set the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;    // threads per block (4 warps)
constexpr int BK = 32;     // cache keys per tile: one per lane
constexpr int RMAX = 32;   // query rows per (sequence, kv head): group * T
constexpr int TMAX = 8;    // new (virtual) rows per sequence
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

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
  int B, Hkv, S, R, T, group, layer, s_live, window, nsplit;
  float scale, softcap;
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

size_t split_smem_bytes(int R, int D) {
  return sizeof(float) *
         (size_t)(R * D + BK * (D + 4) + BK * D + R * BK + RMAX + 2 * BK);
}

// Pass 1: block (split, h, b) runs the online softmax over its share of
// the live cache keys of (b, h) and writes the unnormalised partial.
template <int D, typename Tc>
__global__ void __launch_bounds__(NT) split_kernel(const Params p) {
  constexpr bool QUANT = sizeof(Tc) == 1;
  constexpr int LDK = D + 4;        // Ks row stride: conflict-free float4s
  constexpr int WROWS = RMAX / 4;   // rows per warp in the score pass
  constexpr int RSTRIDE = NT / D;   // threads per column in the PV pass
  constexpr int ACC = RMAX / RSTRIDE;
  constexpr int CN = Chunk<Tc>::N;
  constexpr int CPR = D / CN;       // 16-byte chunks per cache row
  extern __shared__ __align__(16) float smem[];
  const int R = p.R;
  float* Qs = smem;              // [R][D]
  float* Ks = Qs + R * D;        // [BK][LDK]
  float* Vs = Ks + BK * LDK;     // [BK][D]
  float* Ps = Vs + BK * D;       // [R][BK] probabilities of this tile
  float* Al = Ps + R * BK;       // [RMAX] rescale of the running sums
  float* Ksc = Al + RMAX;        // [BK]
  float* Vsc = Ksc + BK;         // [BK]

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t bh = (size_t)b * p.Hkv + h;
  const size_t row0 = (((size_t)p.layer * p.B + b) * p.Hkv + h) * p.S;
  const Tc* kb = static_cast<const Tc*>(p.k) + row0 * D;
  const Tc* vb = static_cast<const Tc*>(p.v) + row0 * D;

  const float4* q4 = reinterpret_cast<const float4*>(p.q + bh * R * D);
  for (int i = tid; i < R * D / 4; i += NT)
    reinterpret_cast<float4*>(Qs)[i] = q4[i];

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
    for (int c = tid; c < BK * CPR; c += NT) {
      const int j = c / CPR, c0 = (c % CPR) * CN;
      float fk[CN], fv[CN];
      if (j < nk) {
        Chunk<Tc>::load(fk, kb + (size_t)(kt + j) * D + c0);
        Chunk<Tc>::load(fv, vb + (size_t)(kt + j) * D + c0);
      } else {
#pragma unroll
        for (int e = 0; e < CN; ++e) fk[e] = fv[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < CN; e += 4) {
        *reinterpret_cast<float4*>(&Ks[j * LDK + c0 + e]) =
            make_float4(fk[e], fk[e + 1], fk[e + 2], fk[e + 3]);
        *reinterpret_cast<float4*>(&Vs[j * D + c0 + e]) =
            make_float4(fv[e], fv[e + 1], fv[e + 2], fv[e + 3]);
      }
    }
    if (QUANT) {
      if (tid < BK)
        Ksc[tid] = tid < nk ? p.ks[row0 + kt + tid] : 0.f;
      else if (tid < 2 * BK)
        Vsc[tid - BK] = tid - BK < nk ? p.vs[row0 + kt + tid - BK] : 0.f;
    }
    __syncthreads();

    // scores: lane = key of the tile, warp w = rows w, w + 4, ...
    float s[WROWS];
#pragma unroll
    for (int i = 0; i < WROWS; ++i) s[i] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 k4 = *reinterpret_cast<const float4*>(&Ks[lane * LDK + d]);
#pragma unroll
      for (int i = 0; i < WROWS; ++i) {
        const int r = warp + 4 * i;
        if (r < R) {
          const float4 qv = *reinterpret_cast<const float4*>(&Qs[r * D + d]);
          s[i] = fmaf(qv.x, k4.x, s[i]);
          s[i] = fmaf(qv.y, k4.y, s[i]);
          s[i] = fmaf(qv.z, k4.z, s[i]);
          s[i] = fmaf(qv.w, k4.w, s[i]);
        }
      }
    }
    const int kp = kt + lane;
#pragma unroll
    for (int i = 0; i < WROWS; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;  // warp-uniform
      float sc = s[i] * p.scale;
      if (QUANT) sc *= Ksc[lane];
      sc = cap(sc, p.softcap);
      const int qpos = pos + r / p.group;
      const bool vis = lane < nk && (act ? kp <= pos - 1 : kp <= qpos) &&
                       kp > qpos - p.window;
      const float m_new = fmaxf(m_run[i], warp_max(vis ? sc : NEG_INF));
      const float alpha = expf(m_run[i] - m_new);
      float pr = vis ? expf(sc - m_new) : 0.f;
      l_run[i] = alpha * l_run[i] + warp_sum(pr);
      m_run[i] = m_new;
      if (QUANT) pr *= Vsc[lane];
      Ps[r * BK + lane] = pr;
      if (lane == 0) Al[r] = alpha;
    }
    __syncthreads();

    // P x V: this thread's column, its rows
#pragma unroll
    for (int i = 0; i < ACC; ++i) {
      const int r = r_first + RSTRIDE * i;
      if (r < R) acc[i] *= Al[r];
    }
    for (int j = 0; j < nk; ++j) {
      const float vv = Vs[j * D + col];
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        const int r = r_first + RSTRIDE * i;
        if (r < R) acc[i] = fmaf(Ps[r * BK + j], vv, acc[i]);
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

// Pass 2: block (h, b) merges the splits in order, folds in the T virtual
// rows and normalises.
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

template <int D, typename Tc>
int launch(const Params& p, cudaStream_t st) {
  const size_t smem = split_smem_bytes(p.R, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        split_kernel<D, Tc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  split_kernel<D, Tc><<<dim3(p.nsplit, p.Hkv, p.B), NT, smem, st>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  combine_kernel<D, Tc><<<dim3(p.Hkv, p.B), NT, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out [B, Hkv, R, D] f32. q [B, Hkv, R, D] f32 (row r = t * group + g); the
// cache bf16 (is_int8 = 0) or int8 codes with f32 scales ks/vs (is_int8 =
// 1); kn/vn [B, Hkv, T, D] in the cache dtype, kns/vns [B, Hkv, T]; pos and
// active int32 [B]; window: keys kept in (qpos - window, qpos]; s_live: no
// key at or past it is read. Scratch: part_acc [B, Hkv, nsplit, R, D],
// part_m / part_l [B, Hkv, nsplit, R] f32. Two launches.
extern "C" int batched_flash_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kn, const void* vn, const void* kns,
    const void* vns, const void* pos, const void* active, void* part_acc,
    void* part_m, void* part_l, void* out, int B, int Hkv, int S, int R,
    int T, int group, int D, int is_int8, int layer, int s_live, int window,
    int nsplit, float scale, float softcap, void* stream) {
  if (R < 1 || R > RMAX || T < 1 || T > TMAX || R != group * T ||
      nsplit < 1 || B < 1 || Hkv < 1 || S < 1 || layer < 0 || s_live < 1 ||
      window < 1)
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
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 128 && !is_int8) return launch<128, __nv_bfloat16>(p, st);
  if (D == 128) return launch<128, int8_t>(p, st);
  if (D == 64 && !is_int8) return launch<64, __nv_bfloat16>(p, st);
  if (D == 64) return launch<64, int8_t>(p, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
