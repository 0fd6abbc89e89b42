// Prefill flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/attention.py::
// _flash_impl / _attn_kernel, entry flash_attention (the prefill path of
// ops/layers.py::attention, taken when q_len >= 64).
//
// What it computes. Causal GQA attention of q [T,Hq,D] against the cache
// k/v [Hkv,S,D] (bf16, or f32), query t at position pos + t, seeing keys in
// (pos + t - window, pos + t]; scores are scaled, optionally soft-capped
// (softcap * tanh(s / softcap)) and masked to NEG_INF = -0.7 * FLT_MAX as the
// reference does. Online softmax in f32 over 64-key tiles; p is rounded to
// bf16 before the PV product, as the TPU kernel rounds it to the cache
// dtype. Output [T,Hq,D] f32. An f32 cache is accepted with its operands
// rounded to bf16, which is what the TPU kernel's default-precision dots do.
//
// What bounds it on the H100. Causal prefill of T queries against pos + T
// keys is 4 * T * (pos + T/2) * D operations per query head on the tensor
// cores (989 TFLOP/s bf16); the bytes (q, the visible keys and values, the
// f32 output) are far fewer, so operations bound it.
//
// What the simple design does about it. One block of four warps per (64
// query rows, query head); each warp holds 16 query rows in mma fragments
// and loops over the KV tiles the block can see, skipping tiles past
// causality or below the window, as the TPU kernel skips grid steps. The
// loop is inside the block: nothing carries between blocks. QK^T and PV run
// as mma.sync m16n8k16 bf16 -> f32; the score fragments are re-used as the
// A operand of PV without a trip through shared memory. K sits in shared
// memory row-major, V transposed, with strides chosen so the fragment loads
// are free of bank conflicts. GQA re-reads each KV head once per query head
// of its group (through L2); no TMA, wgmma or pipelining yet.
//
// Second entry, flash_attention_partials_fwd: the same kernel with PARTIALS
// set replaces flash_attention_partials (attention.py:210, _flash_impl with
// partials=True), one shard's pass under context parallelism. The cache is
// a [Hkv, S_local, D] slice whose key i sits at global position
// kpos_offset + i; the tile range and the causal test use global positions,
// so tiles past a block's last query are still skipped, and a shard wholly
// past its queries runs no tile. It writes the UNNORMALIZED acc [T,Hq,D]
// with the running max m and sum l [T,Hq] of each (query row, head), for
// the caller's exact combine across shards. A row that sees no key of the
// shard writes acc = 0, m = NEG_INF, l = 0 (the combine weights it by
// exp(NEG_INF - m) = 0); no window, no softcap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FA_BT = 64;  // query rows per block (4 warps x 16)
constexpr int FA_BS = 64;  // keys per tile
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ void load8(__nv_bfloat16* dst,
                                      const __nv_bfloat16* src, bool ok) {
  uint4 v = make_uint4(0u, 0u, 0u, 0u);
  if (ok) v = *reinterpret_cast<const uint4*>(src);
  *reinterpret_cast<uint4*>(dst) = v;
}

__device__ __forceinline__ void load8(__nv_bfloat16* dst, const float* src,
                                      bool ok) {
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
  if (ok) {
    a = *reinterpret_cast<const float4*>(src);
    b = *reinterpret_cast<const float4*>(src + 4);
  }
  dst[0] = __float2bfloat16_rn(a.x);
  dst[1] = __float2bfloat16_rn(a.y);
  dst[2] = __float2bfloat16_rn(a.z);
  dst[3] = __float2bfloat16_rn(a.w);
  dst[4] = __float2bfloat16_rn(b.x);
  dst[5] = __float2bfloat16_rn(b.y);
  dst[6] = __float2bfloat16_rn(b.z);
  dst[7] = __float2bfloat16_rn(b.w);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <int D, typename Tin, bool PARTIALS>
__global__ void __launch_bounds__(128)
flash_fwd_kernel(const Tin* __restrict__ q, const Tin* __restrict__ k,
                 const Tin* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int T,
                 int Hq, int Hkv, int S, int pos, int kpos_offset, int window,
                 float scale, float softcap) {
  constexpr int LDK = D + 8;      // Ks row stride (bf16); also stages Q
  constexpr int LDV = FA_BS + 8;  // Vt row stride (bf16)
  constexpr int CH = D / 8;       // 8-element chunks per row
  __shared__ __align__(16) __nv_bfloat16 Ks[FA_BS * LDK];
  __shared__ __align__(16) __nv_bfloat16 Vt[D * LDV];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int hq = blockIdx.y;
  const int hkv = hq / (Hq / Hkv);
  const int q0 = blockIdx.x * FA_BT;
  const int q_end = min(q0 + FA_BT, T);

  // stage this block's Q rows, then keep them as A fragments in registers
  for (int c = tid; c < FA_BT * CH; c += 128) {
    const int r = c / CH, col = (c % CH) * 8, t = q0 + r;
    load8(&Ks[r * LDK + col], q + ((size_t)t * Hq + hq) * D + col, t < T);
  }
  __syncthreads();
  const int r0 = warp * 16 + g;
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    qa[ks][0] = ld32(&Ks[r0 * LDK + ks * 16 + 2 * t4]);
    qa[ks][1] = ld32(&Ks[(r0 + 8) * LDK + ks * 16 + 2 * t4]);
    qa[ks][2] = ld32(&Ks[r0 * LDK + ks * 16 + 2 * t4 + 8]);
    qa[ks][3] = ld32(&Ks[(r0 + 8) * LDK + ks * 16 + 2 * t4 + 8]);
  }
  __syncthreads();

  const int qpos0 = pos + q0 + r0;  // fragment rows g and g + 8
  const int qpos1 = qpos0 + 8;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  // the KV tiles any row of this block can see, as local key indices (the
  // global position of local key i is kpos_offset + i)
  const int max_kpos = min(pos + q_end - 1 - kpos_offset, S - 1);
  const int min_kpos = pos + q0 - window + 1 - kpos_offset;
  const int j_begin = min_kpos > 0 ? min_kpos / FA_BS : 0;
  const int j_end = max_kpos >= 0 ? max_kpos / FA_BS : -1;
  const Tin* kh = k + (size_t)hkv * S * D;
  const Tin* vh = v + (size_t)hkv * S * D;

  for (int j = j_begin; j <= j_end; ++j) {
    const int kbase = j * FA_BS;
    // K rows: neighbouring threads read neighbouring 16-byte chunks
    for (int c = tid; c < FA_BS * CH; c += 128) {
      const int r = c / CH, col = (c % CH) * 8, key = kbase + r;
      load8(&Ks[r * LDK + col], kh + (size_t)key * D + col, key < S);
    }
    // V transposed: a warp takes 32 keys of one 8-column chunk, so its
    // scattered 2-byte stores land in distinct banks
    for (int c = tid; c < FA_BS * CH; c += 128) {
      const int r = c % FA_BS, col = (c / FA_BS) * 8, key = kbase + r;
      __nv_bfloat16 tmp[8];
      load8(tmp, vh + (size_t)key * D + col, key < S);
#pragma unroll
      for (int i = 0; i < 8; ++i) Vt[(col + i) * LDV + r] = tmp[i];
    }
    __syncthreads();

    float s[FA_BS / 8][4];
#pragma unroll
    for (int nt = 0; nt < FA_BS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
      const __nv_bfloat16* krow = &Ks[(nt * 8 + g) * LDK + 2 * t4];
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        mma_16816(s[nt], qa[ks], ld32(krow + ks * 16), ld32(krow + ks * 16 + 8));
    }

    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int nt = 0; nt < FA_BS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = s[nt][e] * scale;
        if (softcap > 0.f) val = softcap * tanhf(val * (1.0f / softcap));
        const int key = kbase + nt * 8 + 2 * t4 + (e & 1);
        const int gkey = kpos_offset + key;
        const int qp = e < 2 ? qpos0 : qpos1;
        const bool vis = gkey <= qp && gkey > qp - window && key < S;
        val = vis ? val : NEG_INF;
        s[nt][e] = val;
        if (e < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
      }
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = expf(m0 - mn0), al1 = expf(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < FA_BS / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[nt][e] - (e < 2 ? mn0 : mn1));
        s[nt][e] = p;
        if (e < 2) ps0 += p; else ps1 += p;
      }
    }
    l0 = al0 * l0 + quad_sum(ps0);
    l1 = al1 * l1 + quad_sum(ps1);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= al0;
      acc[dt][1] *= al0;
      acc[dt][2] *= al1;
      acc[dt][3] *= al1;
    }
    // P (score fragments, rounded to bf16) x V
#pragma unroll
    for (int kk = 0; kk < FA_BS / 16; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const __nv_bfloat16* vrow = &Vt[(dt * 8 + g) * LDV + kk * 16 + 2 * t4];
        mma_16816(acc[dt], pa, ld32(vrow), ld32(vrow + 8));
      }
    }
    m0 = mn0;
    m1 = mn1;
    __syncthreads();
  }

  const int t0 = q0 + r0, t1 = t0 + 8;
  if constexpr (PARTIALS) {
    // a row that saw no key keeps m = NEG_INF: the tiles it sat in summed
    // p = exp(NEG_INF - NEG_INF) = 1 for it, so its acc and l are zeroed
    const bool none0 = m0 == NEG_INF, none1 = m1 == NEG_INF;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const int col = dt * 8 + 2 * t4;
      if (t0 < T) {
        float* out = o + ((size_t)t0 * Hq + hq) * D + col;
        out[0] = none0 ? 0.f : acc[dt][0];
        out[1] = none0 ? 0.f : acc[dt][1];
      }
      if (t1 < T) {
        float* out = o + ((size_t)t1 * Hq + hq) * D + col;
        out[0] = none1 ? 0.f : acc[dt][2];
        out[1] = none1 ? 0.f : acc[dt][3];
      }
    }
    // m and l are equal across the four lanes of a fragment row's quad
    if (t4 == 0) {
      if (t0 < T) {
        m_out[(size_t)t0 * Hq + hq] = m0;
        l_out[(size_t)t0 * Hq + hq] = none0 ? 0.f : l0;
      }
      if (t1 < T) {
        m_out[(size_t)t1 * Hq + hq] = m1;
        l_out[(size_t)t1 * Hq + hq] = none1 ? 0.f : l1;
      }
    }
    return;
  }
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    const int col = dt * 8 + 2 * t4;
    if (t0 < T) {
      float* out = o + ((size_t)t0 * Hq + hq) * D + col;
      out[0] = acc[dt][0] / l0;
      out[1] = acc[dt][1] / l0;
    }
    if (t1 < T) {
      float* out = o + ((size_t)t1 * Hq + hq) * D + col;
      out[0] = acc[dt][2] / l1;
      out[1] = acc[dt][3] / l1;
    }
  }
}

template <int D, typename Tin, bool PARTIALS>
void launch(const void* q, const void* k, const void* v, void* o, void* m,
            void* l, int T, int Hq, int Hkv, int S, int pos, int kpos_offset,
            int window, float scale, float softcap, cudaStream_t st) {
  const dim3 grid((T + FA_BT - 1) / FA_BT, Hq);
  flash_fwd_kernel<D, Tin, PARTIALS><<<grid, 128, 0, st>>>(
      static_cast<const Tin*>(q), static_cast<const Tin*>(k),
      static_cast<const Tin*>(v), static_cast<float*>(o),
      static_cast<float*>(m), static_cast<float*>(l), T, Hq, Hkv, S, pos,
      kpos_offset, window, scale, softcap);
}

template <bool PARTIALS>
int dispatch(const void* q, const void* k, const void* v, void* o, void* m,
             void* l, int T, int Hq, int Hkv, int S, int D, int is_f32,
             int pos, int kpos_offset, int window, float scale, float softcap,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64 && !is_f32)
    launch<64, __nv_bfloat16, PARTIALS>(q, k, v, o, m, l, T, Hq, Hkv, S, pos,
                                        kpos_offset, window, scale, softcap,
                                        st);
  else if (D == 128 && !is_f32)
    launch<128, __nv_bfloat16, PARTIALS>(q, k, v, o, m, l, T, Hq, Hkv, S, pos,
                                         kpos_offset, window, scale, softcap,
                                         st);
  else if (D == 64)
    launch<64, float, PARTIALS>(q, k, v, o, m, l, T, Hq, Hkv, S, pos,
                                kpos_offset, window, scale, softcap, st);
  else if (D == 128)
    launch<128, float, PARTIALS>(q, k, v, o, m, l, T, Hq, Hkv, S, pos,
                                 kpos_offset, window, scale, softcap, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// o [T,Hq,D] f32 = attention(q [T,Hq,D], k/v [Hkv,S,D]); q, k, v share one
// dtype: bf16 (is_f32 = 0) or f32 (is_f32 = 1). D is 64 or 128.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int T, int Hq, int Hkv, int S,
                                   int D, int is_f32, int pos, int window,
                                   float scale, float softcap, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, T, Hq, Hkv, S, D,
                         is_f32, pos, 0, window, scale, softcap, stream);
}

// One shard's partials: acc [T,Hq,D], m and l [T,Hq], all f32, of q [T,Hq,D]
// (global positions pos + t) over k/v [Hkv,S,D] whose key i sits at global
// position kpos_offset + i. Types and D as above; causal, no window.
extern "C" int flash_attention_partials_fwd(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int T, int Hq, int Hkv, int S, int D, int is_f32, int pos,
    int kpos_offset, float scale, void* stream) {
  return dispatch<true>(q, k, v, acc, m, l, T, Hq, Hkv, S, D, is_f32, pos,
                        kpos_offset, 1 << 30, scale, 0.f, stream);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
