// W8A8 int8 serving matmul for Hopper (sm_90a), plain C interface, with the
// activation quantization folded in.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/w8a8.py::_w8a8_impl
// (entry w8a8_matmul_pallas, reached from ops/linear.py::qmatmul) and the
// XLA row quantization in front of it (core/w8a8.quantize_rows): every
// product of a model requantized with --w8a8, at any row count up to 2048
// (decode at B = 1, batched steps, verify windows, 512-token prefill
// chunks).
//
// What it computes. x [T, K] (bf16 or f32, any strides) is quantized per
// row: amax_t = max |x[t, :]|, am_t = amax_t / 127 (an IEEE division; 1
// for a zero row), codes a = rint(x / am_t) (a true division, half to
// even) clamped to +-127. Then y[t,n] f32 = (f32(P[t,n]) * am[t]) * s[n]
// with P = a[t,:] . q[:,n] the exact int32 dot with the per-column weight
// codes q int8 [K,N] (N contiguous) and s f32 [N] the column scales.
// |P| <= 127 * 127 * K < 2^31 for K <= 133,000, so the dot is exact in any
// order; its conversion to f32 rounds to nearest even (as the plain twin's
// float64 sum does), and the two multiplies of the fixup round in the
// golden's order (core/w8a8.py), with explicit _rn intrinsics so nothing
// contracts. The kernel is therefore bit-equal to its plain twin, whose
// codes and scales equal core/w8a8.quantize_rows' on the same x.
//
// What bounds it on the H100. Bytes at small T: q is read once, one byte a
// weight (fused gate|up of an 8B model, K 4096 x N 28672, 117.4 MB: 35 us
// at 3.35 TB/s). At T = 512 the 120 GOP of the same product take 61 us on
// the int8 tensor cores (1,979 TOP/s), so large T is bound by operations.
//
// What the design does about it. A call is two launches and no PyTorch
// op: a quantize pass (quant_kernel, one block a row of x, bf16 or f32 at
// any strides: the column-major first-layer view needs no copy) writes the
// codes and row scales once, and the matmul, launched with programmatic
// dependent launch, is resident and streaming weights while the pass runs
// (it waits for the codes before it reads them).
//  * T <= 32 (plans.SKINNY_ROWS): skinny_kernel. A block owns a strip of
//    128 columns and a K split; the splits of a strip form one thread-block
//    cluster (at most 8 blocks, as many as give every SM one: fewer, longer
//    streams measured faster than two a SM). The weight is the M side of
//    mma.sync m16n8k32 (s8 -> s32) and the tokens its N side (padded to 8,
//    16 or 32). The block's 4 warps take interleaved 32-row steps, each
//    warp keeping 2 steps in flight in a ring of 3 shared-memory slots
//    filled by cp.async (the step's weight rows and its tokens' codes), so
//    the bytes in flight cost no registers; lane g reads the 16 columns
//    16 g .. 16 g + 15 of 4 K rows at a time (rows rotated in the slot so a
//    load phase meets no bank conflict) and transposes their 4 x 4 byte
//    blocks with __byte_perm (8-bit operands are K-major only); the mma
//    rows are permuted so every byte lands in the lane's own fragments.
//    The warps' int32 sums meet in shared memory, the cluster's over
//    distributed shared memory, and the fixup is the epilogue.
//  * T > 32: the int8 wgmma tile of hopper_tile.cuh (BM x 128, K split in
//    two where that measured faster): a producer warpgroup transposes each
//    128-row stage of the N-major plane into the 128-byte-swizzled K-major
//    layout wgmma takes for 8-bit operands (4 x 4 byte blocks with
//    __byte_perm, 16-byte stores), two consumer warpgroups issue
//    m64n128k32 s8 wgmma, and the fixup is the epilogue.
// The row threshold: the skinny kernel streams the weight once for up to 32
// tokens, where its 32 mma columns a warp still fit the registers; at T =
// 32 it measured faster than the tile at every 8B shape but gate|up (equal).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace cg = cooperative_groups;

namespace {
using namespace hop;

__device__ __forceinline__ float fixup(int p, float am, float s) {
  return __fmul_rn(__fmul_rn(__int2float_rn(p), am), s);
}

__device__ __forceinline__ float ldx(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

__device__ __forceinline__ float ldx(const float* x, long long i) {
  return x[i];
}

// am = amax / 127 (IEEE), 1 where that is 0 (core/w8a8.quantize_rows)
__device__ __forceinline__ float row_scale(float amax) {
  const float am = __fdiv_rn(amax, 127.f);
  return am > 0.f ? am : 1.f;
}

__device__ __forceinline__ int8_t code(float v, float am) {
  const int c = __float2int_rn(__fdiv_rn(v, am));
  return static_cast<int8_t>(max(-127, min(127, c)));
}

// ------------------------------------------------------------- T <= 32
constexpr int SK_WARPS = 4;
constexpr int SK_THREADS = SK_WARPS * 32;
constexpr int SK_MAX_CLUSTER = 8;
constexpr int SK_MAX_ROWS = 32;
constexpr int SK_STAGES = 3;              // a warp's ring of steps
constexpr int SC = 128;                   // strip columns: 8 lanes x 16
constexpr int SK_A = 32 * SC;             // a step's weight codes [32][128],
constexpr int A_LD = 48;                  // then activation codes [8 NT][32]
                                          // 48 bytes apart (no conflict)

template <int NT>
struct Skinny {
  static constexpr int SLOT = SK_A + 8 * NT * A_LD;
  static constexpr int RING = SK_WARPS * SK_STAGES * SLOT;
  static constexpr int RED = 8 * NT * SC * 4;  // the block's sums
  static constexpr int SMEM = RING > RED ? RING : RED;
};

// byte offset of 16-byte chunk c of code row r in a slot: the chunks of a
// row are rotated by 2 ((r >> 2) & 3), so the 8 lanes of a 16-byte load
// phase (two column chunks x the four rows 4 t + i) hit 8 bank groups
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * SC + ((c ^ (2 * ((r >> 2) & 3))) << 4);
}

// a warp's copies of the 32 weight rows at row k into slot (zero past K or
// N): cp.async, or plain loads when the plane is not 16-byte aligned
__device__ __forceinline__ void issue_weights(uint8_t* slot,
                                              const int8_t* __restrict__ q,
                                              int k, int n0, int K, int N,
                                              int vec, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // 32 rows x 8 chunks of 16 codes
    const int id = lane + 32 * i, r = id >> 3, c = id & 7;
    const int col = n0 + 16 * c;
    const bool row_in = k + r < K;
    uint8_t* dst = slot + chunk_at(r, c);
    const int8_t* src = q + (size_t)(k + r) * N + col;
    if (vec) {
      const bool in = row_in && col < N;
      cp_async16(smem_u32(dst), in ? src : q, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e)
        dst[e] = (row_in && col + e < N) ? src[e] : 0;
    }
  }
}

// a warp's copies of the activation codes of the step at row k: 8 NT
// tokens x 32 codes (zero past T; the quantize pass pads the rows to Kp)
template <int NT>
__device__ __forceinline__ void issue_codes(uint8_t* slot,
                                            const int8_t* __restrict__ a,
                                            int k, int T, int Kp, int lane) {
  for (int id = lane; id < 16 * NT; id += 32) {  // 8 NT tokens x 2 chunks
    const int r = id >> 1, c = id & 1;
    const bool in = r < T;
    cp_async16(smem_u32(slot + SK_A + r * A_LD + 16 * c),
               in ? a + (size_t)r * Kp + k + 16 * c : a, in ? 16 : 0);
  }
}

// y rows [0, T) x the 128 columns of this cluster's strip; blockIdx.x: the
// K split (the cluster's rank), blockIdx.y: the strip. a / am: the codes
// and row scales of the quantize pass this grid depends on (programmatic
// dependent launch: the first weight steps are in flight before they are
// waited for). Dynamic shared memory: the warps' rings, later the block's
// sums.
// SEL: q and s are the first matrix of a stacked [M, K, N] / [M, 1, N]
// plane set; every block reads the index sel[0] on the card and offsets
// both by it times their strides in bytes before its first copy (the TPU
// kernel's scalar-prefetch select; a template flag, as in q8_0_matmul.cu).
// sel was written before the quantize pass was launched, so it is read
// before pdl_wait.
template <int NT, bool SEL>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const int8_t* __restrict__ a, const float* __restrict__ am,
              const int8_t* __restrict__ q, const float* __restrict__ s,
              float* __restrict__ y, int T, int K, int Kp, int N,
              int split_k, int vec, const int* __restrict__ sel,
              long long q_stride, long long s_stride) {
  if constexpr (SEL) {
    const long long e = __ldg(sel);
    q += e * q_stride;
    s = reinterpret_cast<const float*>(
        reinterpret_cast<const uint8_t*>(s) + e * s_stride);
  }
  constexpr int MT = 8;         // m16 tiles: a lane's 16 columns
  constexpr int ROWS = 8 * NT;  // padded tokens
  constexpr int SLOT = Skinny<NT>::SLOT;
  extern __shared__ __align__(1024) uint8_t dyn[];
  cg::cluster_group cluster = cg::this_cluster();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.y * SC;
  const int kb = blockIdx.x * split_k;
  const int ke = min(kb + split_k, K);
  uint8_t* ring = dyn + warp * SK_STAGES * SLOT;
  // this warp's steps: rows kb + 32 (warp + 4 i)
  const int k0 = kb + 32 * warp;
  const int steps = k0 < ke ? (ke - k0 + 32 * SK_WARPS - 1) / (32 * SK_WARPS)
                            : 0;

  // cp.async groups: the first steps' weights, then each of their codes,
  // then one group a step; at step i every group but the last S - 1 is in
#pragma unroll
  for (int i = 0; i < SK_STAGES - 1; ++i)
    if (i < steps)
      issue_weights(ring + i * SLOT, q, k0 + 32 * SK_WARPS * i, n0, K, N,
                    vec, lane);
  cp_async_commit();
  pdl_wait();  // the quantize pass's codes and scales are written
#pragma unroll
  for (int i = 0; i < SK_STAGES - 1; ++i) {
    if (i < steps)
      issue_codes<NT>(ring + i * SLOT, a, k0 + 32 * SK_WARPS * i, T, Kp,
                      lane);
    cp_async_commit();
  }

  int acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0;

  for (int i = 0; i < steps; ++i) {
    __syncwarp();  // every lane is done with the slot refilled next
    const int nx = i + SK_STAGES - 1;
    if (nx < steps) {
      uint8_t* sl = ring + (nx % SK_STAGES) * SLOT;
      const int k = k0 + 32 * SK_WARPS * nx;
      issue_weights(sl, q, k, n0, K, N, vec, lane);
      issue_codes<NT>(sl, a, k, T, Kp, lane);
    }
    cp_async_commit();
    cp_async_wait<SK_STAGES - 1>();  // this lane's copies of step i
    __syncwarp();                    // and every lane's
    const uint8_t* slot = ring + (i % SK_STAGES) * SLOT;
    uint32_t b[NT][2];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint8_t* cr = slot + SK_A + (8 * nt + g) * A_LD + 4 * t;
      b[nt][0] = *reinterpret_cast<const uint32_t*>(cr);
      b[nt][1] = *reinterpret_cast<const uint32_t*>(cr + 16);
    }
    // a[j][i]: fragment register i of tile j; row g of tile j is column
    // 16 g + j, row g + 8 column 16 g + 8 + j
    uint32_t af[MT][4];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint4 v[4];  // rows 16 h + 4 t + i
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = *reinterpret_cast<const uint4*>(
            slot + chunk_at(16 * h + 4 * t + e, g));
#pragma unroll
      for (int wb = 0; wb < 4; ++wb) {
        const uint32_t rw[4] = {word(v[0], wb), word(v[1], wb),
                                word(v[2], wb), word(v[3], wb)};
        uint32_t cw[4];
        transpose4(rw, cw);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int cc = 4 * wb + j;
          if (cc < MT)
            af[cc][2 * h] = cw[j];
          else
            af[cc - MT][2 * h + 1] = cw[j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < MT; ++j)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_s8_16832(acc[j][nt], af[j], b[nt][0], b[nt][1]);
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are dead: the block's sums take their place

  // the warps' sums in warp order into one [ROWS][128] array; the
  // fragment's columns are tokens 2 t, 2 t + 1
  int* red = reinterpret_cast<int*>(dyn);
  for (int w = 0; w < SK_WARPS; ++w) {
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
            red[o[e]] = w == 0 ? acc[j][nt][e] : red[o[e]] + acc[j][nt][e];
        }
    }
    __syncthreads();
  }
  const int rows = min(T, ROWS);
  cluster.sync();  // every block's int32 partial rows are in its red
  const int ranks = cluster.num_blocks();
  const int rank = cluster.block_rank();
  for (int e = rank * SK_THREADS + threadIdx.x; e < rows * SC;
       e += ranks * SK_THREADS) {
    const int n = n0 + e % SC;
    if (n >= N) continue;
    int v = 0;
    for (int qr = 0; qr < ranks; ++qr)
      v += cluster.map_shared_rank(red, qr)[e];
    const int r = e / SC;
    y[(size_t)r * N + n] = fixup(v, am[r], s[n]);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int NT, bool SEL = false>
int launch_skinny(const int8_t* a, const float* am, const void* q,
                  const void* s, void* y, int T, int K, int Kp, int N,
                  int nsplit, int split_k, int vec, cudaStream_t st,
                  const int* sel = nullptr, long long q_stride = 0,
                  long long s_stride = 0) {
  constexpr int SMEM = Skinny<NT>::SMEM;
  const cudaError_t ae = cudaFuncSetAttribute(
      skinny_kernel<NT, SEL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (ae != cudaSuccess) return static_cast<int>(ae);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, (N + SC - 1) / SC, 1);
  cfg.blockDim = dim3(SK_THREADS, 1, 1);
  cfg.dynamicSmemBytes = SMEM;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, skinny_kernel<NT, SEL>, a, am, static_cast<const int8_t*>(q),
      static_cast<const float*>(s), static_cast<float*>(y), T, K, Kp, N,
      split_k, vec, sel, q_stride, s_stride);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// ------------------------------------------------------ the quantize pass
constexpr int QT_THREADS = 256;

template <typename XT>
__device__ __forceinline__ void ld8(const XT* __restrict__ xr, long long xsk,
                                    int i, bool vec, float (&v)[8]) {
  if constexpr (sizeof(XT) == 2) {
    if (vec) {
      const uint4 w = *reinterpret_cast<const uint4*>(xr + i);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&w);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h[e]);
        v[2 * e] = f.x, v[2 * e + 1] = f.y;
      }
      return;
    }
  } else {
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(xr + i);
      const float4 b = *reinterpret_cast<const float4*>(xr + i + 4);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
      return;
    }
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) v[e] = ldx(xr, (i + e) * xsk);
}

// row t of x -> codes a[t, 0:Kp] (zero past K) and am[t]; vec: x rows are
// contiguous and 16-byte aligned (K % 16 == 0)
template <typename XT>
__global__ void __launch_bounds__(QT_THREADS)
quant_kernel(const XT* __restrict__ x, long long xst, long long xsk,
             int8_t* __restrict__ a, float* __restrict__ am, int K, int Kp,
             int vec) {
  __shared__ float wmax[QT_THREADS / 32];
  pdl_launch_dependents();  // the matmul may become resident meanwhile
  const int r = blockIdx.x;
  const XT* xr = x + r * xst;
  float m = 0.f;
#pragma unroll 2
  for (int i = 8 * threadIdx.x; i < K; i += 8 * QT_THREADS) {
    float v[8];
    ld8(xr, xsk, i, vec, v);
#pragma unroll
    for (int e = 0; e < 8; ++e) m = fmaxf(m, fabsf(v[e]));
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
  __syncthreads();
  m = wmax[0];
#pragma unroll
  for (int w = 1; w < QT_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
  const float sc = row_scale(m);
  int8_t* ar = a + (size_t)r * Kp;
#pragma unroll 2
  for (int i = 8 * threadIdx.x; i < Kp; i += 8 * QT_THREADS) {
    uint32_t lo = 0, hi = 0;
    if (i < K) {
      float v[8];
      ld8(xr, xsk, i, vec, v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[e], sc)))
              << (8 * e);
        hi |= static_cast<uint32_t>(static_cast<uint8_t>(code(v[e + 4], sc)))
              << (8 * e);
      }
    }
    *reinterpret_cast<uint2*>(ar + i) = make_uint2(lo, hi);
  }
  if (threadIdx.x == 0) am[r] = sc;
}

// ----------------------------------------------------------------- T > 32
// the W8A8 format of the hopper_tile.cuh tile: a stage is 128 k (128 code
// bytes a row)
struct W8 {
  using Acc = int;
  struct Args {
    const int8_t* a;  // codes [T, Kp]
    const float* am;
    const int8_t* q;
    const float* s;
    float* y;
    int T, K, Kp, N, vec;
  };
  static constexpr int X_AHEAD = 2, R_AHEAD = 2;
  static constexpr int RAW_BYTES = 128 * tile::BN;  // [128][128]

  __device__ static int steps(const Args& a) { return a.Kp / 128; }

  __device__ static const void* a_chunk(const Args& a, int row, int st,
                                        int c, int& bytes) {
    const bool in = row < a.T;
    bytes = in ? 16 : 0;
    return a.a + (in ? (size_t)row * a.Kp + 128 * st + 16 * c : 0);
  }

  __device__ static void issue_raw(const Args& a, uint8_t* raw, int st,
                                   int n0, int pt) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {  // 128 rows x 8 chunks of 16 codes
      const int id = pt + tile::PRODUCERS * i, r = id >> 3, c = id & 7;
      const int k = 128 * st + r, col = n0 + 16 * c;
      uint8_t* dst = raw + r * tile::BN + 16 * c;
      const int8_t* src = a.q + (size_t)k * a.N + col;
      if (a.vec) {
        const bool in = col < a.N && k < a.K;
        cp_async16(smem_u32(dst), in ? src : a.q, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (k < a.K && col + e < a.N) ? src[e] : 0;
      }
    }
  }

  // items: 16 code rows x 4 columns, 256 a stage, two a thread. A warp's
  // lanes read 32 neighbouring words of a row (no bank conflict); each
  // column's 16 K bytes go out as one 16-byte store, column j of an item at
  // step q = j - rot so the 8 lanes of a store phase write 8 distinct
  // swizzled chunks
  __device__ static void transform(const Args&, const uint8_t* raw,
                                   uint8_t* bt, int, int pt) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int it = pt + tile::PRODUCERS * u;
      const int cgp = it & 31, rg = it >> 5, rot = (cgp >> 1) & 3;
      uint32_t w[16];
#pragma unroll
      for (int i = 0; i < 16; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(
            raw + (16 * rg + i) * tile::BN + 4 * cgp);
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int j = (qq + rot) & 3, n = 4 * cgp + j;
        // bytes j of rows 4 bb .. 4 bb + 3, first row in the low byte
        const uint32_t s01 = j | ((j + 4) << 4), s23 = s01;
        uint32_t o[4];
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          const uint32_t lo = __byte_perm(w[4 * bb], w[4 * bb + 1], s01);
          const uint32_t hi = __byte_perm(w[4 * bb + 2], w[4 * bb + 3], s23);
          o[bb] = __byte_perm(lo, hi, 0x5410);
        }
        *reinterpret_cast<uint4*>(bt + sw128(n, rg)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }

  __device__ static void mma(int (&acc)[64], uint64_t da, uint64_t db) {
    wgmma_s8_m64n128(acc, da, db);
  }

  __device__ static void store(const Args& a, int r, int c, int v0, int v1) {
    if (r >= a.T) return;
    const float am = a.am[r];
    float* dst = a.y + (size_t)r * a.N + c;
    if ((a.N & 1) == 0 && c + 1 < a.N) {
      *reinterpret_cast<float2*>(dst) =
          make_float2(fixup(v0, am, a.s[c]), fixup(v1, am, a.s[c + 1]));
    } else {
      if (c < a.N) dst[0] = fixup(v0, am, a.s[c]);
      if (c + 1 < a.N) dst[1] = fixup(v1, am, a.s[c + 1]);
    }
  }
};

template <typename XT>
int launch(const void* x, long long xst, long long xsk, const void* q,
           const void* s, void* y, void* work, int T, int K, int N, int path,
           int nsplit, int split_k, int bm, int vec, const int* sel,
           long long q_stride, long long s_stride, cudaStream_t st) {
  if (sel != nullptr &&
      (path != 0 || T > 8 ||
       (vec && (q_stride % 16 != 0 || s_stride % 16 != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    if (nsplit < 1 || nsplit > SK_MAX_CLUSTER || split_k % 128 != 0 ||
        (long long)nsplit * split_k < K ||
        (long long)(nsplit - 1) * split_k >= K || T > SK_MAX_ROWS)
      return static_cast<int>(cudaErrorInvalidValue);
  } else if ((bm != 256 && bm != 128) || nsplit < 1 ||
             nsplit > SK_MAX_CLUSTER || split_k % 128 != 0 ||
             (long long)nsplit * split_k < K ||
             (long long)(nsplit - 1) * split_k >= K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Kp = (K + 127) / 128 * 128;
  int8_t* a = static_cast<int8_t*>(work);
  float* am = reinterpret_cast<float*>(a + (size_t)T * Kp);
  const bool xvec = xsk == 1 && xst % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  quant_kernel<XT><<<T, QT_THREADS, 0, st>>>(static_cast<const XT*>(x), xst,
                                             xsk, a, am, K, Kp, xvec);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (path == 0) {
    if (sel != nullptr)
      return launch_skinny<1, true>(a, am, q, s, y, T, K, Kp, N, nsplit,
                                    split_k, vec, st, sel, q_stride,
                                    s_stride);
    if (T <= 8)
      return launch_skinny<1>(a, am, q, s, y, T, K, Kp, N, nsplit, split_k,
                              vec, st);
    if (T <= 16)
      return launch_skinny<2>(a, am, q, s, y, T, K, Kp, N, nsplit, split_k,
                              vec, st);
    return launch_skinny<4>(a, am, q, s, y, T, K, Kp, N, nsplit, split_k,
                            vec, st);
  }
  W8::Args args;
  args.a = a;
  args.am = am;
  args.q = static_cast<const int8_t*>(q);
  args.s = static_cast<const float*>(s);
  args.y = static_cast<float*>(y);
  args.T = T, args.K = K, args.Kp = Kp, args.N = N, args.vec = vec;
  const int per = split_k / 128;
  return bm == 256 ? tile::launch<W8, 2>(args, T, N, nsplit, per, true, st)
                   : tile::launch<W8, 1>(args, T, N, nsplit, per, true, st);
}

}  // namespace

// y [T,N] f32 = the W8A8 product of x [T,K] (x_f32: 1 for f32, 0 for bf16;
// element (t, k) at x + t xst + k xsk) with q [K,N] int8 and s [N] f32.
// K % 16 == 0. Two launches: the quantize pass, then path 0, the skinny
// kernel (T <= 32) on nsplit (1-8) clusters of split_k rows (a multiple of
// 128, nsplit = ceil(K / split_k)), or path 1, the wgmma tile of bm (256 or
// 128) rows, its K split likewise. work: T * roundup(K, 128) code bytes then T f32 scales,
// 16-byte aligned. vec: 1 when N % 16 == 0 and q is 16-byte aligned. sel:
// null, or (path 0, T <= 8) a device int32 index into stacked planes
// [M, K, N] / [M, 1, N] that start at q and s, matrix m at q + m q_stride
// and s + m s_stride bytes (with vec, both multiples of 16); only the
// matmul reads it.
extern "C" int w8a8_matmul(const void* x, int x_f32, long long xst,
                           long long xsk, const void* q, const void* s,
                           void* y, void* work, int T, int K, int N,
                           int path, int nsplit, int split_k, int bm,
                           int vec, const void* sel, long long q_stride,
                           long long s_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || K % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int* si = static_cast<const int*>(sel);
  return x_f32 ? launch<float>(x, xst, xsk, q, s, y, work, T, K, N, path,
                               nsplit, split_k, bm, vec, si, q_stride,
                               s_stride, st)
               : launch<__nv_bfloat16>(x, xst, xsk, q, s, y, work, T, K, N,
                                       path, nsplit, split_k, bm, vec, si,
                                       q_stride, s_stride, st);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
