// Fused Q8_0 dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/matmul.py::
// _quant_matmul_impl with its _q8_0_tile body (entry quant_matmul_pallas,
// reached from ops/linear.py::qmatmul): fused QKV, wo, fused gate|up, down
// and the LM head, at T = 1 (decode), at the serving T (batched steps,
// verify windows) and at prefill T.
//
// What it computes. y[T,N] f32 = x[T,K] @ W with W[k,n] = bf16(qs[k,n] *
// d[k/32,n]): qs int8 [K,N] (N contiguous), d the raw f16 bits of the block
// scales [K/32,N], x bf16 [T,K]. This is exactly the TPU kernel at its
// default dot precision (operands rounded to bf16, f32 accumulation) and the
// JAX CPU path (ops/linear.py: bf16 dequant, bf16 activations, f32 dot).
// The product of two bf16 values is exact in f32, so the kernel and its
// plain twin differ only in the order of the f32 sums. Each weight is
// dequantized as the plain twin does it: the f32 product q * s (exact: 8 by
// 11 significant bits) rounded once to bf16.
//
// What bounds it on the H100. At small T it streams 1.0625 bytes per
// weight once: bytes over 3.35 TB/s (fused gate|up of an 8B model, K=4096 x
// N=28672, ~125 MB: ~37 us). At prefill T it is bound by operations: 2*T*K*N
// on the bf16 tensor cores (989 TFLOP/s).
//
// What the design does about it.
//  * T <= 32 (plans.SKINNY_ROWS): skinny_kernel, one launch. The weight is
//    the M side of mma.sync m16n8k16 (bf16 -> f32) and the tokens its N
//    side (padded to 8, 16 or 32), so the tensor cores do the multiply-adds
//    and a weight costs a byte permute, a subtract, a multiply and half a
//    bf16x2 convert. A block owns a strip of 128 columns and a K split; its
//    4 warps take interleaved 32-row steps (one Q8_0 scale row each), and
//    each warp keeps 2 steps in flight in a ring of 3 shared-memory slots
//    filled by cp.async (the step's codes, its scale row and its tokens'
//    32 x values), so the bytes in flight cost no registers. Lane g reads
//    the 16 columns 16 g .. 16 g + 15 of the rows its fragments need
//    (16-byte loads, rows rotated in the slot so a load phase meets no bank
//    conflict); the mma rows are permuted so every byte lands in the lane's
//    own fragments (row g of tile j is column 16 g + j, row g + 8 column
//    16 g + 8 + j). The splits of a strip form one thread-block cluster (at
//    most 8, as many as give every SM one block: fewer, longer streams
//    measured faster than two a SM): each block sums its warps in shared
//    memory in warp order, and the cluster adds its blocks' partial rows
//    in rank order through distributed shared memory (a fixed order: runs
//    repeat bit for bit).
//  * T > 32: the warp-specialized wgmma tile of hopper_tile.cuh (BM x 128,
//    BM = 256 or 128 and K split in two by plans.tile_plan): a producer
//    warpgroup dequantizes each 64-row stage (two Q8_0 scale rows) once
//    for BM rows of x into the 128-byte-swizzled K-major bf16 layout, two
//    consumer warpgroups issue m64n128k16 wgmma with one batch in flight.
// The row threshold: the skinny kernel streams the weight once for up to 32
// tokens, where its 32 mma columns a warp still fit the registers; at T =
// 32 it measured faster than the tile at every 8B shape (the tile re-reads
// nothing there, but dequantizes on one warpgroup a block).
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tile.cuh"

namespace cg = cooperative_groups;

namespace {
using namespace hop;

__device__ __forceinline__ float scale_of(uint16_t bits) {
  return __half2float(__ushort_as_half(bits));
}

// ------------------------------------------------------------- T <= 32
constexpr int SK_WARPS = 4;
constexpr int SK_THREADS = SK_WARPS * 32;
constexpr int SK_MAX_CLUSTER = 8;
constexpr int SK_STAGES = 3;              // a warp's ring of steps
constexpr int SC = 128;                   // strip columns: 8 lanes x 16
constexpr int SK_CODE = 32 * SC;          // a step's codes [32][128]
constexpr int SK_X = SK_CODE + 2 * SC;    // then its scale row [128] f16,
constexpr int X_LD = 80;                  // then x [8 NT][32] bf16 rows
                                          // 80 bytes apart (no conflict)

template <int NT>
struct Skinny {
  static constexpr int SLOT = SK_X + 8 * NT * X_LD;
  static constexpr int RING = SK_WARPS * SK_STAGES * SLOT;
  static constexpr int RED = 8 * NT * SC * 4;  // the block's sums
  static constexpr int SMEM = RING > RED ? RING : RED;
};

// byte offset of 16-byte chunk c of code row r in a slot: the chunks of a
// row are rotated by 2 ((r >> 1) & 3), so the 8 lanes of a 16-byte load
// phase (two column chunks x the four rows 2 t + ...) hit 8 bank groups
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * SC + ((c ^ (2 * ((r >> 1) & 3))) << 4);
}

// a warp's copies of the step at row k into slot: 32 code rows, their
// scale row and the 32 x columns of its 8 NT tokens (zero past T or N);
// cp.async, or plain loads when the planes are not 16-byte aligned
template <int NT>
__device__ __forceinline__ void issue_step(uint8_t* slot,
                                           const __nv_bfloat16* __restrict__ x,
                                           const int8_t* __restrict__ qs,
                                           const uint16_t* __restrict__ d,
                                           int k, int n0, int T, int K,
                                           int N, int vec, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {  // 32 rows x 8 chunks of 16 codes
    const int id = lane + 32 * i, r = id >> 3, c = id & 7;
    const int col = n0 + 16 * c;
    uint8_t* dst = slot + chunk_at(r, c);
    const int8_t* src = qs + (size_t)(k + r) * N + col;
    if (vec) {
      const bool in = col < N;
      cp_async16(smem_u32(dst), in ? src : qs, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) dst[e] = col + e < N ? src[e] : 0;
    }
  }
  if (lane < 16) {  // the scale row: 16 chunks of 8
    const int col = n0 + 8 * lane;
    uint8_t* dst = slot + SK_CODE + 16 * lane;
    const uint16_t* src = d + (size_t)(k >> 5) * N + col;
    if (vec) {
      const bool in = col < N;
      cp_async16(smem_u32(dst), in ? src : d, in ? 16 : 0);
    } else {
      uint16_t* dd = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
      for (int e = 0; e < 8; ++e) dd[e] = col + e < N ? src[e] : 0;
    }
  }
#pragma unroll
  for (int i = 0; i < NT; ++i) {  // 8 NT tokens x 4 chunks of 8 bf16
    const int id = lane + 32 * i, r = id >> 2, c = id & 3;
    const bool in = r < T;
    cp_async16(smem_u32(slot + SK_X + r * X_LD + 16 * c),
               in ? x + (size_t)r * K + k + 8 * c : x, in ? 16 : 0);
  }
}

// y rows [0, T) x the 128 columns of this cluster's strip; blockIdx.x: the
// K split (the cluster's rank), blockIdx.y: the strip. Dynamic shared
// memory: the warps' rings, later the block's sums. SEL: qs and d are the
// first matrix of a stacked [M, K, N] plane set and every block reads the
// index sel[0] on the card and offsets both by it times their strides in
// bytes before its first copy (the TPU kernel's scalar-prefetch select:
// a routed expert never reaches the host). A template flag, not a runtime
// test of sel, so the dense instantiations compile as they did without the
// select: a runtime test moved the dense T = 1 device times of the skinny
// kernels by -2.6% (Q5_K) to +4.5% (Q6_K) on an H100 (select_ab.py in
// experiments/).
template <int NT, bool SEL>
__global__ void __launch_bounds__(SK_THREADS)
skinny_kernel(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ qs, const uint16_t* __restrict__ d,
              float* __restrict__ y, int T, int K, int N, int split_k,
              int vec, const int* __restrict__ sel, long long qs_stride,
              long long d_stride) {
  if constexpr (SEL) {
    const long long e = __ldg(sel);
    qs += e * qs_stride;
    d = reinterpret_cast<const uint16_t*>(
        reinterpret_cast<const uint8_t*>(d) + e * d_stride);
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

  float acc[MT][NT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

#pragma unroll
  for (int i = 0; i < SK_STAGES - 1; ++i) {
    if (i < steps)
      issue_step<NT>(ring + i * SLOT, x, qs, d, k0 + 32 * SK_WARPS * i, n0,
                     T, K, N, vec, lane);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    __syncwarp();  // every lane is done with the slot refilled next
    const int nx = i + SK_STAGES - 1;
    if (nx < steps)
      issue_step<NT>(ring + (nx % SK_STAGES) * SLOT, x, qs, d,
                     k0 + 32 * SK_WARPS * nx, n0, T, K, N, vec, lane);
    cp_async_commit();
    cp_async_wait<SK_STAGES - 1>();  // this lane's copies of step i
    __syncwarp();                    // and every lane's
    const uint8_t* slot = ring + (i % SK_STAGES) * SLOT;
    // this lane's 16 scales
    float sc[16];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint4 v = *reinterpret_cast<const uint4*>(slot + SK_CODE +
                                                      32 * g + 16 * h);
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        sc[8 * h + 2 * b] = scale_of(static_cast<uint16_t>(w[b]));
        sc[8 * h + 2 * b + 1] = scale_of(static_cast<uint16_t>(w[b] >> 16));
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // code rows 16 h + 2t, 2t + 1, 2t + 8, 2t + 9: the k pairs of this
      // lane's m16n8k16 fragments, biased to q + 128
      uint32_t cw[4][4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * h + 2 * t + (e & 1) + 8 * (e >> 1);
        const uint4 v = *reinterpret_cast<const uint4*>(slot + chunk_at(r, g));
        cw[e][0] = v.x ^ 0x80808080u, cw[e][1] = v.y ^ 0x80808080u;
        cw[e][2] = v.z ^ 0x80808080u, cw[e][3] = v.w ^ 0x80808080u;
      }
      uint32_t b[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint8_t* xr = slot + SK_X + (8 * nt + g) * X_LD + 32 * h + 4 * t;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(xr);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(xr + 16);
      }
      // bf16(q * s) of column cc of row e, as an f32
      auto deq = [&](int e, int cc) {
        return __fmul_rn(s8_to_f32(cw[e][cc >> 2], cc & 3), sc[cc]);
      };
      // row g of tile j is column 16 g + j, row g + 8 column 16 g + 8 + j
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        uint32_t a[4];
        a[0] = bf16x2(deq(0, j), deq(1, j));
        a[1] = bf16x2(deq(0, MT + j), deq(1, MT + j));
        a[2] = bf16x2(deq(2, j), deq(3, j));
        a[3] = bf16x2(deq(2, MT + j), deq(3, MT + j));
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma_bf16_16816(acc[j][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the rings are dead: the block's sums take their place

  // the warps' sums in warp order into one [ROWS][128] array; the
  // fragment's columns are tokens 2 t, 2 t + 1
  float* red = reinterpret_cast<float*>(dyn);
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
  for (int e = rank * SK_THREADS + threadIdx.x; e < rows * SC;
       e += ranks * SK_THREADS) {
    const int n = n0 + e % SC;
    if (n >= N) continue;
    float v = cluster.map_shared_rank(red, 0)[e];
    for (int q = 1; q < ranks; ++q)
      v = __fadd_rn(v, cluster.map_shared_rank(red, q)[e]);
    y[(size_t)(e / SC) * N + n] = v;
  }
  cluster.sync();  // no block leaves while another reads its red
}

template <int NT, bool SEL = false>
int launch_skinny(const void* x, const void* qs, const void* d, void* y,
                  int T, int K, int N, int nsplit, int split_k, int vec,
                  cudaStream_t st, const int* sel = nullptr,
                  long long qs_stride = 0, long long d_stride = 0) {
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
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, skinny_kernel<NT, SEL>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const int8_t*>(qs), static_cast<const uint16_t*>(d),
      static_cast<float*>(y), T, K, N, split_k, vec, sel, qs_stride,
      d_stride);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// ----------------------------------------------------------------- T > 32
// the Q8_0 format of the hopper_tile.cuh tile: a stage is 64 k (128 bytes
// of bf16 a row), two scale rows
struct Q8 {
  using Acc = float;
  struct Args {
    const __nv_bfloat16* x;
    const int8_t* qs;
    const uint16_t* d;
    float* y;
    int T, K, N, vec;
  };
  static constexpr int X_AHEAD = 3, R_AHEAD = 3;
  static constexpr int CODE_BYTES = 64 * tile::BN;           // [64][128]
  static constexpr int RAW_BYTES = CODE_BYTES + 2 * tile::BN * 2;  // + d

  __device__ static int steps(const Args& a) { return (a.K + 63) / 64; }

  __device__ static const void* a_chunk(const Args& a, int row, int st,
                                        int c, int& bytes) {
    const int k = 64 * st + 8 * c;
    const bool in = row < a.T && k < a.K;
    bytes = in ? 16 : 0;
    return a.x + (in ? (size_t)row * a.K + k : 0);
  }

  __device__ static void issue_raw(const Args& a, uint8_t* raw, int st,
                                   int n0, int pt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // 64 rows x 8 chunks of 16 codes
      const int id = pt + tile::PRODUCERS * i, r = id >> 3, c = id & 7;
      const int k = 64 * st + r, col = n0 + 16 * c;
      uint8_t* dst = raw + r * tile::BN + 16 * c;
      const int8_t* src = a.qs + (size_t)k * a.N + col;
      if (a.vec) {
        const bool in = col < a.N && k < a.K;
        cp_async16(smem_u32(dst), in ? src : a.qs, in ? 16 : 0);
      } else {
#pragma unroll
        for (int e = 0; e < 16; ++e)
          dst[e] = (k < a.K && col + e < a.N) ? src[e] : 0;
      }
    }
    if (pt < 32) {  // 2 scale rows x 16 chunks of 8
      const int rr = pt >> 4, c = pt & 15;
      const int sr = 2 * st + rr, col = n0 + 8 * c;
      uint8_t* dst = raw + CODE_BYTES + rr * tile::BN * 2 + 16 * c;
      const uint16_t* src = a.d + (size_t)sr * a.N + col;
      const bool rin = sr < a.K / 32;
      if (a.vec) {
        const bool in = rin && col < a.N;
        cp_async16(smem_u32(dst), in ? src : a.d, in ? 16 : 0);
      } else {
        uint16_t* dd = reinterpret_cast<uint16_t*>(dst);
#pragma unroll
        for (int e = 0; e < 8; ++e)
          dd[e] = (rin && col + e < a.N) ? src[e] : 0;
      }
    }
  }

  // items: 8 code rows x 4 columns, 256 a stage, two a thread. A warp's
  // lanes read 32 neighbouring words of a row (no bank conflict); column j
  // of an item is taken at step q = j - rot, so the 8 lanes of a store
  // phase write 8 rows n with 8 distinct n % 8 (distinct swizzled chunks)
  __device__ static void transform(const Args&, const uint8_t* raw,
                                   uint8_t* bt, int, int pt) {
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int it = pt + tile::PRODUCERS * u;
      const int cgp = it & 31, rg = it >> 5, rot = (cgp >> 1) & 3;
      uint32_t w[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        w[i] = *reinterpret_cast<const uint32_t*>(
                   raw + (8 * rg + i) * tile::BN + 4 * cgp) ^
               0x80808080u;
      const uint16_t* sc = reinterpret_cast<const uint16_t*>(
          raw + CODE_BYTES + (rg >> 2) * tile::BN * 2);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = (q + rot) & 3, n = 4 * cgp + j;
        const float s = scale_of(sc[n]);
        uint32_t o[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          o[p] = bf16x2(__fmul_rn(s8_to_f32(w[2 * p], j), s),
                        __fmul_rn(s8_to_f32(w[2 * p + 1], j), s));
        *reinterpret_cast<uint4*>(bt + sw128(n, rg)) =
            make_uint4(o[0], o[1], o[2], o[3]);
      }
    }
  }

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
};

}  // namespace

// y [T,N] f32 = x [T,K] bf16 @ dequant(qs [K,N] int8, d [K/32,N] f16 bits).
// x contiguous and 16-byte aligned, K % 32 == 0. path 0: the skinny
// kernel (T <= 32) on nsplit (1-8) clusters of split_k rows (a multiple of
// 128, nsplit = ceil(K / split_k)); path 1: the wgmma tile with bm (256 or
// 128) rows, its K split likewise (split_k a multiple of 64). vec: 1 when
// N % 16 == 0 and qs/d are 16-byte aligned (cp.async copies). sel: null,
// or (path 0, T <= 8) a device int32 index into stacked [M, K, N] planes
// that start at qs and d, matrix m at qs + m qs_stride and d + m d_stride
// bytes (with vec, both strides multiples of 16).
extern "C" int q8_0_matmul(const void* x, const void* qs, const void* d,
                           void* y, int T, int K, int N, int path,
                           int nsplit, int split_k, int bm, int vec,
                           const void* sel, long long qs_stride,
                           long long d_stride, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 1 || K % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (sel != nullptr &&
      (path != 0 || T > 8 ||
       (vec && (qs_stride % 16 != 0 || d_stride % 16 != 0))))
    return static_cast<int>(cudaErrorInvalidValue);
  if (path == 0) {
    if (T > 32 || nsplit < 1 || nsplit > SK_MAX_CLUSTER ||
        split_k % 128 != 0 || (long long)nsplit * split_k < K ||
        (long long)(nsplit - 1) * split_k >= K)
      return static_cast<int>(cudaErrorInvalidValue);
    if (sel != nullptr)
      return launch_skinny<1, true>(x, qs, d, y, T, K, N, nsplit, split_k,
                                    vec, st, static_cast<const int*>(sel),
                                    qs_stride, d_stride);
    if (T <= 8)
      return launch_skinny<1>(x, qs, d, y, T, K, N, nsplit, split_k, vec, st);
    if (T <= 16)
      return launch_skinny<2>(x, qs, d, y, T, K, N, nsplit, split_k, vec, st);
    return launch_skinny<4>(x, qs, d, y, T, K, N, nsplit, split_k, vec, st);
  }
  Q8::Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.qs = static_cast<const int8_t*>(qs);
  a.d = static_cast<const uint16_t*>(d);
  a.y = static_cast<float*>(y);
  a.T = T, a.K = K, a.N = N, a.vec = vec;
  if (nsplit < 1 || nsplit > SK_MAX_CLUSTER || split_k % 64 != 0 ||
      (long long)nsplit * split_k < K ||
      (long long)(nsplit - 1) * split_k >= K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 256)
    return tile::launch<Q8, 2>(a, T, N, nsplit, split_k / 64, false, st);
  if (bm == 128)
    return tile::launch<Q8, 1>(a, T, N, nsplit, split_k / 64, false, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
