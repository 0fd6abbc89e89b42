// Fused Q8_0 dequant-matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/matmul.py::
// _quant_matmul_impl with its _q8_0_tile body (entry quant_matmul_pallas,
// reached from ops/linear.py::qmatmul): fused QKV, wo, fused gate|up, down
// and the LM head, at T = 1 (decode) and at prefill T.
//
// What it computes. y[T,N] f32 = x[T,K] @ W with W[k,n] = bf16(qs[k,n] *
// d[k/32,n]): qs int8 [K,N] (N contiguous), d the raw f16 bits of the block
// scales [K/32,N], x bf16 [T,K]. This is exactly the TPU kernel at its
// default dot precision (operands rounded to bf16, f32 accumulation) and the
// JAX CPU path (ops/linear.py: bf16 dequant, bf16 activations, f32 dot).
// The product of two bf16 values is exact in f32, so the kernel and its
// plain twin differ only in the order of the f32 sums.
//
// What bounds it on the H100. At T = 1 it streams 1.0625 bytes per weight
// once: bytes over 3.35 TB/s (fused gate|up of an 8B model, K=4096 x
// N=28672, ~125 MB: ~37 us). At prefill T it is bound by operations: 2*T*K*N
// on the bf16 tensor cores (989 TFLOP/s), plus the dequant of every weight
// once per 64-row tile of x.
//
// What the simple design does about it.
//  * T == 1: q8_gemv_kernel. Each lane owns 16 neighbouring columns and
//    reads one 16-byte row segment of qs per k (a warp covers 512 contiguous
//    bytes: coalesced), with the 16 scales of its columns loaded once per
//    32-row block. Four warps share a column strip and take interleaved
//    32-row blocks. With N=4096 there are only 8 such strips for 132 SMs, so
//    K is split across blocks (split-K) and a second kernel sums the partial
//    rows in a fixed order: no atomics, runs repeat bit for bit.
//  * T > 1: q8_mma_kernel. 64x128 output tiles, K stepped 32 rows at a time
//    (one Q8_0 block row). Each step stages x in shared memory, dequantizes
//    the 32x128 weight tile to bf16 into shared memory (transposed, with an
//    XOR swizzle that keeps both the stores and the fragment reads free of
//    bank conflicts), and runs mma.sync m16n8k16 bf16 -> f32 on the tensor
//    cores. No TMA, wgmma or pipelining yet: that is later work.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float scale_of(uint16_t bits) {
  return __half2float(__ushort_as_half(bits));
}

// bf16(q * s), returned as the exact f32 value of that bf16
__device__ __forceinline__ float dequant(int8_t q, float s) {
  return __bfloat162float(__float2bfloat16_rn(static_cast<float>(q) * s));
}

// ---------------------------------------------------------------- T == 1
constexpr int GV_WARPS = 4;
constexpr int GV_COLS = 16;                  // columns per lane
constexpr int GV_BLOCK_COLS = 32 * GV_COLS;  // 512 columns per block

__global__ void __launch_bounds__(GV_WARPS * 32)
q8_gemv_kernel(const __nv_bfloat16* __restrict__ x,
               const int8_t* __restrict__ qs, const uint16_t* __restrict__ d,
               float* __restrict__ out, int K, int N, int groups_per_split,
               int vec) {
  __shared__ float red[GV_WARPS][GV_BLOCK_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * GV_BLOCK_COLS + lane * GV_COLS;
  const int n_groups = K / 32;
  const int g_begin = blockIdx.y * groups_per_split;
  const int g_end = min(g_begin + groups_per_split, n_groups);
  const bool full = vec && (c0 + GV_COLS <= N);

  float acc[GV_COLS];
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) acc[j] = 0.f;

  for (int g = g_begin + warp; g < g_end; g += GV_WARPS) {
    const float xv = __bfloat162float(x[g * 32 + lane]);
    float s[GV_COLS];
    if (full) {
      const uint4* dp = reinterpret_cast<const uint4*>(d + (size_t)g * N + c0);
      const uint4 sa = __ldg(dp);
      const uint4 sb = __ldg(dp + 1);
      const uint16_t* ha = reinterpret_cast<const uint16_t*>(&sa);
      const uint16_t* hb = reinterpret_cast<const uint16_t*>(&sb);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j] = scale_of(ha[j]);
        s[j + 8] = scale_of(hb[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j)
        s[j] = (c0 + j < N) ? scale_of(d[(size_t)g * N + c0 + j]) : 0.f;
    }
#pragma unroll 8
    for (int r = 0; r < 32; ++r) {
      const float xr = __shfl_sync(0xffffffffu, xv, r);
      const size_t row = (size_t)(g * 32 + r) * N;
      if (full) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(qs + row + c0));
        const int8_t* q = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
        for (int j = 0; j < GV_COLS; ++j)
          acc[j] = fmaf(xr, dequant(q[j], s[j]), acc[j]);
      } else {
#pragma unroll
        for (int j = 0; j < GV_COLS; ++j)
          if (c0 + j < N)
            acc[j] = fmaf(xr, dequant(qs[row + c0 + j], s[j]), acc[j]);
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
constexpr int MM_BK = 32;
constexpr int MM_LDS = MM_BK + 8;  // smem row stride (bf16): 20 words

// Bs[n][k] column swizzle: XOR k with 4 * ((n / 16) % 8). Keeps (k, k+1)
// pairs adjacent and makes both the dequant stores and the fragment loads
// conflict-free.
__device__ __forceinline__ int swz(int n, int k) {
  return k ^ (((n >> 4) & 7) << 2);
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

__global__ void __launch_bounds__(128)
q8_mma_kernel(const __nv_bfloat16* __restrict__ x,
              const int8_t* __restrict__ qs, const uint16_t* __restrict__ d,
              float* __restrict__ y, int T, int K, int N, int vec) {
  __shared__ __align__(16) __nv_bfloat16 As[MM_BM][MM_LDS];
  __shared__ __align__(16) __nv_bfloat16 Bs[MM_BN][MM_LDS];  // [n][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;

  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    // x tile: 64 rows x 32 bf16, as 256 chunks of 8
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, row = c >> 2, col = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < T)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 +
                                            col);
      *reinterpret_cast<uint4*>(&As[row][col]) = v;
    }
    // weight tile: 32 rows x 128 int8, as 256 chunks of 16 columns,
    // dequantized to bf16 and stored transposed
    const size_t drow = (size_t)(k0 / 32) * N;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, row = c >> 3, col = (c & 7) * 16;
      const int n = n0 + col;
      const size_t qrow = (size_t)(k0 + row) * N;
      if (vec && n + 16 <= N) {
        const int4 v = __ldg(reinterpret_cast<const int4*>(qs + qrow + n));
        const uint4* dp = reinterpret_cast<const uint4*>(d + drow + n);
        const uint4 sa = __ldg(dp);
        const uint4 sb = __ldg(dp + 1);
        const int8_t* q = reinterpret_cast<const int8_t*>(&v);
        const uint16_t* ha = reinterpret_cast<const uint16_t*>(&sa);
        const uint16_t* hb = reinterpret_cast<const uint16_t*>(&sb);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const float s = scale_of(j < 8 ? ha[j] : hb[j - 8]);
          Bs[col + j][swz(col + j, row)] =
              __float2bfloat16_rn(static_cast<float>(q[j]) * s);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          float w = 0.f;
          if (n + j < N)
            w = static_cast<float>(qs[qrow + n + j]) *
                scale_of(d[drow + n + j]);
          Bs[col + j][swz(col + j, row)] = __float2bfloat16_rn(w);
        }
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

}  // namespace

// y [T,N] f32 = x [T,K] bf16 @ dequant(qs [K,N] int8, d [K/32,N] f16 bits).
// work: [nsplit, N] f32 scratch when T == 1 and nsplit > 1, else unused.
// vec: 1 when N % 16 == 0 and qs/d are 16-byte aligned (vector loads).
extern "C" int q8_0_matmul(const void* x, const void* qs, const void* d,
                           void* y, void* work, int T, int K, int N,
                           int nsplit, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(x);
  const int8_t* q = static_cast<const int8_t*>(qs);
  const uint16_t* s = static_cast<const uint16_t*>(d);
  float* out = static_cast<float*>(y);
  if (T == 1) {
    const int n_groups = K / 32;
    const int gps = (n_groups + nsplit - 1) / nsplit;
    const dim3 grid((N + GV_BLOCK_COLS - 1) / GV_BLOCK_COLS, nsplit);
    float* part = nsplit > 1 ? static_cast<float*>(work) : out;
    q8_gemv_kernel<<<grid, GV_WARPS * 32, 0, st>>>(xb, q, s, part, K, N, gps,
                                                   vec);
    if (nsplit > 1)
      splitk_reduce_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, out, nsplit,
                                                            N);
  } else {
    const dim3 grid((N + MM_BN - 1) / MM_BN, (T + MM_BM - 1) / MM_BM);
    q8_mma_kernel<<<grid, 128, 0, st>>>(xb, q, s, out, T, K, N, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
