// W8A8 int8 serving matmul for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/w8a8.py::_w8a8_impl
// (entry w8a8_matmul_pallas, reached from ops/linear.py::qmatmul): every
// product of a model requantized with --w8a8, at any row count up to 2048
// (decode at B = 1, batched steps, verify windows, 512-token prefill
// chunks).
//
// What it computes. y[t,n] f32 = (f32(P[t,n]) * am[t]) * s[n] with
// P = a[t,:] . q[:,n] the exact int32 dot of the row-quantized activation
// codes a int8 [T,K] and the per-column weight codes q int8 [K,N] (N
// contiguous), am f32 [T] the row scales and s f32 [N] the column scales.
// |P| <= 127 * 127 * K < 2^31 for K <= 133,000, so the dot is exact in any
// order; its conversion to f32 rounds to nearest even (as the plain twin's
// float64 sum does), and the two multiplies of the fixup round in the
// golden's order (core/w8a8.py), with explicit _rn intrinsics so nothing
// contracts. The kernel is therefore bit-equal to its plain twin.
//
// What bounds it on the H100. Bytes at small T: q is read once, one byte a
// weight (fused gate|up of an 8B model, K 4096 x N 28672, 117.4 MB: 35 us
// at 3.35 TB/s). At T = 512 the 120 GOP of the same product take 61 us on
// the int8 tensor cores (1,979 TOP/s), so large T is bound by operations.
//
// What the simple design does about it. Both paths need 4 consecutive K
// bytes of one column in a 32-bit word (dp4a and mma.sync's s8 fragments),
// while the plane is N-minor: a thread loads 16-byte row segments of 4 K
// rows and transposes the 4 x 4 byte blocks with __byte_perm (ldmatrix.trans
// does not transpose 8-bit data).
//  * T == 1: w8_gemv_kernel. Each lane owns 16 neighbouring columns (a warp
//    reads 512 contiguous bytes of a row) and accumulates 4 rows per dp4a.
//    Four warps share a column strip and interleave 4-row steps; K is split
//    across blocks to cover the SMs, the warps' int32 partials are summed
//    in shared memory and the splits' in a second pass: integer sums, so
//    the result is the same in any order and runs repeat bit for bit.
//  * T > 1: w8_mma_kernel. 64x128 output tiles, K stepped 64 at a time,
//    activations and transposed weights staged in shared memory, and
//    mma.sync m16n8k32 s8 x s8 -> s32 on the tensor cores; the fixup is the
//    epilogue. No TMA, wgmma or pipelining yet: that is later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// column j of 4 row words r[0..3] (4 columns each): the 4 row bytes of that
// column, first row in the low byte
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

// word b (columns 4b .. 4b + 3) of a 16-byte row segment
__device__ __forceinline__ uint32_t word(const uint4& v, int b) {
  return b == 0 ? v.x : b == 1 ? v.y : b == 2 ? v.z : v.w;
}

// 16 bytes of a q row from column c0, zero beyond N
__device__ __forceinline__ uint4 ld_row16(const int8_t* __restrict__ row,
                                          int c0, int N, bool full) {
  if (full) return __ldg(reinterpret_cast<const uint4*>(row + c0));
  union {
    uint4 v;
    int8_t b[16];
  } u;
#pragma unroll
  for (int j = 0; j < 16; ++j) u.b[j] = (c0 + j < N) ? row[c0 + j] : 0;
  return u.v;
}

// the 16 column words (4 rows each) of rows [k, k + 4) x columns
// [c0, c0 + 16)
__device__ __forceinline__ void col_words(const int8_t* __restrict__ q,
                                          int k, int c0, int N, bool full,
                                          uint32_t (&w)[16]) {
  uint4 v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = ld_row16(q + (size_t)(k + i) * N, c0, N,
                                              full);
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const uint32_t r[4] = {word(v[0], b), word(v[1], b), word(v[2], b),
                           word(v[3], b)};
    uint32_t c[4];
    transpose4(r, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) w[4 * b + j] = c[j];
  }
}

__device__ __forceinline__ float fixup(int p, float am, float s) {
  return __fmul_rn(__fmul_rn(__int2float_rn(p), am), s);
}

// ---------------------------------------------------------------- T == 1
constexpr int GV_WARPS = 4;
constexpr int GV_COLS = 16;                  // columns per lane
constexpr int GV_BLOCK_COLS = 32 * GV_COLS;  // 512 columns per block

// blockIdx.y takes rows [y * split_rows, (y + 1) * split_rows). With one
// split the block writes y; otherwise int32 partials [nsplit, N] to part.
__global__ void __launch_bounds__(GV_WARPS * 32)
w8_gemv_kernel(const int8_t* __restrict__ a, const float* __restrict__ am,
               const int8_t* __restrict__ q, const float* __restrict__ s,
               float* __restrict__ y, int* __restrict__ part, int K, int N,
               int split_rows, int vec) {
  __shared__ int red[GV_WARPS][GV_BLOCK_COLS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * GV_BLOCK_COLS + lane * GV_COLS;
  const int k_begin = blockIdx.y * split_rows;
  const int k_end = min(k_begin + split_rows, K);
  const bool full = vec && (c0 + GV_COLS <= N);

  int acc[GV_COLS];
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) acc[j] = 0;
  if (c0 < N) {
#pragma unroll 4
    for (int k = k_begin + 4 * warp; k < k_end; k += 4 * GV_WARPS) {
      const int av = __ldg(reinterpret_cast<const int*>(a + k));
      uint32_t w[16];
      col_words(q, k, c0, N, full, w);
#pragma unroll
      for (int j = 0; j < GV_COLS; ++j)
        acc[j] = __dp4a(static_cast<int>(w[j]), av, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < GV_COLS; ++j) red[warp][lane * GV_COLS + j] = acc[j];
  __syncthreads();
  const float a_scale = am[0];
  for (int c = threadIdx.x; c < GV_BLOCK_COLS; c += blockDim.x) {
    const int n = blockIdx.x * GV_BLOCK_COLS + c;
    if (n >= N) continue;
    int t = 0;
#pragma unroll
    for (int w = 0; w < GV_WARPS; ++w) t += red[w][c];
    if (gridDim.y == 1)
      y[n] = fixup(t, a_scale, s[n]);
    else
      part[(size_t)blockIdx.y * N + n] = t;
  }
}

__global__ void w8_splitk_kernel(const int* __restrict__ part,
                                 const float* __restrict__ am,
                                 const float* __restrict__ s,
                                 float* __restrict__ y, int nsplit, int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  int t = 0;
  for (int i = 0; i < nsplit; ++i) t += part[(size_t)i * N + n];
  y[n] = fixup(t, am[0], s[n]);
}

// ----------------------------------------------------------------- T > 1
constexpr int MM_BM = 64;
constexpr int MM_BN = 128;
constexpr int MM_BK = 64;            // K bytes per step: two k32 mma steps
constexpr int MM_LDS = MM_BK + 16;   // smem row stride in bytes: 20 words

__device__ __forceinline__ uint32_t ld32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(128)
w8_mma_kernel(const int8_t* __restrict__ a, const float* __restrict__ am,
              const int8_t* __restrict__ q, const float* __restrict__ s,
              float* __restrict__ y, int T, int K, int N, int vec) {
  __shared__ __align__(16) int8_t As[MM_BM][MM_LDS];  // [m][k]
  __shared__ __align__(16) int8_t Bs[MM_BN][MM_LDS];  // [n][k]
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 64;
  const int m0 = blockIdx.y * MM_BM, n0 = blockIdx.x * MM_BN;

  int acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0;

  // this thread's B piece: K rows [4 kg, 4 kg + 4) x columns [16 cc, +16)
  const int kg = tid & 15, cc = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += MM_BK) {
    // activation tile: 64 rows x 64 bytes, as 256 chunks of 16 (K % 16 == 0)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, row = c >> 2, col = (c & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < T && k0 + col < K)
        v = __ldg(reinterpret_cast<const uint4*>(a + (size_t)(m0 + row) * K +
                                                 k0 + col));
      *reinterpret_cast<uint4*>(&As[row][col]) = v;
    }
    // weight tile: 64 K rows x 128 columns, transposed to [n][k] words
    {
      const int k = k0 + 4 * kg, n = n0 + 16 * cc;
      uint32_t w[16];
      if (k < K && n < N) {
        col_words(q, k, n, N, vec && n + 16 <= N, w);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j) w[j] = 0u;
      }
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<uint32_t*>(&Bs[16 * cc + j][4 * kg]) = w[j];
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < MM_BK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + g;
        af[mt][0] = ld32(&As[r][ks + 4 * t4]);
        af[mt][1] = ld32(&As[r + 8][ks + 4 * t4]);
        af[mt][2] = ld32(&As[r][ks + 16 + 4 * t4]);
        af[mt][3] = ld32(&As[r + 8][ks + 16 + 4 * t4]);
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int cn = wn + nt * 8 + g;
        const uint32_t b0 = ld32(&Bs[cn][ks + 4 * t4]);
        const uint32_t b1 = ld32(&Bs[cn][ks + 16 + 4 * t4]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = m0 + wm + mt * 16 + g;
    const float a0 = r < T ? am[r] : 0.f;
    const float a8 = r + 8 < T ? am[r + 8] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int c = n0 + wn + nt * 8 + 2 * t4;
      if (r < T) {
        if (c < N) y[(size_t)r * N + c] = fixup(acc[mt][nt][0], a0, s[c]);
        if (c + 1 < N)
          y[(size_t)r * N + c + 1] = fixup(acc[mt][nt][1], a0, s[c + 1]);
      }
      if (r + 8 < T) {
        if (c < N)
          y[(size_t)(r + 8) * N + c] = fixup(acc[mt][nt][2], a8, s[c]);
        if (c + 1 < N)
          y[(size_t)(r + 8) * N + c + 1] = fixup(acc[mt][nt][3], a8, s[c + 1]);
      }
    }
  }
}

}  // namespace

// y [T,N] f32 = fixup(a [T,K] int8 . q [K,N] int8) with am [T] and s [N]
// f32. work: [nsplit, N] int32 scratch when T == 1 and nsplit > 1.
// split_rows: K rows per split at T == 1 (a multiple of 4). vec: 1 when
// N % 16 == 0 and q is 16-byte aligned. K % 16 == 0.
extern "C" int w8a8_matmul(const void* a, const void* am, const void* q,
                           const void* s, void* y, void* work, int T, int K,
                           int N, int split_rows, int nsplit, int vec,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* ap = static_cast<const int8_t*>(a);
  const float* amp = static_cast<const float*>(am);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(s);
  float* out = static_cast<float*>(y);
  if (T == 1) {
    const dim3 grid((N + GV_BLOCK_COLS - 1) / GV_BLOCK_COLS, nsplit);
    int* part = static_cast<int*>(work);
    w8_gemv_kernel<<<grid, GV_WARPS * 32, 0, st>>>(ap, amp, qp, sp, out,
                                                   part, K, N, split_rows,
                                                   vec);
    if (nsplit > 1)
      w8_splitk_kernel<<<(N + 255) / 256, 256, 0, st>>>(part, amp, sp, out,
                                                        nsplit, N);
  } else {
    const dim3 grid((N + MM_BN - 1) / MM_BN, (T + MM_BM - 1) / MM_BM);
    w8_mma_kernel<<<grid, 128, 0, st>>>(ap, amp, qp, sp, out, T, K, N, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
