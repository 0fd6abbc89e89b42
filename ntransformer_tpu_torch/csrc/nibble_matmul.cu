// Fused dequant-matmul of the engine-native W4A8 format at T > 1 for Hopper
// (sm_90a), plain C interface: entry w4a8_matmul. (The GGUF nibble formats
// Q4_0, Q4_K, Q5_K and Q6_K are kquant_matmul.cu; W4A8's T = 1 product,
// which quantizes the activations, is w4a8_decode.cu.)
//
// Plane layout (core/layout.py): transposed planes, N contiguous. Nibble
// plane row r (split unit 512) holds element 512 (r / 256) + r % 256 in its
// low nibble and that element + 256 in its high nibble; s_lo / m_lo (low
// nibble) and s_hi / m_hi (high) f32 row r / 256.
//
// What bounds it on the H100: operations, 2 T K N on the bf16 tensor cores
// (989 TFLOP/s; the fused gate|up of an 8B model at T = 512, 120 GFLOP:
// 0.122 ms), plus the dequant of every weight once per 128- or 256-row
// tile of x.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// ------------------------------------------------------------ W4A8, T > 1
// Replaces ntransformer_tpu/ops/pallas/matmul.py::_w4a8_tile (via
// _quant_matmul_impl). y[T,N] f32 = bf16(x)[T,K] @ W, W[k,n] = bf16(nib * s
// - m) with the multiply and the subtraction rounded apart, as the plain
// dequant. Bound by operations: 2 T K N at 989 TFLOP/s. A block computes a
// BM x BN tile of y (256 x 128, 128 x 256 or 128 x 128: the wrapper takes
// the first that gives at least half the SMs a block) with three
// warpgroups:
//  * two consumers of BM / 2 rows (MW = BM / 128 m64 tiles) each: each
//    copies its rows of the x tile with cp.async and issues wgmma
//    m64nBNk16 (bf16 -> f32), A (the x tile) and B (the dequantized weight
//    tile) both read by the tensor cores from shared memory in the
//    128-byte-swizzled K-major layout; one wgmma batch stays in flight
//    while the next is issued;
//  * one producer: copies the raw codes (and, at a pair's first stage, the
//    pair's four scale rows) with cp.async and dequantizes them into a ring
//    of 3 B tiles with 16-byte stores in the consumers' layout, each weight
//    once for BM rows of x (at T = 512, twice in all with 256-row tiles).
// A stage is 32 plane rows: 64 k-elements, the low nibbles' 32 and the high
// nibbles' 32 (256 elements on in x). Named barriers hand the B tiles over:
// FULL[s % 3] (the producer arrives when tile s is written, the consumers
// wait) and EMPTY[s % 3] (the consumers arrive when the wgmma of stage s is
// done, the producer waits before it rewrites that tile for stage s + 3).
// The scales of a pair are read from shared memory once per 256 plane rows
// and held in registers for the pair's 8 stages.
namespace w4 {
constexpr int ROWS = 32;         // plane rows per stage
constexpr int B_SLOTS = 3;       // dequantized tiles
constexpr int R_AHEAD = 3;       // raw-code stages in flight (producer)
constexpr int RAW_SLOTS = R_AHEAD + 1;
constexpr int CONSUMERS = 256, PRODUCERS = 128;
constexpr int THREADS = CONSUMERS + PRODUCERS;
// named barrier ids (0 is __syncthreads)
constexpr int BAR_FULL = 1, BAR_EMPTY = 4, BAR_PROD = 7;

// MW m64 row tiles per consumer (BM = 128 MW rows) by BN columns
template <int MW, int BN>
struct Smem {
  static constexpr int BM = 128 * MW;
  static constexpr int A_BYTES = BM * 128;     // [BM][64] bf16
  static constexpr int X_AHEAD = MW == 1 ? 4 : 3;  // x stages in flight
  static constexpr int A_SLOTS = X_AHEAD + 1;
  static constexpr int B_BYTES = BN * 128;     // [BN][64] bf16
  static constexpr int RAW_BYTES = ROWS * BN;  // codes [32][BN]
  static constexpr int SC_BYTES = 4 * BN * 4;  // s_lo, s_hi, m_lo, m_hi
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = A_OFF + A_SLOTS * A_BYTES;
  static constexpr int RAW_OFF = B_OFF + B_SLOTS * B_BYTES;
  static constexpr int SC_OFF = RAW_OFF + RAW_SLOTS * RAW_BYTES;
  static constexpr int BYTES = SC_OFF + 2 * SC_BYTES + 1024;  // + alignment
};

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, the tail past src_bytes zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
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

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the tensor cores' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma matrix descriptor of a K-major tile with 128-byte swizzle: rows of
// 128 bytes, 8-row atoms 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// byte offset of 16-byte chunk c of row r in a 128-byte-swizzled tile
__device__ __forceinline__ int sw128(int r, int c) {
  return r * 128 + ((c ^ (r & 7)) << 4);
}

__device__ __forceinline__ void wgmma_m64n256(float (&d)[128], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_m64n128(float (&d)[64], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

template <int BN>
__device__ __forceinline__ void wgmma_tile(float (&d)[BN / 2], uint64_t da,
                                           uint64_t db) {
  if constexpr (BN == 256)
    wgmma_m64n256(d, da, db);
  else
    wgmma_m64n128(d, da, db);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// fl(q * s) for a nibble q given as the f32 2^23 + q (its bits 0x4B00000q)
// and c = -2^23 * s (exact): one fma rounds (2^23 + q) s - 2^23 s = q s once
__device__ __forceinline__ float nib_mul(uint32_t magic, float s, float c) {
  return __fmaf_rn(__uint_as_float(magic), s, c);
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// what a block's warpgroups share
struct Job {
  const __nv_bfloat16* x;
  const uint8_t* qs;
  const float *s_lo, *s_hi, *m_lo, *m_hi;
  float* y;
  int T, K, N, vec;
  uint8_t* sm;    // the block's 1024-byte-aligned shared memory
  uint32_t base;  // its shared-memory address
  int m0, n0, steps;
};

// the producer warpgroup (thread pt of 128)
template <int MW, int BN>
__device__ __forceinline__ void produce(const Job& job, int pt) {
  using L = Smem<MW, BN>;
  const int steps = job.steps, N = job.N, n0 = job.n0;
  uint8_t* sm = job.sm;
  // raw codes of stage st (and the pair's scale rows at its first stage)
  auto issue = [&](int st) {
    if (st < steps) {
      uint8_t* raw = sm + L::RAW_OFF + (st % RAW_SLOTS) * L::RAW_BYTES;
      constexpr int CPR = BN / 16;  // 16-byte chunks per code row
      for (int id = pt; id < ROWS * CPR; id += PRODUCERS) {
        const int r = id / CPR, c = id % CPR, col = n0 + 16 * c;
        const uint8_t* src = job.qs + (size_t)(ROWS * st + r) * N + col;
        uint8_t* dst = raw + r * BN + 16 * c;
        if (job.vec) {
          const bool in = col < N;  // N % 16 == 0: whole chunks
          cp_async16(smem_u32(dst), in ? src : job.qs, in ? 16 : 0);
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) dst[e] = col + e < N ? src[e] : 0;
        }
      }
      if ((st & 7) == 0) {
        const int pair = st >> 3;
        float* sc = reinterpret_cast<float*>(sm + L::SC_OFF +
                                             (pair & 1) * L::SC_BYTES);
        constexpr int CPP = BN / 4;  // 16-byte chunks per plane row
        for (int id = pt; id < 4 * CPP; id += PRODUCERS) {
          const int pl = id / CPP, c = id % CPP, col = n0 + 4 * c;
          const float* plane =
              pl == 0 ? job.s_lo
                      : (pl == 1 ? job.s_hi : (pl == 2 ? job.m_lo : job.m_hi));
          const float* src = plane + (size_t)pair * N + col;
          float* dst = sc + pl * BN + 4 * c;
          if (job.vec) {
            const bool in = col < N;
            cp_async16(smem_u32(dst), in ? src : job.s_lo, in ? 16 : 0);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dst[e] = col + e < N ? src[e] : 0.f;
          }
        }
      }
    }
    cp_async_commit();
  };

  // dequant items: plane rows [8 rg, 8 rg + 8) of a stage x CPI columns
  // from CPI cg, 256 a stage, two a thread. Each writes 2 CPI chunks of
  // 8 bf16 (per column its low and its high nibbles' k-elements). Column
  // j of an item is taken at step q = j - rot: the 8 lanes of a store
  // phase then write 8 rows n with 8 distinct n % 8, so the swizzled
  // chunks fall in 8 distinct bank groups.
  constexpr int CPI = BN / 64;  // columns per item: 4 or 2
  constexpr int G = 8 / CPI;    // lanes whose columns cover n % 8 = 0..7
  constexpr int ITEMS = 256 / PRODUCERS;
  int cg[ITEMS], rg[ITEMS], rot[ITEMS];
#pragma unroll
  for (int u = 0; u < ITEMS; ++u) {
    const int it = pt + PRODUCERS * u;
    cg[u] = it % (BN / CPI);
    rg[u] = it / (BN / CPI);
    rot[u] = (cg[u] / G) % CPI;
  }
  // slot q of item u: column CPI cg + (q + rot) % CPI; cl / ch = -2^23
  // sl / sh
  float sl[ITEMS][CPI], sh[ITEMS][CPI], ml[ITEMS][CPI], mh[ITEMS][CPI],
      cl[ITEMS][CPI], ch[ITEMS][CPI];

#pragma unroll
  for (int st = 0; st < R_AHEAD; ++st) issue(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<R_AHEAD - 1>();  // this thread's copies of stage st
    // every producer's copies of stage st have landed, and every
    // producer is done with stage st - 1, whose raw slot is reused next
    bar_sync(BAR_PROD, PRODUCERS);
    issue(st + R_AHEAD);
    if (st >= B_SLOTS)  // the wgmma of stage st - 3 is done with its tile
      bar_sync(BAR_EMPTY + st % B_SLOTS, THREADS);
    if ((st & 7) == 0) {
      const float* sc = reinterpret_cast<const float*>(
          sm + L::SC_OFF + ((st >> 3) & 1) * L::SC_BYTES);
#pragma unroll
      for (int u = 0; u < ITEMS; ++u)
#pragma unroll
        for (int q = 0; q < CPI; ++q) {
          const int n = CPI * cg[u] + (q + rot[u]) % CPI;
          sl[u][q] = sc[n];
          sh[u][q] = sc[BN + n];
          ml[u][q] = sc[2 * BN + n];
          mh[u][q] = sc[3 * BN + n];
          cl[u][q] = -8388608.f * sl[u][q];
          ch[u][q] = -8388608.f * sh[u][q];
        }
    }
    const uint8_t* raw = sm + L::RAW_OFF + (st % RAW_SLOTS) * L::RAW_BYTES;
    uint8_t* bt = sm + L::B_OFF + (st % B_SLOTS) * L::B_BYTES;
#pragma unroll
    for (int u = 0; u < ITEMS; ++u) {
      // the low and the high nibbles of the item's columns in each row
      uint32_t wl[8], wh[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const uint8_t* row = raw + (8 * rg[u] + i) * BN + CPI * cg[u];
        const uint32_t w =
            CPI == 4 ? *reinterpret_cast<const uint32_t*>(row)
                     : *reinterpret_cast<const uint16_t*>(row);
        wl[i] = w & 0x0F0F0F0Fu;
        wh[i] = (w >> 4) & 0x0F0F0F0Fu;
      }
#pragma unroll
      for (int q = 0; q < CPI; ++q) {
        const int j = (q + rot[u]) % CPI, n = CPI * cg[u] + j;
        // byte j of a nibble word into the mantissa of 0x4B000000
        const uint32_t sel = 0x7440u | j;
        uint32_t lo[4], hi[4];
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          float vl[2], vh[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const uint32_t ql =
                __byte_perm(wl[2 * p + e], 0x4B000000u, sel);
            const uint32_t qh =
                __byte_perm(wh[2 * p + e], 0x4B000000u, sel);
            // two roundings, in the plain dequant's order
            vl[e] = __fsub_rn(nib_mul(ql, sl[u][q], cl[u][q]), ml[u][q]);
            vh[e] = __fsub_rn(nib_mul(qh, sh[u][q], ch[u][q]), mh[u][q]);
          }
          lo[p] = bf16x2(vl[0], vl[1]);
          hi[p] = bf16x2(vh[0], vh[1]);
        }
        *reinterpret_cast<uint4*>(bt + sw128(n, rg[u])) =
            make_uint4(lo[0], lo[1], lo[2], lo[3]);
        *reinterpret_cast<uint4*>(bt + sw128(n, 4 + rg[u])) =
            make_uint4(hi[0], hi[1], hi[2], hi[3]);
      }
    }
    fence_proxy_async();
    bar_arrive(BAR_FULL + st % B_SLOTS, THREADS);
  }
  cp_async_wait<0>();
}

// a consumer warpgroup (wg 0 or 1; thread ct of its 128)
template <int MW, int BN>
__device__ __forceinline__ void consume(const Job& job, int wg, int ct) {
  using L = Smem<MW, BN>;
  constexpr int A_BYTES = L::A_BYTES, A_SLOTS = L::A_SLOTS;
  constexpr int X_AHEAD = L::X_AHEAD;
  const int steps = job.steps, T = job.T, K = job.K, N = job.N;
  const int m0 = job.m0, n0 = job.n0;
  const uint32_t base = job.base;
  // this warpgroup's 64 MW rows of the x tile of stage st
  auto issue_x = [&](int st) {
    if (st < steps) {
      const int pair = st >> 3, j0 = 32 * (st & 7);
      const uint32_t a = base + L::A_OFF + (st % A_SLOTS) * A_BYTES;
#pragma unroll
      for (int i = 0; i < 4 * MW; ++i) {  // 64 MW rows x 8 chunks of 8
        const int id = ct + 128 * i, r = 64 * MW * wg + (id >> 3);
        const int c = id & 7;
        // 4 low-nibble chunks, then 4 high-nibble chunks 256 elements on
        const int e = 512 * pair + j0 + (c < 4 ? 8 * c : 256 + 8 * (c - 4));
        const bool in = m0 + r < T;
        cp_async16(a + sw128(r, c),
                   job.x + (size_t)(in ? m0 + r : 0) * K + e, in ? 16 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[MW][BN / 2];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[mi][i] = 0.f;

#pragma unroll
  for (int st = 0; st < X_AHEAD; ++st) issue_x(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<X_AHEAD - 1>();  // this thread's x chunks of stage st
    fence_proxy_async();
    // the B tile of stage st is written and every consumer's x is in
    bar_sync(BAR_FULL + st % B_SLOTS, THREADS);
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) fence_regs(acc[mi]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t a = base + L::A_OFF + (st % A_SLOTS) * A_BYTES +
                       MW * wg * 64 * 128;
    const uint32_t b = base + L::B_OFF + (st % B_SLOTS) * L::B_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // k16 slices: 32 bytes on
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
        wgmma_tile<BN>(acc[mi], desc_sw128(a + mi * 64 * 128 + 32 * kk),
                       desc_sw128(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the batch of stage st stays in flight; that of st - 1 is done
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) fence_regs(acc[mi]);
    if (st >= 1 && st - 1 + B_SLOTS < steps)
      bar_arrive(BAR_EMPTY + (st - 1) % B_SLOTS, THREADS);
    // stage st - 1's x slot is free in this warpgroup: its rows are read
    // by this warpgroup's wgmma alone
    issue_x(st + X_AHEAD);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) fence_regs(acc[mi]);
  cp_async_wait<0>();

  // accumulator fragment: warp w of the warpgroup holds rows 16 w + lane/4
  // (+ 8) of each m64 tile, register i column 8 (i / 4) + 2 (lane % 4) +
  // i % 2
  const int lane = ct & 31, wq = ct >> 5;
  const bool pairs_ok = (N & 1) == 0;
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int r0 = m0 + 64 * (MW * wg + mi) + 16 * wq + (lane >> 2);
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1);
      const int c = n0 + 8 * (i >> 2) + 2 * (lane & 3);
      if (r >= T) continue;
      float* dst = job.y + (size_t)r * N + c;
      if (pairs_ok && c + 1 < N) {
        *reinterpret_cast<float2*>(dst) =
            make_float2(acc[mi][i], acc[mi][i + 1]);
      } else {
        if (c < N) dst[0] = acc[mi][i];
        if (c + 1 < N) dst[1] = acc[mi][i + 1];
      }
    }
  }
}

template <int MW, int BN>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ qs, const float* __restrict__ s_lo,
            const float* __restrict__ s_hi, const float* __restrict__ m_lo,
            const float* __restrict__ m_hi, float* __restrict__ y, int T,
            int K, int N, int vec) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  Job job;
  job.x = x;
  job.qs = qs;
  job.s_lo = s_lo;
  job.s_hi = s_hi;
  job.m_lo = m_lo;
  job.m_hi = m_hi;
  job.y = y;
  job.T = T;
  job.K = K;
  job.N = N;
  job.vec = vec;
  job.sm = smem_raw + (((raw0 + 1023) & ~1023u) - raw0);
  job.base = smem_u32(job.sm);
  job.m0 = blockIdx.x * Smem<MW, BN>::BM;
  job.n0 = blockIdx.y * BN;
  job.steps = K / 64;
  // the role of this thread's warpgroup, made warp-uniform for the
  // compiler (a wgmma on a path it cannot prove uniform is serialized)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2)
    produce<MW, BN>(job, threadIdx.x - CONSUMERS);
  else
    consume<MW, BN>(job, role, threadIdx.x & 127);
}

template <int MW, int BN>
int launch(const void* x, const void* qs, const void* s_lo, const void* s_hi,
           const void* m_lo, const void* m_hi, void* y, int T, int K, int N,
           int vec, cudaStream_t st) {
  using L = Smem<MW, BN>;
  const cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<MW, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((T + L::BM - 1) / L::BM, (N + BN - 1) / BN);
  tile_kernel<MW, BN><<<grid, THREADS, L::BYTES, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qs),
      static_cast<const float*>(s_lo), static_cast<const float*>(s_hi),
      static_cast<const float*>(m_lo), static_cast<const float*>(m_hi),
      static_cast<float*>(y), T, K, N, vec);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace w4

}  // namespace

// y [T,N] f32 = x [T,K] bf16 @ the W4A8 weight (T > 1; T = 1 is the
// quantized-activation product of w4a8_decode.cu). qs u8 [K/2, N]; s_* /
// m_* f32 [K/512, N]; x 16-byte aligned, K % 512 == 0. (bm, bn): the tile,
// 256 x 128, 128 x 256 or 128 x 128. vec: 1 when N % 16 == 0 and every
// plane is 16-byte aligned (cp.async copies).
extern "C" int w4a8_matmul(const void* x, const void* qs, const void* s_lo,
                           const void* s_hi, const void* m_lo,
                           const void* m_hi, void* y, int T, int K, int N,
                           int bm, int bn, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T < 2 || K % 512 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bm == 256 && bn == 128)
    return w4::launch<2, 128>(x, qs, s_lo, s_hi, m_lo, m_hi, y, T, K, N,
                              vec, st);
  if (bm == 128 && bn == 256)
    return w4::launch<1, 256>(x, qs, s_lo, s_hi, m_lo, m_hi, y, T, K, N,
                              vec, st);
  if (bm == 128 && bn == 128)
    return w4::launch<1, 128>(x, qs, s_lo, s_hi, m_lo, m_hi, y, T, K, N,
                              vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
