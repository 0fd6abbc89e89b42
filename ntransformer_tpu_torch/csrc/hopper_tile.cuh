// Pieces shared by q8_0_matmul.cu, w8a8_matmul.cu and kquant_matmul.cu
// (sm_90a): PTX wrappers (cp.async, named barriers, wgmma, mma.sync), the
// 4 x 4 byte transpose of an N-major int8 plane, and the warp-specialized
// wgmma tile the formats run at prefill T (namespace tile).
//
// The tile. A block computes a BM x 128 tile of y (BM = 128 MW, MW = 1 or
// 2) with three warpgroups:
//  * two consumers of BM / 2 rows each: each copies its rows of the
//    activation tile with cp.async into the 128-byte-swizzled K-major
//    layout and issues wgmma m64n128 (bf16 -> f32, or s8 -> s32) with A
//    (activations) and B (weights) read by the tensor cores from shared
//    memory; one wgmma batch stays in flight while the next is issued;
//  * one producer: copies the raw weight rows of a stage with cp.async and
//    turns them into a ring of 3 K-major B tiles (the format's `transform`:
//    the Q8_0 or K-quant dequant, or the int8 transpose), each weight once
//    for BM rows of activations.
// A stage is 128 bytes of K a row: 64 bf16 or 128 int8 values. Named
// barriers hand the B tiles over: FULL[s % 3] (the producer arrives when
// tile s is written, the consumers wait) and EMPTY[s % 3] (the consumers
// arrive when the wgmma of stage s is done, the producer waits before it
// rewrites the tile for stage s + 3). This is the W4A8 tile of
// nibble_matmul.cu (namespace w4) with the format taken out.
//
// A format F gives:
//   using Acc (float or int), struct Args (its pointers, T, K, N, vec),
//   X_AHEAD / R_AHEAD (activation / raw stages in flight) and RAW_BYTES,
//   steps(args): the number of stages,
//   a_chunk(args, row, st, c, bytes): the global address of 16-byte chunk
//     c of activation row `row` at stage st, and its valid bytes (0: fill
//     zeros),
//   issue_raw(args, raw, st, n0, pt): the producer thread pt's cp.async
//     copies of stage st into raw,
//   transform(args, raw, bt, n0, pt): raw -> the swizzled B tile (a
//     format that declares STAGED = true gets the stage's index too:
//     transform(args, raw, bt, n0, pt, st); Q6_K's shared qh rows),
//   mma(acc, da, db): one wgmma of 32 bytes of K,
//   store(args, r, c, v0, v1): y[r, c], y[r, c + 1] from a pair.
// Where the tiles alone leave SMs idle (few tokens, or a narrow N), K is
// split over a cluster of up to 8 blocks a tile: each block leaves its
// sums in its shared memory, and the cluster adds them in rank order
// through distributed shared memory (a fixed order), then stores.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace hop {

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

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// generic-proxy writes to shared memory (st.shared, cp.async) made visible
// to the tensor cores' async proxy
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// programmatic dependent launch: a dependent grid may start (its
// griddepcontrol.wait still waits for this grid's writes) / wait for the
// grid this one depends on (a no-op when launched without the attribute)
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
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

// word b (a compile-time constant) of a 16-byte load
__device__ __forceinline__ uint32_t word(const uint4& v, int b) {
  return b == 0 ? v.x : (b == 1 ? v.y : (b == 2 ? v.z : v.w));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the exact f32 value of the signed byte j of w given as u = w ^ 0x80808080
// (its bytes biased to q + 128): 2^23 + q + 128 in the mantissa of
// 0x4B000000, less 2^23 + 128 (exact)
__device__ __forceinline__ float s8_to_f32(uint32_t u, int j) {
  return __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | j)),
                   8388736.f);
}

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_s8_16832(int (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

#define HOP_D64(T)                                                           \
  T(d[0]), T(d[1]), T(d[2]), T(d[3]), T(d[4]), T(d[5]), T(d[6]), T(d[7]),    \
      T(d[8]), T(d[9]), T(d[10]), T(d[11]), T(d[12]), T(d[13]), T(d[14]),    \
      T(d[15]), T(d[16]), T(d[17]), T(d[18]), T(d[19]), T(d[20]), T(d[21]),  \
      T(d[22]), T(d[23]), T(d[24]), T(d[25]), T(d[26]), T(d[27]), T(d[28]),  \
      T(d[29]), T(d[30]), T(d[31]), T(d[32]), T(d[33]), T(d[34]), T(d[35]),  \
      T(d[36]), T(d[37]), T(d[38]), T(d[39]), T(d[40]), T(d[41]), T(d[42]),  \
      T(d[43]), T(d[44]), T(d[45]), T(d[46]), T(d[47]), T(d[48]), T(d[49]),  \
      T(d[50]), T(d[51]), T(d[52]), T(d[53]), T(d[54]), T(d[55]), T(d[56]),  \
      T(d[57]), T(d[58]), T(d[59]), T(d[60]), T(d[61]), T(d[62]), T(d[63])
#define HOP_REGS64                                                     \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "                           \
  "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "                 \
  "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "                 \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "                 \
  "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "                 \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
#define HOP_F(x) "+f"(x)
#define HOP_R(x) "+r"(x)

// D[64 x 128] f32 += A[64 x 16] bf16 . B[16 x 128] bf16, both K-major
__device__ __forceinline__ void wgmma_bf16_m64n128(float (&d)[64],
                                                   uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOP_REGS64
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : HOP_D64(HOP_F)
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 128] s32 += A[64 x 32] s8 . B[32 x 128] s8, both K-major (the
// only layout wgmma takes for 8-bit operands)
__device__ __forceinline__ void wgmma_s8_m64n128(int (&d)[64], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {" HOP_REGS64
      "}, %64, %65, p;\n}\n"
      : HOP_D64(HOP_R)
      : "l"(da), "l"(db), "r"(1));
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

}  // namespace hop

namespace tile {
using namespace hop;

constexpr int BN = 128;                 // tile columns
constexpr int B_SLOTS = 3;              // weight tiles in the ring
constexpr int CONSUMERS = 256, PRODUCERS = 128;
constexpr int THREADS = CONSUMERS + PRODUCERS;
// named barrier ids (0 is __syncthreads)
constexpr int BAR_FULL = 1, BAR_EMPTY = 4, BAR_PROD = 7, BAR_CONS = 8;
constexpr int RED_LD = BN + 8;  // a split tile's row stride in shared memory

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.aligned;\n"
               "barrier.cluster.wait.aligned;\n" ::: "memory");
}

// the same shared-memory location in block `rank` of the cluster
template <typename T>
__device__ __forceinline__ const T* map_rank(const T* p, int rank) {
  uint64_t g;
  asm volatile("mapa.u64 %0, %1, %2;\n"
               : "=l"(g)
               : "l"(reinterpret_cast<uint64_t>(p)), "r"(rank));
  return reinterpret_cast<const T*>(g);
}

template <class F, int MW>
struct Smem {
  static constexpr int BM = 128 * MW;
  static constexpr int A_BYTES = BM * 128;   // [BM][128 bytes]
  static constexpr int A_SLOTS = F::X_AHEAD + 1;
  static constexpr int B_BYTES = BN * 128;   // [BN][128 bytes]
  static constexpr int RAW_SLOTS = F::R_AHEAD + 1;
  static constexpr int A_OFF = 0;
  static constexpr int B_OFF = A_OFF + A_SLOTS * A_BYTES;
  static constexpr int RAW_OFF = B_OFF + B_SLOTS * B_BYTES;
  static constexpr int BYTES = RAW_OFF + RAW_SLOTS * F::RAW_BYTES + 1024;
  static_assert(BYTES <= 232448, "tile shared memory over the 227 KB");
  static_assert(BM * RED_LD * 4 <= BYTES - 1024,
                "a split tile's sums do not fit its shared memory");
};

// F::STAGED, or false where F does not declare it
template <class F, class = void>
struct staged : std::false_type {};
template <class F>
struct staged<F, std::void_t<decltype(F::STAGED)>>
    : std::integral_constant<bool, F::STAGED> {};

// stages s0 .. s0 + steps - 1 (a K split's; ring slots count from s0)
template <class F, int MW>
__device__ __forceinline__ void produce(const typename F::Args& args,
                                        uint8_t* sm, int n0, int s0,
                                        int steps, int pt) {
  using L = Smem<F, MW>;
  constexpr int R_AHEAD = F::R_AHEAD, RAW_SLOTS = L::RAW_SLOTS;
  auto issue = [&](int st) {
    if (st < steps)
      F::issue_raw(args, sm + L::RAW_OFF + (st % RAW_SLOTS) * F::RAW_BYTES,
                   s0 + st, n0, pt);
    cp_async_commit();
  };
#pragma unroll
  for (int st = 0; st < R_AHEAD; ++st) issue(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<R_AHEAD - 1>();  // this thread's copies of stage st
    // every producer's copies of stage st have landed, and every producer
    // is done with stage st - 1, whose raw slot is reused next
    bar_sync(BAR_PROD, PRODUCERS);
    issue(st + R_AHEAD);
    if (st >= B_SLOTS)  // the wgmma of stage st - 3 is done with its tile
      bar_sync(BAR_EMPTY + st % B_SLOTS, THREADS);
    const uint8_t* raw = sm + L::RAW_OFF + (st % RAW_SLOTS) * F::RAW_BYTES;
    uint8_t* bt = sm + L::B_OFF + (st % B_SLOTS) * L::B_BYTES;
    if constexpr (staged<F>::value)
      F::transform(args, raw, bt, n0, pt, s0 + st);
    else
      F::transform(args, raw, bt, n0, pt);
    fence_proxy_async();
    bar_arrive(BAR_FULL + st % B_SLOTS, THREADS);
  }
  cp_async_wait<0>();
}

template <class F, int MW>
__device__ __forceinline__ void consume(const typename F::Args& args,
                                        uint8_t* sm, int m0, int n0, int s0,
                                        int steps, int wg, int ct) {
  const uint32_t base = smem_u32(sm);
  using L = Smem<F, MW>;
  using Acc = typename F::Acc;
  constexpr int A_BYTES = L::A_BYTES, A_SLOTS = L::A_SLOTS;
  constexpr int X_AHEAD = F::X_AHEAD;
  // this warpgroup's 64 MW rows of the activation tile of stage st
  auto issue_x = [&](int st) {
    if (st < steps) {
      const uint32_t a = base + L::A_OFF + (st % A_SLOTS) * A_BYTES;
#pragma unroll
      for (int i = 0; i < 4 * MW; ++i) {  // 64 MW rows x 8 chunks
        const int id = ct + 128 * i, r = 64 * MW * wg + (id >> 3);
        const int c = id & 7;
        int bytes;
        const void* src = F::a_chunk(args, m0 + r, s0 + st, c, bytes);
        cp_async16(a + sw128(r, c), src, bytes);
      }
    }
    cp_async_commit();
  };

  Acc acc[MW][64];
#pragma unroll
  for (int mi = 0; mi < MW; ++mi)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[mi][i] = 0;

#pragma unroll
  for (int st = 0; st < X_AHEAD; ++st) issue_x(st);
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<X_AHEAD - 1>();  // this thread's chunks of stage st
    fence_proxy_async();
    // the B tile of stage st is written and every consumer's rows are in
    bar_sync(BAR_FULL + st % B_SLOTS, THREADS);
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) fence_regs(acc[mi]);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
    const uint32_t a = base + L::A_OFF + (st % A_SLOTS) * A_BYTES +
                       MW * wg * 64 * 128;
    const uint32_t b = base + L::B_OFF + (st % B_SLOTS) * L::B_BYTES;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 32 bytes of K on
#pragma unroll
      for (int mi = 0; mi < MW; ++mi)
        F::mma(acc[mi], desc_sw128(a + mi * 64 * 128 + 32 * kk),
               desc_sw128(b + 32 * kk));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    // the batch of stage st stays in flight; that of st - 1 is done
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) fence_regs(acc[mi]);
    if (st >= 1 && st - 1 + B_SLOTS < steps)
      bar_arrive(BAR_EMPTY + (st - 1) % B_SLOTS, THREADS);
    // stage st - 1's slot is free in this warpgroup: its rows are read by
    // this warpgroup's wgmma alone
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
  if (gridDim.z == 1) {
#pragma unroll
    for (int mi = 0; mi < MW; ++mi) {
      const int r0 = m0 + 64 * (MW * wg + mi) + 16 * wq + (lane >> 2);
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int r = r0 + 8 * ((i >> 1) & 1);
        const int c = n0 + 8 * (i >> 2) + 2 * (lane & 3);
        F::store(args, r, c, acc[mi][i], acc[mi][i + 1]);
      }
    }
    return;
  }
  // a K split: the tile's sums go to shared memory (rows RED_LD apart, so a
  // pair store phase meets no bank conflict) once both consumers' wgmma are
  // done with the tiles there, and the cluster adds its blocks' tiles in
  // rank order through distributed shared memory
  Acc* red = reinterpret_cast<Acc*>(sm);
  bar_sync(BAR_CONS, CONSUMERS);
#pragma unroll
  for (int mi = 0; mi < MW; ++mi) {
    const int r0 = 64 * (MW * wg + mi) + 16 * wq + (lane >> 2);
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int r = r0 + 8 * ((i >> 1) & 1);
      const int c = 8 * (i >> 2) + 2 * (lane & 3);
      red[r * RED_LD + c] = acc[mi][i];
      red[r * RED_LD + c + 1] = acc[mi][i + 1];
    }
  }
  cluster_sync();  // every block's tile is in its shared memory
  const int ranks = gridDim.z, rank = blockIdx.z;
  const int rows = min(Smem<F, MW>::BM, args.T - m0);
  for (int e = rank * CONSUMERS + 128 * wg + ct; e < rows * (BN / 2);
       e += ranks * CONSUMERS) {
    const int r = e / (BN / 2), c = 2 * (e % (BN / 2));
    const int o = r * RED_LD + c;
    Acc v0 = 0, v1 = 0;
    for (int q = 0; q < ranks; ++q) {
      const Acc* rq = map_rank(red, q);
      v0 = v0 + rq[o];
      v1 = v1 + rq[o + 1];
    }
    F::store(args, m0 + r, n0 + c, v0, v1);
  }
  cluster_sync();  // no block leaves while another reads its tile
}

// blockIdx.z: the K split, stages [z * per, (z + 1) * per); the splits of
// a tile are one cluster
template <class F, int MW>
__global__ void __launch_bounds__(THREADS, 1)
tile_kernel(const typename F::Args args, int per) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw0 = smem_u32(smem_raw);
  uint8_t* sm = smem_raw + (((raw0 + 1023) & ~1023u) - raw0);
  const int m0 = blockIdx.x * Smem<F, MW>::BM, n0 = blockIdx.y * BN;
  const int s0 = blockIdx.z * per;
  const int steps = min(per, F::steps(args) - s0);
  // the activations may be written by the grid this one depends on
  pdl_wait();
  // the role of this thread's warpgroup, made warp-uniform for the
  // compiler (a wgmma on a path it cannot prove uniform is serialized)
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (role == 2) {
    produce<F, MW>(args, sm, n0, s0, steps, threadIdx.x - CONSUMERS);
    if (gridDim.z > 1) {  // the consumers' two cluster barriers
      cluster_sync();
      cluster_sync();
    }
  } else {
    consume<F, MW>(args, sm, m0, n0, s0, steps, role, threadIdx.x & 127);
  }
}

// launch on a grid of (row tiles, column tiles, K splits of `per` stages,
// each tile's splits one cluster); pdl: may start while the previous
// kernel on the stream finishes (its writes are waited for)
template <class F, int MW>
int launch(const typename F::Args& args, int T, int N, int nsplit, int per,
           bool pdl, cudaStream_t st) {
  using L = Smem<F, MW>;
  const cudaError_t e = cudaFuncSetAttribute(
      tile_kernel<F, MW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + L::BM - 1) / L::BM, (N + BN - 1) / BN, nsplit);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = L::BYTES;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = nsplit;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 2 : 1;
  const cudaError_t le =
      cudaLaunchKernelEx(&cfg, tile_kernel<F, MW>, args, per);
  return static_cast<int>(le != cudaSuccess ? le : cudaGetLastError());
}

}  // namespace tile
