// Prefill flash attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/attention.py::
// _flash_impl / _attn_kernel, entry flash_attention (the prefill path of
// ops/layers.py::attention, taken when q_len >= 64).
//
// What it computes. Causal GQA attention of q [T,Hq,D] against the bf16
// cache k/v [Hkv,S,D], query t at position pos + t, seeing keys in
// (pos + t - window, pos + t]; scores are scaled, optionally soft-capped
// (softcap * tanh(s / softcap)) and masked to NEG_INF = -0.7 * FLT_MAX as the
// reference does. Online softmax in f32 over 128-key tiles; p is rounded to
// bf16 before the PV product, as the TPU kernel rounds it to the cache
// dtype. Output [T,Hq,D] f32. The scores are kept in log2 units (scale *
// log2(e) folded into the scale; a softcap applies in natural units first)
// and p = exp2f(x - m): one MUFU op each, within an ulp or two of expf, far
// below p's bf16 rounding; the partials' m goes back to natural units (m *
// ln 2). No path of the port holds an f32 cache, so the wrapper refuses one
// and this entry returns cudaErrorInvalidValue for it.
//
// What bounds it on the H100. Causal prefill of T queries against pos + T
// keys is 4 * T * (pos + T/2) * D operations per query head on the tensor
// cores (989 TFLOP/s bf16); the bytes (q, the visible keys and values, the
// f32 output) are far fewer, so operations bound it.
//
// What the design does about it (warp-specialized, wgmma, TMA):
//  * GQA packing: a block owns 128 query rows of ONE kv head: 128 / group
//    tokens x the group's query heads (row r = token r / group, head
//    r % group), so each K/V tile is fetched once per (query block, kv head)
//    and not once per query head. At T = 512, Hkv 8, group 4: 128 blocks,
//    one wave on 132 SMs.
//  * A producer warpgroup (one lane copies) keeps a 2-stage ring of K and V
//    tiles (128 keys x D, bf16) in flight with TMA (3-d tensor maps over
//    [Hkv, S, D], 128-byte swizzle, rows past S zero-filled), completing on
//    mbarriers; the consumers release a stage on an `empty` mbarrier. It
//    gives its registers to the consumers (setmaxnreg 40 / 232): with a
//    lone producer warp, 9 warps capped every thread at 168 registers
//    (three warps on one SM sub-partition) and the consumers spilled.
//    3 stages measured slower (the L1 left is smaller).
//  * Two consumer warpgroups hold 64 rows each. S = Q K^T is a wgmma with Q
//    (staged once by cp.async in the same swizzled layout) and K both from
//    shared memory; O += P V is a wgmma with P in registers (the S
//    accumulator layout is the register-A layout, so P is packed to bf16 in
//    place) and V read row-major as the MN-major (transposed) B operand:
//    no hand transpose. A warpgroup runs PV of tile j and then S of tile
//    j + 1 as two wgmma groups; its softmax overlaps the other warpgroup's
//    products.
//  * Tiles past causality or below the window are skipped, from the block's
//    rows; a tile every row sees whole runs without the mask.
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
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;        // query rows per block: 2 warpgroups x 64
constexpr int BN = 128;        // keys per tile
constexpr int STAGES = 2;      // K/V tiles in flight
constexpr int CONSUMERS = 256;
constexpr int THREADS = CONSUMERS + 128;  // + the producer warpgroup
constexpr int BAR_Q = 1;       // named barrier: Q staged (consumers only)
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// shared memory: Q [D/64][BM][64], K and V [STAGES][D/64][BN][64] bf16,
// each [rows][64] slab 128-byte swizzled and 1024-byte aligned; then the
// mbarriers
template <int D>
struct Smem {
  static constexpr int HALVES = D / 64;
  static constexpr int Q_HALF = BM * 128;
  static constexpr int KV_HALF = BN * 128;
  static constexpr int KV_TILE = HALVES * KV_HALF;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + HALVES * Q_HALF;
  static constexpr int V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr int BYTES = BAR_OFF + 3 * STAGES * 8 + 1024;  // + align
};

struct Params {
  const __nv_bfloat16* q;
  float* o;
  float* m_out;
  float* l_out;
  // the first query's position on the device (int64, read once a block),
  // or nullptr: then `pos`
  const long long* pos_dev;
  int T, Hq, Hkv, S, pos, kpos_offset, window, group, tpb;
  float scale, softcap;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// box (64 elements, BN rows, 1 head) at (c0, key0, head) of a 3-d map
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int key0, int head,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(key0), "r"(head),
      "r"(bar)
      : "memory");
}

// 16 bytes global -> shared, zero-filled past src_bytes
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// 2^x, one MUFU op (-inf and large negative x give +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma descriptor of a K-major [rows][64] bf16 slab, 128-byte swizzle:
// 8-row atoms 1024 bytes apart (SBO), the leading offset unused
__device__ __forceinline__ uint64_t desc_k(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// wgmma descriptor of an MN-major B operand (V: keys x d, d contiguous),
// 128-byte swizzle: a 64-wide MN atom of 8 K rows is 1024 bytes; the next
// 64 columns (d) lie one slab on (LBO), the next 8 keys 1024 bytes on (SBO)
__device__ __forceinline__ uint64_t desc_v(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(BN * 128 / 16) << 16) | (64ull << 32) |
         (1ull << 62);
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// D[64 x 128] = A[64 x 16] B[16 x 128] (the first k-slice: D is written,
// not read, so no instruction has to define it first) and D += A B (the
// rest); A and B K-major in shared memory (128-byte swizzle)
__device__ __forceinline__ void wgmma_ss_n128_first(float (&d)[64],
                                                    uint64_t da,
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
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]),
        "=f"(d[5]), "=f"(d[6]), "=f"(d[7]), "=f"(d[8]), "=f"(d[9]),
        "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]),
        "=f"(d[15]), "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]),
        "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]), "=f"(d[24]),
        "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]),
        "=f"(d[30]), "=f"(d[31]), "=f"(d[32]), "=f"(d[33]), "=f"(d[34]),
        "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]),
        "=f"(d[45]), "=f"(d[46]), "=f"(d[47]), "=f"(d[48]), "=f"(d[49]),
        "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]),
        "=f"(d[55]), "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]),
        "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "l"(da), "l"(db), "r"(0));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
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

// D[64 x 128] += A[64 x 16] B[16 x 128]: A from registers (bf16 pairs),
// B MN-major in shared memory (128-byte swizzle, transposed read)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A from registers (bf16 pairs),
// B MN-major in shared memory (128-byte swizzle, transposed read)
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int D>
__device__ __forceinline__ void wgmma_pv(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

template <int D, bool PARTIALS>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Smem<D>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const uint32_t base = smem_u32(sm);
  const uint32_t bar_full_k = base + L::BAR_OFF;
  const uint32_t bar_full_v = bar_full_k + 8 * STAGES;
  const uint32_t bar_empty = bar_full_v + 8 * STAGES;

  const int tid = threadIdx.x;
  // warp-uniform role (a wgmma on a path ptxas cannot prove uniform is
  // serialized)
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int hkv = blockIdx.y;
  const int q0 = blockIdx.x * p.tpb;                  // first token
  const int q_end = min(q0 + p.tpb, p.T);             // past the last
  __shared__ int pos_s;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_full_k + 8 * s, 1);
      mbar_init(bar_full_v + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, CONSUMERS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    pos_s = p.pos_dev != nullptr ? static_cast<int>(*p.pos_dev) : p.pos;
  }
  __syncthreads();
  const int pos = pos_s;
  // the KV tiles any row of this block can see, as local key indices (the
  // global position of local key i is kpos_offset + i)
  const int max_kpos = min(pos + q_end - 1 - p.kpos_offset, p.S - 1);
  const int min_kpos = pos + q0 - p.window + 1 - p.kpos_offset;
  const int j_begin = min_kpos > 0 ? min_kpos / BN : 0;
  const int n_tiles = max_kpos >= 0 ? max_kpos / BN + 1 - j_begin : 0;

  if (warp >= CONSUMERS / 32) {  // the producer warpgroup: one lane works
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == CONSUMERS) {
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % STAGES;
        const uint32_t ph = (it / STAGES) & 1;
        const int key0 = (j_begin + it) * BN;
        mbar_wait(bar_empty + 8 * s, ph ^ 1);  // passes at the first use
        mbar_expect_tx(bar_full_k + 8 * s, L::KV_TILE);
#pragma unroll
        for (int h = 0; h < L::HALVES; ++h)
          tma_load(base + L::K_OFF + s * L::KV_TILE + h * L::KV_HALF, &tm_k,
                   64 * h, key0, hkv, bar_full_k + 8 * s);
        mbar_expect_tx(bar_full_v + 8 * s, L::KV_TILE);
#pragma unroll
        for (int h = 0; h < L::HALVES; ++h)
          tma_load(base + L::V_OFF + s * L::KV_TILE + h * L::KV_HALF, &tm_v,
                   64 * h, key0, hkv, bar_full_v + 8 * s);
      }
    }
    return;
  }

  // ---- the consumers: warpgroup wg holds block rows [64 wg, 64 wg + 64),
  // with the registers the producer gave up (168 a thread would spill)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wg = warp >> 2, wq = warp & 3, lane = tid & 31;
  const int group = p.group;
  // stage Q: row r = token q0 + r / group, head hkv * group + r % group
  for (int id = tid; id < BM * (D / 8); id += CONSUMERS) {
    const int r = id / (D / 8), c = id % (D / 8);
    const int t = q0 + r / group;
    const bool in = r < p.tpb * group && t < p.T;
    const __nv_bfloat16* src =
        p.q + ((size_t)(in ? t : 0) * p.Hq + hkv * group + r % group) * D +
        8 * c;
    cp_async16(base + L::Q_OFF + (c >> 3) * L::Q_HALF + r * 128 +
                   (((c & 7) ^ (r & 7)) << 4),
               src, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  bar_sync(BAR_Q, CONSUMERS);

  // this thread's two rows: fragment rows g and g + 8 of its warp
  const int rb0 = 64 * wg + 16 * wq + (lane >> 2), rb1 = rb0 + 8;
  const int qpos0 = pos + q0 + rb0 / group;
  const int qpos1 = pos + q0 + rb1 / group;
  const int t4 = lane & 3;
  // the block's rows see all of a tile's keys from key lo_all to hi_all
  const int qmin = pos + q0, qmax = pos + q_end - 1;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  const uint32_t q_base = base + L::Q_OFF + wg * 64 * 128;

  // S = Q K^T of tile `it` into sc (its K stage has landed)
  float sc[BN / 2];
  auto start_s = [&](int it) {
    const uint32_t k_base = base + L::K_OFF + (it % STAGES) * L::KV_TILE;
    wgmma_ss_n128_first(sc, desc_k(q_base), desc_k(k_base));
#pragma unroll
    for (int kk = 1; kk < D / 16; ++kk)
      wgmma_ss_n128(sc,
                    desc_k(q_base + (kk >> 2) * L::Q_HALF + 32 * (kk & 3)),
                    desc_k(k_base + (kk >> 2) * L::KV_HALF + 32 * (kk & 3)));
  };
  if (n_tiles > 0) {
    mbar_wait(bar_full_k, 0);
    fence_regs(sc);
    wgmma_fence();
    start_s(0);
    wgmma_commit_wait();
    fence_regs(sc);
  }
  // scores in log2 units: x = s * scale * log2(e) (soft-capped in natural
  // units first), p = exp2(x - m)
  const float scale2 = p.scale * LOG2E;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % STAGES;
    const uint32_t ph = (it / STAGES) & 1;
    const int kbase = (j_begin + it) * BN;

    // scale, cap, mask; accumulator i sits at row rb0 (+ 8 if bit 1 of i)
    // and tile column 8 (i / 4) + 2 t4 + i % 2
    const int gk0 = p.kpos_offset + kbase;
    const bool whole = gk0 + BN - 1 <= qmin && gk0 > qmax - p.window &&
                       kbase + BN <= p.S;
    float mx0 = NEG_INF, mx1 = NEG_INF;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      float x;
      if (p.softcap > 0.f)
        x = p.softcap * tanhf(sc[i] * p.scale * (1.0f / p.softcap)) * LOG2E;
      else
        x = sc[i] * scale2;
      if (!whole) {
        const int key = kbase + 8 * (i >> 2) + 2 * t4 + (i & 1);
        const int gk = p.kpos_offset + key;
        const int qp = (i & 2) ? qpos1 : qpos0;
        const bool vis = gk <= qp && gk > qp - p.window && key < p.S;
        x = vis ? x : NEG_INF;
      }
      sc[i] = x;
      if (i & 2)
        mx1 = fmaxf(mx1, x);
      else
        mx0 = fmaxf(mx0, x);
    }
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[BN / 16][4];
#pragma unroll
    for (int i = 0; i < BN / 2; i += 2) {
      const float mn = (i & 2) ? mn1 : mn0;
      const float e0 = ex2(sc[i] - mn), e1 = ex2(sc[i + 1] - mn);
      if (i & 2)
        ps1 += e0 + e1;
      else
        ps0 += e0 + e1;
      pa[i >> 3][(i >> 1) & 3] = pack_bf16(e0, e1);
    }
    l0 = al0 * l0 + quad_sum(ps0);
    l1 = al1 * l1 + quad_sum(ps1);
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= (i & 2) ? al1 : al0;

    // O += P V of this tile (P rounded to bf16), which frees its stage,
    // then S of the next, each its own wgmma group: one batch of both made
    // ptxas serialize the wgmmas (C7515). The other warpgroup's softmax
    // runs while these hold the tensor cores.
    mbar_wait(bar_full_v + 8 * s, ph);
    fence_regs(acc);
    wgmma_fence();
    const uint32_t v_base = base + L::V_OFF + s * L::KV_TILE;
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)
      wgmma_pv<D>(acc, pa[kk], desc_v(v_base + kk * 16 * 128));
    wgmma_commit_wait();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(bar_empty + 8 * s);
    if (it + 1 < n_tiles) {
      mbar_wait(bar_full_k + 8 * ((it + 1) % STAGES), ((it + 1) / STAGES) & 1);
      fence_regs(sc);
      wgmma_fence();
      start_s(it + 1);
      wgmma_commit_wait();
      fence_regs(sc);
    }
  }

  // the epilogue: row rb -> token q0 + rb / group, head hkv * group + rb %
  // group; register i holds column 8 (i / 4) + 2 t4 + i % 2
  const int t0 = q0 + rb0 / group, t1 = q0 + rb1 / group;
  const bool ok0 = rb0 < p.tpb * group && t0 < p.T;
  const bool ok1 = rb1 < p.tpb * group && t1 < p.T;
  const size_t o0 = ((size_t)t0 * p.Hq + hkv * group + rb0 % group);
  const size_t o1 = ((size_t)t1 * p.Hq + hkv * group + rb1 % group);
  if constexpr (PARTIALS) {
    // a row that saw no key keeps m = NEG_INF: the tiles it sat in summed
    // p = exp2(0) = 1 for it, so its acc and l are zeroed; m goes back to
    // natural units
    const bool none0 = m0 == NEG_INF, none1 = m1 == NEG_INF;
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int col = 8 * (i >> 2) + 2 * t4;
      const bool hi = i & 2;
      if (hi ? ok1 : ok0) {
        const bool none = hi ? none1 : none0;
        *reinterpret_cast<float2*>(p.o + (hi ? o1 : o0) * D + col) =
            none ? make_float2(0.f, 0.f) : make_float2(acc[i], acc[i + 1]);
      }
    }
    if (t4 == 0) {
      if (ok0) {
        p.m_out[o0] = none0 ? NEG_INF : m0 * LN2;
        p.l_out[o0] = none0 ? 0.f : l0;
      }
      if (ok1) {
        p.m_out[o1] = none1 ? NEG_INF : m1 * LN2;
        p.l_out[o1] = none1 ? 0.f : l1;
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < D / 2; i += 2) {
      const int col = 8 * (i >> 2) + 2 * t4;
      const bool hi = i & 2;
      if (hi ? ok1 : ok0) {
        const float l = hi ? l1 : l0;
        *reinterpret_cast<float2*>(p.o + (hi ? o1 : o0) * D + col) =
            make_float2(acc[i] / l, acc[i + 1] / l);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, found through the runtime's entry-point
// query (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(f);
  }
  return fn;
}

// a [Hkv, S, D] bf16 cache as a 3-d tensor map of (64, BN, 1) boxes,
// 128-byte swizzled, rows past S read as zeros
bool cache_map(CUtensorMap* map, const void* ptr, int Hkv, int S, int D) {
  EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)Hkv};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)S * D * 2};
  const cuuint32_t box[3] = {64, BN, 1};
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<void*>(ptr), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool PARTIALS>
int launch(const CUtensorMap& mk, const CUtensorMap& mv, const Params& p,
           cudaStream_t st) {
  auto kernel = flash_fwd_kernel<D, PARTIALS>;
  const int bytes = Smem<D>::BYTES;
  // the attribute is per function and card: set once for each card
  static bool sized[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= 64 || !sized[dev]) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (dev < 64) sized[dev] = true;
  }
  const dim3 grid((p.T + p.tpb - 1) / p.tpb, p.Hkv);
  kernel<<<grid, THREADS, bytes, st>>>(mk, mv, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool PARTIALS>
int dispatch(const void* q, const void* k, const void* v, void* o, void* m,
             void* l, int T, int Hq, int Hkv, int S, int D, int is_f32,
             int pos, const void* pos_dev, int kpos_offset, int window,
             float scale, float softcap, void* stream) {
  const int group = Hkv > 0 ? Hq / Hkv : 0;
  if (is_f32 || (D != 64 && D != 128) || T < 1 || S < 1 || group < 1 ||
      group > BM || Hq != group * Hkv)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap mk, mv;
  if (!cache_map(&mk, k, Hkv, S, D) || !cache_map(&mv, v, Hkv, S, D))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.o = static_cast<float*>(o);
  p.m_out = static_cast<float*>(m);
  p.l_out = static_cast<float*>(l);
  p.T = T;
  p.Hq = Hq;
  p.Hkv = Hkv;
  p.S = S;
  p.pos = pos;
  p.pos_dev = static_cast<const long long*>(pos_dev);
  p.kpos_offset = kpos_offset;
  p.window = window;
  p.group = group;
  p.tpb = BM / group;
  p.scale = scale;
  p.softcap = softcap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return D == 128 ? launch<128, PARTIALS>(mk, mv, p, st)
                  : launch<64, PARTIALS>(mk, mv, p, st);
}

}  // namespace

// o [T,Hq,D] f32 = attention(q [T,Hq,D], k/v [Hkv,S,D]); q, k, v bf16
// (is_f32 = 1 is refused: cudaErrorInvalidValue). D is 64 or 128; Hq / Hkv
// at most 128. The first query's position: pos_dev, a device int64 each
// block reads (the TPU kernel's scalar-prefetch pos: a captured graph
// replays at any offset), or, where pos_dev is null, pos. The caller keeps
// rows [pos, pos + T) inside the cache.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int T, int Hq, int Hkv, int S,
                                   int D, int is_f32, int pos, int window,
                                   float scale, float softcap,
                                   const void* pos_dev, void* stream) {
  return dispatch<false>(q, k, v, o, nullptr, nullptr, T, Hq, Hkv, S, D,
                         is_f32, pos, pos_dev, 0, window, scale, softcap,
                         stream);
}

// One shard's partials: acc [T,Hq,D], m and l [T,Hq], all f32, of q [T,Hq,D]
// (global positions pos + t) over k/v [Hkv,S,D] whose key i sits at global
// position kpos_offset + i. Types and D as above; causal, no window.
extern "C" int flash_attention_partials_fwd(
    const void* q, const void* k, const void* v, void* acc, void* m, void* l,
    int T, int Hq, int Hkv, int S, int D, int is_f32, int pos,
    int kpos_offset, float scale, void* stream) {
  return dispatch<true>(q, k, v, acc, m, l, T, Hq, Hkv, S, D, is_f32, pos,
                        nullptr, kpos_offset, 1 << 30, scale, 0.f, stream);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
