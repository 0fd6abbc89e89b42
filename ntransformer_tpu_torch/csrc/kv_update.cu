// In-place KV-cache row append for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels ntransformer_tpu/ops/pallas/kv_update.py::
// _append_stacked_impl / _stacked_kernel (entry append_rows_stacked: every
// layer's new row at once, after the batched decode step's layer loop) and
// _append_impl / _kernel (entry append_rows: one layer; called here as an
// L = 1 view of the same launch).
//
// What it computes. For every layer l < L, sequence b with active[b] != 0
// and 0 <= pos[b] < S, and kv head h: cache[l, b, h, pos[b], :] =
// rows[l, b, h, :], in place. Inactive sequences, and positions outside
// [0, S), keep their contents. Up to four caches go in one launch: the k
// and v code caches [L, B, Hkv, S, D] (bf16 or int8) and, for an int8
// cache, their S-minor scale buffers [L, B, Hkv, S] (f32), which are
// caches of dc = 1. A bf16 cache takes f32 rows rounded to nearest even, as
// the TPU kernel's astype.
//
// What bounds it on the H100. The bytes moved: each active row read once
// and written once, ~2 MB each way at L = 32, B = 32, Hkv = 8, D = 128 int8
// with scales, about a microsecond at 3.35 TB/s; at decode sizes the
// launch and one memory round trip cost more than that.
//
// What the design does about it. The TPU kernel reads, merges and writes a
// whole sublane tile because Mosaic refuses one-row blocks; here only the
// rows move. A thread moves one 16-byte chunk of a cache row (8 bf16 or 16
// int8 codes; reading 32 bytes of f32 rows for a bf16 cache) where the
// row's bytes divide into 16-byte chunks and both arrays are 16-byte
// aligned, else one element (the scale buffers' one float a row). Each
// array has its own blocks, sized by its own rows: blockIdx.y is the
// sequence, blockIdx.x the array and a piece of that sequence's L * Hkv
// rows, so a block reads pos[b] and active[b] once and an inactive slot's
// blocks leave before any load. The plan (which array, chunks or elements,
// each array's first block) is the wrapper's (ops/cuda/kv_update.py::
// launch_plan, modelled on the CPU by tests/test_torch_kv_update.py).
// Indices are 32-bit from the block and thread indices (two 32-bit divides
// a thread); only the cache offset is widened to 64 bits. One launch
// covers every layer and every cache, as the TPU kernel's one grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_BF16 = 0;
constexpr int KIND_INT8 = 1;
constexpr int KIND_F32 = 2;
constexpr int MAX_ARRAYS = 4;
constexpr int THREADS = 128;

__host__ __device__ __forceinline__ int kind_size(int kind) {
  return kind == KIND_BF16 ? 2 : (kind == KIND_INT8 ? 1 : 4);
}

struct Array {
  uint8_t* cache;       // [L, B, H, S, dc]
  const uint8_t* rows;  // [L, B, H, dc], contiguous
  int cache_kind;
  int row_kind;
  int dc;
  int vec;     // 1: units are 16-byte chunks of a cache row; 0: elements
  int units;   // units a row
  int block0;  // this array's first blockIdx.x
};

struct Params {
  Array a[MAX_ARRAYS];
  const int* pos;     // [B]
  const int* active;  // [B]
  int n_arrays, L, B, H, S;
};

__device__ __forceinline__ float load_float(const uint8_t* p, int kind,
                                            int i) {
  if (kind == KIND_BF16)
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  if (kind == KIND_INT8)
    return static_cast<float>(reinterpret_cast<const int8_t*>(p)[i]);
  return reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_float(uint8_t* p, int kind, int i,
                                            float v) {
  if (kind == KIND_BF16)
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  else
    reinterpret_cast<float*>(p)[i] = v;
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// one 16-byte chunk of a cache row from its source values (16, 32 or 8
// bytes of the row: the same kind, f32 to bf16, bf16 to f32)
__device__ __forceinline__ void move_chunk(uint8_t* dst, const uint8_t* src,
                                           int ck, int rk) {
  uint4 v;
  if (ck == rk) {  // int8 -> int8, bf16 -> bf16, f32 -> f32
    v = *reinterpret_cast<const uint4*>(src);
  } else if (ck == KIND_BF16) {  // 8 f32 -> 8 bf16, nearest even
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v = make_uint4(bf16x2(a.x, a.y), bf16x2(a.z, a.w), bf16x2(b.x, b.y),
                   bf16x2(b.z, b.w));
  } else {  // 4 bf16 -> 4 f32
    const uint2 h = *reinterpret_cast<const uint2*>(src);
    v = make_uint4(h.x << 16, h.x & 0xFFFF0000u, h.y << 16,
                   h.y & 0xFFFF0000u);
  }
  *reinterpret_cast<uint4*>(dst) = v;
}

// blockIdx.y: sequence b; blockIdx.x: array i (from its block0) and piece
// j of b's L * H rows of that array, THREADS units a block
__global__ void __launch_bounds__(THREADS) kv_append_kernel(const Params p) {
  const int b = blockIdx.y;
  const int pos = p.pos[b];
  if (p.active[b] == 0 || pos < 0 || pos >= p.S) return;
  // the block's array, picked with constant indices (selects, no
  // indexed access to the parameters)
  Array ar = p.a[0];
#pragma unroll
  for (int q = 1; q < MAX_ARRAYS; ++q)
    if (q < p.n_arrays && (int)blockIdx.x >= p.a[q].block0) ar = p.a[q];
  const int unit = ((int)blockIdx.x - ar.block0) * THREADS + threadIdx.x;
  const int per_l = p.H * ar.units;
  if (unit >= p.L * per_l) return;
  const int l = unit / per_l;
  const int h = (unit - l * per_l) / ar.units;
  const int c = unit - l * per_l - h * ar.units;
  const int row = (l * p.B + b) * p.H + h;  // of rows[]
  const int cs = kind_size(ar.cache_kind), rs = kind_size(ar.row_kind);
  uint8_t* dst = ar.cache + ((size_t)row * p.S + pos) * ar.dc * cs;
  const uint8_t* src = ar.rows + (size_t)row * ar.dc * rs;
  if (ar.vec) {
    move_chunk(dst + 16 * c, src + (16 / cs) * rs * c, ar.cache_kind,
               ar.row_kind);
  } else if (ar.cache_kind == KIND_INT8) {
    reinterpret_cast<int8_t*>(dst)[c] = reinterpret_cast<const int8_t*>(src)[c];
  } else {
    store_float(dst, ar.cache_kind, c, load_float(src, ar.row_kind, c));
  }
}

}  // namespace

// Writes rows into n_arrays (1..4) caches at pos[b] for the active b.
// desc holds 8 values an array: cache pointer, rows pointer, cache kind,
// row kind (0 bf16, 1 int8, 2 f32; an int8 cache takes int8 rows only),
// dc, vec, units a row and its first block, the last three the wrapper's
// launch plan (ops/cuda/kv_update.py::launch_plan), checked here; blocks:
// the grid's x. pos/active: int32 [B] on the card.
extern "C" int kv_append(const long long* desc, int n_arrays, int blocks,
                         int L, int B, int H, int S, const void* pos,
                         const void* active, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n_arrays < 1 || n_arrays > MAX_ARRAYS || L < 1 || B < 1 || H < 1 ||
      S < 1 || B > 65535 || (long long)L * B * H > INT32_MAX)
    return bad;
  Params p = {};
  long long next = 0;  // the plan's next block
  for (int i = 0; i < n_arrays; ++i) {
    const long long* d = desc + 8 * i;
    Array& ar = p.a[i];
    ar.cache = reinterpret_cast<uint8_t*>(d[0]);
    ar.rows = reinterpret_cast<const uint8_t*>(d[1]);
    const long long ck = d[2], rk = d[3], dc = d[4];
    if (dc < 1 || dc > INT32_MAX / 4 || ck < 0 || ck > 2 || rk < 0 ||
        rk > 2 || (ck == KIND_INT8) != (rk == KIND_INT8))
      return bad;
    ar.cache_kind = static_cast<int>(ck);
    ar.row_kind = static_cast<int>(rk);
    ar.dc = static_cast<int>(dc);
    const int cs = kind_size(ar.cache_kind), rs = kind_size(ar.row_kind);
    ar.vec = d[5] != 0;
    if (ar.vec && ((dc * cs) % 16 || (dc * rs) % 16 || d[0] % 16 ||
                   d[1] % 16))
      return bad;
    // 32-bit indices: a sequence's units
    const long long units = (long long)L * H * d[6];
    if (d[6] != (ar.vec ? dc * cs / 16 : dc) || d[7] != next ||
        units > INT32_MAX - THREADS)
      return bad;
    ar.units = static_cast<int>(d[6]);
    ar.block0 = static_cast<int>(next);
    next += (units + THREADS - 1) / THREADS;
  }
  if (next != blocks) return bad;
  p.pos = static_cast<const int*>(pos);
  p.active = static_cast<const int*>(active);
  p.n_arrays = n_arrays;
  p.L = L;
  p.B = B;
  p.H = H;
  p.S = S;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  kv_append_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
