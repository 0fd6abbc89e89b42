// In-place KV-cache row append for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels ntransformer_tpu/ops/pallas/kv_update.py::
// _append_stacked_impl / _stacked_kernel (entry append_rows_stacked: every
// layer's new row at once, after the batched decode step's layer loop) and
// _append_impl / _kernel (entry append_rows: one layer; called here as an
// L = 1 view of the same launch).
//
// What it computes. For every layer l < L, sequence b with active[b] != 0,
// kv head h and lane c < dc: cache[l, b, h, pos[b], c] = rows[l, b, h, c],
// in place. Inactive sequences, and positions outside [0, S), keep their
// contents. Up to four caches go in one launch: the k and v code caches
// [L, B, Hkv, S, D] (bf16 or int8) and, for an int8 cache, their S-minor
// scale buffers [L, B, Hkv, S] (f32), which are caches of dc = 1. A bf16
// cache takes f32 rows rounded to nearest even, as the TPU kernel's astype.
//
// What bounds it on the H100. The bytes written: one row per (layer,
// sequence, head) and cache, ~2 MB at L = 32, B = 32, Hkv = 8, D = 128 int8
// with scales, under a microsecond at 3.35 TB/s; at decode sizes one launch
// costs more than that.
//
// What the design does about it. The TPU kernel reads, merges and writes a
// whole sublane tile because Mosaic refuses one-row blocks; here a thread
// writes one element of one row and nothing else is touched. One launch
// covers every layer and every cache, so the step pays one launch for the
// append, as the TPU kernel pays one grid.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KIND_BF16 = 0;
constexpr int KIND_INT8 = 1;
constexpr int KIND_F32 = 2;
constexpr int MAX_ARRAYS = 4;

struct Array {
  void* cache;       // [L, B, H, S, dc]
  const void* rows;  // [L, B, H, dc], contiguous
  int cache_kind;
  int row_kind;
  int dc;
};

struct Params {
  Array a[MAX_ARRAYS];
  const int* pos;     // [B]
  const int* active;  // [B]
  int L, B, H, S;
};

__device__ __forceinline__ float load_float(const void* p, int kind,
                                            long long i) {
  if (kind == KIND_BF16)
    return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  if (kind == KIND_INT8) return static_cast<float>(static_cast<const int8_t*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

// blockIdx.y picks the cache; a grid-stride loop walks its L*B*H*dc row
// elements, neighbouring threads on neighbouring lanes of one row
__global__ void __launch_bounds__(256) kv_append_kernel(Params p) {
  const Array ar = p.a[blockIdx.y];
  const long long n = (long long)p.L * p.B * p.H * ar.dc;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % ar.dc);
    long long rest = i / ar.dc;
    const int h = (int)(rest % p.H);
    rest /= p.H;
    const int b = (int)(rest % p.B);
    const long long l = rest / p.B;
    const int pos = p.pos[b];
    if (p.active[b] == 0 || pos < 0 || pos >= p.S) continue;
    const long long dst =
        (((l * p.B + b) * p.H + h) * p.S + pos) * (long long)ar.dc + c;
    if (ar.cache_kind == KIND_INT8) {
      static_cast<int8_t*>(ar.cache)[dst] =
          static_cast<const int8_t*>(ar.rows)[i];
    } else if (ar.cache_kind == KIND_BF16) {
      __nv_bfloat16* out = static_cast<__nv_bfloat16*>(ar.cache);
      if (ar.row_kind == KIND_BF16)
        out[dst] = static_cast<const __nv_bfloat16*>(ar.rows)[i];
      else
        out[dst] = __float2bfloat16_rn(load_float(ar.rows, ar.row_kind, i));
    } else {
      static_cast<float*>(ar.cache)[dst] = load_float(ar.rows, ar.row_kind, i);
    }
  }
}

}  // namespace

// Writes rows into n_arrays (1..4) caches at pos[b] for the active b. Array i
// is (cache_i, rows_i, cache_kind_i, row_kind_i, dc_i); kinds are 0 bf16,
// 1 int8, 2 f32; an int8 cache takes int8 rows only. pos/active: int32 [B].
extern "C" int kv_append(int n_arrays, void* c0, const void* r0, int ck0,
                         int rk0, int dc0, void* c1, const void* r1, int ck1,
                         int rk1, int dc1, void* c2, const void* r2, int ck2,
                         int rk2, int dc2, void* c3, const void* r3, int ck3,
                         int rk3, int dc3, int L, int B, int H, int S,
                         const void* pos, const void* active, void* stream) {
  if (n_arrays < 1 || n_arrays > MAX_ARRAYS || L < 1 || B < 1 || H < 1 ||
      S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  void* caches[MAX_ARRAYS] = {c0, c1, c2, c3};
  const void* rows[MAX_ARRAYS] = {r0, r1, r2, r3};
  const int ck[MAX_ARRAYS] = {ck0, ck1, ck2, ck3};
  const int rk[MAX_ARRAYS] = {rk0, rk1, rk2, rk3};
  const int dc[MAX_ARRAYS] = {dc0, dc1, dc2, dc3};
  long long most = 0;
  for (int i = 0; i < MAX_ARRAYS; ++i) {
    p.a[i] = Array{caches[i], rows[i], ck[i], rk[i], dc[i]};
    if (i >= n_arrays) continue;
    if (dc[i] < 1 || ck[i] < 0 || ck[i] > 2 || rk[i] < 0 || rk[i] > 2 ||
        (ck[i] == KIND_INT8) != (rk[i] == KIND_INT8))
      return static_cast<int>(cudaErrorInvalidValue);
    const long long n = (long long)L * B * H * dc[i];
    most = n > most ? n : most;
  }
  p.pos = static_cast<const int*>(pos);
  p.active = static_cast<const int*>(active);
  p.L = L;
  p.B = B;
  p.H = H;
  p.S = S;
  long long blocks = (most + 255) / 256;
  if (blocks > 4096) blocks = 4096;
  const dim3 grid((unsigned)blocks, (unsigned)n_arrays);
  kv_append_kernel<<<grid, 256, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
