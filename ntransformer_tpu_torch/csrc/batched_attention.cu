// Batched flash decode / verify attention for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel ntransformer_tpu/ops/pallas/batched_attention.py::
// _impl / _kernel (entries flash_decode_batched and flash_verify_batched; the
// serving path's attention in models/batched.py) in all five of its cache-dot
// forms (`dot_impl`): "f32", "int8", "int8_s", "int8_v" and "bf16".
//
// What it computes. For every sequence b and kv head h, R = group * T query
// rows (row r belongs to window token t = r / group, at position pos + t)
// attend the cache keys of layer `layer` of a [L?, B, Hkv, S, D] cache plus T
// new k/v rows that are not written yet (the "virtual block"). An active
// slot sees cache keys [0, pos - 1] and virtual row i from window token i on;
// an inactive slot sees the frozen cache keys [0, pos + t] and no virtual
// row. A window keeps keys in (pos + t - window, pos + t]. The cache is bf16,
// or int8 codes with S-minor f32 scales [L?, B, Hkv, S]: the scales fold
// into the score columns (k) and the probability columns (v), which is exact
// because they are per (head, position), so no dequantized cache is written.
// Scores are scaled, then scale-folded, then soft-capped, as in the TPU
// kernel. The virtual block is always f32.
//
// The cache dots, as the TPU kernel defines them (_kernel, the int8 forms
// act on an int8 cache only):
//   f32     q and the cache values as f32.
//   int8_s  the score dot on the int8 codes: q is quantized per row
//           (qm = max|q| + 1e-30, round(q * (127 / qm)), half to even), the
//           int8 x int8 dot is exact in int32 (dp4a), then scaled by
//           qm * (scale / 127) and the key scale.
//   int8_v  the value dot on the int8 codes: p * vs is quantized per row
//           over one block of keys at that block's max (pm), the int32 dot
//           is scaled by pm / 127; the denominator keeps the exact f32 p.
//   int8    both.
//   bf16    q rounded to bf16 for the score dot, p (after the v-scale fold)
//           rounded to bf16 for the value dot, both summed in f32.
// "int8_v", "int8" and "bf16" round p relative to the running max of a block
// of block_s keys, so they depend on the TPU kernel's blocking: block_s is
// its _pick_block_s of the 128-rounded s_live (the wrapper computes it).
// They run the `group` kernel, whose blocks are exactly those key blocks;
// "f32" and "int8_s" do not depend on it and run the freely split kernel.
//
// What bounds it on the H100. The bytes: every live K and V row (and its
// scales) is read once; q, the new rows and the output are small. Decode
// (R = 4) does about 8 operations per cache byte, under the CUDA cores' 20
// (67 TFLOP/s over 3.35 TB/s): bytes set the time. A verify window of 16 or
// 32 rows does 32-64, and the f32 operations set it.
//
// The split kernel ("f32", "int8_s"). The live keys of each (sequence,
// head) are split over `nsplit` blocks, a count the wrapper takes from the
// shapes alone (never from s_live, so an s_live bucket changes no bit): a
// block an SM (B = 1 has Hkv = 8 (sequence, head) pairs for 132 SMs; at B =
// 32 one block a pair walks longest and measured fastest). A block walks its
// share in tiles of 128 keys through a two-stage cp.async ring of the raw
// cache rows (codes or bf16, with the codes' scales, and the virtual rows
// with the first tile), so one tile is in flight while the last is computed
// and no thread holds a byte in flight; values are converted to f32 in
// registers where they are used (int8 codes exactly, through the f32 2^23:
// one byte permute and one subtraction a value), never expanded in shared
// memory. One key a thread for the score dot (dp4a on the raw codes for
// "int8_s"), 8 query rows at a time into shared memory, the rows instanced
// at 4, 8 and 32. Warp w owns keys [32 w, 32 w + 32) of every tile and
// keeps its own online softmax over them, a row at a time (row r's running
// max and denominator in lane r, so any S works with no score kept), and
// its own value sums, a lane D / 32 columns, with p * vs broadcast from
// shared memory. After the walk the four warps are added in warp order,
// each scaled to the block's row max. Where the splits of a (sequence, head)
// fit one thread-block cluster (8 or fewer), every rank takes a share of the
// output and adds the splits in rank order through distributed shared
// memory, folds in the virtual rows and normalises: one launch a call.
// Otherwise each block writes its unnormalised partial (m, l, acc) and the
// combine pass merges them in split order: two launches. Every order is
// fixed, so runs repeat bit for bit.
//
// The group kernel (the per-block forms). Its clusters follow the key
// blocks of the TPU kernel: one cluster of csize blocks (csize <= 8) per
// (key block, head, sequence), each block a contiguous slice of the key
// block's live keys, so a (sequence, head) whose keys fit one key block
// (s_live <= 2048 at int8, Hkv 8, D 128: the 8B serving case) still fills
// the card (the wrapper sizes csize to cover the SMs twice). A block reads
// its K slice ONCE, through a cp.async ring of 128-key tiles, one key a
// thread, and keeps every f32 score of the slice in shared memory (masked
// keys as -inf). Then, from the kept scores:
//   1. the row max: the slice's, exchanged over the cluster through
//      distributed shared memory (exact, so any order); past the first key
//      block it is the prefix max of the per-block maxima that a max pass
//      wrote first (see below), which is the TPU kernel's running max;
//   2. p = exp(s - m), the slice's part of the f32 denominator, and the row
//      max of p * vs, exchanged over the cluster (exact), so p and its int8
//      codes are the TPU kernel's, relative to the block's running max;
//   3. the int8 codes of p * vs (int8, int8_v) or p * vs rounded to bf16
//      (bf16);
//   4. the value dot over the V slice, read ONCE through the same ring (its
//      first tiles load during steps 1-3): int8 as dp4a over four keys, V's
//      4 x 4 bytes of four keys and four columns transposed in registers by
//      byte permutes; bf16 as f32 FMAs over four columns a lane (bytes, not
//      operations, bound the step). The warps' int32 sums are added in a
//      fixed order, then rank 0 adds the cluster's in rank order (exact) and
//      the denominator parts in rank order (the one f32 sum whose order
//      differs from the TPU kernel's), and writes the block's partial.
// Past the first key block (nsplit > 1) a max pass runs first: the same
// kernel through step 1 over K, writing each key block's row max; the main
// pass takes the prefix max over blocks 0..g. K is read twice in all and V
// once: at s_live 2176 (17 blocks of 128 keys) 17 + 17 K block reads, where
// the old walk from the sequence's first live key read 153 (1 + 2 + ... +
// 17) for the row max alone. A call then runs three launches (max, main,
// combine); the wrapper's counters count them.
#include "batched_attention.cuh"

// the parts' launchers (batched_attention.d<D>_<dtype>.cu)
extern "C" int bflash_launch_d128_bf16(const void* params, int dot, void* stream);
extern "C" int bflash_launch_d128_int8(const void* params, int dot, void* stream);
extern "C" int bflash_launch_d64_bf16(const void* params, int dot, void* stream);
extern "C" int bflash_launch_d64_int8(const void* params, int dot, void* stream);

// out [B, Hkv, R, D] f32. q [B, Hkv, R, D] f32 (row r = t * group + g); the
// cache bf16 (is_int8 = 0) or int8 codes with f32 scales ks/vs (is_int8 =
// 1); kn/vn [B, Hkv, T, D] in the cache dtype, kns/vns [B, Hkv, T]; pos and
// active int32 [B]; window: keys kept in (qpos - window, qpos]; s_live: no
// key at or past it is read. dot: the cache-dot form (0 f32, 1 bf16, 2 int8,
// 3 int8_s, 4 int8_v; the int8 forms on an int8 cache only). The split
// forms (f32, int8_s) take nsplit blocks a (sequence, head) and csize =
// nsplit (one cluster, at most 8, whose rank 0 writes out) or 0 (the
// combine pass merges); they ignore block_s and slice_cap. The per-block
// forms (bf16, int8, int8_v) take block_s, their key block, nsplit = the
// number of key blocks, each on a cluster of csize blocks (1-8) whose
// slices hold at most slice_cap keys (a multiple of 128). Scratch: part_acc
// [B, Hkv, nsplit, R, D], part_m / part_l / part_max [B, Hkv, nsplit, R]
// f32. Launches: a split form one (csize > 0) or two (the split pass, then
// the combine pass); a per-block form the group pass and the combine pass,
// with its max pass first when nsplit > 1 (three).
extern "C" int batched_flash_attention(
    const void* q, const void* k, const void* v, const void* ks,
    const void* vs, const void* kn, const void* vn, const void* kns,
    const void* vns, const void* pos, const void* active, void* part_acc,
    void* part_m, void* part_l, void* part_max, void* out, int B, int Hkv,
    int S, int R, int T, int group, int D, int is_int8, int layer,
    int s_live, int window, int nsplit, int dot, int block_s, int csize,
    int slice_cap, float scale, float softcap, float qscale, float inv127,
    void* stream) {
  if (R < 1 || R > RMAX || T < 1 || T > TMAX || R != group * T ||
      nsplit < 1 || B < 1 || Hkv < 1 || S < 1 || layer < 0 || s_live < 1 ||
      window < 1 || block_s < 1 || dot < DOT_F32 || dot > DOT_INT8_V)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const float*>(q);
  p.k = k;
  p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.kn = kn;
  p.vn = vn;
  p.kns = static_cast<const float*>(kns);
  p.vns = static_cast<const float*>(vns);
  p.pos = static_cast<const int*>(pos);
  p.active = static_cast<const int*>(active);
  p.part_acc = static_cast<float*>(part_acc);
  p.part_m = static_cast<float*>(part_m);
  p.part_l = static_cast<float*>(part_l);
  p.part_max = static_cast<float*>(part_max);
  p.out = static_cast<float*>(out);
  p.B = B;
  p.Hkv = Hkv;
  p.S = S;
  p.R = R;
  p.T = T;
  p.group = group;
  p.layer = layer;
  p.s_live = s_live;
  p.window = window;
  p.nsplit = nsplit;
  p.block_s = block_s;
  p.csize = csize;
  p.slice_cap = slice_cap;
  p.scale = scale;
  p.softcap = softcap;
  p.qscale = qscale;
  p.inv127 = inv127;
  p.magic = 0x4B000000u;
  if (D == 128 && !is_int8) return bflash_launch_d128_bf16(&p, dot, stream);
  if (D == 128) return bflash_launch_d128_int8(&p, dot, stream);
  if (D == 64 && !is_int8) return bflash_launch_d64_bf16(&p, dot, stream);
  if (D == 64) return bflash_launch_d64_int8(&p, dot, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* nt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
