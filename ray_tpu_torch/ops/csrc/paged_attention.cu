// Paged decode kernels for Hopper (sm_90a): the KV append (K5) and the
// decode attention (K6) of the continuous-batching engine's fused decode
// route.  Built by ray_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// wrappers in ray_tpu_torch/ops/paged_attention.py check devices, dtypes,
// shapes and contiguity before passing pointers; every entry here returns
// cudaGetLastError() after its launch, and the wrapper raises if it is not 0.
//
// Layouts (all contiguous):
//   pools    [L, NB, BS, KV, HD]   model dtype (f32 / bf16) or int8
//   scales   [L, NB, BS, KV]       f32, int8 pools only
//   tables   [B, W]                int32 block ids (padding = scratch block 0)
//   pos      [B]                   int32 per-row positions
//   q, out   [B, H, HD]            f32 / bf16
//   ws       f32 split partials, counters int32 (K6; see its entry)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_commit;
using hopper::cp_async_wait;
using hopper::pack_bf16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// ---------------------------------------------------------------------------
// K5: paged KV append, in place.
//
// Replaces ray_tpu/ops/paged_attention.py:93 `_build_append` (pallas_call at
// l.202, entry `paged_kv_append` l.216).
//
// Bound on this card: not bytes.  A call reads B*KV*HD new elements per
// pool and writes as many (plus B*KV f32 scales each way for int8):
// kilobytes, ~20 ns of HBM at the serve shape.  What a launch of its own
// costs is the launch and a three-step dependent chain, pos[b] -> tables[b,
// p / BS] -> the store, each step a round trip to memory: microseconds.
//
// Design: one block per (row, kv head).  A row's new K (or V) for one kv
// head is a contiguous run of HD elements both in `k_new` and in the pool,
// so the append is a byte copy in the widest unit the alignment allows
// (16-byte vectors at HD=128 for every supported dtype).  The Pallas
// kernel's whole-block copy-through and its sequential grid existed only
// because Pallas stages whole blocks; an in-place scatter has neither, so
// rows run in parallel.  Two idle rows may write the same slot of scratch
// block 0: benign, scratch content is garbage by contract.
//
// This kernel stays for `paged_kv_append`.  The decode step does not launch
// it: K6's `kAppend` instantiation below does the same writes (one store
// body, `store_new_row`, serves both) in K6's own launch, where K6 already pays the chain's first two steps (pos and the
// table entries come in its prologue's one round trip, beside the new row),
// so the append costs K6 a few stores and a barrier instead of a launch.
// ---------------------------------------------------------------------------
// The fused append's operands (kAppend): the new rows [B, KV, HD] in the
// pool dtype, their int8 scales [B, KV] (null for model-dtype pools), the
// pools and scale sidecars written through, and the copy unit in bytes (16,
// 8, 4, 2 or 1: dividing the row and every pointer).  K5 takes it too;
// plain K6 passes it zeroed and never reads it.
struct NewRow {
  const char* k_new;
  const char* v_new;
  const float* k_new_scale;
  const float* v_new_scale;
  char* k_pool;
  char* v_pool;
  float* k_scale;
  float* v_scale;
  int vb;
};

template <typename V>
__device__ __forceinline__ void copy_units(char* dst, const char* src, int n,
                                           int tid, int nt) {
  for (int i = tid; i < n; i += nt)
    reinterpret_cast<V*>(dst)[i] = reinterpret_cast<const V*>(src)[i];
}

// nt threads of the CTA (tid < nt) copy n bytes from src to dst in units
// of vb bytes
__device__ __forceinline__ void copy_bytes(char* dst, const char* src, int n,
                                           int vb, int tid, int nt) {
  switch (vb) {
    case 16: copy_units<uint4>(dst, src, n / 16, tid, nt); break;
    case 8: copy_units<uint2>(dst, src, n / 8, tid, nt); break;
    case 4: copy_units<unsigned>(dst, src, n / 4, tid, nt); break;
    case 2: copy_units<unsigned short>(dst, src, n / 2, tid, nt); break;
    default: copy_units<unsigned char>(dst, src, n, tid, nt); break;
  }
}

// the pool slot (layer, block blk, offset p % BS) that position p of a row
// goes to
__device__ __forceinline__ long long pool_slot(int layer, int NB, int BS,
                                               long long blk, int p) {
  return ((long long)layer * NB + blk) * BS + p % BS;
}

// K5's store, the one body of every append: row b's new K and V of kv head
// h (rb bytes each) into pool slot `slot`, and for int8 pools their scales
// into the sidecars, by nt threads of the CTA
__device__ __forceinline__ void store_new_row(const NewRow& nr,
                                              long long slot, int b, int h,
                                              int KV, int rb, int tid,
                                              int nt) {
  const long long dst = (slot * KV + h) * rb;
  const long long src = ((long long)b * KV + h) * rb;
  copy_bytes(nr.k_pool + dst, nr.k_new + src, rb, nr.vb, tid, nt);
  copy_bytes(nr.v_pool + dst, nr.v_new + src, rb, nr.vb, tid, nt);
  if (nr.k_scale != nullptr && tid == 0) {
    nr.k_scale[slot * KV + h] = nr.k_new_scale[(long long)b * KV + h];
    nr.v_scale[slot * KV + h] = nr.v_new_scale[(long long)b * KV + h];
  }
}

__global__ void append_kernel(NewRow nr, const int* __restrict__ tables,
                              const int* __restrict__ pos, int layer, int NB,
                              int BS, int KV, int row_bytes, int W) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int p = pos[b];
  // a position past the table's reach writes nothing (the reference's
  // `p_b < view` guard); within reach, p / BS <= W - 1 already
  if (p < 0 || p >= W * BS) return;
  store_new_row(nr,
                pool_slot(layer, NB, BS, tables[(long long)b * W + p / BS], p),
                b, h, KV, row_bytes, threadIdx.x, blockDim.x);
}

// ---------------------------------------------------------------------------
// K6: paged decode attention through the block table, as split-KV
// flash-decoding in one launch.
//
// Replaces ray_tpu/ops/paged_attention.py:247 `_build_attention` (pallas_call
// at l.344, entry `paged_decode_attention` l.367).
//
// Bound on this card: bytes.  Each row's live K and V (pos[b] + 1 columns of
// KV*HD elements each) are read once; the arithmetic is 4*H*HD flops per
// live column, a few flops per byte, far below the ~295 flop/byte where the
// tensor cores would bind.  At the serve main path's shape (Llama-3-8B's H
// 32, KV 8, hd 128, bf16, B 8 at positions 16-232) that is 0.00115 ms, and
// ~0.024 ms at B 32 with positions to 1,024 (chip_smoke.attention_bound).
// At the serve shape a launch and one DRAM round trip, several
// microseconds, are the real floor.
//
// What held the first design back: one CTA of 128 threads per (row, kv
// head), 64 CTAs on 132 SMs at the serve shape, each walking its row one
// 16-token block a step with 8 KB in flight, three barriers and a scalar
// 128-long dot product per score a step: latency-bound per step.
//
// Design.  The grid is (split, kv head x group chunk, row).  The host cuts
// each row's table into `splits` runs of `per` blocks from shapes alone
// (ops/paged_attention.py `split_plan`: about two CTAs an SM), never from
// pos, which lives on the device: the grid is fixed by shapes, as a CUDA
// graph per width bucket needs, and the engine's tick never syncs.  A split
// past a row's last block costs one predicate.  A CTA serves its kv head's
// GQA group (up to kMaxG query heads; a larger group takes several CTAs),
// so K and V cross HBM once per kv head.  It stages its run's table entries
// in shared memory, then walks the run's live columns in steps of `step`
// tokens (16 KB of K a step where the head allows: four 16-token pool
// blocks at hd 128 in bf16, half of a 128-token block) through a ring of
// `stages` cp.async copies, 16 bytes a thread.  Pool blocks are scattered,
// so TMA's tiled maps do not fit them; each copy's address goes through the
// table, with its block and offset advanced step by step from registers, so
// the walk divides nothing and any BS works (a block larger than a step
// arrives in step-sized pieces).  Rows in shared memory are XOR-swizzled by
// 16-byte chunk (or padded to an odd chunk count), so no read conflicts on
// banks.
//
// The math.  bf16 q over a bf16 pool at hd 64 or 128 (the serve path) runs
// on mma.sync m16n8k16 with the group padded to 16 rows: each warp takes
// 16-column slices of every step and keeps its own online softmax and O in
// registers, so a step costs one barrier, and the four warps' partials
// merge once at the end.  The f32 instantiation (no tensor-core route is
// exact in f32), int8 pools (dequantised as (int8 -> f32) * scale -> q
// dtype on the way in) and wider heads run on FMA: scores one thread per
// (column, slice of hd) with q broadcast from shared memory, the online
// softmax one warp per query head, P.V one thread per (pair of hd columns,
// token group), three barriers a step.  Either way the kernel stays bound
// by its bytes and keeps every thread's copies in flight.
//
// The combine is in the same launch.  With splits > 1 each CTA writes its
// f32 (m, l, acc[group, hd]) to a workspace (an empty split: m = -1e30, l =
// 0 and no acc).  The last CTA of a (row, kv head) to arrive, by an atomic
// counter that it resets to 0, merges the splits in split order, skipping
// those with l == 0, and writes out in q's dtype, dividing by (L == 0 ? 1 :
// L): the same bits whichever CTA comes last.  P is rounded to q's dtype
// against the split's running max at each step, where the Pallas kernel
// rounds against a per-block one: a bf16 rounding difference only.
//
// Tables wider than the plan's 64 splits of 1,024 blocks (65,536 blocks, a
// million tokens at 16 a block) give a split more than the kMaxPer entries
// it stages at once: it stages them in rounds as the walk reaches them.
// Heads wider than kMaxHD (the reference takes any width; no config of
// the repo has one) run decode_attention_wide below.
//
// The fused append (kAppend; `paged_append_decode_attention`, one launch a
// layer on the decode step in place of K5 then K6).  The new token's column
// p = pos[b] lies in exactly one split, (p / BS) / per: only that split's
// CTAs of (row b, kv head) write, and they write before their walk reads
// anything.  No other split reads column p, so no ordering across CTAs is
// needed; the writing CTA is the only reader, and the barrier between its
// stores and its walk's first copies orders the two.  The row's new K and V
// for the kv head (and the int8 scales) come in the prologue's one round
// trip beside pos, the table entries and q; the destination block is the
// staged table entry, so the append adds no dependent trip to memory.
// With a GQA group past kMaxG, each group-chunk CTA of the split writes the
// same bytes to the same slot and reads back its own store: identical
// concurrent stores are benign, and the walk needs no second source for
// column p.  A position past the table's reach, or below 0, writes nothing.
// Output and pools are bit-equal to K5 then K6 for every row whose live
// blocks no other row of the call writes (the engine shares only full
// prompt blocks and parks released and idle slots on scratch block 0);
// idle rows that read scratch block 0 while another idle row writes it are
// garbage by contract, in both routes.
// ---------------------------------------------------------------------------
template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// a value rounded through the query dtype and read back as f32
template <typename QT>
__device__ __forceinline__ float round_q(float x) {
  return to_f32<QT>(from_f32<QT>(x));
}

// element e of a 16-byte vector of pool dtype PT, as f32 (exact)
__device__ __forceinline__ unsigned vec_word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename PT>
__device__ __forceinline__ float vec_elem(const uint4& v, int e);
template <>
__device__ __forceinline__ float vec_elem<float>(const uint4& v, int e) {
  return __uint_as_float(vec_word(v, e));
}
template <>
__device__ __forceinline__ float vec_elem<__nv_bfloat16>(const uint4& v,
                                                        int e) {
  const unsigned w = vec_word(v, e >> 1);  // little-endian: even = low half
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float vec_elem<int8_t>(const uint4& v, int e) {
  return static_cast<float>(
      static_cast<signed char>(vec_word(v, e >> 2) >> (8 * (e & 3))));
}

// elements 2j and 2j + 1 of a pool row at `p` (8, 4 or 2 bytes), as f32
template <typename PT>
__device__ __forceinline__ float2 pair_elems(const unsigned char* p);
template <>
__device__ __forceinline__ float2 pair_elems<float>(const unsigned char* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <>
__device__ __forceinline__ float2
pair_elems<__nv_bfloat16>(const unsigned char* p) {
  const unsigned w = *reinterpret_cast<const unsigned*>(p);
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}
template <>
__device__ __forceinline__ float2 pair_elems<int8_t>(const unsigned char* p) {
  const unsigned short w = *reinterpret_cast<const unsigned short*>(p);
  return make_float2(static_cast<float>(static_cast<signed char>(w & 0xff)),
                     static_cast<float>(static_cast<signed char>(w >> 8)));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// mma.sync m16n8k16, bf16 in, f32 accumulate: D += A B
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four 8x8 b16 matrices from shared memory, lane l giving the row address
// of matrix l / 8; .trans hands each thread a column pair instead of a row
// pair
template <bool kTrans>
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = hopper::smem_u32(p);
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(a));
}

constexpr int kAttnThreads = 128;
constexpr int kWarps = kAttnThreads / 32;
constexpr int kMaxG = 8;           // query heads a CTA serves
constexpr int kMaxSplits = 64;     // ops/paged_attention.py _MAX_SPLITS
constexpr int kMaxPer = 1024;      // table entries a split stages
constexpr int kStepBytes = 16384;  // K bytes a step stages, where hd allows
constexpr int kMaxStep = 128;      // tokens a step (step * parts == 128)
constexpr int kMinStep = 4;
constexpr int kMaxVecs = 8;  // 16-byte copies a thread issues a step, a pool
constexpr int kWideSlots = 4;  // hd pairs an FMA P.V thread owns past hd 256
constexpr int kMaxHD = 2 * kWideSlots * kAttnThreads;  // 1,024
constexpr int kSmemOptIn = 232448;

// hd pairs an FMA P.V thread owns: one up to hd 256, else kWideSlots
__host__ __device__ constexpr int pv_slots(int HD) {
  return HD / 2 <= kAttnThreads ? 1 : kWideSlots;
}

// The step and shared-memory plan, computed alike by the launcher and the
// kernel.  Shared memory: the ring of `stages` (K tile, V tile) pairs,
// which after the walk holds the partial results and then the merge's
// weights; int8 scales per stage; the split's table entries; q [G, HD]
// f32; the FMA path's score partials [parts, kMaxG, step] and P [step,
// kMaxG]; the mma path's per-warp m and l; m, l, corr [kMaxG]; a flag.
struct DecodePlan {
  int vpr;     // 16-byte chunks in a pool row: hd * itemsize / 16
  int sc;      // chunks between rows in shared memory
  bool swz;    // chunks XOR-swizzled by row (vpr % 8 == 0), else odd sc
  int step;    // tokens a step: step * vpr <= kMaxVecs * 128
  int parts;   // FMA score threads a column: 128 / step
  int cpp;     // chunks an FMA score thread covers
  int stages;
  size_t tile, off_scale, off_tbl, off_q, off_s, off_p, off_w, off_vec, bytes;

  __host__ __device__ DecodePlan(int HD, int elem, int G, int stages_,
                                 int per)
      : vpr(HD * elem / 16), stages(stages_) {
    swz = vpr % 8 == 0;
    sc = swz ? vpr : (vpr | 1);
    step = kMaxStep;
    while (step > kMinStep && step * vpr * 16 > kStepBytes) step >>= 1;
    parts = kAttnThreads / step;
    cpp = (vpr + parts - 1) / parts;
    tile = (size_t)step * sc * 16;
    const int tpr = (HD / 2 + pv_slots(HD) - 1) / pv_slots(HD);
    size_t ring = 2 * (size_t)stages * tile;
    const size_t red = (size_t)(kAttnThreads / tpr) * G * HD * 4;
    const size_t warp_red = (size_t)kWarps * G * HD * 4;
    if (ring < red) ring = red;
    if (ring < warp_red) ring = warp_red;
    if (ring < (size_t)kMaxSplits * kMaxG * 12) ring = kMaxSplits * kMaxG * 12;
    off_scale = ring;
    off_tbl = off_scale + (elem == 1 ? (size_t)stages * 2 * step * 4 : 0);
    off_q = off_tbl + ((size_t)min(per, kMaxPer) * 4 + 15) / 16 * 16;
    off_s = off_q + (size_t)G * HD * 4;
    off_p = off_s + (size_t)kAttnThreads * kMaxG * 4;
    off_w = off_p + (size_t)step * kMaxG * 4;
    off_vec = off_w + (size_t)2 * kWarps * kMaxG * 4;
    bytes = off_vec + 128;
  }
  // the shared-memory chunk of (row r, chunk c), in chunks from the tile
  __device__ __forceinline__ int at(int r, int c) const {
    return r * sc + (swz ? c ^ (r & 7) : c);
  }
};

// 16-byte vectors of a new K and V row (hd * itemsize / 16 each) a thread
// holds in the fused append's prologue: the FMA path's widest head over 128
// threads, one on the mma path
template <typename PT, int kMmaHD>
__host__ __device__ constexpr int new_row_vecs() {
  return kMmaHD > 0 ? 1
                    : (2 * kMaxHD * (int)sizeof(PT) / 16 + kAttnThreads - 1) /
                          kAttnThreads;
}

// kMmaHD: the head width of the mma.sync path (bf16 q and pool), or 0 for
// the FMA path.  kAppend: the fused append (see above) writes the row's new
// K and V before the walk; off, the kernel is K6 alone.
template <typename QT, typename PT, int kSlots, int kMmaHD, bool kAppend>
__global__ void __launch_bounds__(kAttnThreads)
    decode_attention_kernel(QT* __restrict__ out, const QT* __restrict__ q,
                            const PT* __restrict__ k_pool,
                            const PT* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tables,
                            const int* __restrict__ pos,
                            float* __restrict__ ws, int* __restrict__ counters,
                            int layer, int NB, int BS, int KV, int HD,
                            int group, int W, int per, int splits, int stages,
                            float scale, NewRow nr) {
  constexpr bool kQuant = sizeof(PT) == 1;  // int8 pools carry scales
  const int n_gc = (group + kMaxG - 1) / kMaxG;
  const int split = blockIdx.x, hc = blockIdx.y, b = blockIdx.z;
  const int kvh = hc / n_gc, g0 = (hc - kvh * n_gc) * kMaxG;
  const int G = min(kMaxG, group - g0);
  const DecodePlan pl(HD, (int)sizeof(PT), G, stages, per);
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* ring = smem;
  float* sc_s = reinterpret_cast<float*>(smem + pl.off_scale);
  int* tbl_s = reinterpret_cast<int*>(smem + pl.off_tbl);  // [per]
  float* q_s = reinterpret_cast<float*>(smem + pl.off_q);   // [G, HD]
  float* m_s = reinterpret_cast<float*>(smem + pl.off_vec);
  float* l_s = m_s + kMaxG;
  float* c_s = l_s + kMaxG;
  int* flag_s = reinterpret_cast<int*>(c_s + kMaxG);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_off =
      ((long long)b * KV * group + (long long)kvh * group + g0) * HD;
  const int w0 = split * per;  // the split's first table column
  // pos, the split's table entries and q are all read before any is used,
  // so that one round trip brings the three (an empty split reads the
  // table and q in vain)
  const int p_b = __ldg(pos + b);
  const long long t_row = (long long)b * W + w0;
  const int n_tbl = min(per, kMaxPer);  // the entries staged
  const int tw =
      tid < n_tbl && w0 + tid < W ? __ldg(tables + t_row + tid) : 0;
  // the fused append's new K and V row for this kv head (vector v < vpr of
  // K, then of V) and, on threads 0 and 1, its int8 scales: loaded before
  // pos is known, in the same round trip, ahead of q (whose FMA-path loop
  // stores each load); only 16-byte units are held, a narrower unit is
  // copied after the barrier below
  const int rb = pl.vpr * 16;  // bytes in a pool row
  [[maybe_unused]] const long long new_off = ((long long)b * KV + kvh) * rb;
  constexpr int kNV = kAppend ? new_row_vecs<PT, kMmaHD>() : 1;
  [[maybe_unused]] uint4 nrow[kNV];
  [[maybe_unused]] float nsc = 0.f;
  if constexpr (kAppend) {
    if (nr.vb == 16) {
#pragma unroll
      for (int j = 0; j < kNV; ++j) {
        const int v = tid + j * kAttnThreads;
        if (v < 2 * pl.vpr)
          nrow[j] = __ldg(reinterpret_cast<const uint4*>(
                              (v < pl.vpr ? nr.k_new : nr.v_new) + new_off) +
                          (v < pl.vpr ? v : v - pl.vpr));
      }
    }
    if (kQuant && tid < 2)
      nsc = __ldg((tid == 0 ? nr.k_new_scale : nr.v_new_scale) +
                  (long long)b * KV + kvh);
  }
  // the mma path's q: each thread's bf16 pairs of its A fragments, from
  // device memory straight into registers (row g = lane / 4; rows past the
  // group are zeros)
  constexpr int kKK = kMmaHD / 16 > 0 ? kMmaHD / 16 : 1;
  uint32_t qa[kKK][2];
  if constexpr (kMmaHD > 0) {
    const int qg = lane >> 2, tig = lane & 3;
    const uint32_t* qr = reinterpret_cast<const uint32_t*>(
        q + q_off + (long long)(qg < G ? qg : 0) * HD + 2 * tig);
#pragma unroll
    for (int kk = 0; kk < kKK; ++kk) {
      qa[kk][0] = qg < G ? __ldg(qr + kk * 8) : 0u;
      qa[kk][1] = qg < G ? __ldg(qr + kk * 8 + 4) : 0u;
    }
  } else {
    for (int i = tid; i < G * HD; i += kAttnThreads)
      q_s[i] = to_f32<QT>(q[q_off + i]);
  }
  if (tid < n_tbl) tbl_s[tid] = tw;
  for (int w = tid + kAttnThreads; w < n_tbl && w0 + w < W;
       w += kAttnThreads)
    tbl_s[w] = __ldg(tables + t_row + w);
  const int n_tok = p_b < 0 ? 0 : min(p_b + 1, W * BS);
  const int t_begin = w0 * BS;
  const int n_live = min(t_begin + per * BS, n_tok) - t_begin;
  const int n_steps = n_live > 0 ? (n_live + pl.step - 1) / pl.step : 0;
  const long long ws_stride = 2 * kMaxG + (long long)kMaxG * HD;
  const long long cell = (long long)b * KV * n_gc + hc;
  float* cell_ws = ws + cell * splits * ws_stride;  // [splits][m, l, acc]
  float* part = cell_ws + split * ws_stride;
  float* red = reinterpret_cast<float*>(ring);  // partials, after the walk

  if (n_steps > 0 || splits == 1) {
    if (tid < kMaxG) {
      m_s[tid] = kNegInf;
      l_s[tid] = 0.f;
    }
    __syncthreads();

    if constexpr (kAppend) {
      // the split that holds column p writes it (uniform over the CTA: p_b
      // and the split are), into the block of the staged table entry or,
      // past the kMaxPer entries staged, of the table itself.  The barrier
      // after the stores orders them before the walk's cp.async reads of
      // the same row by other threads of the CTA: __syncthreads() makes
      // every global and shared write made before it visible to the whole
      // block, which is all a __threadfence_block() would add, and no
      // other CTA reads column p
      const int col = p_b / BS;
      if (p_b >= 0 && p_b < W * BS && col >= w0 && col < w0 + per) {
        const int wc = col - w0;
        const long long slot = pool_slot(
            layer, NB, BS,
            wc < kMaxPer ? tbl_s[wc] : __ldg(tables + t_row + wc), p_b);
        if (nr.vb == 16) {  // K5's store, from the registers loaded above
          const long long dst = (slot * KV + kvh) * rb;
#pragma unroll
          for (int j = 0; j < kNV; ++j) {
            const int v = tid + j * kAttnThreads;
            if (v < 2 * pl.vpr)
              reinterpret_cast<uint4*>((v < pl.vpr ? nr.k_pool : nr.v_pool) +
                                       dst)[v < pl.vpr ? v : v - pl.vpr] =
                  nrow[j];
          }
          if (kQuant && tid < 2)
            (tid == 0 ? nr.k_scale : nr.v_scale)[slot * KV + kvh] = nsc;
        } else {
          store_new_row(nr, slot, b, kvh, KV, rb, tid, kAttnThreads);
        }
        __syncthreads();
      }
    }

    // Copy k of a step (k < kMaxVecs) is row vr[k], chunk vc of the step's
    // tiles; vw / vo, its table column (from w0) and offset in the block
    // for the next step to issue, advance by the step as steps issue in
    // order, so the walk divides nothing.  Thread tid < step also copies
    // the int8 scales of row tid.
    const int dq = pl.step / BS, dr = pl.step - dq * BS;
    int vr[kMaxVecs], vd[kMaxVecs], vs[kMaxVecs], vw[kMaxVecs], vo[kMaxVecs];
    {
      // vpr divides 128 for every power-of-two row: then a thread's copies
      // share its chunk and step down the rows 128 / vpr at a time
      const bool even = kAttnThreads % pl.vpr == 0;
      const int rp = kAttnThreads / pl.vpr;
      const int r0 = tid / pl.vpr, c0 = tid - r0 * pl.vpr;
      const int rq = rp / BS, rr = rp - rq * BS;
      int w = r0 / BS, o = r0 - w * BS;
#pragma unroll
      for (int k = 0; k < kMaxVecs; ++k) {
        const int v = tid + k * kAttnThreads;
        const int r = even ? r0 + k * rp : v / pl.vpr;
        const int c = even ? c0 : v - r * pl.vpr;
        vr[k] = v < pl.step * pl.vpr ? r : pl.step;  // step: no copy
        vd[k] = pl.at(vr[k], c) * 16;
        vs[k] = c * 16;
        if (!even) {
          w = r / BS;
          o = r - w * BS;
        }
        vw[k] = w;
        vo[k] = o;
        o += rr;  // row r + rp, for the next copy
        w += rq;
        if (o >= BS) {
          o -= BS;
          ++w;
        }
      }
    }
    int sw = tid / BS, so = tid - sw * BS;
    const char* kp = reinterpret_cast<const char*>(k_pool);
    const char* vp = reinterpret_cast<const char*>(v_pool);
    const long long layer_row = (long long)layer * NB;
    // step i's K and V (and int8 scales) into stage i % stages; rows past
    // the split's live columns arrive as zeros
    auto issue = [&](int i) {
      const int st = i % pl.stages;
      unsigned char* kt = ring + (size_t)st * 2 * pl.tile;
      unsigned char* vt = kt + pl.tile;
      const int ts = i * pl.step;
#pragma unroll
      for (int k = 0; k < kMaxVecs; ++k) {
        if (vr[k] < pl.step) {
          const bool ok = ts + vr[k] < n_live;
          long long src = 0;
          if (ok)
            src = (((layer_row + tbl_s[vw[k]]) * BS + vo[k]) * KV + kvh) * rb +
                  vs[k];
          cp_async16(kt + vd[k], kp + src, ok);
          cp_async16(vt + vd[k], vp + src, ok);
          vo[k] += dr;
          vw[k] += dq;
          if (vo[k] >= BS) {
            vo[k] -= BS;
            ++vw[k];
          }
        }
      }
      if constexpr (kQuant) {
        if (tid < pl.step) {
          float* ks = sc_s + st * 2 * pl.step;
          const bool ok = ts + tid < n_live;
          long long row = 0;
          if (ok) row = ((layer_row + tbl_s[sw]) * BS + so) * KV + kvh;
          cp_async4(ks + tid, k_scale + row, ok);
          cp_async4(ks + pl.step + tid, v_scale + row, ok);
          so += dr;
          sw += dq;
          if (so >= BS) {
            so -= BS;
            ++sw;
          }
        }
      }
    };
    for (int i = 0; i < pl.stages - 1; ++i) {
      if (i < n_steps) issue(i);
      cp_async_commit();
    }
    // A split of more than kMaxPer blocks stages its table in rounds:
    // before the first step whose columns pass the staged ones, every
    // thread (past the barrier that ends the issue of the step before)
    // restages from that step's first column, and shifts its copies'
    // table columns (vw, sw: relative to the staged round) by as much.
    int round0 = 0;  // the split's table column staged at tbl_s[0]
    auto restage = [&](int j) {
      const int c_new = j * pl.step / BS, last = ((j + 1) * pl.step - 1) / BS;
      if (last - round0 < kMaxPer) return;
      for (int w = tid; w < kMaxPer && c_new + w < per && w0 + c_new + w < W;
           w += kAttnThreads)
        tbl_s[w] = __ldg(tables + t_row + c_new + w);
#pragma unroll
      for (int k = 0; k < kMaxVecs; ++k) vw[k] -= c_new - round0;
      sw -= c_new - round0;
      round0 = c_new;
      __syncthreads();
    };
    // once every thread is done with step i - 1, refills its stage with
    // step i + stages - 1, then waits until step i has landed for every
    // thread: the refill does not wait on step i's arrival
    auto next_step = [&](int i) {
      __syncthreads();
      if (i + pl.stages - 1 < n_steps) {
        if (per > kMaxPer) restage(i + pl.stages - 1);
        issue(i + pl.stages - 1);
      }
      cp_async_commit();
      switch (pl.stages) {  // groups younger than step i's may be pending
        case 2: cp_async_wait<1>(); break;
        case 3: cp_async_wait<2>(); break;
        case 4: cp_async_wait<3>(); break;
        case 5: cp_async_wait<4>(); break;
        default: cp_async_wait<5>(); break;
      }
      __syncthreads();
    };

    if constexpr (kMmaHD > 0) {
      // bf16 q and pool, hd = kMmaHD.  Each warp takes 16-column slices of
      // every step (slice warp, warp + 4, ...) and keeps its own online
      // softmax and O for the group's rows, padded to mma's 16 (row g =
      // lane / 4 of the quad; rows 8-15 are zeros), so a step needs no
      // barrier beyond its stage's.  S = Q K^T and O += P V by mma.sync
      // m16n8k16: Q's A fragments stay in registers for the walk, K's B
      // fragments come by ldmatrix and V's by ldmatrix.trans from the
      // swizzled tiles, and P (S's accumulators, rounded to bf16) is O's A
      // fragment as it stands.  S sums even and odd k16 steps in two
      // chains, so the products of one wait on half as many before them.
      constexpr int kNT = kMmaHD / 8;
      const int qg = lane >> 2, tig = lane & 3;
      float o[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
      float m_w = kNegInf, l_w = 0.f;  // row qg, this lane's share of l
      int st = 0;
      for (int i = 0; i < n_steps; ++i, st = st + 1 == pl.stages ? 0 : st + 1) {
        next_step(i);
        const unsigned char* kt = ring + (size_t)st * 2 * pl.tile;
        const unsigned char* vt = kt + pl.tile;
        const int live = min(pl.step, n_live - i * pl.step);
        for (int t0 = warp * 16; t0 < live; t0 += kWarps * 16) {
          float s[2][2][4] = {};  // [chain][n-tile]
          const int kr = t0 + (lane & 7) + ((lane >> 4) << 3);
#pragma unroll
          for (int kk = 0; kk < kKK; ++kk) {
            uint32_t kb[4];
            ldmatrix_x4<false>(kb,
                               kt + pl.at(kr, 2 * kk + ((lane >> 3) & 1)) * 16);
            const uint32_t a[4] = {qa[kk][0], 0u, qa[kk][1], 0u};
            mma_bf16(s[kk & 1][0], a, kb[0], kb[1]);
            mma_bf16(s[kk & 1][1], a, kb[2], kb[3]);
          }
          // columns t0 + 8 n + 2 tig + e of row qg: s[.][n][e]
          float x[4], mx = kNegInf;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int t = t0 + 8 * (j >> 1) + 2 * tig + (j & 1);
            const float v = s[0][j >> 1][j & 1] + s[1][j >> 1][j & 1];
            x[j] = t < live ? v * scale : kNegInf;
            mx = fmaxf(mx, x[j]);
          }
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m_w, mx);
          const float corr = expf(m_w - m_new);
          float p[4], sum = 0.f;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            p[j] = x[j] > kNegInf ? expf(x[j] - m_new) : 0.f;
            sum += p[j];
          }
          l_w = l_w * corr + sum;
          m_w = m_new;
          const uint32_t pa[4] = {pack_bf16(p[0], p[1]), 0u,
                                  pack_bf16(p[2], p[3]), 0u};
          const int vr_ = t0 + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
          for (int n = 0; n < kNT; n += 2) {
            uint32_t vb[4];
            ldmatrix_x4<true>(vb, vt + pl.at(vr_, n + (lane >> 4)) * 16);
            o[n][0] *= corr;
            o[n][1] *= corr;
            o[n + 1][0] *= corr;
            o[n + 1][1] *= corr;
            mma_bf16(o[n], pa, vb[0], vb[1]);
            mma_bf16(o[n + 1], pa, vb[2], vb[3]);
          }
        }
      }
      cp_async_wait<0>();
      // the warps' partials, merged in warp order: O rows through the ring,
      // (m, l) per warp and row beside them
      l_w += __shfl_xor_sync(0xffffffffu, l_w, 1);
      l_w += __shfl_xor_sync(0xffffffffu, l_w, 2);
      float* wm = reinterpret_cast<float*>(smem + pl.off_w);  // [warp][g]
      float* wl = wm + kWarps * kMaxG;
      __syncthreads();  // every warp is done with the ring's tiles
      if (qg < G) {
        if (tig == 0) {
          wm[warp * kMaxG + qg] = m_w;
          wl[warp * kMaxG + qg] = l_w;
        }
#pragma unroll
        for (int n = 0; n < kNT; ++n) {
          float* r = red + ((size_t)warp * G + qg) * HD + 8 * n + 2 * tig;
          r[0] = o[n][0];
          r[1] = o[n][1];
        }
      }
      __syncthreads();
      if (tid < G) {  // the weights exp(m_w - M) of each warp, then l
        float M = kNegInf;
        for (int w = 0; w < kWarps; ++w) M = fmaxf(M, wm[w * kMaxG + tid]);
        float L = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          const float e = expf(wm[w * kMaxG + tid] - M);
          wm[w * kMaxG + tid] = e;
          L += wl[w * kMaxG + tid] * e;
        }
        m_s[tid] = M;
        l_s[tid] = L;
      }
      __syncthreads();
      for (int e = tid; e < G * HD; e += kAttnThreads) {
        const int g = e / HD;
        float acc = 0.f;
        for (int w = 0; w < kWarps; ++w)
          acc += red[(size_t)w * G * HD + e] * wm[w * kMaxG + g];
        red[e] = acc;  // only this thread reads element e of any warp
      }
      __syncthreads();
    } else {
      // f32 q (f32 or int8 pools), bf16 q over int8 pools, and heads the
      // mma path does not hold: FMA.  Scores with one thread per (column,
      // slice of hd), the online softmax one warp per query head, P.V one
      // thread per (pair of hd columns, token group).
      float* s_s = reinterpret_cast<float*>(smem + pl.off_s);
      float* p_s = reinterpret_cast<float*>(smem + pl.off_p);
      const int sr = tid % pl.step, spart = tid / pl.step;
      const int c_lo = spart * pl.cpp, c_hi = min(pl.vpr, c_lo + pl.cpp);
      const int np = HD / 2, tpr = (np + kSlots - 1) / kSlots;
      const int tgs = kAttnThreads / tpr;
      const int my_tg = tid / tpr, jj = tid - my_tg * tpr;
      float acc[kSlots][kMaxG][2];
#pragma unroll
      for (int k = 0; k < kSlots; ++k)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) acc[k][g][0] = acc[k][g][1] = 0.f;

      int st = 0;
      for (int i = 0; i < n_steps; ++i, st = st + 1 == pl.stages ? 0 : st + 1) {
        next_step(i);
        const unsigned char* kt = ring + (size_t)st * 2 * pl.tile;
        const unsigned char* vt = kt + pl.tile;
        const float* ksc = sc_s + st * 2 * pl.step;
        const float* vsc = ksc + pl.step;
        const int live = min(pl.step, n_live - i * pl.step);

        float s[kMaxG];
#pragma unroll
        for (int g = 0; g < kMaxG; ++g) s[g] = 0.f;
        if (sr < live) {
          constexpr int E = 16 / sizeof(PT);  // elements a chunk
          const float kscale = kQuant ? ksc[sr] : 1.f;
          for (int c = c_lo; c < c_hi; ++c) {
            const uint4 kv4 =
                *reinterpret_cast<const uint4*>(kt + pl.at(sr, c) * 16);
            float kf[E];
#pragma unroll
            for (int e = 0; e < E; ++e) {
              kf[e] = vec_elem<PT>(kv4, e);
              if (kQuant) kf[e] = round_q<QT>(kf[e] * kscale);
            }
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g < G) {
                const float* qg = q_s + g * HD + c * E;
#pragma unroll
                for (int e = 0; e < E; e += 4) {
                  const float4 qv = *reinterpret_cast<const float4*>(qg + e);
                  s[g] = fmaf(qv.x, kf[e], s[g]);
                  s[g] = fmaf(qv.y, kf[e + 1], s[g]);
                  s[g] = fmaf(qv.z, kf[e + 2], s[g]);
                  s[g] = fmaf(qv.w, kf[e + 3], s[g]);
                }
              }
            }
          }
        }
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          s_s[(spart * kMaxG + g) * pl.step + sr] = s[g];
        __syncthreads();

        // online softmax, one warp a query head, in the reference's order
        for (int g = warp; g < G; g += kWarps) {
          float x[kMaxStep / 32];
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < kMaxStep / 32; ++j) {
            const int t = lane + 32 * j;
            float v = kNegInf;
            if (t < live) {
              v = 0.f;
              for (int p = 0; p < pl.parts; ++p)
                v += s_s[(p * kMaxG + g) * pl.step + t];
              v *= scale;
            }
            x[j] = v;
            mx = fmaxf(mx, v);
          }
          const float m_old = m_s[g];
          const float m_new = fmaxf(m_old, warp_max(mx));
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < kMaxStep / 32; ++j) {
            const int t = lane + 32 * j;
            if (t < pl.step) {
              const float e = t < live ? expf(x[j] - m_new) : 0.f;
              sum += e;
              p_s[t * kMaxG + g] = round_q<QT>(e);  // P in q's dtype
            }
          }
          sum = warp_sum(sum);  // every lane has read m_s[g] by now
          if (lane == 0) {
            const float corr = expf(m_old - m_new);
            c_s[g] = corr;
            m_s[g] = m_new;
            l_s[g] = l_s[g] * corr + sum;
          }
        }
        __syncthreads();

        // acc = acc * corr + P V over this thread's token group
        if (my_tg < tgs) {
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) {
            if (g < G) {
              const float corr = c_s[g];
#pragma unroll
              for (int k = 0; k < kSlots; ++k) {
                acc[k][g][0] *= corr;
                acc[k][g][1] *= corr;
              }
            }
          }
          for (int t = my_tg; t < live; t += tgs) {
            const float4 pa =
                *reinterpret_cast<const float4*>(p_s + t * kMaxG);
            const float4 pb =
                *reinterpret_cast<const float4*>(p_s + t * kMaxG + 4);
            const float pw[kMaxG] = {pa.x, pa.y, pa.z, pa.w,
                                     pb.x, pb.y, pb.z, pb.w};
            const float vscale = kQuant ? vsc[t] : 1.f;
#pragma unroll
            for (int k = 0; k < kSlots; ++k) {
              const int j = jj + k * tpr;
              if (j < np) {
                const int off = j * 2 * (int)sizeof(PT);  // bytes into row
                float2 v = pair_elems<PT>(vt + pl.at(t, off >> 4) * 16 +
                                          (off & 15));
                if (kQuant) {
                  v.x = round_q<QT>(v.x * vscale);
                  v.y = round_q<QT>(v.y * vscale);
                }
#pragma unroll
                for (int g = 0; g < kMaxG; ++g) {
                  if (g < G) {
                    acc[k][g][0] = fmaf(pw[g], v.x, acc[k][g][0]);
                    acc[k][g][1] = fmaf(pw[g], v.y, acc[k][g][1]);
                  }
                }
              }
            }
          }
        }
      }
      cp_async_wait<0>();
      __syncthreads();
      // the token groups' partials through the ring, summed in group order
      if (my_tg < tgs) {
#pragma unroll
        for (int k = 0; k < kSlots; ++k) {
          const int j = jj + k * tpr;
          if (j < np) {
#pragma unroll
            for (int g = 0; g < kMaxG; ++g) {
              if (g < G) {
                float* r = red + ((size_t)my_tg * G + g) * HD + 2 * j;
                r[0] = acc[k][g][0];
                r[1] = acc[k][g][1];
              }
            }
          }
        }
      }
      __syncthreads();
      for (int e = tid; e < G * HD; e += kAttnThreads) {
        float o = red[e];
        for (int z = 1; z < tgs; ++z) o += red[(size_t)z * G * HD + e];
        red[e] = o;
      }
      __syncthreads();
    }

    // the CTA's (m, l) in m_s / l_s and acc [G, HD] in red
    if (splits == 1) {
      for (int e = tid; e < G * HD; e += kAttnThreads) {
        const float l = l_s[e / HD];
        out[q_off + e] = from_f32<QT>(red[e] / (l == 0.f ? 1.f : l));
      }
      return;
    }
    for (int e = tid; e < G * HD; e += kAttnThreads)
      part[2 * kMaxG + e] = red[e];
    if (tid < kMaxG) {
      part[tid] = m_s[tid];
      part[kMaxG + tid] = l_s[tid];
    }
  } else if (tid < kMaxG) {  // an empty split: m = -1e30, l = 0, no acc
    part[tid] = kNegInf;
    part[kMaxG + tid] = 0.f;
  }

  // arrive: the CTA's writes are done; one fence releases them, and the
  // last of the cell's splits to arrive merges them
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const int last = atomicAdd(counters + cell, 1) == splits - 1;
    if (last) {
      counters[cell] = 0;  // ready for the next launch
      __threadfence();
    }
    *flag_s = last;
  }
  __syncthreads();
  if (!*flag_s) return;
  // every split's (m, l) in one round trip, then each split's weight
  // exp(m - M) per query head (0 for an empty split) and L
  float* ml = reinterpret_cast<float*>(ring);  // [splits][m, l][kMaxG]
  float* wts = ml + splits * 2 * kMaxG;          // [splits][kMaxG]
  for (int i = tid; i < splits * 2 * kMaxG; i += kAttnThreads) {
    const int z = i / (2 * kMaxG);
    ml[i] = __ldcg(cell_ws + z * ws_stride + (i - z * 2 * kMaxG));
  }
  __syncthreads();
  if (tid < G) {
    float M = kNegInf;
    for (int z = 0; z < splits; ++z)
      if (ml[(z * 2 + 1) * kMaxG + tid] > 0.f)
        M = fmaxf(M, ml[z * 2 * kMaxG + tid]);
    float L = 0.f;
    for (int z = 0; z < splits; ++z) {
      const float l = ml[(z * 2 + 1) * kMaxG + tid];
      const float w = l > 0.f ? expf(ml[z * 2 * kMaxG + tid] - M) : 0.f;
      wts[z * kMaxG + tid] = w;
      L += l * w;
    }
    l_s[tid] = L == 0.f ? 1.f : L;
  }
  __syncthreads();
  // out = sum_z w_z acc_z / L, four elements of a row a thread (HD % 4 ==
  // 0) by 16-byte loads, eight splits at a time in flight together; the acc
  // of an empty split is never written and its loads are selected out
  const float* acc_ws = cell_ws + 2 * kMaxG;
  for (int e = 4 * tid; e < G * HD; e += 4 * kAttnThreads) {
    const int g = e / HD;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int z0 = 0; z0 < splits; z0 += 8) {
      float4 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = z0 + j < splits
                   ? __ldcg(reinterpret_cast<const float4*>(
                         acc_ws + (z0 + j) * ws_stride + e))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float w = z0 + j < splits ? wts[(z0 + j) * kMaxG + g] : 0.f;
        const bool on = w != 0.f;
        o.x += on ? w * v[j].x : 0.f;
        o.y += on ? w * v[j].y : 0.f;
        o.z += on ? w * v[j].z : 0.f;
        o.w += on ? w * v[j].w : 0.f;
      }
    }
    const float inv = l_s[g];
    out[q_off + e] = from_f32<QT>(o.x / inv);
    out[q_off + e + 1] = from_f32<QT>(o.y / inv);
    out[q_off + e + 2] = from_f32<QT>(o.z / inv);
    out[q_off + e + 3] = from_f32<QT>(o.w / inv);
  }
}

// ---------------------------------------------------------------------------
// K6 for heads wider than kMaxHD, where the walk above would hold more
// than kWideSlots hd pairs a P.V thread and its tiles outgrow shared
// memory.  A simple kernel, right before fast: the grid is (column part,
// kv head x group chunk, row); each CTA walks its row's whole table, one
// token a warp a step, K and V read straight from device memory (no
// split, no workspace).  Scores q.k over the whole head (each warp one
// token, lanes over hd, every CTA of the row the same sums in the same
// order), the online softmax one thread a query head as the FMA path does
// it (P rounded to q's dtype against the running max), and P.V for the
// CTA's kWideCols columns, one thread a column, the accumulators in
// shared memory.  With kAppend, every column-part CTA of (row, kv head x
// group chunk) reads every K column for its scores, so each writes the
// whole new row (K, V and the int8 scales: identical bytes) and then reads
// the pools through L2 (ld.global.cg), never the read-only path, whose
// cache does not see a store of the same launch.
// ---------------------------------------------------------------------------
constexpr int kWideCols = 1024;  // the columns of a wide head a CTA owns

// one pool element as f32; kCg: through L2, for pools this launch writes
template <bool kCg, typename T>
__device__ __forceinline__ float elem_f32(const T* p) {
  if constexpr (sizeof(T) == 1) {
    const signed char* c = reinterpret_cast<const signed char*>(p);
    return static_cast<float>(kCg ? __ldcg(c) : *c);
  } else {
    return to_f32<T>(kCg ? __ldcg(p) : *p);
  }
}

template <typename QT, typename PT, bool kAppend>
__global__ void __launch_bounds__(kAttnThreads)
    decode_attention_wide(QT* __restrict__ out, const QT* __restrict__ q,
                          const PT* __restrict__ k_pool,
                          const PT* __restrict__ v_pool,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ tables,
                          const int* __restrict__ pos, int layer, int NB,
                          int BS, int KV, int HD, int group, int W,
                          float scale, NewRow nr) {
  constexpr bool kQuant = sizeof(PT) == 1;
  __shared__ float acc_s[kMaxG * kWideCols];
  __shared__ float s_s[kWarps][kMaxG], p_s[kWarps][kMaxG];
  __shared__ float m_s[kMaxG], l_s[kMaxG], c_s[kMaxG];
  __shared__ long long row_s[kWarps];  // the step's pool rows (-1: none)
  __shared__ float vsc_s[kWarps];
  const int n_gc = (group + kMaxG - 1) / kMaxG;
  const int part = blockIdx.x, hc = blockIdx.y, b = blockIdx.z;
  const int kvh = hc / n_gc, g0 = (hc - kvh * n_gc) * kMaxG;
  const int G = min(kMaxG, group - g0);
  const int c_lo = part * kWideCols, nc = min(kWideCols, HD - c_lo);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long q_off =
      ((long long)b * KV * group + (long long)kvh * group + g0) * HD;
  const int p_b = pos[b];
  const int n_tok = p_b < 0 ? 0 : min(p_b + 1, W * BS);
  for (int i = tid; i < G * kWideCols; i += kAttnThreads) acc_s[i] = 0.f;
  if (tid < kMaxG) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  const long long layer_row = (long long)layer * NB;
  if constexpr (kAppend) {
    if (p_b >= 0 && p_b < W * BS) {
      store_new_row(
          nr,
          pool_slot(layer, NB, BS, tables[(long long)b * W + p_b / BS], p_b),
          b, kvh, KV, HD * (int)sizeof(PT), tid, kAttnThreads);
      __syncthreads();  // the stores, before any warp reads the row
    }
  }
  for (int t0 = 0; t0 < n_tok; t0 += kWarps) {
    const int t = t0 + warp;
    long long row = -1;  // the pool row of token t, kv head kvh
    if (t < n_tok)
      row = ((layer_row + tables[(long long)b * W + t / BS]) * BS + t % BS) *
                KV + kvh;
    const float ksc =
        kQuant && row >= 0 ? (kAppend ? __ldcg(k_scale + row) : k_scale[row])
                           : 1.f;
    for (int g = 0; g < G; ++g) {
      float s = 0.f;
      if (row >= 0) {
        for (int d = lane; d < HD; d += 32) {
          float kf = elem_f32<kAppend>(k_pool + row * HD + d);
          if (kQuant) kf = round_q<QT>(kf * ksc);
          s = fmaf(to_f32<QT>(q[q_off + (long long)g * HD + d]), kf, s);
        }
      }
      s = warp_sum(s);
      if (lane == 0) s_s[warp][g] = row >= 0 ? s * scale : kNegInf;
    }
    if (lane == 0) {
      row_s[warp] = row;
      vsc_s[warp] =
          kQuant && row >= 0 ? (kAppend ? __ldcg(v_scale + row) : v_scale[row])
                             : 1.f;
    }
    __syncthreads();
    if (tid < G) {  // the online softmax of query head tid over the step
      const float m_old = m_s[tid];
      float m_new = m_old;
      for (int w = 0; w < kWarps; ++w) m_new = fmaxf(m_new, s_s[w][tid]);
      float sum = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        const float e = row_s[w] >= 0 ? expf(s_s[w][tid] - m_new) : 0.f;
        sum += e;
        p_s[w][tid] = round_q<QT>(e);  // P in q's dtype
      }
      const float corr = expf(m_old - m_new);
      c_s[tid] = corr;
      m_s[tid] = m_new;
      l_s[tid] = l_s[tid] * corr + sum;
    }
    __syncthreads();
    for (int c = tid; c < nc; c += kAttnThreads) {
      float v[kWarps];
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        v[w] = 0.f;
        if (row_s[w] >= 0) {
          v[w] = elem_f32<kAppend>(v_pool + row_s[w] * HD + c_lo + c);
          if (kQuant) v[w] = round_q<QT>(v[w] * vsc_s[w]);
        }
      }
      for (int g = 0; g < G; ++g) {
        float a = acc_s[g * kWideCols + c] * c_s[g];
#pragma unroll
        for (int w = 0; w < kWarps; ++w) a = fmaf(p_s[w][g], v[w], a);
        acc_s[g * kWideCols + c] = a;
      }
    }
    __syncthreads();
  }
  __syncthreads();
  for (int i = tid; i < G * nc; i += kAttnThreads) {
    const int g = i / nc, c = i - g * nc;
    const float l = l_s[g];
    out[q_off + (long long)g * HD + c_lo + c] =
        from_f32<QT>(acc_s[g * kWideCols + c] / (l == 0.f ? 1.f : l));
  }
}

// One instantiation's launch.
template <typename QT, typename PT, int kSlots, int kMmaHD, bool kAppend>
cudaError_t launch_variant(dim3 grid, size_t smem, cudaStream_t stream,
                           void* out, const void* q, const void* k_pool,
                           const void* v_pool, const void* k_scale,
                           const void* v_scale, const void* tables,
                           const void* pos, void* ws, void* counters,
                           int layer, int NB, int BS, int KV, int HD,
                           int group, int W, int per, int splits, int stages,
                           float scale, const NewRow& nr) {
  auto kernel = decode_attention_kernel<QT, PT, kSlots, kMmaHD, kAppend>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kAttnThreads, smem, stream>>>(
      static_cast<QT*>(out), static_cast<const QT*>(q),
      static_cast<const PT*>(k_pool), static_cast<const PT*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(pos),
      static_cast<float*>(ws), static_cast<int*>(counters), layer, NB, BS, KV,
      HD, group, W, per, splits, stages, scale, nr);
  return cudaGetLastError();
}

template <typename QT, typename PT, bool kAppend>
cudaError_t launch_attention(void* out, const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const void* tables,
                             const void* pos, void* ws, void* counters,
                             int layer, int NB, int BS, int KV, int HD, int H,
                             int B, int W, int per, int splits, float scale,
                             const NewRow& nr, cudaStream_t stream) {
  if ((HD * (int)sizeof(PT)) % 16 != 0 || KV < 1 || H % KV != 0 ||
      splits < 1 || splits > kMaxSplits || per < 1 ||
      (long long)(splits - 1) * per >= W || (long long)splits * per < W)
    return cudaErrorInvalidValue;
  if (kAppend && (nr.vb < 1 || nr.vb > 16 || (nr.vb & (nr.vb - 1)) != 0))
    return cudaErrorInvalidValue;
  const int group = H / KV, G = min(group, kMaxG);
  if (HD > kMaxHD) {  // one CTA a (column part, kv head x group chunk, row)
    decode_attention_wide<QT, PT, kAppend>
        <<<dim3((HD + kWideCols - 1) / kWideCols,
                KV * ((group + kMaxG - 1) / kMaxG), B),
           kAttnThreads, 0, stream>>>(
            static_cast<QT*>(out), static_cast<const QT*>(q),
            static_cast<const PT*>(k_pool), static_cast<const PT*>(v_pool),
            static_cast<const float*>(k_scale),
            static_cast<const float*>(v_scale),
            static_cast<const int*>(tables), static_cast<const int*>(pos),
            layer, NB, BS, KV, HD, group, W, scale, nr);
    return cudaGetLastError();
  }
  int stages = 3;
  if (DecodePlan(HD, sizeof(PT), G, stages, per).bytes > kSmemOptIn)
    stages = 2;
  const DecodePlan plan(HD, sizeof(PT), G, stages, per);
  const size_t smem = plan.bytes;
  // a step's copies must fit kMaxVecs a thread (hd <= kMaxHD makes sure)
  if (smem > kSmemOptIn || plan.step * plan.vpr > kMaxVecs * kAttnThreads)
    return cudaErrorInvalidValue;
  const dim3 grid(splits, KV * ((group + kMaxG - 1) / kMaxG), B);
  constexpr bool kBf16 = sizeof(QT) == 2 && sizeof(PT) == 2;
#define RT_VARIANT(SLOTS, MMA)                                             \
  launch_variant<QT, PT, SLOTS, MMA, kAppend>(                             \
      grid, smem, stream, out, q, k_pool, v_pool, k_scale, v_scale, tables, \
      pos, ws, counters, layer, NB, BS, KV, HD, group, W, per, splits,     \
      stages, scale, nr)
  if constexpr (kBf16) {
    if (HD == 128) return RT_VARIANT(1, 128);
    if (HD == 64) return RT_VARIANT(1, 64);
  }
  if (pv_slots(HD) == 1) return RT_VARIANT(1, 0);
  return RT_VARIANT(kWideSlots, 0);
#undef RT_VARIANT
}

// K6, or with kAppend K5 and K6 in one launch, for the dtype pair
template <bool kAppend>
int launch_by_dtype(void* out, const void* q, const void* k_pool,
                    const void* v_pool, const void* k_scale,
                    const void* v_scale, const void* tables, const void* pos,
                    void* ws, void* counters, int layer, int NB, int BS,
                    int KV, int HD, int H, int B, int W, int per, int splits,
                    float scale, int q_dtype, int pool_dtype, const NewRow& nr,
                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_ATTN(QT, PT)                                                    \
  launch_attention<QT, PT, kAppend>(out, q, k_pool, v_pool, k_scale,       \
                                    v_scale, tables, pos, ws, counters,    \
                                    layer, NB, BS, KV, HD, H, B, W, per,   \
                                    splits, scale, nr, s)
  if (q_dtype == kF32 && pool_dtype == kF32) return (int)RT_ATTN(float, float);
  if (q_dtype == kBF16 && pool_dtype == kBF16)
    return (int)RT_ATTN(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && pool_dtype == kI8) return (int)RT_ATTN(float, int8_t);
  if (q_dtype == kBF16 && pool_dtype == kI8)
    return (int)RT_ATTN(__nv_bfloat16, int8_t);
#undef RT_ATTN
  return (int)cudaErrorInvalidValue;
}

__global__ void empty_kernel() {}

}  // namespace

extern "C" {

// K5.  vec_bytes is the copy unit (16, 8, 4, 2 or 1), chosen by the wrapper
// to divide row_bytes and the alignment of all four data pointers.  The
// scale pointers are null for model-dtype pools.
int rt_paged_kv_append(void* k_pool, void* v_pool, const void* k_new,
                       const void* v_new, void* k_scale, void* v_scale,
                       const void* k_new_scale, const void* v_new_scale,
                       const void* tables, const void* pos, int layer, int NB,
                       int BS, int KV, int row_bytes, int B, int W,
                       int vec_bytes, void* stream) {
  if (vec_bytes < 1 || vec_bytes > 16 || (vec_bytes & (vec_bytes - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const NewRow nr{static_cast<const char*>(k_new),
                  static_cast<const char*>(v_new),
                  static_cast<const float*>(k_new_scale),
                  static_cast<const float*>(v_new_scale),
                  static_cast<char*>(k_pool),
                  static_cast<char*>(v_pool),
                  static_cast<float*>(k_scale),
                  static_cast<float*>(v_scale),
                  vec_bytes};
  append_kernel<<<dim3(B, KV), 32, 0, static_cast<cudaStream_t>(stream)>>>(
      nr, static_cast<const int*>(tables), static_cast<const int*>(pos), layer,
      NB, BS, KV, row_bytes, W);
  return (int)cudaGetLastError();
}

// K6.  q_dtype / pool_dtype: 0 = f32, 1 = bf16, 2 = int8 (pool only).  An
// int8 pool needs the scale pointers; a model-dtype pool has q's dtype.
// Each row's table is cut into `splits` runs of `per` blocks; ws is an f32
// workspace of B * KV * ceil(group / kMaxG) * splits * (2 * kMaxG + kMaxG *
// HD) floats and counters as many ints over splits, zeroed once: the
// kernel leaves them zero.
int rt_paged_decode_attention(void* out, const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const void* tables,
                              const void* pos, void* ws, void* counters,
                              int layer, int NB, int BS, int KV, int HD, int H,
                              int B, int W, int per, int splits, float scale,
                              int q_dtype, int pool_dtype, void* stream) {
  return launch_by_dtype<false>(out, q, k_pool, v_pool, k_scale, v_scale,
                                tables, pos, ws, counters, layer, NB, BS, KV,
                                HD, H, B, W, per, splits, scale, q_dtype,
                                pool_dtype, NewRow{}, stream);
}

// K5 folded into K6: rt_paged_kv_append's writes, then
// rt_paged_decode_attention's output, in one launch.  The arguments are
// the union of the two entries'; vec_bytes is the copy unit (16, 8, 4, 2
// or 1) dividing the row and every pointer, as for K5.
int rt_paged_append_decode_attention(
    void* out, const void* q, void* k_pool, void* v_pool, void* k_scale,
    void* v_scale, const void* k_new, const void* v_new,
    const void* k_new_scale, const void* v_new_scale, const void* tables,
    const void* pos, void* ws, void* counters, int layer, int NB, int BS,
    int KV, int HD, int H, int B, int W, int per, int splits, float scale,
    int q_dtype, int pool_dtype, int vec_bytes, void* stream) {
  const NewRow nr{static_cast<const char*>(k_new),
                  static_cast<const char*>(v_new),
                  static_cast<const float*>(k_new_scale),
                  static_cast<const float*>(v_new_scale),
                  static_cast<char*>(k_pool),
                  static_cast<char*>(v_pool),
                  static_cast<float*>(k_scale),
                  static_cast<float*>(v_scale),
                  vec_bytes};
  return launch_by_dtype<true>(out, q, k_pool, v_pool, k_scale, v_scale,
                               tables, pos, ws, counters, layer, NB, BS, KV,
                               HD, H, B, W, per, splits, scale, q_dtype,
                               pool_dtype, nr, stream);
}

// An empty kernel on `stream`: the floor of a launch of its own, for
// timing beside K5 (chip_smoke.py).
int rt_empty_launch(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return (int)cudaGetLastError();
}

}  // extern "C"
