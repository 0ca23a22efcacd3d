// Fused lm-head + softmax cross entropy for Hopper (sm_90a): the forward
// (K7: per-row logsumexp and target logit), and the backward's two products,
// dx (K8) and dw (K9), none of which puts the [N, V] logits in device memory.
// Built by ray_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// wrappers in ray_tpu_torch/ops/xent_pallas.py check devices, dtypes, shapes,
// alignment and contiguity before passing pointers (and cast an f32 `w` to
// x's dtype, as the reference casts before its products); every entry here
// returns cudaGetLastError() after its launch, and the wrapper raises if it
// is not 0.
//
// Layouts (all contiguous, row-major):
//   x          [N, E]   f32 or bf16
//   w          [V, E]   x's dtype
//   targets    [N]      int32; a target outside [0, V) matches no column
//   lse, tgt   [N]      f32 (the reference's [N, 1])
//   dx         [N, E]   f32, unscaled (the wrapper scales by g / N)
//   dw         [V, E]   f32, unscaled
//
// How the TPU kernels translate.  The Pallas kernels take 512 x E VMEM blocks
// and carry (m, l, t), or a [block_n, E] / [block_v, E] f32 accumulator,
// across the sequential last grid axis; they pad x, w and targets up to the
// blocks in device memory first.  Here nothing is padded: every tile load
// zero-fills the rows past N or V and the columns past E, and the kernels
// mask columns past V (-1e30 before the max in K7, probability 0 in K8/K9).
// The f32 K7, K8 and K9 are the first design, kept as the instantiation
// that checks the algorithm against the plain versions: they share one
// step, a score tile S = A[64 rows] . B[64 rows]^T over all of E, streamed
// in E chunks through a two-stage cp.async ring in shared memory, on scalar
// FMA with a 4 x 4 register tile a thread.  The bf16 K7, K8 and K9 are
// Hopper kernels (TMA, mbarriers, wgmma with accumulators in registers, PTX
// helpers in hopper.cuh); see their notes.
//
// Bound on this card.  At the GPT-2 124M head (N 32,768, E 768, V 50,257,
// bf16) every kernel is bound by tensor-core operations: K7 does 2 N V E =
// 2.53 TFLOP (2.56 ms at 989 TFLOP/s) against ~0.13 GB of input (0.04 ms at
// 3.35 TB/s); K8 and K9 each recompute S and do one more product, 4 N V E,
// 5.1 ms each.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"


namespace {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kThreads = 256;      // eight warps per block
constexpr int kBM = 64;  // rows of a score tile (A side) = rows of an output tile
constexpr int kBN = 64;  // columns of a score tile (B side): K8/K9's reduction step
constexpr int kES = 256;  // output columns a K8/K9 block owns (a slice of E)
constexpr int kPadF = 4;  // f32 score tile: ld = kBN + 4
enum DType { kF32 = 0, kBF16 = 1 };

// E chunk per pipeline stage and the row pad (elements) of the T tiles: the
// pad spreads f32 rows over banks
template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kBK = 32, kPad = 4;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// rows [row0, row0 + rows) x columns [col0, col0 + cols) of a row-major
// [n_rows, E] matrix into a shared tile (ld lds), 16 bytes a copy; rows past
// n_rows and columns past E arrive as zeros.  E % 8 == 0 and col0, cols
// multiples of 8, so a 16-byte vector is wholly inside or wholly outside.
template <typename T>
__device__ __forceinline__ void load_async(T* s, int lds, const T* g,
                                           int n_rows, int E, int row0,
                                           int col0, int rows, int cols) {
  constexpr int kVec = 16 / sizeof(T);
  const int vpr = cols / kVec;
  for (int i = threadIdx.x; i < rows * vpr; i += kThreads) {
    const int r = i / vpr, c = (i - r * vpr) * kVec;
    const bool ok = row0 + r < n_rows && col0 + c < E;
    const T* src = ok ? g + (long long)(row0 + r) * E + col0 + c : g;
    hopper::cp_async16(s + r * lds + c, src, ok);
  }
}

// An M x N f32 accumulator held in registers across a block's eight warps
// (the f32 first design's).
//   mma_nt: acc += A[M, K] . B[N, K]^T;  mma_nn: acc += A[M, K] . B[K, N]
// (A, B in shared memory, K a multiple of 16).  store: the tile into shared
// memory; store_global: rows [0, rows) x columns [0, cols) of it into device
// memory.  No barrier inside.
template <typename T, int M, int N>
struct Acc;

// f32: scalar FMA, threads as 16 x 16, each holding rows ty + 16 i and
// columns tx + 16 j of the tile
template <int M, int N>
struct Acc<float, M, N> {
  static constexpr int TM = M / 16, TN = N / 16;
  float c[TM][TN];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = 0.f;
  }
  template <bool kNT>
  __device__ __forceinline__ void mma(const float* A, int lda, const float* B,
                                      int ldb, int K) {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = A[(ty + 16 * i) * lda + k];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = kNT ? B[(tx + 16 * j) * ldb + k] : B[k * ldb + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void mma_nt(const float* A, int lda,
                                         const float* B, int ldb, int K) {
    mma<true>(A, lda, B, ldb, K);
  }
  __device__ __forceinline__ void mma_nn(const float* A, int lda,
                                         const float* B, int ldb, int K) {
    mma<false>(A, lda, B, ldb, K);
  }
  __device__ __forceinline__ void store(float* C, int ldc) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) C[(ty + 16 * i) * ldc + tx + 16 * j] = c[i][j];
  }
  __device__ __forceinline__ void store_global(float* G, long long ldg,
                                               int rows, int cols) const {
    const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int r = ty + 16 * i, col = tx + 16 * j;
        if (r < rows && col < cols) G[r * ldg + col] = c[i][j];
      }
  }
};

// acc = A[a0 : a0 + M, :E] . B[b0 : b0 + N, :E]^T in f32, rows past na / nb
// as zeros.  E streams through two stages of [M, BK] and [N, BK] tiles at
// sA / sB: the next chunk's copies are in flight while this one multiplies.
// Ends on a barrier, so the caller may reuse the stages and anything the
// block read before the call.
template <typename T, int M, int N>
__device__ __forceinline__ void score_tile(Acc<T, M, N>& acc, const T* A,
                                           int na, int a0, const T* B, int nb,
                                           int b0, int E, T* sA, T* sB) {
  constexpr int BK = Cfg<T>::kBK, ld = BK + Cfg<T>::kPad;
  const int nk = (E + BK - 1) / BK;
  acc.zero();
  load_async(sA, ld, A, na, E, a0, 0, M, BK);
  load_async(sB, ld, B, nb, E, b0, 0, N, BK);
  hopper::cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) {
      const int nxt = cur ^ 1;
      load_async(sA + nxt * M * ld, ld, A, na, E, a0, (kc + 1) * BK, M, BK);
      load_async(sB + nxt * N * ld, ld, B, nb, E, b0, (kc + 1) * BK, N, BK);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    acc.mma_nt(sA + cur * M * ld, ld, sB + cur * N * ld, ld, BK);
    __syncthreads();
  }
}

constexpr size_t up128(size_t n) { return (n + 127) / 128 * 128; }

// shared-memory plan (byte offsets), shared by the kernels and launchers
template <typename T>
struct Plan {
  static constexpr int ld = Cfg<T>::kBK + Cfg<T>::kPad;  // A / B stages
  static constexpr int lds = kBN + kPadF;                // f32 scores
  static constexpr int ldd = kBN + Cfg<T>::kPad;         // dl tile
  static constexpr int ldb2 = kES + Cfg<T>::kPad;        // K8/K9's B slice
  static constexpr size_t a = 0;
  static constexpr size_t b = up128(a + 2 * kBM * ld * sizeof(T));
  static constexpr size_t s = up128(b + 2 * kBN * ld * sizeof(T));
  static constexpr size_t vec = up128(s + kBM * lds * sizeof(float));
  // K7: m, l, t (f32) and targets; K8 / K9: lse and targets
  static constexpr size_t dl = up128(vec + 4 * 64 * sizeof(float));
  static constexpr size_t b2 = up128(dl + kBM * ldd * sizeof(T));
  static constexpr size_t fwd_bytes = dl;
  static constexpr size_t grad_bytes = up128(b2 + kBN * ldb2 * sizeof(T));
};

// ---------------------------------------------------------------------------
// K7: per-row logsumexp over all V logits and the target logit.
//
// Replaces ray_tpu/ops/xent_pallas.py:51 `_fwd_kernel` (pallas_call at
// l.184, in `_lse_tgt`).
//
// This is the f32 instantiation, the first design kept as the check of the
// algorithm against the plain version (bf16 runs xent_fwd_wgmma below).
// Bound: operations (2 N V E; see the file note).  Design: one
// block per 64-row tile of x, walking the vocab in 64-column tiles, as K1
// walks its kv tiles: the Pallas grid's sequential vocab axis is a loop
// inside the block.  Per tile: S = x w^T (f32, score_tile) into shared
// memory; one warp per row masks columns past V to -1e30, adds the score
// at the target column to t (from the f32 score, never a rounded logit),
// and updates the running m and l in the reference's order (m_new = max(m,
// max s); l = l exp(m - m_new) + sum exp(s - m_new)).  At the end lse = m +
// log l.  (m, l, t) stay in f32 shared memory for the whole walk.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    xent_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                    const int* __restrict__ tg, float* __restrict__ lse,
                    float* __restrict__ tgt, int N, int V, int E) {
  using P = Plan<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem + P::a);
  T* sB = reinterpret_cast<T*>(smem + P::b);
  float* sS = reinterpret_cast<float*>(smem + P::s);
  float* m_s = reinterpret_cast<float*>(smem + P::vec);
  float* l_s = m_s + kBM;
  float* t_s = l_s + kBM;
  int* tg_s = reinterpret_cast<int*>(t_s + kBM);

  const int r0 = blockIdx.x * kBM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int r = tid; r < kBM; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
    t_s[r] = 0.f;
    tg_s[r] = r0 + r < N ? tg[r0 + r] : -1;
  }
  Acc<T, kBM, kBN> acc;
  const int nv = (V + kBN - 1) / kBN;
  for (int vt = 0; vt < nv; ++vt) {
    const int c0 = vt * kBN;
    // its barriers also order the last step's reads of sS before this store
    score_tile(acc, x, N, r0, w, V, c0, E, sA, sB);
    acc.store(sS, P::lds);
    __syncthreads();
    for (int r = warp; r < kBM; r += kThreads / 32) {
      const int t = tg_s[r];
      float mx = kNegInf, hit = 0.f;
      for (int c = lane; c < kBN; c += 32) {
        const int col = c0 + c;
        const float s = col < V ? sS[r * P::lds + c] : kNegInf;
        if (col == t && col < V) hit += s;  // a target >= V matches none
        mx = fmaxf(mx, s);
      }
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < kBN; c += 32) {
        const float s = c0 + c < V ? sS[r * P::lds + c] : kNegInf;
        sum += expf(s - m_new);
      }
      sum = warp_sum(sum);
      hit = warp_sum(hit);
      if (lane == 0) {
        l_s[r] = l_s[r] * expf(m_old - m_new) + sum;
        m_s[r] = m_new;
        t_s[r] += hit;
      }
    }
  }
  __syncthreads();
  for (int r = tid; r < kBM; r += kThreads) {
    if (r0 + r < N) {
      lse[r0 + r] = m_s[r] + logf(l_s[r]);
      tgt[r0 + r] = t_s[r];
    }
  }
}

// ---------------------------------------------------------------------------
// K8 (kDW = false) and K9 (kDW = true): out = dl . B2, where dl = exp(s -
// lse) - onehot(target) is recomputed from the saved lse, 0 past V (and, for
// K9, past N), and cast to x's dtype before the product.
//
// K8 replaces ray_tpu/ops/xent_pallas.py:86 `_dx_kernel` (pallas_call at
// l.230, in `_bwd`): A = x, B = w, out = dx [N, E], reduced over the vocab.
// K9 replaces ray_tpu/ops/xent_pallas.py:114 `_dw_kernel` (pallas_call at
// l.248, in `_bwd`): A = w, B = x, out = dw [V, E], reduced over the rows;
// its score tile is S^T = w x^T, so the two kernels are one loop.
//
// This is the f32 instantiation, the first design kept as the check of the
// algorithm against the plain versions (bf16 runs xent_grad_wgmma below):
// each block owns a 64-row x 256-column slice of the output in registers
// and walks the whole reduction axis in 64-wide steps: per step, S for its
// 64 rows over all of E (score_tile), dl into shared memory, the step's
// [64, 256] slice of B2, then acc += dl . B2.  S is recomputed once per E
// slice (ceil(E / 256) times).
// ---------------------------------------------------------------------------
template <bool kDW>
__global__ void __launch_bounds__(kThreads)
    xent_grad_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     const int* __restrict__ tg,
                     const float* __restrict__ lse, float* __restrict__ out,
                     int N, int V, int E) {
  using T = float;
  using P = Plan<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem + P::a);
  T* sB = reinterpret_cast<T*>(smem + P::b);
  float* sS = reinterpret_cast<float*>(smem + P::s);
  float* lse_s = reinterpret_cast<float*>(smem + P::vec);  // [64]
  int* tg_s = reinterpret_cast<int*>(lse_s + 64);          // [64]
  T* sDL = reinterpret_cast<T*>(smem + P::dl);
  T* sB2 = reinterpret_cast<T*>(smem + P::b2);

  const int na = kDW ? V : N, nb = kDW ? N : V;
  const int a0 = blockIdx.x * kBM, e0 = blockIdx.y * kES;
  const int tid = threadIdx.x;
  if constexpr (!kDW) {  // K8: lse and target of the block's own rows, once
    for (int r = tid; r < kBM; r += kThreads) {
      const int n = a0 + r;
      lse_s[r] = n < N ? lse[n] : 0.f;
      tg_s[r] = n < N ? tg[n] : -1;
    }
  }
  Acc<T, kBM, kES> acc;
  acc.zero();
  Acc<T, kBM, kBN> sacc;
  const int nbt = (nb + kBN - 1) / kBN;
  for (int bt = 0; bt < nbt; ++bt) {
    const int b0 = bt * kBN;
    if constexpr (kDW) {  // K9: lse and target of this step's rows of x
      for (int c = tid; c < kBN; c += kThreads) {
        const int n = b0 + c;
        lse_s[c] = n < N ? lse[n] : 0.f;
        tg_s[c] = n < N ? tg[n] : -1;
      }
    }
    load_async(sB2, P::ldb2, B, nb, E, b0, e0, kBN, kES);
    hopper::cp_async_commit();
    // waits for every copy (the slice of B2 too) and ends on a barrier
    score_tile(sacc, A, na, a0, B, nb, b0, E, sA, sB);
    sacc.store(sS, P::lds);
    __syncthreads();
    for (int i = tid; i < kBM * kBN; i += kThreads) {
      const int r = i / kBN, c = i - r * kBN;
      const int n = kDW ? b0 + c : a0 + r, v = kDW ? a0 + r : b0 + c;
      const int k = kDW ? c : r;
      float dl = 0.f;
      if (n < N && v < V) {
        dl = expf(sS[r * P::lds + c] - lse_s[k]);
        if (tg_s[k] == v) dl -= 1.f;
      }
      sDL[r * P::ldd + c] = dl;
    }
    __syncthreads();
    acc.mma_nn(sDL, P::ldd, sB2, P::ldb2, kBN);
    __syncthreads();
  }
  acc.store_global(out + (long long)a0 * E + e0, E, min(kBM, na - a0),
                   min(kES, E - e0));
}

// ---------------------------------------------------------------------------
// K8 and K9, bf16: Hopper kernels (PTX helpers in hopper.cuh).
//
// Replace the same Pallas builders as above: K8 `_dx_kernel`
// (ray_tpu/ops/xent_pallas.py:86, pallas_call at l.230), K9 `_dw_kernel`
// (l.114, pallas_call at l.248).
//
// Bound: tensor-core operations, 4 N V E (S and the second product, 2 N V
// E each): 5.115 ms at GPT-2 124M's head on an H100 (989 TFLOP/s bf16).
//
// What held the first design (kept as the f32 kernel above) back: each
// block owned a 64 x 256 slice of the output, so S = A B^T over all of E
// was recomputed for every slice (3 times at E 768: 8 N V E in all, twice
// the reference's operations); its products ran on 16x16x16 wmma
// fragments through a two-stage cp.async ring, with S stored to shared
// memory in f32 and read back to form dl; and 64 x 64 tiles reloaded A
// and B every step.
//
// Design: "K1's loop at head width E, with the lse known in advance".  A
// CTA owns 64 output rows (A rows: x's for K8, w's for K9) and up to 768
// output columns: all of E when E <= 768, which covers GPT-2 124M's head,
// so S is computed once per output row block.  Wider E splits into as few
// column slices as fit (six at Llama-3-8B's 4,096), each recomputing S.
// Three warpgroups: a producer whose first thread issues every TMA load
// (128-byte-swizzled [rows, 64] panels through 3-D tensor maps, which
// zero-fill rows past N or V and columns past E), and two consumer
// warpgroups that walk B in steps of 32 rows.  Per step:
//   S [64, 32] = A B_step^T by wgmma m64n32k16 into registers, the E
//     chunks split between the warpgroups (chunk k to warpgroup k % 2);
//   the two f32 partials summed through shared memory (one named barrier a
//     step, the exchange tiles alternating by step), so both warpgroups
//     hold the same S;
//   dl = exp(S - lse) - onehot(target) in registers (0 past N and V), cast
//     to bf16 straight into wgmma's A-fragment layout;
//   out[:, 384 columns of this warpgroup] += dl B_step by wgmma_rs
//     m64n128k16 with B read MN-major from the step's tile, the f32
//     accumulator (192 registers a thread) kept across the walk and
//     written once at the end, so every output element has one owner
//     (deterministic, no atomics).
// The four parts run in turn.  Issuing the next step's S under this step's
// second product (K1's pipeline) needs more registers than the consumers'
// 240 beside the accumulator, and ptxas then serialises every wgmma (the
// kernels ran about a third slower on an H100).
// Shared memory (227 KB): when E <= 768 A's 64 rows stay resident (96 KB)
// and B's steps stream through two stages of [32, E] (2 x 48 KB); wider E
// streams (A panel, B panel) pairs for S through an eight-stage ring in
// A's place, and the stages hold only the slice's columns.  K9's per-column
// lse and target are written beside each stage by a second producer warp.
// ---------------------------------------------------------------------------
constexpr int kGM = 64;          // output rows a CTA owns (rows of A)
constexpr int kGN = 32;          // rows of B a step
constexpr int kSlicePanels = 12;  // output columns a CTA owns: 768
constexpr int kWgPanels = 6;      // a consumer warpgroup's: 384
constexpr int kRing = 8;          // (A, B) panel pairs in flight, wide E
constexpr float kLog2e = 1.4426950408889634f;
// the producer warpgroup drops to 24 registers a thread and the consumers
// take 240 (128 * 24 + 256 * 240 <= 65,536): the accumulator alone is 192
constexpr int kGradProducerRegs = 24, kGradConsumerRegs = 240;

struct GradPlan {
  static constexpr int kAPanel = kGM * hopper::kPanel;  // bf16 elements
  static constexpr int kBPanel = kGN * hopper::kPanel;
  static constexpr int kStage = kSlicePanels * kBPanel;
  static constexpr int kChunk = kAPanel + kBPanel;  // a ring slot
  static constexpr int kA = kSlicePanels * kAPanel;  // = kRing * kChunk
  static constexpr int kXch = kGM * kGN;              // f32 partial S
  static constexpr int kThreads = 3 * hopper::kWarpgroup;
  // A (or the ring), two B stages, four exchange tiles, per stage K9's
  // lse and target, barriers; + 1 KB to align (225.7 KB)
  static constexpr size_t kBytes = 2 * ((size_t)kA + 2 * kStage) +
                                   4 * ((size_t)4 * kXch + 2 * 2 * kGN) +
                                   8 * (1 + 2 * 2 + 2 * kRing) + 1024;
};
static_assert(GradPlan::kA == kRing * GradPlan::kChunk, "ring fills A");

template <bool kDW, bool kStream>
__global__ void __launch_bounds__(GradPlan::kThreads, 1)
    xent_grad_wgmma(const __grid_constant__ CUtensorMap map_a,
                    const __grid_constant__ CUtensorMap map_b,
                    const int* __restrict__ tg,
                    const float* __restrict__ lse, float* __restrict__ out,
                    int N, int V, int E, int slice_panels) {
  using P = GradPlan;
  using hopper::kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hopper::align1024(smem_raw);
  bf16* as = reinterpret_cast<bf16*>(base);  // A's panels, or the ring
  bf16* bs = as + P::kA;                     // [2] B stages
  float* xch = reinterpret_cast<float*>(bs + 2 * P::kStage);  // [wg][2]
  float* col_lse = xch + 4 * P::kXch;  // K9: [2][32] lse * log2 e
  int* col_tg = reinterpret_cast<int*>(col_lse + 2 * kGN);  // [2][32]
  uint64_t* a_full = reinterpret_cast<uint64_t*>(col_tg + 2 * kGN);
  uint64_t* full = a_full + 1;  // a B stage (and K9's row data) landed
  uint64_t* empty = full + 2;   // every consumer warp is done with it
  uint64_t* ring_full = empty + 2;
  uint64_t* ring_empty = ring_full + kRing;

  const int na = kDW ? V : N, nb = kDW ? N : V;
  const int a0 = blockIdx.x * kGM;
  const int nk = (E + kPanel - 1) / kPanel;  // S's chunks: all of E
  const int p0 = blockIdx.y * slice_panels;  // the slice's first panel
  const int np = min(slice_panels, nk - p0);  // and its panel count
  const int steps = (nb + kGN - 1) / kGN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(a_full, 1);
    for (int s = 0; s < 2; ++s) {
      hopper::mbar_init(&full[s], kDW ? 2 : 1);  // + K9's row-data warp
      hopper::mbar_init(&empty[s], 8);
    }
    for (int r = 0; r < kRing; ++r) {
      hopper::mbar_init(&ring_full[r], 1);
      hopper::mbar_init(&ring_empty[r], 4);  // the warpgroup that used it
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    hopper::reg_dealloc<kGradProducerRegs>();
    if (warp == 8 && lane == 0) {  // TMA
      if constexpr (!kStream) {
        hopper::mbar_expect_tx(a_full, nk * P::kAPanel * 2);
        for (int k = 0; k < nk; ++k)
          hopper::tma_load_3d(as + k * P::kAPanel, &map_a, a_full,
                              k * kPanel, a0, 0);
      }
      int g = 0;  // ring position
      for (int i = 0; i < steps; ++i) {
        const int s = i & 1, b0 = i * kGN;
        hopper::mbar_wait(&empty[s], ((i >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], np * P::kBPanel * 2);
        for (int p = 0; p < np; ++p)
          hopper::tma_load_3d(bs + s * P::kStage + p * P::kBPanel, &map_b,
                              &full[s], (p0 + p) * kPanel, b0, 0);
        if constexpr (kStream) {
          for (int k = 0; k < nk; ++k, ++g) {
            const int r = g % kRing;
            bf16* slot = as + r * P::kChunk;
            hopper::mbar_wait(&ring_empty[r], ((g / kRing) & 1) ^ 1);
            hopper::mbar_expect_tx(&ring_full[r], P::kChunk * 2);
            hopper::tma_load_3d(slot, &map_a, &ring_full[r], k * kPanel, a0,
                                0);
            hopper::tma_load_3d(slot + P::kAPanel, &map_b, &ring_full[r],
                                k * kPanel, b0, 0);
          }
        }
      }
    } else if (kDW && warp == 9) {
      // K9: lse (times log2 e) and target of each step's 32 rows of x
      for (int i = 0; i < steps; ++i) {
        const int s = i & 1, n = i * kGN + lane;
        const float l = n < N ? lse[n] * kLog2e : 0.f;
        const int t = n < N ? tg[n] : -1;
        hopper::mbar_wait(&empty[s], ((i >> 1) & 1) ^ 1);
        col_lse[s * kGN + lane] = l;
        col_tg[s * kGN + lane] = t;
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns the slice's panels [6 wg, 6 wg + 6)
  hopper::reg_alloc<kGradConsumerRegs>();
  // the warpgroup index through a shuffle, so that the compiler sees it
  // warp-uniform: loops and branches around the wgmmas that depend on it
  // are then not divergent (which would serialise every wgmma)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int wtid = threadIdx.x & (hopper::kWarpgroup - 1);
  const int r_local = (warp & 3) * 16 + (lane >> 2);
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // K8: lse (times log2 e) and target of the thread's two rows of x
  float row_lse[2] = {0.f, 0.f};
  int row_tg[2] = {-1, -1};
  if constexpr (!kDW) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = a0 + r_local + 8 * h;
      if (n < N) {
        row_lse[h] = lse[n] * kLog2e;
        row_tg[h] = tg[n];
      }
    }
  }
  float acc[kWgPanels / 2][64];
#pragma unroll
  for (int n = 0; n < kWgPanels / 2; ++n)
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[n][j] = 0.f;
  if constexpr (!kStream) hopper::mbar_wait(a_full, 0);

  int g = 0;  // ring position
  for (int i = 0; i < steps; ++i) {
    const int s = i & 1, b0 = i * kGN;
    const bf16* bt = bs + s * P::kStage;
    // this warpgroup's part of S: chunks k = wg, wg + 2, ...
    float sc[kGN / 2];
#pragma unroll
    for (int j = 0; j < kGN / 2; ++j) sc[j] = 0.f;
    if constexpr (!kStream) {
      hopper::mbar_wait(&full[s], (i >> 1) & 1);
      hopper::wgmma_fence();
      for (int k = wg; k < nk; k += 2)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss<kGN, 0, 0>(
              sc, hopper::desc_k(as, kGM, 0, 4 * k + kk),
              hopper::desc_k(bt, kGN, 0, 4 * k + kk), 1);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
    } else {
      int prev = -1;  // the ring slot of this warpgroup's previous chunk
      for (int k = wg; k < nk; k += 2) {
        const int gk = g + k, r = gk % kRing;
        const bf16* slot = as + r * P::kChunk;
        hopper::mbar_wait(&ring_full[r], (gk / kRing) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::wgmma_ss<kGN, 0, 0>(
              sc, hopper::desc_k(slot, kGM, 0, kk),
              hopper::desc_k(slot + P::kAPanel, kGN, 0, kk), 1);
        hopper::wgmma_commit();
        if (prev >= 0) {
          hopper::wgmma_wait<1>();
          release(&ring_empty[prev]);
        }
        prev = r;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      if (prev >= 0) release(&ring_empty[prev]);
      g += nk;
      hopper::mbar_wait(&full[s], (i >> 1) & 1);
    }
    // S = the two partials (p0 + p1 on both sides: the same bits)
    float* mine = xch + (wg * 2 + s) * P::kXch;
    const float* theirs = xch + ((wg ^ 1) * 2 + s) * P::kXch;
#pragma unroll
    for (int j = 0; j < kGN / 2; ++j)
      mine[j * hopper::kWarpgroup + wtid] = sc[j];
    hopper::named_sync(1, 2 * hopper::kWarpgroup);
#pragma unroll
    for (int j = 0; j < kGN / 2; ++j)
      sc[j] += theirs[j * hopper::kWarpgroup + wtid];
    // dl = exp(s - lse) - onehot(target) in registers, 0 past N and V
#pragma unroll
    for (int j = 0; j < kGN / 2; ++j) {
      const int h = hopper::acc_half(j), c = hopper::acc_col(j, lane);
      const int ra = a0 + r_local + 8 * h, cb = b0 + c;
      const int n = kDW ? cb : ra, v = kDW ? ra : cb;
      const float l2 = kDW ? col_lse[s * kGN + c] : row_lse[h];
      const int t = kDW ? col_tg[s * kGN + c] : row_tg[h];
      float d = 0.f;
      if (n < N && v < V)
        d = hopper::ex2(fmaf(sc[j], kLog2e, -l2)) - (t == v ? 1.f : 0.f);
      sc[j] = d;
    }
    uint32_t da[kGN / 4];  // dl in bf16, the A operand
#pragma unroll
    for (int t = 0; t < kGN / 16; ++t) hopper::a_frag(da + 4 * t, sc, t);
    // out[:, this warpgroup's panels] += dl B_step
    hopper::wgmma_fence();
#pragma unroll
    for (int n = 0; n < kWgPanels / 2; ++n) {
      const int p = wg * kWgPanels + 2 * n;
      if (p < np) {
#pragma unroll
        for (int t = 0; t < kGN / 16; ++t)
          hopper::wgmma_rs<128, 1>(
              acc[n], da + 4 * t,
              hopper::desc_mn(bt + p * P::kBPanel, kGN, t, 0), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
#pragma unroll
    for (int n = 0; n < kWgPanels / 2; ++n) hopper::fence_regs(acc[n]);
    hopper::fence_regs(da);
    release(&empty[s]);
  }

  // the accumulator straight to device memory, two f32 a store; rows past
  // the output's and columns past the slice or E dropped (E % 8 == 0, so
  // a pair is wholly inside or outside)
  const int c_end = min(E, (p0 + np) * kPanel);
#pragma unroll
  for (int n = 0; n < kWgPanels / 2; ++n) {
    const int p = wg * kWgPanels + 2 * n;
    if (p >= np) continue;
    const int c0 = (p0 + p) * kPanel;
#pragma unroll
    for (int j = 0; j < 64; j += 2) {
      const int row = a0 + r_local + 8 * hopper::acc_half(j);
      const int col = c0 + hopper::acc_col(j, lane);
      if (row < na && col < c_end)
        *reinterpret_cast<float2*>(out + (long long)row * E + col) =
            make_float2(acc[n][j], acc[n][j + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// K7, bf16: a Hopper kernel (PTX helpers in hopper.cuh).
//
// Replaces the same Pallas builder as above: `_fwd_kernel`
// (ray_tpu/ops/xent_pallas.py:51, pallas_call at l.184, in `_lse_tgt`).
//
// Bound: tensor-core operations, 2 N V E: 2.56 ms at GPT-2 124M's head on
// an H100 (989 TFLOP/s bf16).
//
// What held the first design (kept as the f32 kernel above) back: 64 x 64
// score tiles on 16x16x16 wmma fragments from a two-stage cp.async ring
// that reloaded x with every vocab tile, S stored to shared memory in f32
// every step, and one warp a row doing the online logsumexp while the
// tensor cores idled: level with one `matmul` of the same product.
//
// Design: K1's loop with the vocab as the kv axis and no second product.  A
// CTA owns 64 rows of x.  At E <= 768 (GPT-2 124M's head) they stay
// resident in shared memory as 128-byte-swizzled [64, 64] panels (96 KB),
// loaded once by TMA.  Two consumer warpgroups take the vocab tiles of 128
// columns in turn (tile j to warpgroup j % 2), so one warpgroup's softmax
// runs under the other's products; each has its own four-stage ring of
// [128, 64] w panels, fed by its own producer thread through TMA (the
// tensor maps zero-fill rows past N or V and columns past E).  Per tile:
// S [64, 128] = x w_tile^T by wgmma m64n128k16 into f32 registers (64 a
// thread), E in k16 steps, each panel's slot released as soon as the
// products reading it are done; then, in registers, columns past V are
// set to -1e30, the score at the target column is added to t (the f32
// score, never a rounded logit; a target outside [0, V) matches none),
// the row max is taken across the quad that shares a row, and l = l exp(m
// - m_new) + sum exp(s - m_new) by ex2 with log2 e folded into one FMA.
// Nothing of S goes through shared memory.  At the end each thread's l and
// t are summed across its quad, and the two warpgroups' (m, l, t) merge
// once through shared memory: lse = M + log(l0 e^(m0 - M) + l1 e^(m1 -
// M)), t = t0 + t1.  Every sum has a fixed order, so the result is
// deterministic.  Wider E (Llama-3-8B's 4,096) streams (x panel, w panel)
// pairs through the rings instead of keeping x resident; S still
// accumulates over all of E in registers, so nothing is recomputed.
// ---------------------------------------------------------------------------
constexpr int kFwdRows = 64;      // rows of x a CTA owns
constexpr int kFwdCols = 128;     // vocab columns a tile
constexpr int kFwdStages = 4;     // ring slots a consumer warpgroup
constexpr int kFwdResident = 12;  // x panels kept resident: E <= 768

template <bool kStream>
struct FwdPlan {
  static constexpr int kXPanel = kFwdRows * hopper::kPanel;  // bf16 elements
  static constexpr int kWPanel = kFwdCols * hopper::kPanel;
  static constexpr int kSlot = kWPanel + (kStream ? kXPanel : 0);
  static constexpr int kX = kStream ? 0 : kFwdResident * kXPanel;
  static constexpr int kThreads = 3 * hopper::kWarpgroup;
  // x (or nothing), two rings, the merge's (m, l, t) per warpgroup and
  // row, barriers; + 1 KB to align (226.6 KB resident, 194.6 streamed)
  static constexpr size_t kBytes = 2 * ((size_t)kX + 2 * kFwdStages * kSlot) +
                                   4 * 2 * 3 * kFwdRows +
                                   8 * (1 + 4 * kFwdStages) + 1024;
};

template <bool kStream>
__global__ void __launch_bounds__(FwdPlan<kStream>::kThreads, 1)
    xent_fwd_wgmma(const __grid_constant__ CUtensorMap map_x,
                   const __grid_constant__ CUtensorMap map_w,
                   const int* __restrict__ tg, float* __restrict__ lse,
                   float* __restrict__ tgt, int N, int V, int E) {
  using P = FwdPlan<kStream>;
  using hopper::kPanel;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = hopper::align1024(smem_raw);
  bf16* xs = reinterpret_cast<bf16*>(base);  // resident x panels
  bf16* rings = xs + P::kX;                  // [wg][stage] slots
  float* mlt = reinterpret_cast<float*>(rings + 2 * kFwdStages * P::kSlot);
  uint64_t* x_full = reinterpret_cast<uint64_t*>(mlt + 2 * 3 * kFwdRows);
  uint64_t* full = x_full + 1;             // [wg][stage]: a slot landed
  uint64_t* empty = full + 2 * kFwdStages;  // [wg][stage]: its reader is done

  const int a0 = blockIdx.x * kFwdRows;
  const int nk = (E + kPanel - 1) / kPanel;
  const int ntiles = (V + kFwdCols - 1) / kFwdCols;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    hopper::mbar_init(x_full, 1);
    for (int s = 0; s < 2 * kFwdStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);  // the four warps of the reader
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup: warp 8 + wg feeds warpgroup wg
    const int wg = warp - 8;
    if (wg < 2 && lane == 0) {
      if (!kStream && wg == 0) {
        hopper::mbar_expect_tx(x_full, nk * P::kXPanel * 2);
        for (int k = 0; k < nk; ++k)
          hopper::tma_load_3d(xs + k * P::kXPanel, &map_x, x_full,
                              k * kPanel, a0, 0);
      }
      bf16* ring = rings + wg * kFwdStages * P::kSlot;
      int g = 0;  // this ring's position
      for (int j = wg; j < ntiles; j += 2) {
        for (int k = 0; k < nk; ++k, ++g) {
          const int s = g % kFwdStages;
          bf16* slot = ring + s * P::kSlot;
          uint64_t* f = &full[wg * kFwdStages + s];
          hopper::mbar_wait(&empty[wg * kFwdStages + s],
                            ((g / kFwdStages) & 1) ^ 1);
          hopper::mbar_expect_tx(f, P::kSlot * 2);
          hopper::tma_load_3d(slot, &map_w, f, k * kPanel, j * kFwdCols, 0);
          if constexpr (kStream)
            hopper::tma_load_3d(slot + P::kWPanel, &map_x, f, k * kPanel,
                                a0, 0);
        }
      }
    }
    return;
  }

  // consumers: the warpgroup index through a shuffle, so that the compiler
  // sees it warp-uniform (divergence around a wgmma serialises it)
  const int wg = __shfl_sync(0xffffffffu, warp >> 2, 0);
  const int r_local = (warp & 3) * 16 + (lane >> 2);
  const bf16* ring = rings + wg * kFwdStages * P::kSlot;
  uint64_t* my_full = full + wg * kFwdStages;
  uint64_t* my_empty = empty + wg * kFwdStages;
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  // the thread's two rows of x: target, and the running (m, l, t); l and t
  // are this thread's share of the row, summed across the quad at the end
  int row_tg[2];
  float m_r[2], l_r[2], t_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = a0 + r_local + 8 * h;
    row_tg[h] = n < N ? tg[n] : -1;
    m_r[h] = kNegInf;
    l_r[h] = 0.f;
    t_r[h] = 0.f;
  }
  if constexpr (!kStream) hopper::mbar_wait(x_full, 0);

  float acc[kFwdCols / 2];
  int g = 0;  // ring position
  for (int j = wg; j < ntiles; j += 2) {
    hopper::wgmma_fence();
    int prev = -1;
    for (int k = 0; k < nk; ++k, ++g) {
      const int s = g % kFwdStages;
      const bf16* slot = ring + s * P::kSlot;
      const bf16* xp = kStream ? slot + P::kWPanel : xs + k * P::kXPanel;
      hopper::mbar_wait(&my_full[s], (g / kFwdStages) & 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hopper::wgmma_ss<kFwdCols, 0, 0>(
            acc, hopper::desc_k(xp, kFwdRows, 0, kk),
            hopper::desc_k(slot, kFwdCols, 0, kk), (k | kk) != 0);
      hopper::wgmma_commit();
      if (prev >= 0) {
        hopper::wgmma_wait<1>();
        release(&my_empty[prev]);
      }
      prev = s;
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    release(&my_empty[prev]);

    // the online logsumexp over this tile, in registers
    const int c0 = j * kFwdCols;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kFwdCols / 2; ++i) {
      const int h = hopper::acc_half(i), c = c0 + hopper::acc_col(i, lane);
      const float s = c < V ? acc[i] : kNegInf;
      t_r[h] += c == row_tg[h] && c < V ? s : 0.f;
      acc[i] = s;
      mx[h] = fmaxf(mx[h], s);
    }
    float neg[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_r[h], mx[h]);
      l_r[h] *= hopper::ex2((m_r[h] - m_new) * kLog2e);
      m_r[h] = m_new;
      neg[h] = -m_new * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < kFwdCols / 2; ++i) {
      const int h = hopper::acc_half(i);
      l_r[h] += hopper::ex2(fmaf(acc[i], kLog2e, neg[h]));
    }
  }

  // each row's l and t over its quad, then the two warpgroups' merge
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 1);
    l_r[h] += __shfl_xor_sync(0xffffffffu, l_r[h], 2);
    t_r[h] += __shfl_xor_sync(0xffffffffu, t_r[h], 1);
    t_r[h] += __shfl_xor_sync(0xffffffffu, t_r[h], 2);
    if ((lane & 3) == 0) {
      float* e = mlt + (wg * kFwdRows + r_local + 8 * h) * 3;
      e[0] = m_r[h];
      e[1] = l_r[h];
      e[2] = t_r[h];
    }
  }
  hopper::named_sync(1, 2 * hopper::kWarpgroup);
  if (wg == 0 && (lane & 3) == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r_local + 8 * h;
      if (a0 + r >= N) continue;
      const float* e0 = mlt + r * 3;
      const float* e1 = mlt + (kFwdRows + r) * 3;
      const float M = fmaxf(e0[0], e1[0]);
      const float L = e0[1] * expf(e0[0] - M) + e1[1] * expf(e1[0] - M);
      lse[a0 + r] = M + logf(L);
      tgt[a0 + r] = e0[2] + e1[2];
    }
  }
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

cudaError_t launch_fwd_f32(const void* x, const void* w, const void* tg,
                           void* lse, void* tgt, int N, int V, int E,
                           cudaStream_t s) {
  const size_t bytes = Plan<float>::fwd_bytes;
  cudaError_t err = set_smem(xent_fwd_kernel<float>, bytes);
  if (err != cudaSuccess) return err;
  xent_fwd_kernel<float><<<(N + kBM - 1) / kBM, kThreads, bytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(tg), static_cast<float*>(lse),
      static_cast<float*>(tgt), N, V, E);
  return cudaGetLastError();
}

template <bool kStream>
cudaError_t launch_fwd_kernel(const CUtensorMap& mx, const CUtensorMap& mw,
                              const void* tg, void* lse, void* tgt, int N,
                              int V, int E, cudaStream_t s) {
  using P = FwdPlan<kStream>;
  cudaError_t err = set_smem(xent_fwd_wgmma<kStream>, P::kBytes);
  if (err != cudaSuccess) return err;
  xent_fwd_wgmma<kStream>
      <<<(N + kFwdRows - 1) / kFwdRows, P::kThreads, P::kBytes, s>>>(
          mx, mw, static_cast<const int*>(tg), static_cast<float*>(lse),
          static_cast<float*>(tgt), N, V, E);
  return cudaGetLastError();
}

// bf16: x in [64, 64] boxes, w in [128, 64] boxes; x resident where its
// panels fit (E <= 768), else streamed beside w
cudaError_t launch_fwd_bf16(const void* x, const void* w, const void* tg,
                            void* lse, void* tgt, int N, int V, int E,
                            cudaStream_t s) {
  CUtensorMap mx, mw;
  if (!hopper::map_3d(&mx, x, false, 1, N, E, kFwdRows) ||
      !hopper::map_3d(&mw, w, false, 1, V, E, kFwdCols))
    return cudaErrorInvalidValue;
  if ((E + hopper::kPanel - 1) / hopper::kPanel <= kFwdResident)
    return launch_fwd_kernel<false>(mx, mw, tg, lse, tgt, N, V, E, s);
  return launch_fwd_kernel<true>(mx, mw, tg, lse, tgt, N, V, E, s);
}

template <bool kDW>
cudaError_t launch_grad_f32(const void* x, const void* w, const void* tg,
                            const void* lse, void* out, int N, int V, int E,
                            cudaStream_t s) {
  const size_t bytes = Plan<float>::grad_bytes;
  cudaError_t err = set_smem(xent_grad_kernel<kDW>, bytes);
  if (err != cudaSuccess) return err;
  const int na = kDW ? V : N;
  const dim3 grid((na + kBM - 1) / kBM, (E + kES - 1) / kES);
  xent_grad_kernel<kDW><<<grid, kThreads, bytes, s>>>(
      static_cast<const float*>(kDW ? w : x),
      static_cast<const float*>(kDW ? x : w), static_cast<const int*>(tg),
      static_cast<const float*>(lse), static_cast<float*>(out), N, V, E);
  return cudaGetLastError();
}

template <bool kDW, bool kStream>
cudaError_t launch_grad_kernel(const CUtensorMap& ma, const CUtensorMap& mb,
                               const void* tg, const void* lse, void* out,
                               int N, int V, int E, int slices,
                               int slice_panels, cudaStream_t s) {
  cudaError_t err = set_smem(xent_grad_wgmma<kDW, kStream>, GradPlan::kBytes);
  if (err != cudaSuccess) return err;
  const int na = kDW ? V : N;
  const dim3 grid((na + kGM - 1) / kGM, slices);
  xent_grad_wgmma<kDW, kStream>
      <<<grid, GradPlan::kThreads, GradPlan::kBytes, s>>>(
          ma, mb, static_cast<const int*>(tg),
          static_cast<const float*>(lse), static_cast<float*>(out), N, V, E,
          slice_panels);
  return cudaGetLastError();
}

// bf16: A = x (K8) or w (K9) in 64-row boxes, B the other in 32-row boxes;
// E in as few column slices of at most 768 as cover it, of equal panels
template <bool kDW>
cudaError_t launch_grad_bf16(const void* x, const void* w, const void* tg,
                             const void* lse, void* out, int N, int V, int E,
                             cudaStream_t s) {
  const int na = kDW ? V : N, nb = kDW ? N : V;
  CUtensorMap ma, mb;
  if (!hopper::map_3d(&ma, kDW ? w : x, false, 1, na, E, kGM) ||
      !hopper::map_3d(&mb, kDW ? x : w, false, 1, nb, E, kGN))
    return cudaErrorInvalidValue;
  const int nk = (E + hopper::kPanel - 1) / hopper::kPanel;
  const int slices = (nk + kSlicePanels - 1) / kSlicePanels;
  const int per = (nk + slices - 1) / slices;
  if (slices == 1)
    return launch_grad_kernel<kDW, false>(ma, mb, tg, lse, out, N, V, E, 1,
                                          nk, s);
  return launch_grad_kernel<kDW, true>(ma, mb, tg, lse, out, N, V, E,
                                       slices, per, s);
}

bool bad_shape(int N, int V, int E) {
  return N < 1 || V < 1 || E < 8 || E % 8 != 0;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16 (x and w both).  Every entry returns a
// cudaError_t (0 = launched).

// K7: lse and tgt, each [N] f32
int rt_xent_fwd(const void* x, const void* w, const void* tg, void* lse,
                void* tgt, int N, int V, int E, int dtype, void* stream) {
  if (bad_shape(N, V, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) return (int)launch_fwd_f32(x, w, tg, lse, tgt, N, V, E, s);
  if (dtype == kBF16) return (int)launch_fwd_bf16(x, w, tg, lse, tgt, N, V, E, s);
  return (int)cudaErrorInvalidValue;
}

// K8: dx [N, E] f32
int rt_xent_dx(const void* x, const void* w, const void* tg, const void* lse,
               void* dx, int N, int V, int E, int dtype, void* stream) {
  if (bad_shape(N, V, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_grad_f32<false>(x, w, tg, lse, dx, N, V, E, s);
  if (dtype == kBF16)
    return (int)launch_grad_bf16<false>(x, w, tg, lse, dx, N, V, E, s);
  return (int)cudaErrorInvalidValue;
}

// K9: dw [V, E] f32
int rt_xent_dw(const void* x, const void* w, const void* tg, const void* lse,
               void* dw, int N, int V, int E, int dtype, void* stream) {
  if (bad_shape(N, V, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_grad_f32<true>(x, w, tg, lse, dw, N, V, E, s);
  if (dtype == kBF16)
    return (int)launch_grad_bf16<true>(x, w, tg, lse, dw, N, V, E, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
