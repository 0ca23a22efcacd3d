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
// The shared step is a score tile S = A[64 rows] . B[64 rows]^T over all of E,
// streamed in E chunks through a two-stage cp.async ring in shared memory,
// with the sum kept in registers: bf16 on the tensor cores through
// nvcuda::wmma (16x16x16, f32 accumulate, eight warps as 2 x 4), f32 on
// scalar FMA with a 4 x 4 register tile a thread (the instantiation that
// checks the algorithm against the plain versions).
//
// Bound on this card.  At the GPT-2 124M head (N 32,768, E 768, V 50,257,
// bf16) every kernel is bound by tensor-core operations: K7 does 2 N V E =
// 2.53 TFLOP (2.56 ms at 989 TFLOP/s) against ~0.13 GB of input (0.04 ms at
// 3.35 TB/s); K8 and K9 each recompute S and do one more product, 4 N V E,
// 5.1 ms each.  What these kernels do about it: products on the tensor cores
// with f32 accumulators in registers, E chunks double-buffered with cp.async.
// What they do not do yet (later work): wgmma and TMA, tiles wider than
// 64 x 64, and a K8/K9 without the recompute below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr int kThreads = 256;      // eight warps per block
constexpr int kBM = 64;  // rows of a score tile (A side) = rows of an output tile
constexpr int kBN = 64;  // columns of a score tile (B side): K8/K9's reduction step
constexpr int kES = 256;  // output columns a K8/K9 block owns (a slice of E)
constexpr int kPadF = 4;  // f32 score tile: ld = kBN + 4
enum DType { kF32 = 0, kBF16 = 1 };

// E chunk per pipeline stage and the row pad (elements) of the T tiles: the
// pad keeps wmma's 32-byte alignment for bf16 and spreads f32 rows over banks
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int kBK = 64, kPad = 8;
};
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

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zeroed
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
    cp_async16(s + r * lds + c, src, ok);
  }
}

// An M x N f32 accumulator held in registers across a block's eight warps.
//   mma_nt: acc += A[M, K] . B[N, K]^T;  mma_nn: acc += A[M, K] . B[K, N]
// (A, B in shared memory, K a multiple of 16).  store: the tile into shared
// memory; store_global: rows [0, rows) x columns [0, cols) of it into device
// memory.  No barrier inside.
template <typename T, int M, int N>
struct Acc;

// bf16: tensor cores through wmma, warps as 2 (rows) x 4 (columns), each
// holding (M / 2) x (N / 4) as 16 x 16 fragments
template <int M, int N>
struct Acc<bf16, M, N> {
  static constexpr int WM = M / 2, WN = N / 4, FM = WM / 16, FN = WN / 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> c[FM][FN];

  __device__ __forceinline__ int m0() const {
    return (threadIdx.x >> 5) / 4 * WM;
  }
  __device__ __forceinline__ int n0() const {
    return (threadIdx.x >> 5) % 4 * WN;
  }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(c[i][j], 0.f);
  }
  template <bool kNT>
  __device__ __forceinline__ void mma(const bf16* A, int lda, const bf16* B,
                                      int ldb, int K) {
    using LB = std::conditional_t<kNT, wmma::col_major, wmma::row_major>;
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(a[i], A + (m0() + 16 * i) * lda + k, lda);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(
            b[j], kNT ? B + (n0() + 16 * j) * ldb + k : B + k * ldb + n0() + 16 * j,
            ldb);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
  }
  __device__ __forceinline__ void mma_nt(const bf16* A, int lda,
                                         const bf16* B, int ldb, int K) {
    mma<true>(A, lda, B, ldb, K);
  }
  __device__ __forceinline__ void mma_nn(const bf16* A, int lda,
                                         const bf16* B, int ldb, int K) {
    mma<false>(A, lda, B, ldb, K);
  }
  __device__ __forceinline__ void store(float* C, int ldc) const {
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(C + (m0() + 16 * i) * ldc + n0() + 16 * j,
                                c[i][j], ldc, wmma::mem_row_major);
  }
  // through a 16 x 16 f32 scratch a warp (scratch holds 8 x 256 floats)
  __device__ __forceinline__ void store_global(float* G, long long ldg,
                                               int rows, int cols,
                                               float* scratch) const {
    const int lane = threadIdx.x & 31;
    float* s = scratch + (threadIdx.x >> 5) * 256;
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(s, c[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m0() + 16 * i + e / 16, col = n0() + 16 * j + e % 16;
          if (r < rows && col < cols) G[r * ldg + col] = s[e];
        }
        __syncwarp();
      }
  }
};

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
                                               int rows, int cols,
                                               float*) const {
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
  cp_async_commit();
  for (int kc = 0; kc < nk; ++kc) {
    const int cur = kc & 1;
    if (kc + 1 < nk) {
      const int nxt = cur ^ 1;
      load_async(sA + nxt * M * ld, ld, A, na, E, a0, (kc + 1) * BK, M, BK);
      load_async(sB + nxt * N * ld, ld, B, nb, E, b0, (kc + 1) * BK, N, BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
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
  static constexpr size_t scratch = up128(b2 + kBN * ldb2 * sizeof(T));
  static constexpr size_t fwd_bytes = dl;
  static constexpr size_t grad_bytes = up128(scratch + 8 * 256 * sizeof(float));
};

// ---------------------------------------------------------------------------
// K7: per-row logsumexp over all V logits and the target logit.
//
// Replaces ray_tpu/ops/xent_pallas.py:51 `_fwd_kernel` (pallas_call at
// l.184, in `_lse_tgt`).
//
// Bound: tensor-core operations (2 N V E; see the file note).  Design: one
// block per 64-row tile of x, walking the vocab in 64-column tiles, as K1
// walks its kv tiles: the Pallas grid's sequential vocab axis is a loop
// inside the block.  Per tile: S = x w^T (f32, score_tile) into shared
// memory; one warp per row masks columns past V to -1e30, adds the score
// at the target column to t (from the f32 score, never a rounded logit),
// and updates the running m and l in the reference's order (m_new = max(m,
// max s); l = l exp(m - m_new) + sum exp(s - m_new)).  At the end lse = m +
// log l.  (m, l, t) stay in f32 shared memory for the whole walk.  At N =
// 32,768 there are 512 row tiles for 132 SMs; a split of the vocab over
// blocks (flash-decoding's combine) is later work for small N.
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
        if (col == t) hit += s;
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
// Bound: tensor-core operations (4 N V E; see the file note).
// The trouble is the E-wide f32 accumulator the Pallas kernels keep in VMEM
// (512 x 768 x 4 B = 1.5 MB): 64 rows of it at E = 768 are 196 KB, and at E =
// 4,096 not even 16 rows fit beside the tiles.  Design: each block owns a
// 64-row x 256-column slice of the output in registers (64 floats a thread)
// and walks the whole reduction axis in 64-wide steps: per step, S for its 64
// rows over all of E (score_tile), dl in x's dtype into shared memory, the
// step's [64, 256] slice of B2 (its copy in flight while S is computed),
// then acc += dl . B2.  Every output element has one owner, so the sums are
// deterministic and need no atomics or second pass; the price is that S is
// recomputed once per E slice: ceil(E / 256) = 3 times at E = 768, so a
// kernel does (3 + 1) / 2 = 2x the reference's operations (16 slices at E =
// 4,096).
// ---------------------------------------------------------------------------
template <typename T, bool kDW>
__global__ void __launch_bounds__(kThreads)
    xent_grad_kernel(const T* __restrict__ A, const T* __restrict__ B,
                     const int* __restrict__ tg,
                     const float* __restrict__ lse, float* __restrict__ out,
                     int N, int V, int E) {
  using P = Plan<T>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sA = reinterpret_cast<T*>(smem + P::a);
  T* sB = reinterpret_cast<T*>(smem + P::b);
  float* sS = reinterpret_cast<float*>(smem + P::s);
  float* lse_s = reinterpret_cast<float*>(smem + P::vec);  // [64]
  int* tg_s = reinterpret_cast<int*>(lse_s + 64);          // [64]
  T* sDL = reinterpret_cast<T*>(smem + P::dl);
  T* sB2 = reinterpret_cast<T*>(smem + P::b2);
  float* scratch = reinterpret_cast<float*>(smem + P::scratch);

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
    cp_async_commit();
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
      sDL[r * P::ldd + c] = from_f32<T>(dl);  // dl in x's dtype
    }
    __syncthreads();
    acc.mma_nn(sDL, P::ldd, sB2, P::ldb2, kBN);
    __syncthreads();
  }
  acc.store_global(out + (long long)a0 * E + e0, E, min(kBM, na - a0),
                   min(kES, E - e0), scratch);
}

template <typename K>
cudaError_t set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const void* tg,
                       void* lse, void* tgt, int N, int V, int E,
                       cudaStream_t s) {
  const size_t bytes = Plan<T>::fwd_bytes;
  cudaError_t err = set_smem(xent_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  xent_fwd_kernel<T><<<(N + kBM - 1) / kBM, kThreads, bytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(tg), static_cast<float*>(lse),
      static_cast<float*>(tgt), N, V, E);
  return cudaGetLastError();
}

template <typename T, bool kDW>
cudaError_t launch_grad(const void* x, const void* w, const void* tg,
                        const void* lse, void* out, int N, int V, int E,
                        cudaStream_t s) {
  const size_t bytes = Plan<T>::grad_bytes;
  cudaError_t err = set_smem(xent_grad_kernel<T, kDW>, bytes);
  if (err != cudaSuccess) return err;
  const int na = kDW ? V : N;
  const dim3 grid((na + kBM - 1) / kBM, (E + kES - 1) / kES);
  xent_grad_kernel<T, kDW><<<grid, kThreads, bytes, s>>>(
      static_cast<const T*>(kDW ? w : x), static_cast<const T*>(kDW ? x : w),
      static_cast<const int*>(tg), static_cast<const float*>(lse),
      static_cast<float*>(out), N, V, E);
  return cudaGetLastError();
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
  if (dtype == kF32) return (int)launch_fwd<float>(x, w, tg, lse, tgt, N, V, E, s);
  if (dtype == kBF16) return (int)launch_fwd<bf16>(x, w, tg, lse, tgt, N, V, E, s);
  return (int)cudaErrorInvalidValue;
}

// K8: dx [N, E] f32
int rt_xent_dx(const void* x, const void* w, const void* tg, const void* lse,
               void* dx, int N, int V, int E, int dtype, void* stream) {
  if (bad_shape(N, V, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_grad<float, false>(x, w, tg, lse, dx, N, V, E, s);
  if (dtype == kBF16)
    return (int)launch_grad<bf16, false>(x, w, tg, lse, dx, N, V, E, s);
  return (int)cudaErrorInvalidValue;
}

// K9: dw [V, E] f32
int rt_xent_dw(const void* x, const void* w, const void* tg, const void* lse,
               void* dw, int N, int V, int E, int dtype, void* stream) {
  if (bad_shape(N, V, E)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_grad<float, true>(x, w, tg, lse, dw, N, V, E, s);
  if (dtype == kBF16)
    return (int)launch_grad<bf16, true>(x, w, tg, lse, dw, N, V, E, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
