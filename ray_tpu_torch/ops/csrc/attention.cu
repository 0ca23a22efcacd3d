// Flash attention for Hopper (sm_90a): the forward (K1), the fused backward
// (K2) and the split backward pair, dQ (K3) and dK/dV (K4).  Built by
// ray_tpu_torch/ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC
// into a shared library with a plain C interface, loaded with ctypes.  The
// wrappers in ray_tpu_torch/ops/attention.py check devices, dtypes, shapes
// and contiguity before passing pointers; every entry here returns
// cudaGetLastError() after its launch, and the wrapper raises if it is not 0.
//
// Layouts (all contiguous, heads folded into the leading dim):
//   q, k, v, o, dout, dq, dk, dv   [BH, T, D]   f32 or bf16 (one dtype)
//   lse, delta                     [BH, T]      f32 (the reference's [BH, T, 1])
//   dq_acc (K2 only)               [BH, T, D]   f32, zeroed by the wrapper
//
// How the TPU kernels translate.  The Pallas kernels take 1024-wide VMEM
// blocks and carry m / l / acc (or the dQ / dK / dV accumulators) across the
// sequential last grid axis.  Here that axis is a loop inside one CTA, over
// Hopper-sized tiles, whatever block_q / block_k the caller passed (those
// choose only the route, in the wrapper).
//
// bf16 K1 and K2 (the training path) are Hopper kernels (PTX helpers in
// hopper.cuh): a producer warpgroup issues TMA loads of 128-byte-swizzled
// tiles into a shared-memory ring of two or three stages guarded by
// mbarriers; two consumer warpgroups multiply with wgmma, S / P / O (K1)
// and S^T / P^T / dP^T / dS^T / dK / dV (K2) accumulated in registers,
// the softmax done in registers; P and dS^T feed the next product as
// register A operands; K1's O leaves by TMA store and K2's dQ by TMA
// reduce-adds, one a 32-column panel a tile pair.  Head widths 64 and 128
// are instantiated; other widths with D % 8 == 0 and D <= 128 run on the
// next larger one (zero-filled by the tensor maps, dropped on store).
// See each kernel's note.
//
// K3, K4 and the f32 instantiations of all four are the first design,
// unchanged: 64-row (bf16) or 32-row (f32) tiles, bf16 products through
// nvcuda::wmma (16x16x16) with the f32 accumulators and the score tile
// staged in shared memory, f32 products through scalar FMA loops (the f32
// path is where the algorithm is checked against the reference), tiles
// loaded synchronously.  K3 and K4 are the next redesign.
//
// Bound on this card.  At the training shape (BH 384, T 1024, D 64, causal,
// bf16) K1 does 2 * (2*BH*T^2*D) / 2 = 52 GFLOP against 0.2 GB of q/k/v/o:
// ~250 flops per byte, just under the card's ridge of ~295, so its floor is
// set by bytes (0.0606 ms against 0.052 ms of operations); at larger T or D
// the quadratic term, which grows with T where the bytes grow linearly,
// takes over.  K2-K4 do 1.5 to 2.5 times K1's work over 1.25 to 2 times its
// bytes and are bound by tensor-core operations (K2: 0.130 ms).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;      // four warps per block
constexpr int kMaxD = 128;         // head widths up to 128 (GPT-2 64, Llama 128)
enum DType { kF32 = 0, kBF16 = 1 };

// Tile geometry per element type.  Rows: q rows and kv rows per step.  Pads
// (in elements) keep wmma's alignment (rows of 16 at 32-byte boundaries) for
// bf16, and spread the FMA loops' column reads over banks for f32.
template <typename T>
struct Tile;
template <>
struct Tile<bf16> {
  static constexpr int kRows = 64;
  static constexpr int kPadT = 8;  // bf16 tiles: ld = Dp + 8 (16 bytes)
  static constexpr int kPadF = 4;  // f32 accumulators: ld = Dp + 4
  // f32 score / dP tiles unpadded: with them the backward kernels' plan
  // at D = 64 is 512 bytes over what two blocks per SM may hold
  static constexpr int kPadS = 0;
};
template <>
struct Tile<float> {
  static constexpr int kRows = 32;
  static constexpr int kPadT = 1;
  static constexpr int kPadF = 1;
  static constexpr int kPadS = 1;
};

__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
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

// C[M, N] (f32, shared, ldc) = (accumulate ? C : 0) + op(A) . op(B), where
// op(A)[m, k] = TA ? A[k * lda + m] : A[m * lda + k] and
// op(B)[k, n] = TB ? B[n * ldb + k] : B[k * ldb + n].  M, N, K multiples of
// 16.  bf16 goes through wmma, one 16x16 output tile per warp at a time; f32
// through scalar FMA, one output element per thread at a time.  No barrier
// inside: callers synchronise around it.
template <typename T, bool TA, bool TB>
__device__ void gemm(float* C, int ldc, const T* A, int lda, const T* B,
                     int ldb, int M, int N, int K, bool accumulate) {
  if constexpr (std::is_same<T, bf16>::value) {
    using LA = std::conditional_t<TA, wmma::col_major, wmma::row_major>;
    using LB = std::conditional_t<TB, wmma::col_major, wmma::row_major>;
    const int warp = threadIdx.x >> 5, nwarps = blockDim.x >> 5;
    const int tn = N / 16, tiles = (M / 16) * tn;
    for (int t = warp; t < tiles; t += nwarps) {
      const int m0 = (t / tn) * 16, n0 = (t % tn) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
      if (accumulate)
        wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
      else
        wmma::fill_fragment(c, 0.f);
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> b;
        wmma::load_matrix_sync(a, TA ? A + k0 * lda + m0 : A + m0 * lda + k0,
                               lda);
        wmma::load_matrix_sync(b, TB ? B + n0 * ldb + k0 : B + k0 * ldb + n0,
                               ldb);
        wmma::mma_sync(c, a, b, c);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
    }
  } else {
    for (int i = threadIdx.x; i < M * N; i += blockDim.x) {
      const int m = i / N, n = i - m * N;
      float s = 0.f;
      for (int k = 0; k < K; ++k) {
        const float a = TA ? A[k * lda + m] : A[m * lda + k];
        const float b = TB ? B[n * ldb + k] : B[k * ldb + n];
        s = fmaf(a, b, s);
      }
      C[m * ldc + n] = accumulate ? C[m * ldc + n] + s : s;
    }
  }
}

// rows [row0, row0 + rows) of a [T, D] slab into a [rows, Dp] shared tile
// (ld lds); rows past T and columns past D read as zero.  bf16 moves as
// 16-byte vectors (D % 8 == 0, so a vector never straddles a row).
template <typename T>
__device__ void load_tile(T* s, int lds, const T* g, int row0, int T_, int D,
                          int Dp, int rows) {
  if constexpr (std::is_same<T, bf16>::value) {
    const int cpr = Dp / 8;
    for (int i = threadIdx.x; i < rows * cpr; i += blockDim.x) {
      const int r = i / cpr, c = (i - r * cpr) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < T_ && c < D)
        v = *reinterpret_cast<const uint4*>(g + (long long)(row0 + r) * D + c);
      *reinterpret_cast<uint4*>(s + r * lds + c) = v;
    }
  } else {
    for (int i = threadIdx.x; i < rows * Dp; i += blockDim.x) {
      const int r = i / Dp, c = i - r * Dp;
      s[r * lds + c] = (row0 + r < T_ && c < D)
                           ? g[(long long)(row0 + r) * D + c]
                           : 0.f;
    }
  }
}

// shared-memory plan, shared by the kernels and their launchers.  f32
// regions come first, then the T tiles; every region size is a multiple of
// 32 bytes for the bf16 geometry, so wmma's pointers stay aligned.
template <typename T>
struct Smem {
  static constexpr int B = Tile<T>::kRows;
  int Dp, ldt, ldp, lds, lda;
  __host__ __device__ explicit Smem(int D)
      : Dp((D + 15) / 16 * 16),
        ldt(Dp + Tile<T>::kPadT),
        ldp(B + Tile<T>::kPadT),
        lds(B + Tile<T>::kPadS),
        lda(Dp + Tile<T>::kPadF) {}
  __host__ __device__ int tile_t() const { return B * ldt; }  // T elements
  __host__ __device__ int tile_p() const { return B * ldp; }  // T elements
  __host__ __device__ int tile_s() const { return B * lds; }  // floats
  __host__ __device__ int tile_a() const { return B * lda; }  // floats
  // K1: S, acc, m / l / corr; then q, k, v, P
  __host__ __device__ size_t fwd_bytes() const {
    return sizeof(float) * (tile_s() + tile_a() + 3 * B) +
           sizeof(T) * (3 * tile_t() + tile_p());
  }
  // K2 / K4: scratch (P, dP, then K2's dQ part), dK acc, dV acc, lse,
  // delta; then q, dO, k, v, P/dS
  __host__ __device__ int scratch() const {
    return 2 * tile_s() > tile_a() ? 2 * tile_s() : tile_a();
  }
  __host__ __device__ size_t bwd_kv_bytes() const {
    return sizeof(float) * (scratch() + 2 * tile_a() + 2 * B) +
           sizeof(T) * (4 * tile_t() + tile_p());
  }
  // K3: P, dP, dQ acc, lse, delta; then q, dO, k, v, dS
  __host__ __device__ size_t bwd_q_bytes() const {
    return sizeof(float) * (2 * tile_s() + tile_a() + 2 * B) +
           sizeof(T) * (4 * tile_t() + tile_p());
  }
};

// ---------------------------------------------------------------------------
// K1 in f32 (the first design; bf16 runs flash_fwd_wgmma below).
//
// Replaces ray_tpu/ops/attention.py:61 `_build_fwd` (pallas_call at l.113).
//
// Bound: bytes at the training shape, just under the ridge (see the file
// note); operations at larger T.  Design: one block per
// (bh, q tile).  It walks the kv tiles 0 .. last, stopping at the diagonal
// when causal.  Per step: S = Q K^T (f32) into shared memory; one warp per
// q row does the online softmax in the reference's order (scale, -1e30 mask,
// m_new = max(m, max s), corr = exp(m - m_new), p = exp(s - m_new), l =
// l * corr + sum p), writes P cast to the input dtype; acc = acc * corr,
// then acc += P V.  Finalize: O = acc / (l == 0 ? 1 : l) in the input dtype,
// LSE = m + log(that l) in f32.  Columns past T (the ragged last tile) get
// p = 0; rows past T are computed on zeros and never written.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int T_, int D, float scale,
                     int causal) {
  constexpr int B = Tile<T>::kRows;
  const Smem<T> sm(D);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* ss = reinterpret_cast<float*>(smem_raw);  // [B, lds] scores
  float* acc = ss + sm.tile_s();                   // [B, lda]
  float* m_s = acc + sm.tile_a();                  // [B]
  float* l_s = m_s + B;
  float* c_s = l_s + B;
  T* qs = reinterpret_cast<T*>(c_s + B);  // [B, ldt]
  T* ks = qs + sm.tile_t();
  T* vs = ks + sm.tile_t();
  T* ps = vs + sm.tile_t();  // [B, ldp]

  const int bh = blockIdx.x, qt = blockIdx.y, r0 = qt * B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long base = (long long)bh * T_ * D;
  const int Dp = sm.Dp;

  load_tile(qs, sm.ldt, q + base, r0, T_, D, Dp, B);
  for (int i = tid; i < B * sm.lda; i += blockDim.x) acc[i] = 0.f;
  for (int r = tid; r < B; r += blockDim.x) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int n_kv = causal ? qt + 1 : (T_ + B - 1) / B;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int c0 = kt * B;
    __syncthreads();  // the previous step is done with ks / vs / ps
    load_tile(ks, sm.ldt, k + base, c0, T_, D, Dp, B);
    load_tile(vs, sm.ldt, v + base, c0, T_, D, Dp, B);
    __syncthreads();
    gemm<T, false, true>(ss, sm.lds, qs, sm.ldt, ks, sm.ldt, B, B, Dp, false);
    __syncthreads();
    for (int r = warp; r < B; r += nwarps) {
      const int row = r0 + r;
      const float m_old = m_s[r];
      float mx = kNegInf;
      for (int c = lane; c < B; c += 32) {
        const int col = c0 + c;
        float s = ss[r * sm.lds + c] * scale;
        if (col >= T_ || (causal && col > row)) s = kNegInf;
        ss[r * sm.lds + c] = s;
        mx = fmaxf(mx, s);
      }
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int c = lane; c < B; c += 32) {
        const float p =
            c0 + c < T_ ? expf(ss[r * sm.lds + c] - m_new) : 0.f;
        sum += p;
        ps[r * sm.ldp + c] = from_f32<T>(p);  // P in the input dtype for P.V
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        c_s[r] = corr;
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
      }
    }
    __syncthreads();
    for (int i = tid; i < B * Dp; i += blockDim.x) {
      const int r = i / Dp, d = i - r * Dp;
      acc[r * sm.lda + d] *= c_s[r];
    }
    __syncthreads();
    gemm<T, false, false>(acc, sm.lda, ps, sm.ldp, vs, sm.ldt, B, Dp, B, true);
  }
  __syncthreads();
  for (int i = tid; i < B * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    if (r0 + r < T_) {
      const float l = l_s[r];
      o[base + (long long)(r0 + r) * D + d] =
          from_f32<T>(acc[r * sm.lda + d] / (l == 0.f ? 1.f : l));
    }
  }
  for (int r = tid; r < B; r += blockDim.x) {
    if (r0 + r < T_) {
      const float l = l_s[r];
      lse[(long long)bh * T_ + r0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 in f32 (kFused; bf16 runs flash_bwd_fused_wgmma below) and K4: the
// backward seen from one kv tile.
//
// K2 replaces ray_tpu/ops/attention.py:202 `_build_bwd_fused` (pallas_call at
// l.238); K4 replaces ray_tpu/ops/attention.py:253 `_build_bwd_dkv`
// (pallas_call at l.296).
//
// Bound: tensor-core operations (see the file note).  The TPU's K2 holds a
// whole T x T tile; on Hopper S alone at T = 1024 is 4 MB of f32, so K2 keeps
// its contract (inputs q, k, v, dO, LSE, O; delta = rowsum(dO * O) computed
// in-kernel; S, P, dS computed once per tile pair) on a redesigned loop: one
// block per (bh, kv tile) walks the q tiles from the diagonal down.  Per q
// tile: delta for its rows (K2; K4 reads the wrapper's), S = Q K^T, P =
// exp(S * scale - LSE) (0 where masked or past T), dV += P^T dO with P cast
// to the input dtype, dP = dO V^T, dS = P (dP - delta) * scale cast to the
// input dtype, dK += dS^T Q; K2 also sends dQ += dS K to an f32 scratch by
// 16-byte vector atomicAdd, so dQ's summation order over kv tiles varies
// from run to run (the wrapper casts the scratch to the input dtype).  Two
// blocks fit an SM at D = 64 (114 KB of shared memory each), and K2's delta
// is read with every thread on its own row slice, so its loads overlap.  dK and dV stay in
// f32 shared memory across the walk and are written once, deterministically.
// ---------------------------------------------------------------------------
template <typename T, bool kFused>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const T* __restrict__ out, float* __restrict__ dq_acc,
                        T* __restrict__ dk, T* __restrict__ dv, int T_, int D,
                        float scale, int causal) {
  constexpr int B = Tile<T>::kRows;
  const Smem<T> sm(D);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* pf = reinterpret_cast<float*>(smem_raw);  // [B, lds] P (f32)
  float* dpf = pf + sm.tile_s();                   // [B, lds] dP
  float* dqt = pf;            // [B, lda] K2's dQ part, over P and dP
  float* dk_acc = pf + sm.scratch();  // [B, lda]
  float* dv_acc = dk_acc + sm.tile_a();
  float* lse_s = dv_acc + sm.tile_a();  // [B]
  float* dl_s = lse_s + B;              // [B]
  T* qs = reinterpret_cast<T*>(dl_s + B);  // [B, ldt]
  T* dos = qs + sm.tile_t();
  T* ks = dos + sm.tile_t();
  T* vs = ks + sm.tile_t();
  T* pc = vs + sm.tile_t();  // [B, ldp] P, then dS, in the input dtype

  const int bh = blockIdx.x, kt = blockIdx.y, c0 = kt * B;
  const int tid = threadIdx.x;
  const long long base = (long long)bh * T_ * D;
  const long long vbase = (long long)bh * T_;
  const int Dp = sm.Dp;

  load_tile(ks, sm.ldt, k + base, c0, T_, D, Dp, B);
  load_tile(vs, sm.ldt, v + base, c0, T_, D, Dp, B);
  for (int i = tid; i < 2 * sm.tile_a(); i += blockDim.x) dk_acc[i] = 0.f;
  const int n_q = (T_ + B - 1) / B;
  for (int qt = causal ? kt : 0; qt < n_q; ++qt) {
    const int r0 = qt * B;
    __syncthreads();  // the previous step is done with every tile
    load_tile(qs, sm.ldt, q + base, r0, T_, D, Dp, B);
    load_tile(dos, sm.ldt, dout + base, r0, T_, D, Dp, B);
    if constexpr (kFused) {
      // delta = rowsum(dO * O) in f32 straight from HBM: kThreads / B
      // neighbouring threads per row, each over every (kThreads / B)-th
      // column, all rows at once, so the loads are in flight together
      constexpr int kTpr = kThreads / B;
      const int r = tid / kTpr, part = tid - r * kTpr, row = r0 + r;
      float s = 0.f;
      if (row < T_) {
        const long long off = base + (long long)row * D;
#pragma unroll 8
        for (int d = part; d < D; d += kTpr)
          s += to_f32(dout[off + d]) * to_f32(out[off + d]);
      }
      for (int o = kTpr / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (part == 0) {
        dl_s[r] = s;
        lse_s[r] = row < T_ ? lse[vbase + row] : 0.f;
      }
    } else {
      for (int r = tid; r < B; r += blockDim.x) {
        const int row = r0 + r;
        lse_s[r] = row < T_ ? lse[vbase + row] : 0.f;
        dl_s[r] = row < T_ ? delta[vbase + row] : 0.f;
      }
    }
    __syncthreads();
    gemm<T, false, true>(pf, sm.lds, qs, sm.ldt, ks, sm.ldt, B, B, Dp, false);
    __syncthreads();
    for (int i = tid; i < B * B; i += blockDim.x) {
      const int r = i / B, c = i - r * B;
      const int row = r0 + r, col = c0 + c;
      const bool live = row < T_ && col < T_ && (!causal || col <= row);
      const float p =
          live ? expf(pf[r * sm.lds + c] * scale - lse_s[r]) : 0.f;
      pf[r * sm.lds + c] = p;
      pc[r * sm.ldp + c] = from_f32<T>(p);
    }
    __syncthreads();
    // dV += P^T dO  and  dP = dO V^T  (independent: no barrier between)
    gemm<T, true, false>(dv_acc, sm.lda, pc, sm.ldp, dos, sm.ldt, B, Dp, B,
                         true);
    gemm<T, false, true>(dpf, sm.lds, dos, sm.ldt, vs, sm.ldt, B, B, Dp,
                         false);
    __syncthreads();
    for (int i = tid; i < B * B; i += blockDim.x) {
      const int r = i / B, c = i - r * B;
      const float ds =
          pf[r * sm.lds + c] * (dpf[r * sm.lds + c] - dl_s[r]) * scale;
      pc[r * sm.ldp + c] = from_f32<T>(ds);
    }
    __syncthreads();
    gemm<T, true, false>(dk_acc, sm.lda, pc, sm.ldp, qs, sm.ldt, B, Dp, B,
                         true);
    if constexpr (kFused) {
      gemm<T, false, false>(dqt, sm.lda, pc, sm.ldp, ks, sm.ldt, B, Dp, B,
                            false);
      __syncthreads();
      // four columns an atomic: sm_90's 16-byte vector atomic add (D % 8
      // == 0 keeps every row's float4s aligned in the scratch)
      const int d4 = D / 4;
      for (int i = tid; i < B * d4; i += blockDim.x) {
        const int r = i / d4, d = (i - r * d4) * 4;
        if (r0 + r < T_) {
          const float* src = dqt + r * sm.lda + d;
          atomicAdd(reinterpret_cast<float4*>(
                        dq_acc + base + (long long)(r0 + r) * D + d),
                    make_float4(src[0], src[1], src[2], src[3]));
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < B * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    if (c0 + r < T_) {
      const long long off = base + (long long)(c0 + r) * D + d;
      dk[off] = from_f32<T>(dk_acc[r * sm.lda + d]);
      dv[off] = from_f32<T>(dv_acc[r * sm.lda + d]);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dQ from the saved LSE and delta.
//
// Replaces ray_tpu/ops/attention.py:143 `_build_bwd_dq` (pallas_call at
// l.179).
//
// Bound: tensor-core operations (see the file note).  Design: one block per
// (bh, q tile), walking the kv tiles 0 .. last (to the diagonal when causal).
// Per step: S = Q K^T and dP = dO V^T, P = exp(S * scale - LSE) (0 where
// masked or past T), dS = P (dP - delta) * scale cast to the input dtype,
// dQ += dS K in f32 shared memory.  Deterministic: one block owns each dQ
// row.
// ---------------------------------------------------------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int T_, int D, float scale, int causal) {
  constexpr int B = Tile<T>::kRows;
  const Smem<T> sm(D);
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* sf = reinterpret_cast<float*>(smem_raw);  // [B, lds] S
  float* dpf = sf + sm.tile_s();                   // [B, lds] dP
  float* dq_accs = dpf + sm.tile_s();              // [B, lda]
  float* lse_s = dq_accs + sm.tile_a();            // [B]
  float* dl_s = lse_s + B;                         // [B]
  T* qs = reinterpret_cast<T*>(dl_s + B);
  T* dos = qs + sm.tile_t();
  T* ks = dos + sm.tile_t();
  T* vs = ks + sm.tile_t();
  T* dsc = vs + sm.tile_t();  // [B, ldp] dS in the input dtype

  const int bh = blockIdx.x, qt = blockIdx.y, r0 = qt * B;
  const int tid = threadIdx.x;
  const long long base = (long long)bh * T_ * D;
  const long long vbase = (long long)bh * T_;
  const int Dp = sm.Dp;

  load_tile(qs, sm.ldt, q + base, r0, T_, D, Dp, B);
  load_tile(dos, sm.ldt, dout + base, r0, T_, D, Dp, B);
  for (int i = tid; i < sm.tile_a(); i += blockDim.x) dq_accs[i] = 0.f;
  for (int r = tid; r < B; r += blockDim.x) {
    const int row = r0 + r;
    lse_s[r] = row < T_ ? lse[vbase + row] : 0.f;
    dl_s[r] = row < T_ ? delta[vbase + row] : 0.f;
  }
  const int n_kv = causal ? qt + 1 : (T_ + B - 1) / B;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int c0 = kt * B;
    __syncthreads();
    load_tile(ks, sm.ldt, k + base, c0, T_, D, Dp, B);
    load_tile(vs, sm.ldt, v + base, c0, T_, D, Dp, B);
    __syncthreads();
    gemm<T, false, true>(sf, sm.lds, qs, sm.ldt, ks, sm.ldt, B, B, Dp, false);
    gemm<T, false, true>(dpf, sm.lds, dos, sm.ldt, vs, sm.ldt, B, B, Dp,
                         false);
    __syncthreads();
    for (int i = tid; i < B * B; i += blockDim.x) {
      const int r = i / B, c = i - r * B;
      const int row = r0 + r, col = c0 + c;
      const bool live = row < T_ && col < T_ && (!causal || col <= row);
      const float p =
          live ? expf(sf[r * sm.lds + c] * scale - lse_s[r]) : 0.f;
      dsc[r * sm.ldp + c] =
          from_f32<T>(p * (dpf[r * sm.lds + c] - dl_s[r]) * scale);
    }
    __syncthreads();
    gemm<T, false, false>(dq_accs, sm.lda, dsc, sm.ldp, ks, sm.ldt, B, Dp, B,
                          true);
  }
  __syncthreads();
  for (int i = tid; i < B * D; i += blockDim.x) {
    const int r = i / D, d = i - r * D;
    if (r0 + r < T_)
      dq[base + (long long)(r0 + r) * D + d] =
          from_f32<T>(dq_accs[r * sm.lda + d]);
  }
}

// ---------------------------------------------------------------------------
// The bf16 K1 and K2: warpgroup products, TMA rings, registers.
//
// Both kernels run CTAs of two consumer warpgroups (64 rows each; one at
// K2's D = 128) and one producer warpgroup, whose first thread issues
// every TMA load into a ring of two or three stages, each guarded by a
// full barrier (the bytes have landed) and an empty barrier (every
// consumer warp is done with it).
// Tiles are [rows, 64] bf16 panels, 128-byte swizzled by TMA (a head width
// of 128 is two panels; narrower widths run on the 64 or 128 instantiation,
// zero-filled past D by the tensor map, masked on store).  Every product is
// a wgmma with its f32 accumulator in registers; the second product of each
// pair takes its A operand from registers (P, or dS^T), repacked from the
// first product's accumulator layout without a shuffle.
// ---------------------------------------------------------------------------
constexpr int kWarpgroup = 128;
constexpr int kPanel = 64;  // bf16 columns in one 128-byte swizzled row
// three warpgroups start at 168 registers a thread; the producer drops to
// 40 and the consumers take 232 (128 * 40 + 256 * 232 <= 65,536).
// setmaxnreg is a warpgroup instruction, hence a whole producer warpgroup
constexpr int kProducerRegs = 40, kConsumerRegs = 232;

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// In a wgmma accumulator of N columns (m64nN, f32), register j of a thread
// holds row (warp % 4) * 16 + lane / 4 + 8 * acc_half(j) and column
// acc_col(j, lane) of the warpgroup's 64-row tile.
__device__ __forceinline__ int acc_half(int j) { return (j >> 1) & 1; }
__device__ __forceinline__ int acc_col(int j, int lane) {
  return (j >> 2) * 8 + (lane & 3) * 2 + (j & 1);
}

// The A fragment of k16 step t (four bf16x2), from an accumulator whose
// columns are that product's K (registers 8t .. 8t + 7), cast to bf16.
template <int N>
__device__ __forceinline__ void a_frag(uint32_t* a, const float (&d)[N],
                                       int t) {
  a[0] = pack_bf16(d[8 * t + 0], d[8 * t + 1]);
  a[1] = pack_bf16(d[8 * t + 2], d[8 * t + 3]);
  a[2] = pack_bf16(d[8 * t + 4], d[8 * t + 5]);
  a[3] = pack_bf16(d[8 * t + 6], d[8 * t + 7]);
}

// bf16 element (r, c) of a 128-byte-swizzled [rows, 64] panel
__device__ __forceinline__ int swz(int r, int c) {
  return r * kPanel + ((((c >> 3) ^ r) & 7) << 3) + (c & 7);
}

// K-major operand: rows [row0, row0 + 64*) of a panel set, k16 step kk
// (panel kk / 4, 32 bytes a step inside it)
__device__ __forceinline__ uint64_t desc_k(const bf16* panels, int rows,
                                           int row0, int kk) {
  return hopper::desc_sw128(panels + (kk >> 2) * rows * kPanel +
                                row0 * kPanel + (kk & 3) * 16,
                            16, 1024);
}

// MN-major operand: K rows [16 t, 16 t + 16) of a [rows, 64] panel set,
// starting at column col0 of the first panel
__device__ __forceinline__ uint64_t desc_mn(const bf16* panels, int rows,
                                            int t, int col0) {
  return hopper::desc_sw128(panels + t * 16 * kPanel + col0,
                            rows * kPanel * 2, 1024);
}

// ---------------------------------------------------------------------------
// K1, bf16: flash-attention forward.
//
// Replaces ray_tpu/ops/attention.py:61 `_build_fwd` (pallas_call at l.113).
//
// Bound at the training shape (BH 384, T 1024, D 64, causal): bytes, 0.0606
// ms, against 0.052 ms of operations; it sits at the ridge, so both the
// products and the loads have to run at rate.  Design: persistent CTAs,
// one an SM, each walking work items of (bh, 128-row q tile) longest
// causal tile first, so that the next item's loads overlap this one's
// tail and the triangle's short tiles fill the end.  The producer loads Q
// into one of two slots and K / V tiles of 128 rows into a ring (three
// stages at D = 64, two at 128; K and V on their own full barriers, so S
// = Q K^T starts before V lands).  Each consumer warpgroup owns 64 q rows
// of the item: S = Q K^T by wgmma m64n128k16 into registers; the online
// softmax in registers in the reference's order (scale, -1e30 mask only
// on the diagonal tile and on columns past T, m_new, corr = exp(m -
// m_new), p = exp(s - m_new), l = l * corr + sum p), row maxima over a
// quad of lanes by __shfl_xor_sync, row sums kept per thread and summed
// over the quad once at the end; O rescaled in registers; P cast to bf16
// (as the reference casts it before P.V) straight into wgmma's A
// registers for O += P V, with V read through its MN-major descriptor.
// S of tile i is issued with P V of tile i - 1, so the softmax runs while
// the tensor cores work.  Finish as the reference: O = acc / (l == 0 ? 1
// : l) in bf16, stored by TMA from a staging tile, and LSE = m + log(that
// l).
// ---------------------------------------------------------------------------
template <int DP>
struct FwdPlan {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kRows = 128;                  // q rows and kv rows
  static constexpr int kTile = kPanels * kRows * kPanel;  // bf16 elements
  static constexpr int kTileBytes = kTile * 2;
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr int kThreads = 3 * kWarpgroup;
  // two Q slots, the K ring, the V ring, the O staging tile, the barriers;
  // + 1 KB to align the base (145 KB at D = 64, 225 KB at D = 128)
  static constexpr size_t kBytes = (size_t)kTileBytes * (3 + 2 * kStages) +
                                   8 * (4 + 3 * kStages) + 1024;
};

template <int DP>
__global__ void __launch_bounds__(FwdPlan<DP>::kThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_o,
                    float* __restrict__ lse, int BH, int T_, float scale,
                    int causal) {
  using Plan = FwdPlan<DP>;
  constexpr int R = Plan::kRows, S = Plan::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* qs = reinterpret_cast<bf16*>(base);  // [2] Q slots
  bf16* ks = qs + 2 * Plan::kTile;
  bf16* vs = ks + S * Plan::kTile;
  bf16* ostage = vs + S * Plan::kTile;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(ostage + Plan::kTile);
  uint64_t* q_empty = q_full + 2;
  uint64_t* k_full = q_empty + 2;
  uint64_t* v_full = k_full + S;
  uint64_t* empty = v_full + S;

  // work items, longest first: item w is q tile nq - 1 - w / BH of head
  // w % BH; CTA b takes items b, b + gridDim.x, ...
  const int nq = (T_ + R - 1) / R, n_items = BH * nq;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      hopper::mbar_init(&q_full[i], 1);
      hopper::mbar_init(&q_empty[i], 8);  // every consumer warp
    }
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&empty[s], 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {  // producer warpgroup
    hopper::reg_dealloc<kProducerRegs>();
    if (threadIdx.x == 2 * kWarpgroup) {
      int g = 0, it = 0;  // ring position, item count
      for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
        const int qt = nq - 1 - w / BH, bh = w % BH;
        const int n_kv = causal ? qt + 1 : nq, slot = it & 1;
        hopper::mbar_wait(&q_empty[slot], ((it >> 1) & 1) ^ 1);
        hopper::mbar_expect_tx(&q_full[slot], Plan::kTileBytes);
        for (int p = 0; p < Plan::kPanels; ++p)
          hopper::tma_load_3d(qs + slot * Plan::kTile + p * R * kPanel,
                              &map_q, &q_full[slot], p * kPanel, qt * R, bh);
        for (int i = 0; i < n_kv; ++i, ++g) {
          const int s = g % S;
          hopper::mbar_wait(&empty[s], ((g / S) & 1) ^ 1);
          hopper::mbar_expect_tx(&k_full[s], Plan::kTileBytes);
          for (int p = 0; p < Plan::kPanels; ++p)
            hopper::tma_load_3d(ks + s * Plan::kTile + p * R * kPanel, &map_k,
                                &k_full[s], p * kPanel, i * R, bh);
          hopper::mbar_expect_tx(&v_full[s], Plan::kTileBytes);
          for (int p = 0; p < Plan::kPanels; ++p)
            hopper::tma_load_3d(vs + s * Plan::kTile + p * R * kPanel, &map_v,
                                &v_full[s], p * kPanel, i * R, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each q tile
  hopper::reg_alloc<kConsumerRegs>();
  const int wg = warp >> 2;
  const bool leader = (threadIdx.x & (kWarpgroup - 1)) == 0;
  const float scale_log2 = scale * kLog2e;
  float acc[DP / 2], sc[R / 2];
  uint32_t pa[R / 4];  // P in bf16, the A operand of O += P V
#pragma unroll
  for (int j = 0; j < R / 2; ++j) sc[j] = 0.f;

  int g = 0, it = 0;
  for (int w = blockIdx.x; w < n_items; w += gridDim.x, ++it) {
    const int qt = nq - 1 - w / BH, bh = w % BH, r0 = qt * R;
    const int n_kv = causal ? qt + 1 : nq, slot = it & 1;
    const bf16* qt_s = qs + slot * Plan::kTile;
    const int row_base = r0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < DP / 2; ++j) acc[j] = 0.f;

    // S = Q K_i^T into sc (committed as one wgmma group, not waited)
    auto issue_s = [&](int i) {
      const int s = (g + i) % S;
      const bf16* kt = ks + s * Plan::kTile;
      hopper::mbar_wait(&k_full[s], ((g + i) / S) & 1);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        hopper::wgmma_ss<R, 0, 0>(sc, desc_k(qt_s, R, wg * 64, kk),
                                  desc_k(kt, R, 0, kk), kk > 0);
      hopper::wgmma_commit();
    };
    // O += P V_i (one group, not waited)
    auto issue_pv = [&](int i) {
      const int s = (g + i) % S;
      const bf16* vt = vs + s * Plan::kTile;
      hopper::mbar_wait(&v_full[s], ((g + i) / S) & 1);
#pragma unroll
      for (int t = 0; t < R / 16; ++t)
        hopper::wgmma_rs<DP, 1>(acc, pa + 4 * t, desc_mn(vt, R, t, 0), 1);
      hopper::wgmma_commit();
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(bar);
    };
    // the online softmax of tile i on sc, in registers: m, l and sc = P;
    // returns corr for the rows' O.  The row maximum is taken on the raw
    // scores (scale > 0 commutes with max) and p = exp(s * scale - m) is
    // one FMA into ex2, with log2 e folded into the scale.
    auto softmax = [&](int i, float (&corr)[2]) {
      const int c0 = i * R;
      const bool edge = (causal && i == qt) || c0 + R > T_;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < R / 2; ++j) {
        if (edge) {
          const int col = c0 + acc_col(j, lane);
          const int row = row_base + 8 * acc_half(j);
          if (col >= T_ || (causal && col > row)) sc[j] = kNegInf;
        }
        mx[acc_half(j)] = fmaxf(mx[acc_half(j)], sc[j]);
      }
      float m_log2[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h] * scale);
        corr[h] = hopper::ex2((m[h] - m_new) * kLog2e);
        m[h] = m_new;
        m_log2[h] = m_new * kLog2e;
        l[h] *= corr[h];
      }
      // masked scores give exp(-1e30 * scale - m) = 0: every live row
      // sees column 0 in the first kv tile, so m is finite from there on
#pragma unroll
      for (int j = 0; j < R / 2; ++j) {
        sc[j] = hopper::ex2(fmaf(sc[j], scale_log2, -m_log2[acc_half(j)]));
        l[acc_half(j)] += sc[j];
      }
    };

    // Software pipeline: S_i and P_{i-1} V_{i-1} are issued together,
    // and the softmax of S_i runs while P_{i-1} V_{i-1} is on the tensor
    // cores.  The Q slot is released once the item's last S is in, each
    // kv stage once its P V is.
    float corr[2];
    hopper::mbar_wait(&q_full[slot], (it >> 1) & 1);
    hopper::wgmma_fence();
    issue_s(0);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    if (n_kv == 1) release(&q_empty[slot]);
    softmax(0, corr);
#pragma unroll
    for (int t = 0; t < R / 16; ++t) a_frag(pa + 4 * t, sc, t);
    for (int i = 1; i < n_kv; ++i) {
      hopper::wgmma_fence();
      issue_s(i);
      issue_pv(i - 1);
      hopper::wgmma_wait<1>();  // S_i is in; P_{i-1} V_{i-1} may still run
      hopper::fence_regs(sc);
      if (i == n_kv - 1) release(&q_empty[slot]);
      softmax(i, corr);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      release(&empty[(g + i - 1) % S]);
#pragma unroll
      for (int j = 0; j < DP / 2; ++j) acc[j] *= corr[acc_half(j)];
#pragma unroll
      for (int t = 0; t < R / 16; ++t) a_frag(pa + 4 * t, sc, t);
    }
    hopper::wgmma_fence();
    issue_pv(n_kv - 1);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::fence_regs(pa);
    release(&empty[(g + n_kv - 1) % S]);
    g += n_kv;

    // finish: l summed over the quad, O = acc / l in bf16 into the
    // staging tile (once the previous item's store has read it), then one
    // TMA store a panel, which drops rows past T and columns past D;
    // LSE = m + log l
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      if (l[h] == 0.f) l[h] = 1.f;
    }
    if (leader) hopper::bulk_wait_read<0>();
    hopper::named_sync(1 + wg, kWarpgroup);
    bf16* os = ostage + wg * 64 * kPanel;
    const int r_local = (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < DP / 2; j += 2) {
      const int col = acc_col(j, lane), r = r_local + 8 * acc_half(j);
      *reinterpret_cast<__nv_bfloat162*>(
          os + (col / kPanel) * R * kPanel + swz(r, col % kPanel)) =
          __floats2bfloat162_rn(acc[j] / l[acc_half(j)],
                                acc[j + 1] / l[acc_half(j)]);
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, kWarpgroup);
    if (leader) {
      for (int p = 0; p < Plan::kPanels; ++p)
        hopper::tma_store_3d(&map_o, os + p * R * kPanel, p * kPanel,
                             r0 + wg * 64, bh);
      hopper::bulk_commit();
    }
    const long long head = (long long)bh * T_;
    if ((lane & 3) == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row_base + 8 * h;
        if (row < T_) lse[head + row] = m[h] + logf(l[h]);
      }
    }
  }
  if (leader) hopper::bulk_wait<0>();
}

// ---------------------------------------------------------------------------
// K2, bf16: the fused backward, seen from one kv tile.
//
// Replaces ray_tpu/ops/attention.py:202 `_build_bwd_fused` (pallas_call at
// l.238).
//
// Bound at the training shape: tensor-core operations, 0.130 ms (five
// products over the causal pairs).  Design: one CTA per (bh, kv tile of
// 64 * NWG rows), NWG consumer warpgroups of 64 kv rows each.  K and V are
// loaded once; the producer warpgroup streams the q tiles of 64 rows, from
// the diagonal down, as (Q, dO, O) into a ring (three stages at D = 64,
// two at 128), and two of its warps write each tile's row data beside it:
// lse from the wrapper's LSE, and delta = rowsum(dO * O) from the landed
// dO and O tiles, computed in the kernel as the reference's K2 does.  Per
// q tile each consumer warpgroup computes the transposed products with its
// kv rows as wgmma's M: S^T = K Q^T and dP^T = V dO^T (m64n64k16,
// registers), P^T = exp(S^T * scale - lse) (0 where masked or past T, rows
// and columns), dS^T = P^T (dP^T - delta) * scale.  P^T and dS^T, cast to
// bf16 as the reference casts them, are the register A operands of dV +=
// P^T dO and dK += dS^T Q, so dK and dV stay in registers across the walk
// and are written once (deterministic).  dS^T goes once to shared memory
// (bf16, swizzled, two buffers alternating by q step, since each
// warpgroup's dQ reads the other's rows) for dQ = dS K, split by columns
// over the warpgroups (both operands MN-major); each warpgroup's f32
// columns leave through TMA
// reduce-adds (cp.reduce.async.bulk.tensor .add) into the wrapper's zeroed
// scratch from a double-buffered, swizzled staging tile, so dQ's order of
// summation over kv tiles varies from run to run.
// D = 64 runs two warpgroups on 128-row kv tiles; D = 128 one warpgroup
// on 64-row tiles, which keeps dK, dV (64 registers each), S^T, dP^T and
// dQ's 64 under the 255-register limit.
// ---------------------------------------------------------------------------
template <int DP, int NWG>
struct BwdPlan {
  static constexpr int kPanels = DP / kPanel;
  static constexpr int kKvRows = 64 * NWG;
  static constexpr int kQRows = 64;
  static constexpr int kKv = kPanels * kKvRows * kPanel;  // bf16 elements
  static constexpr int kQ = kPanels * kQRows * kPanel;
  static constexpr int kStages = DP == 64 ? 3 : 2;  // the (Q, dO, O) ring
  static constexpr int kDqCols = DP / NWG;  // dQ columns a warpgroup owns
  static constexpr int kStage = kQRows * kDqCols;  // its f32 dQ tile
  static constexpr int kThreads = (NWG + 1) * kWarpgroup;
  // K, V; the ring's Q, dO, O; two dS^T [kv, 64]; per warpgroup two f32
  // dQ staging tiles; per stage lse and delta [64]; barriers; + 1 KB to
  // align (171 KB at D = 64, 210 KB at D = 128)
  static constexpr size_t kBytes =
      2 * ((size_t)2 * kKv + 3 * kStages * kQ + 2 * kKvRows * 64) +
      4 * ((size_t)2 * NWG * kStage + kStages * 2 * 64) +
      8 * (1 + 3 * kStages) + 1024;
};

template <int DP, int NWG>
__global__ void __launch_bounds__(BwdPlan<DP, NWG>::kThreads, 1)
    flash_bwd_fused_wgmma(const __grid_constant__ CUtensorMap map_q,
                          const __grid_constant__ CUtensorMap map_k,
                          const __grid_constant__ CUtensorMap map_v,
                          const __grid_constant__ CUtensorMap map_do,
                          const __grid_constant__ CUtensorMap map_o,
                          const __grid_constant__ CUtensorMap map_dq,
                          const float* __restrict__ lse,
                          bf16* __restrict__ dk,
                          bf16* __restrict__ dv, int T_, int D, float scale,
                          int causal) {
  using Plan = BwdPlan<DP, NWG>;
  constexpr int BK = Plan::kKvRows, BQ = Plan::kQRows, S = Plan::kStages;
  constexpr int NC = NWG * kWarpgroup;  // consumer threads
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align1024(smem_raw);
  bf16* ks = reinterpret_cast<bf16*>(base);
  bf16* vs = ks + Plan::kKv;
  bf16* qs = vs + Plan::kKv;  // ring: [stage] Q, then dO, then O
  bf16* dos = qs + S * Plan::kQ;
  bf16* os = dos + S * Plan::kQ;
  bf16* dst = os + S * Plan::kQ;  // [2] dS^T [BK, 64], swizzled
  float* stage_dq = reinterpret_cast<float*>(dst + 2 * BK * 64);  // [NWG][2]
  float* rowdata = stage_dq + 2 * NWG * Plan::kStage;  // [S][lse, delta]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(rowdata + S * 128);
  uint64_t* full = kv_full + 1;   // the stage's tiles have landed
  uint64_t* rows_full = full + S;  // its lse and delta are written
  uint64_t* empty = rows_full + S;

  const int bh = blockIdx.x, kt = blockIdx.y, c0 = kt * BK;
  const int q_first = causal ? c0 / BQ : 0;
  const int n_q = (T_ + BQ - 1) / BQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long head = (long long)bh * T_;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < S; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&rows_full[s], 2);  // the two row-data warps
      hopper::mbar_init(&empty[s], NWG * 4);  // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  if (warp >= NWG * 4) {  // producer warpgroup
    if constexpr (NWG == 2) hopper::reg_dealloc<kProducerRegs>();
    const int pw = warp - NWG * 4;
    if (pw == 0 && lane == 0) {  // TMA
      hopper::mbar_expect_tx(kv_full, 2 * Plan::kKv * 2);
      for (int p = 0; p < Plan::kPanels; ++p) {
        hopper::tma_load_3d(ks + p * BK * kPanel, &map_k, kv_full, p * kPanel,
                            c0, bh);
        hopper::tma_load_3d(vs + p * BK * kPanel, &map_v, kv_full, p * kPanel,
                            c0, bh);
      }
      for (int qi = q_first, i = 0; qi < n_q; ++qi, ++i) {
        const int s = i % S;
        hopper::mbar_wait(&empty[s], ((i / S) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 3 * Plan::kQ * 2);
        for (int p = 0; p < Plan::kPanels; ++p) {
          const int off = s * Plan::kQ + p * BQ * kPanel;
          hopper::tma_load_3d(qs + off, &map_q, &full[s], p * kPanel,
                              qi * BQ, bh);
          hopper::tma_load_3d(dos + off, &map_do, &full[s], p * kPanel,
                              qi * BQ, bh);
          hopper::tma_load_3d(os + off, &map_o, &full[s], p * kPanel,
                              qi * BQ, bh);
        }
      }
    } else if (pw == 1 || pw == 2) {
      // row data of each q tile, one row a thread: lse (times log2 e)
      // and delta = rowsum(dO * O) from the landed tiles (rows past T
      // were zero-filled: delta 0)
      const int r = (pw - 1) * 32 + lane;
      for (int qi = q_first, i = 0; qi < n_q; ++qi, ++i) {
        const int s = i % S, row = qi * BQ + r;
        const float l = row < T_ ? lse[head + row] : 0.f;
        hopper::mbar_wait(&full[s], (i / S) & 1);
        const bf16* dot = dos + s * Plan::kQ;
        const bf16* ot = os + s * Plan::kQ;
        float d = 0.f;
#pragma unroll
        for (int c = 0; c < DP; c += 8) {
          if (c < D) {
            const int off = (c / kPanel) * BQ * kPanel + swz(r, c % kPanel);
            const uint4 a = *reinterpret_cast<const uint4*>(dot + off);
            const uint4 b = *reinterpret_cast<const uint4*>(ot + off);
            const __nv_bfloat162* pa =
                reinterpret_cast<const __nv_bfloat162*>(&a);
            const __nv_bfloat162* pb =
                reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float2 fa = __bfloat1622float2(pa[e]);
              const float2 fb = __bfloat1622float2(pb[e]);
              d += fa.x * fb.x + fa.y * fb.y;
            }
          }
        }
        // the consumers of two steps back are done with this stage's row
        // data: they released the stage before the producer refilled it
        rowdata[s * 128 + r] = l * kLog2e;
        rowdata[s * 128 + 64 + r] = d;
        __syncwarp();
        if (lane == 0) hopper::mbar_arrive(&rows_full[s]);
      }
    }
    return;
  }

  // consumers: warpgroup wg owns kv rows [c0 + 64 wg, c0 + 64 wg + 64)
  if constexpr (NWG == 2) hopper::reg_alloc<kConsumerRegs>();
  const int wg = warp >> 2;
  const bool leader = (threadIdx.x & (kWarpgroup - 1)) == 0;
  const int kv_base = c0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const float scale_log2 = scale * kLog2e;
  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int j = 0; j < DP / 2; ++j) dk_acc[j] = dv_acc[j] = 0.f;
  float st[32], dpt[32], dq[Plan::kDqCols / 2];
#pragma unroll
  for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.f;
#pragma unroll
  for (int j = 0; j < Plan::kDqCols / 2; ++j) dq[j] = 0.f;

  hopper::mbar_wait(kv_full, 0);
  for (int qi = q_first, i = 0; qi < n_q; ++qi, ++i) {
    const int s = i % S, q0 = qi * BQ;
    const uint32_t phase = (i / S) & 1;
    const bf16* qt = qs + s * Plan::kQ;
    const bf16* dot = dos + s * Plan::kQ;
    const float* lse_s = rowdata + s * 128;
    const float* dl_s = lse_s + 64;
    hopper::mbar_wait(&full[s], phase);

    // S^T = K Q^T and dP^T = V dO^T, kv rows as M
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hopper::wgmma_ss<64, 0, 0>(st, desc_k(ks, BK, wg * 64, kk),
                                 desc_k(qt, BQ, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      hopper::wgmma_ss<64, 0, 0>(dpt, desc_k(vs, BK, wg * 64, kk),
                                 desc_k(dot, BQ, 0, kk), kk > 0);
    hopper::wgmma_commit();
    hopper::mbar_wait(&rows_full[s], phase);
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(dpt);

    // P^T and dS^T in registers (st becomes P^T, dpt dS^T); p = exp(s *
    // scale - lse) as one FMA into ex2
    const bool edge = (causal && q0 < c0 + BK) || q0 + BQ > T_ || c0 + BK > T_;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int c = acc_col(j, lane);
      float p = hopper::ex2(fmaf(st[j], scale_log2, -lse_s[c]));
      if (edge) {
        const int kv = kv_base + 8 * acc_half(j), q = q0 + c;
        if (kv >= T_ || q >= T_ || (causal && q < kv)) p = 0.f;
      }
      st[j] = p;
      dpt[j] = p * (dpt[j] - dl_s[c]) * scale;
    }

    // dV += P^T dO and dK += dS^T Q, A from registers, B MN-major
    uint32_t pa[BQ / 4], da[BQ / 4];
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      a_frag(pa + 4 * t, st, t);
      a_frag(da + 4 * t, dpt, t);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t)
      hopper::wgmma_rs<DP, 1>(dv_acc, pa + 4 * t, desc_mn(dot, BQ, t, 0), 1);
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t)
      hopper::wgmma_rs<DP, 1>(dk_acc, da + 4 * t, desc_mn(qt, BQ, t, 0), 1);
    hopper::wgmma_commit();

    // dS^T (bf16) to shared memory for dQ, while those run.  Every
    // warpgroup's dQ reads all BK rows, so the buffer alternates by step:
    // a warpgroup that runs ahead writes the other one, and can come back
    // to this one only past the next step's barrier, which the slower
    // warpgroup reaches after its dQ product here has completed
    bf16* dst_i = dst + (i & 1) * BK * 64;
#pragma unroll
    for (int j = 0; j < 32; j += 2) {
      const int r = kv_base - c0 + 8 * acc_half(j), c = acc_col(j, lane);
      *reinterpret_cast<__nv_bfloat162*>(dst_i + swz(r, c)) =
          __floats2bfloat162_rn(dpt[j], dpt[j + 1]);
    }
    hopper::fence_proxy_async();
    // this warpgroup's staging tile written below was last read by its
    // reduce-adds two steps back
    if (leader) hopper::bulk_wait_read<1>();
    hopper::named_sync(3, NC);  // dS^T complete, from every warpgroup

    hopper::wgmma_wait<0>();
    hopper::fence_regs(dv_acc);
    hopper::fence_regs(dk_acc);
    hopper::fence_regs(pa);
    hopper::fence_regs(da);
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);

    // dQ[:, wg's columns] = dS K, both operands MN-major
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < BK / 16; ++t)
      hopper::wgmma_ss<Plan::kDqCols, 1, 1>(
          dq, desc_mn(dst_i, BK, t, 0), desc_mn(ks, BK, t, wg * Plan::kDqCols),
          t > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dq);

    // stage this warpgroup's f32 columns in 32-column panels, 128-byte
    // swizzled (16-byte chunk c of row r at c ^ (r % 8)), and add them to
    // the scratch with one TMA reduce-add a panel, which drops rows past T
    // and columns past D
    float* stage = stage_dq + (wg * 2 + (i & 1)) * Plan::kStage;
#pragma unroll
    for (int j = 0; j < Plan::kDqCols / 2; j += 2) {
      const int r = (warp & 3) * 16 + (lane >> 2) + 8 * acc_half(j);
      const int c = acc_col(j, lane);
      *reinterpret_cast<float2*>(stage + (c >> 5) * BQ * 32 + r * 32 +
                                 ((((c >> 2) ^ r) & 7) << 2) + (c & 3)) =
          make_float2(dq[j], dq[j + 1]);
    }
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, kWarpgroup);
    if (leader) {
      for (int p = 0; p < Plan::kDqCols / 32; ++p)
        hopper::tma_reduce_add_3d(&map_dq, stage + p * BQ * 32,
                                  wg * Plan::kDqCols + p * 32, q0, bh);
      hopper::bulk_commit();
    }
  }
  if (leader) hopper::bulk_wait<0>();

  // dK, dV: written once
#pragma unroll
  for (int j = 0; j < DP / 2; j += 2) {
    const int col = acc_col(j, lane), kv = kv_base + 8 * acc_half(j);
    if (col < D && kv < T_) {
      const long long off = (head + kv) * D + col;
      *reinterpret_cast<__nv_bfloat162*>(dk + off) =
          __floats2bfloat162_rn(dk_acc[j], dk_acc[j + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off) =
          __floats2bfloat162_rn(dv_acc[j], dv_acc[j + 1]);
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

dim3 grid_of(int BH, int T_, int rows) {
  return dim3(BH, (T_ + rows - 1) / rows);
}

template <typename T>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int BH, int T_, int D, float scale,
                       int causal, cudaStream_t s) {
  const size_t bytes = Smem<T>(D).fwd_bytes();
  cudaError_t err = set_smem(flash_fwd_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  flash_fwd_kernel<T><<<grid_of(BH, T_, Tile<T>::kRows), kThreads, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      T_, D, scale, causal);
  return cudaGetLastError();
}

template <typename T, bool kFused>
cudaError_t launch_bwd_kv(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, const void* out, void* dq_acc,
                          void* dk, void* dv, int BH, int T_, int D,
                          float scale, int causal, cudaStream_t s) {
  const size_t bytes = Smem<T>(D).bwd_kv_bytes();
  cudaError_t err = set_smem(flash_bwd_kv_kernel<T, kFused>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_kv_kernel<T, kFused>
      <<<grid_of(BH, T_, Tile<T>::kRows), kThreads, bytes, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<const T*>(out), static_cast<float*>(dq_acc),
          static_cast<T*>(dk), static_cast<T*>(dv), T_, D, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dq(const void* q, const void* k, const void* v,
                          const void* dout, const void* lse,
                          const void* delta, void* dq, int BH, int T_, int D,
                          float scale, int causal, cudaStream_t s) {
  const size_t bytes = Smem<T>(D).bwd_q_bytes();
  cudaError_t err = set_smem(flash_bwd_dq_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  flash_bwd_dq_kernel<T>
      <<<grid_of(BH, T_, Tile<T>::kRows), kThreads, bytes, s>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<const T*>(dout),
          static_cast<const float*>(lse), static_cast<const float*>(delta),
          static_cast<T*>(dq), T_, D, scale, causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_fwd_bf16(const void* q, const void* k, const void* v,
                            void* o, void* lse, int BH, int T_, int D,
                            float scale, int causal, cudaStream_t s) {
  using Plan = FwdPlan<DP>;
  CUtensorMap mq, mk, mv, mo;
  if (!hopper::map_3d(&mq, q, false, BH, T_, D, Plan::kRows) ||
      !hopper::map_3d(&mk, k, false, BH, T_, D, Plan::kRows) ||
      !hopper::map_3d(&mv, v, false, BH, T_, D, Plan::kRows) ||
      !hopper::map_3d(&mo, o, false, BH, T_, D, 64))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_fwd_wgmma<DP>, Plan::kBytes);
  if (err != cudaSuccess) return err;
  // persistent: one CTA an SM (or one an item, if fewer)
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int items = BH * ((T_ + Plan::kRows - 1) / Plan::kRows);
  flash_fwd_wgmma<DP>
      <<<items < sms ? items : sms, Plan::kThreads, Plan::kBytes, s>>>(
          mq, mk, mv, mo, static_cast<float*>(lse), BH, T_, scale, causal);
  return cudaGetLastError();
}

template <int DP, int NWG>
cudaError_t launch_bwd_fused_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* out, void* dq_acc, void* dk,
                                  void* dv, int BH, int T_, int D,
                                  float scale, int causal, cudaStream_t s) {
  using Plan = BwdPlan<DP, NWG>;
  CUtensorMap mq, mk, mv, mdo, mo, mdq;
  if (!hopper::map_3d(&mdq, dq_acc, true, BH, T_, D, Plan::kQRows) ||
      !hopper::map_3d(&mq, q, false, BH, T_, D, Plan::kQRows) ||
      !hopper::map_3d(&mk, k, false, BH, T_, D, Plan::kKvRows) ||
      !hopper::map_3d(&mv, v, false, BH, T_, D, Plan::kKvRows) ||
      !hopper::map_3d(&mdo, dout, false, BH, T_, D, Plan::kQRows) ||
      !hopper::map_3d(&mo, out, false, BH, T_, D, Plan::kQRows))
    return cudaErrorInvalidValue;
  cudaError_t err = set_smem(flash_bwd_fused_wgmma<DP, NWG>, Plan::kBytes);
  if (err != cudaSuccess) return err;
  flash_bwd_fused_wgmma<DP, NWG>
      <<<grid_of(BH, T_, Plan::kKvRows), Plan::kThreads, Plan::kBytes, s>>>(
          mq, mk, mv, mdo, mo, mdq, static_cast<const float*>(lse),
          static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), T_, D, scale, causal);
  return cudaGetLastError();
}

bool bad_shape(int BH, int T_, int D) {
  return BH < 1 || T_ < 1 || D < 8 || D > kMaxD || D % 8 != 0;
}

}  // namespace

extern "C" {

// dtype: 0 = f32, 1 = bf16.  causal: 0 or 1.  Every entry returns a
// cudaError_t (0 = launched).

// K1
int rt_flash_fwd(const void* q, const void* k, const void* v, void* o,
                 void* lse, int BH, int T, int D, float scale, int causal,
                 int dtype, void* stream) {
  if (bad_shape(BH, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_fwd<float>(q, k, v, o, lse, BH, T, D, scale, causal, s);
  if (dtype == kBF16)
    return (int)(D <= 64 ? launch_fwd_bf16<64>(q, k, v, o, lse, BH, T, D,
                                                scale, causal, s)
                         : launch_fwd_bf16<128>(q, k, v, o, lse, BH, T, D,
                                                 scale, causal, s));
  return (int)cudaErrorInvalidValue;
}

// K2: dq_acc is an f32 [BH, T, D] scratch the caller has zeroed.
int rt_flash_bwd_fused(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* out,
                       void* dq_acc, void* dk, void* dv, int BH, int T, int D,
                       float scale, int causal, int dtype, void* stream) {
  if (bad_shape(BH, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_bwd_kv<float, true>(q, k, v, dout, lse, nullptr, out,
                                           dq_acc, dk, dv, BH, T, D, scale,
                                           causal, s);
  if (dtype == kBF16)
    return (int)(D <= 64 ? launch_bwd_fused_bf16<64, 2>(
                               q, k, v, dout, lse, out, dq_acc, dk, dv, BH, T,
                               D, scale, causal, s)
                         : launch_bwd_fused_bf16<128, 1>(
                               q, k, v, dout, lse, out, dq_acc, dk, dv, BH, T,
                               D, scale, causal, s));
  return (int)cudaErrorInvalidValue;
}

// K3
int rt_flash_bwd_dq(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dq, int BH, int T, int D, float scale, int causal,
                    int dtype, void* stream) {
  if (bad_shape(BH, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_bwd_dq<float>(q, k, v, dout, lse, delta, dq, BH, T, D,
                                     scale, causal, s);
  if (dtype == kBF16)
    return (int)launch_bwd_dq<bf16>(q, k, v, dout, lse, delta, dq, BH, T, D,
                                    scale, causal, s);
  return (int)cudaErrorInvalidValue;
}

// K4
int rt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     void* dk, void* dv, int BH, int T, int D, float scale,
                     int causal, int dtype, void* stream) {
  if (bad_shape(BH, T, D)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return (int)launch_bwd_kv<float, false>(q, k, v, dout, lse, delta,
                                            nullptr, nullptr, dk, dv, BH, T,
                                            D, scale, causal, s);
  if (dtype == kBF16)
    return (int)launch_bwd_kv<bf16, false>(q, k, v, dout, lse, delta, nullptr,
                                           nullptr, dk, dv, BH, T, D, scale,
                                           causal, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
