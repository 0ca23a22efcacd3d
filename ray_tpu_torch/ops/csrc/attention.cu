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
// sequential last grid axis.  Here that axis is a loop inside one thread
// block, and the blocks are Hopper-sized: 64 rows (bf16) of q against 64 rows
// of k / v per step, whatever block_q / block_k the caller passed (those
// choose only the route, in the wrapper).  bf16 tiles multiply on the tensor
// cores through nvcuda::wmma (16x16x16, bf16 in, f32 accumulate), with the
// f32 accumulators and the score tile staged in shared memory.  The f32
// instantiation is where the algorithm is checked against the reference: it
// multiplies with scalar FMA loops, on 32-row tiles so that its f32 tiles fit
// the 227 KB of shared memory at D = 128.
//
// Bound on this card.  At the training shape (BH 384, T 1024, D 64, causal,
// bf16) K1 does 2 * (2*BH*T^2*D) / 2 = 52 GFLOP against 0.2 GB of q/k/v/o:
// ~250 flops per byte, just under the card's ridge of ~295, so its floor is
// set by bytes (0.061 ms against 0.052 ms of operations); at larger T or D
// the quadratic term, which grows with T where the bytes grow linearly,
// takes over.  K2-K4 do 1.5 to 2.5 times K1's work over 1.25 to 2 times its
// bytes and are bound by tensor-core operations.  What these kernels do
// about it: matmuls on the tensor cores
// with f32 accumulation, causal tiles above the diagonal skipped (half the
// work), S / P / dS never leave shared memory.  What they do not do yet
// (later work): wgmma, TMA / cp.async double-buffered tile loads, register-
// resident accumulators, warp specialisation; every step here loads its
// tiles synchronously and passes through shared memory between products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // the reference's mask value
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
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

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
// K1: flash-attention forward.
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
// K2 (kFused) and K4: the backward seen from one kv tile.
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
    return (int)launch_fwd<bf16>(q, k, v, o, lse, BH, T, D, scale, causal, s);
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
    return (int)launch_bwd_kv<bf16, true>(q, k, v, dout, lse, nullptr, out,
                                          dq_acc, dk, dv, BH, T, D, scale,
                                          causal, s);
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
