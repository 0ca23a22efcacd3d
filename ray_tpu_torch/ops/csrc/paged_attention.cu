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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the reference's mask value
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };

// ---------------------------------------------------------------------------
// K5: paged KV append, in place.
//
// Replaces ray_tpu/ops/paged_attention.py:93 `_build_append` (pallas_call at
// l.202, entry `paged_kv_append` l.216).
//
// Bound on this card: bytes.  A call reads B*KV*HD new elements per pool and
// writes as many (plus B*KV f32 scales each way for int8): kilobytes, so the
// launch itself is the floor, not the 3.35 TB/s of HBM.
//
// Design: one block per (row, kv head).  A row's new K (or V) for one kv
// head is a contiguous run of HD elements both in `k_new` and in the pool,
// so the append is a byte copy in the widest unit the alignment allows
// (16-byte vectors at HD=128 for every supported dtype).  The Pallas
// kernel's whole-block copy-through and its sequential grid existed only
// because Pallas stages whole blocks; an in-place scatter has neither, so
// rows run in parallel.  Two idle rows may write the same slot of scratch
// block 0: benign, scratch content is garbage by contract.
// ---------------------------------------------------------------------------
template <typename V>
__global__ void append_kernel(char* __restrict__ k_pool,
                              char* __restrict__ v_pool,
                              const char* __restrict__ k_new,
                              const char* __restrict__ v_new,
                              float* __restrict__ k_scale,
                              float* __restrict__ v_scale,
                              const float* __restrict__ k_new_scale,
                              const float* __restrict__ v_new_scale,
                              const int* __restrict__ tables,
                              const int* __restrict__ pos, int layer, int NB,
                              int BS, int KV, int row_bytes, int W) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int p = pos[b];
  // a position past the table's reach writes nothing (the reference's
  // `p_b < view` guard); within reach, p / BS <= W - 1 already
  if (p < 0 || p >= W * BS) return;
  const long long blk = tables[(long long)b * W + p / BS];
  const long long slot = ((long long)layer * NB + blk) * BS + p % BS;
  const long long dst = (slot * KV + h) * row_bytes;
  const long long src = ((long long)b * KV + h) * row_bytes;
  const int n = row_bytes / (int)sizeof(V);
  const V* ks = reinterpret_cast<const V*>(k_new + src);
  const V* vs = reinterpret_cast<const V*>(v_new + src);
  V* kd = reinterpret_cast<V*>(k_pool + dst);
  V* vd = reinterpret_cast<V*>(v_pool + dst);
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    kd[i] = ks[i];
    vd[i] = vs[i];
  }
  if (k_scale != nullptr && threadIdx.x == 0) {
    k_scale[slot * KV + h] = k_new_scale[b * KV + h];
    v_scale[slot * KV + h] = v_new_scale[b * KV + h];
  }
}

// ---------------------------------------------------------------------------
// K6: paged decode attention through the block table.
//
// Replaces ray_tpu/ops/paged_attention.py:247 `_build_attention` (pallas_call
// at l.344, entry `paged_decode_attention` l.367).
//
// Bound on this card: bytes.  Each row's live K and V (pos[b] + 1 rows of
// KV*HD elements each) are read once; the arithmetic is 4*H*HD flops per
// live column, a few flops per byte, far below the ~295 flop/byte where
// the tensor cores would bind.
//
// Design: one block per (row b, kv head).  The block serves that kv head's
// `group = H / KV` query heads, so each KV tile crosses HBM once per group
// rather than once per query head.  It walks w = 0 .. min(pos // BS, W - 1).
// The [BS, HD] K and V tiles of block tables[b, w] arrive as 16-byte vector
// loads issued one block ahead (tile w+1 is in flight while tile w is
// computed) and are staged into shared memory as f32, int8 dequantized as
// (int8 -> f32) * scale -> q dtype.  Then: f32 scores, one thread per
// (query row, column) over a bank-padded K tile, masked > pos at -1e30; the
// online max/sum update in f32, one warp per query row; P cast to q's dtype;
// P.V accumulated in f32.  Finalize divides by (l == 0 ? 1 : l).  The walk
// is serial per block; splitting long rows over W with a combine pass,
// cp.async/TMA pipelining and mma for the group rows are later work.
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

constexpr int kAttnThreads = 128;
// 16-byte vectors a thread holds per tile: tiles up to 16 KB
// (BS * HD * sizeof(PT) <= 16 * kMaxVecs * kAttnThreads)
constexpr int kMaxVecs = 8;

template <typename QT, typename PT>
__global__ void __launch_bounds__(kAttnThreads)
    decode_attention_kernel(QT* __restrict__ out, const QT* __restrict__ q,
                            const PT* __restrict__ k_pool,
                            const PT* __restrict__ v_pool,
                            const float* __restrict__ k_scale,
                            const float* __restrict__ v_scale,
                            const int* __restrict__ tables,
                            const int* __restrict__ pos, int layer, int NB,
                            int BS, int KV, int HD, int group, int W,
                            float scale) {
  // K rows are padded to HD + 1 floats: the score loop's threads read one
  // column of BS different rows, which then fall in distinct banks
  const int ks_stride = HD + 1;
  extern __shared__ float smem[];
  float* k_s = smem;                  // [BS, HD + 1]
  float* v_s = k_s + BS * ks_stride;  // [BS, HD]
  float* q_s = v_s + BS * HD;     // [group, HD]
  float* acc = q_s + group * HD;  // [group, HD] f32 accumulator
  float* p_s = acc + group * HD;  // [group, BS] scores, then P
  float* m_s = p_s + group * BS;  // [group] running max
  float* l_s = m_s + group;       // [group] running sum
  float* c_s = l_s + group;       // [group] this step's correction

  const int b = blockIdx.x, kvh = blockIdx.y;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const int H = KV * group;
  const long long q_off = ((long long)b * H + (long long)kvh * group) * HD;
  const int p_b = pos[b];
  const bool quantized = k_scale != nullptr;

  for (int i = tid; i < group * HD; i += nt) {
    q_s[i] = to_f32<QT>(q[q_off + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < group; g += nt) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  // the K and V tiles travel as 16-byte vectors (a vector never straddles
  // a row: HD * sizeof(PT) % 16 == 0), held in registers one block ahead
  constexpr int kPer = 16 / sizeof(PT);  // elements per vector
  const int n_vec = BS * HD / kPer;      // vectors per tile
  uint4 kr[kMaxVecs], vr[kMaxVecs];
  float ksr[kMaxVecs], vsr[kMaxVecs];
  auto load = [&](int w) {  // issue tile w's loads
    const long long row0 =
        ((long long)layer * NB + tables[(long long)b * W + w]) * BS;
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j) {
      const int v = tid + j * kAttnThreads;
      if (v < n_vec) {
        const int i = v * kPer, r = i / HD, d = i - r * HD;
        const long long row = (row0 + r) * KV + kvh;
        kr[j] = *reinterpret_cast<const uint4*>(k_pool + row * HD + d);
        vr[j] = *reinterpret_cast<const uint4*>(v_pool + row * HD + d);
        if (quantized) {
          ksr[j] = k_scale[row];
          vsr[j] = v_scale[row];
        }
      }
    }
  };
  auto stage = [&]() {  // registers -> shared memory as f32
#pragma unroll
    for (int j = 0; j < kMaxVecs; ++j) {
      const int v = tid + j * kAttnThreads;
      if (v < n_vec) {
        const int i = v * kPer, r = i / HD, d = i - r * HD;
#pragma unroll
        for (int e = 0; e < kPer; ++e) {
          float kf = vec_elem<PT>(kr[j], e);
          float vf = vec_elem<PT>(vr[j], e);
          if (quantized) {  // (int8 -> f32) * scale -> q dtype
            kf = round_q<QT>(kf * ksr[j]);
            vf = round_q<QT>(vf * vsr[j]);
          }
          k_s[r * ks_stride + d + e] = kf;
          v_s[i + e] = vf;
        }
      }
    }
  };

  const int n_w = p_b < 0 ? 0 : min(p_b / BS + 1, W);
  if (n_w > 0) load(0);
  for (int w = 0; w < n_w; ++w) {
    __syncthreads();  // the previous step is done with k_s / v_s / p_s
    stage();
    if (w + 1 < n_w) load(w + 1);  // in flight during this step's math
    __syncthreads();
    for (int pr = tid; pr < group * BS; pr += nt) {  // one thread a score
      const int g = pr / BS, r = pr - g * BS;
      const float* qg = q_s + g * HD;
      const float* kr_s = k_s + r * ks_stride;
      float s = 0.f;
      for (int d = 0; d < HD; ++d) s += qg[d] * kr_s[d];
      p_s[pr] = (w * BS + r <= p_b) ? s * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < group; g += nwarps) {
      const float m_old = m_s[g];
      float mx = kNegInf;
      for (int r = lane; r < BS; r += 32) mx = fmaxf(mx, p_s[g * BS + r]);
      const float m_new = fmaxf(m_old, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < BS; r += 32) {
        const float e =
            (w * BS + r <= p_b) ? expf(p_s[g * BS + r] - m_new) : 0.f;
        sum += e;
        p_s[g * BS + r] = round_q<QT>(e);  // P in q's dtype for P.V
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
    for (int i = tid; i < group * HD; i += nt) {
      const int g = i / HD, d = i - g * HD;
      float a = 0.f;
      for (int r = 0; r < BS; ++r) a += p_s[g * BS + r] * v_s[r * HD + d];
      acc[i] = acc[i] * c_s[g] + a;
    }
  }
  __syncthreads();
  for (int i = tid; i < group * HD; i += nt) {
    const float l = l_s[i / HD];
    out[q_off + i] = from_f32<QT>(acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename QT, typename PT>
cudaError_t launch_attention(void* out, const void* q, const void* k_pool,
                             const void* v_pool, const void* k_scale,
                             const void* v_scale, const void* tables,
                             const void* pos, int layer, int NB, int BS,
                             int KV, int HD, int H, int B, int W, float scale,
                             cudaStream_t stream) {
  const int tile_bytes = BS * HD * (int)sizeof(PT);
  if ((HD * (int)sizeof(PT)) % 16 != 0 ||
      tile_bytes > 16 * kMaxVecs * kAttnThreads)
    return cudaErrorInvalidValue;
  const int group = H / KV;
  const size_t smem = sizeof(float) * (BS * (HD + 1) + BS * HD +
                                       2 * group * HD + group * BS + 3 * group);
  auto kernel = decode_attention_kernel<QT, PT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(B, KV), kAttnThreads, smem, stream>>>(
      static_cast<QT*>(out), static_cast<const QT*>(q),
      static_cast<const PT*>(k_pool), static_cast<const PT*>(v_pool),
      static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
      static_cast<const int*>(tables), static_cast<const int*>(pos), layer, NB,
      BS, KV, HD, group, W, scale);
  return cudaGetLastError();
}

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
  const dim3 grid(B, KV);
  const int threads = 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* kp = static_cast<char*>(k_pool);
  char* vp = static_cast<char*>(v_pool);
  const char* kn = static_cast<const char*>(k_new);
  const char* vn = static_cast<const char*>(v_new);
  float* ks = static_cast<float*>(k_scale);
  float* vs = static_cast<float*>(v_scale);
  const float* kns = static_cast<const float*>(k_new_scale);
  const float* vns = static_cast<const float*>(v_new_scale);
  const int* tb = static_cast<const int*>(tables);
  const int* ps = static_cast<const int*>(pos);
#define RT_APPEND(V)                                                       \
  append_kernel<V><<<grid, threads, 0, s>>>(kp, vp, kn, vn, ks, vs, kns,  \
                                            vns, tb, ps, layer, NB, BS, KV, \
                                            row_bytes, W)
  switch (vec_bytes) {
    case 16: RT_APPEND(uint4); break;
    case 8: RT_APPEND(uint2); break;
    case 4: RT_APPEND(unsigned int); break;
    case 2: RT_APPEND(unsigned short); break;
    case 1: RT_APPEND(unsigned char); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef RT_APPEND
  return (int)cudaGetLastError();
}

// K6.  q_dtype / pool_dtype: 0 = f32, 1 = bf16, 2 = int8 (pool only).  An
// int8 pool needs the scale pointers; a model-dtype pool has q's dtype.
int rt_paged_decode_attention(void* out, const void* q, const void* k_pool,
                              const void* v_pool, const void* k_scale,
                              const void* v_scale, const void* tables,
                              const void* pos, int layer, int NB, int BS,
                              int KV, int HD, int H, int B, int W,
                              float scale, int q_dtype, int pool_dtype,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RT_ATTN(QT, PT)                                                     \
  launch_attention<QT, PT>(out, q, k_pool, v_pool, k_scale, v_scale, tables, \
                           pos, layer, NB, BS, KV, HD, H, B, W, scale, s)
  if (q_dtype == kF32 && pool_dtype == kF32) return (int)RT_ATTN(float, float);
  if (q_dtype == kBF16 && pool_dtype == kBF16)
    return (int)RT_ATTN(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && pool_dtype == kI8) return (int)RT_ATTN(float, int8_t);
  if (q_dtype == kBF16 && pool_dtype == kI8)
    return (int)RT_ATTN(__nv_bfloat16, int8_t);
#undef RT_ATTN
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
