// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel).  Same function: q (B,Hq,Lq,D), k/v (B,Hkv,Lk,D),
// q head h reads KV head h / (Hq/Hkv); causal, sliding-window and ragged
// (lk_valid) masks; tanh softcap; q scaled by sm_scale in f32 before the
// product; an f32 online softmax; masked logits are -1e30, never -inf, so a
// row whose keys are all masked comes out finite; out = acc / max(l, 1e-30)
// in q's dtype.
//
// Design.  One block of 128 threads per (batch, q head, 32-row q tile).
// The q tile is loaded once into shared memory as f32; a loop walks the
// 64-key K/V tiles (the TPU kernel's fori_loop), staging each through
// shared memory as f32.  Each warp owns 8 query rows: a lane computes the
// logits of those rows against keys `lane` and `lane + 32`, the row
// max/sum are warp shuffles, and the lane keeps the output columns
// `lane + 32 e` of its rows in registers.  For causal attention the KV
// tiles wholly above the diagonal are skipped; they are fully masked for
// every row of the tile, so skipping them leaves the result unchanged.
//
// Bound.  At the serving prefill's shapes (1 request, Hq 14, Hkv 2,
// Lq 128, Lk 256, D 64, bf16, causal) the function reads q and the 128 K/V
// rows (of 256) that the causal mask keeps once and writes the output
// once, ~0.52 MB: about 0.16 us at 3.35 TB/s, against
// ~30 MFLOP of products (0.03 us at 989 TFLOP/s).  So it is bound by bytes,
// and a launch of 28 blocks on 132 SMs is far from either bound.  The
// products run on the CUDA cores in f32; tensor cores (mma/wgmma) and TMA
// loads are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBQ = 32;               // query rows per block
constexpr int kBK = 64;               // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Shared-memory layout for head dim D: q [kBQ][D], K [kBK][kKS],
// V [kBK][D], P [kBQ][kBK], all f32.  The K row is padded by 4 floats so
// that the float4 reads of 8 neighbouring lanes hit all 32 banks.
template <int D>
struct Smem {
  static constexpr int kKS = D + 4;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * D + kBK * kKS + kBK * D + kBQ * kBK);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
          int lq, int lk, int lk_valid, int causal, int window,
          float softcap, float sm_scale) {
  constexpr int kKS = Smem<D>::kKS;
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kBQ][D], scaled
  float* ks = qs + kBQ * D;                        // [kBK][kKS]
  float* vs = ks + kBK * kKS;                      // [kBK][D]
  float* ps = vs + kBK * D;                        // [kBQ][kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  const T* qg = q + ((size_t)(b * hq + h) * lq + q0) * D;
  const T* kg = k + (size_t)(b * hkv + hk) * lk * D;
  const T* vg = v + (size_t)(b * hkv + hk) * lk * D;
  T* og = o + ((size_t)(b * hq + h) * lq + q0) * D;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads)
    qs[i] = to_float(qg[i]) * sm_scale;

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[r][e] = 0.f;
  }

  int n_kb = lk / kBK;
  if (causal) n_kb = min(n_kb, (q0 + kBQ - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      ks[(i / D) * kKS + i % D] = to_float(kg[(size_t)k0 * D + i]);
      vs[i] = to_float(vg[(size_t)k0 * D + i]);
    }
    __syncthreads();

    // logits of this warp's rows against keys `lane` and `lane + 32`
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ks + lane * kKS + d);
      const float4 kc =
          *reinterpret_cast<const float4*>(ks + (lane + 32) * kKS + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qa =
            *reinterpret_cast<const float4*>(qs + (warp * kRows + r) * D + d);
        s[r][0] += qa.x * ka.x + qa.y * ka.y + qa.z * ka.z + qa.w * ka.w;
        s[r][1] += qa.x * kc.x + qa.y * kc.y + qa.z * kc.z + qa.w * kc.w;
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      const int q_pos = q0 + row;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int k_pos = k0 + lane + 32 * j;
        float val = s[r][j];
        if (softcap > 0.f) val = softcap * tanhf(val / softcap);
        bool ok = k_pos < lk_valid;
        if (causal) ok = ok && k_pos <= q_pos;
        if (window > 0) ok = ok && k_pos > q_pos - window;
        x[j] = ok ? val : kNegInf;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new);
      const float p1 = expf(x[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) acc[r][e] *= alpha;
      ps[row * kBK + lane] = p0;
      ps[row * kBK + lane + 32] = p1;
    }
    __syncwarp();  // a warp reads back only its own rows of P

    // acc += P V over this tile, four keys at a time
    for (int c = 0; c < kBK; c += 4) {
      float v4[kCols][4];
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const int d = lane + 32 * e;
#pragma unroll
        for (int t = 0; t < 4; ++t)
          v4[e][t] = d < D ? vs[(c + t) * D + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pr =
            *reinterpret_cast<const float4*>(ps + (warp * kRows + r) * kBK + c);
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          acc[r][e] += pr.x * v4[e][0] + pr.y * v4[e][1] + pr.z * v4[e][2] +
                       pr.w * v4[e][3];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r;
    const float den = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int d = lane + 32 * e;
      if (d < D) store(og + (size_t)row * D + d, acc[r][e] / den);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int b, int hq, int hkv, int lq, int lk, int lk_valid,
                   int causal, int window, float softcap, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lq / kBQ, hq, b);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, lq, lk,
      lk_valid, causal, window, softcap, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     void* o, int b, int hq, int hkv, int lq, int lk,
                     int lk_valid, int causal, int window, float softcap,
                     float sm_scale, cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, o, b, hq, hkv, lq, lk, lk_valid, causal,
                           window, softcap, sm_scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, o, b, hq, hkv, lq, lk, lk_valid, causal,
                           window, softcap, sm_scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, o, b, hq, hkv, lq, lk, lk_valid, causal,
                           window, softcap, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, o, b, hq, hkv, lq, lk, lk_valid, causal,
                            window, softcap, sm_scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Lq % 32 == 0, Lk % 64 == 0,
// D in {16, 32, 64, 128}, Hq % Hkv == 0; tensors contiguous.  window <= 0
// means no window, softcap <= 0 no softcap.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int hq, int hkv, int lq, int lk, int d, int lk_valid, int causal,
    int window, float softcap, float sm_scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || lq % kBQ != 0 ||
      lk % kBK != 0 || lq <= 0 || lk <= 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(d, q, k, v, o, b, hq, hkv, lq, lk,
                                  lk_valid, causal, window, softcap,
                                  sm_scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(d, q, k, v, o, b, hq, hkv, lq, lk,
                                          lk_valid, causal, window, softcap,
                                          sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
