// Ring-attention partials for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel repro/kernels/ring_attention.py::_partials_pallas
// (body _partials_kernel).  Same function: the un-normalised flash partial
// of a query shard against ONE KV block,
//   acc = sum_j exp(s_j - m) v_j   (B,Hq,Lq,D) f32
//   m   = max_j s_j                (B,Hq,Lq)   f32
//   l   = sum_j exp(s_j - m)       (B,Hq,Lq)   f32,
// with s = (q * sm_scale) . k in f32, the tanh softcap before the mask, and
// the mask built from GLOBAL positions: key slot j is kept for query row i
// iff k_pos[j] >= 0 (-1 marks a padded slot), k_pos[j] <= q_pos[i] when
// causal, and k_pos[j] > q_pos[i] - window with a window.  Masked logits
// are -1e30, never -inf, exactly as the reference: a row whose keys are all
// masked gets m = -1e30, l = Lk (every slot weighs exp(0) = 1) and acc =
// the sum of v over the block, all finite, which the merge later wipes
// with a weight exp(-1e30 - m) = 0.  q head h reads KV head h / (Hq/Hkv).
//
// One launch is one ring step for every PE: the reference vmaps its Pallas
// call over the SIM's leading PE axis; here the P PEs and the B batch rows
// fold into the grid's z axis, and a block reads its PE's position tables
// q_pos[pe] (Lq,) and k_pos[pe] (Lk,).
//
// Design: that of csrc/flash_attention.cu.  One block of 128 threads per
// (query tile of 32 rows, q head, PE x batch row).  The q tile is loaded
// once into shared memory as f32, scaled; a loop walks every 64-key K/V
// tile (the TPU kernel's fori_loop), staging each through shared memory as
// f32 with its k_pos slice.  Each warp owns 8 query rows: a lane computes
// the logits of those rows against keys `lane` and `lane + 32`, the row
// max and sum are warp shuffles, and the lane keeps the output columns
// `lane + 32 e` of its rows in registers.  The online softmax rescales
// with expf (not __expf).  Differences from flash_attention.cu: no final
// division (acc, m and l are written); positions come from the tables,
// not from row indices; no tile is skipped (a tile "above the diagonal" is
// wholly masked, but it still adds exp(0) = 1 per slot to a row that has
// kept nothing yet); and the ragged edge is handled here, with no padding:
// a key slot past Lk is absent, its logit -inf, so it weighs exp(-inf) = 0
// and is not counted in l, and query rows past Lq are neither read nor
// written.  Tile skipping where it is provably exact, tensor cores and TMA
// are later work.
//
// Bound.  At the ring step of the port's main path (16 PEs, B 1, Hq 14,
// Hkv 2, Lq = Lk = 2048, D 64, bf16, causal) the function reads q (58.7
// MB), k and v (16.8 MB) and writes acc (117.4 MB), m and l (3.7 MB):
// 196.9 MB, 0.059 ms at 3.35 TB/s.  Computing every tile, as this kernel and
// the TPU kernel do, is 4 D = 256 operations for each of the 940M
// query-key pairs, 240.5 GFLOP: 3.59 ms on the CUDA cores in f32 (67
// TFLOP/s), 0.243 ms at the bf16 tensor-core rate.  So the kernel is bound
// by operations; it computes on the CUDA cores in f32.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace {

constexpr int kBQ = 32;               // query rows per block
constexpr int kBK = 64;               // keys per K/V tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = kBQ / kWarps;   // query rows per warp
constexpr float kNegInf = -1e30f;     // a masked logit, as the reference's

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
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
// V [kBK][D], P [kBQ][kBK] as f32, then the tile's k_pos [kBK] as int.
// The K row is padded by 4 floats so that the float4 reads of 8
// neighbouring lanes hit all 32 banks.
template <int D>
struct Smem {
  static constexpr int kKS = D + 4;
  static constexpr size_t kBytes =
      sizeof(float) * (kBQ * D + kBK * kKS + kBK * D + kBQ * kBK) +
      sizeof(int) * kBK;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
ring_partials(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ qpos,
              const int* __restrict__ kpos, float* __restrict__ acc_out,
              float* __restrict__ m_out, float* __restrict__ l_out, int b,
              int hq, int hkv, int lq, int lk, int causal, int window,
              float softcap, float sm_scale) {
  constexpr int kKS = Smem<D>::kKS;
  constexpr int kCols = (D + 31) / 32;  // output columns per lane
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);  // [kBQ][D], scaled
  float* ks = qs + kBQ * D;                        // [kBK][kKS]
  float* vs = ks + kBK * kKS;                      // [kBK][D]
  float* ps = vs + kBK * D;                        // [kBQ][kBK]
  int* kps = reinterpret_cast<int*>(ps + kBQ * kBK);  // [kBK]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int z = blockIdx.z;             // pe * b + batch row
  const int pe = z / b;
  const int hk = h / (hq / hkv);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rows = min(kBQ, lq - q0);   // query rows of this tile

  const size_t head = (size_t)z * hq + h;
  const T* qg = q + (head * lq + q0) * D;
  const T* kg = k + ((size_t)z * hkv + hk) * lk * D;
  const T* vg = v + ((size_t)z * hkv + hk) * lk * D;
  const int* kpg = kpos + (size_t)pe * lk;

  for (int i = threadIdx.x; i < kBQ * D; i += kThreads)
    qs[i] = i / D < rows ? to_float(qg[i]) * sm_scale : 0.f;

  int q_pos[kRows];
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r;
    q_pos[r] = row < rows ? qpos[(size_t)pe * lq + q0 + row] : 0;
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < kCols; ++e) acc[r][e] = 0.f;
  }

  const int n_kb = (lk + kBK - 1) / kBK;
  for (int kb = 0; kb < n_kb; ++kb) {
    const int k0 = kb * kBK;
    const int keys = min(kBK, lk - k0);  // key slots present in the tile
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
      const bool in = i / D < keys;
      ks[(i / D) * kKS + i % D] =
          in ? to_float(kg[(size_t)k0 * D + i]) : 0.f;
      vs[i] = in ? to_float(vg[(size_t)k0 * D + i]) : 0.f;
    }
    if (threadIdx.x < kBK)
      kps[threadIdx.x] = threadIdx.x < keys ? kpg[k0 + threadIdx.x] : -1;
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
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int slot = lane + 32 * j;
        const int k_pos = kps[slot];
        float val = s[r][j];
        if (softcap > 0.f) val = softcap * tanhf(val / softcap);
        bool ok = k_pos >= 0;
        if (causal) ok = ok && k_pos <= q_pos[r];
        if (window > 0) ok = ok && k_pos > q_pos[r] - window;
        // a slot past Lk is absent: -inf weighs exp(-inf) = 0; a present
        // masked slot is -1e30, as the reference's
        x[j] = slot >= keys ? -CUDART_INF_F : (ok ? val : kNegInf);
      }
      // m[r] >= -1e30, so m_new is finite and no exp sees inf - inf
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

    // acc += P V over this tile, four keys at a time (absent keys have
    // p = 0 and v = 0)
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
    if (row >= rows) continue;
    const size_t at = head * lq + q0 + row;
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      const int d = lane + 32 * e;
      if (d < D) acc_out[at * D + d] = acc[r][e];
    }
    if (lane == 0) {
      m_out[at] = m[r];
      l_out[at] = l[r];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* qpos, const int* kpos, float* acc, float* m,
                   float* l, int p, int b, int hq, int hkv, int lq, int lk,
                   int causal, int window, float softcap, float sm_scale,
                   cudaStream_t stream) {
  constexpr size_t smem = Smem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ring_partials<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((lq + kBQ - 1) / kBQ, hq, p * b);
  ring_partials<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), qpos, kpos, acc, m, l, b, hq, hkv, lq, lk,
      causal, window, softcap, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int d, const void* q, const void* k, const void* v,
                     const int* qpos, const int* kpos, float* acc, float* m,
                     float* l, int p, int b, int hq, int hkv, int lq, int lk,
                     int causal, int window, float softcap, float sm_scale,
                     cudaStream_t stream) {
  switch (d) {
    case 16:
      return launch<T, 16>(q, k, v, qpos, kpos, acc, m, l, p, b, hq, hkv, lq,
                           lk, causal, window, softcap, sm_scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, qpos, kpos, acc, m, l, p, b, hq, hkv, lq,
                           lk, causal, window, softcap, sm_scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, qpos, kpos, acc, m, l, p, b, hq, hkv, lq,
                           lk, causal, window, softcap, sm_scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, qpos, kpos, acc, m, l, p, b, hq, hkv,
                            lq, lk, causal, window, softcap, sm_scale,
                            stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike).  q (P*B,Hq,Lq,D),
// k and v (P*B,Hkv,Lk,D), qpos (P,Lq) and kpos (P,Lk) int32; acc
// (P*B,Hq,Lq,D), m and l (P*B,Hq,Lq) f32; all contiguous.  Any Lq, Lk >= 1;
// D in {16, 32, 64, 128}; Hq % Hkv == 0.  window <= 0 means no window,
// softcap <= 0 no softcap.  Launches on `stream` without synchronising;
// returns the launch's cudaError_t (0 on success).
extern "C" int repro_ring_partials(const void* q, const void* k,
                                   const void* v, const void* qpos,
                                   const void* kpos, void* acc, void* m,
                                   void* l, int dtype, int p, int b, int hq,
                                   int hkv, int lq, int lk, int d,
                                   int causal, int window, float softcap,
                                   float sm_scale, void* stream) {
  if (p <= 0 || b <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lk <= 0 ||
      hq > 65535 || p * b > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* qp = static_cast<const int*>(qpos);
  const int* kp = static_cast<const int*>(kpos);
  float* a = static_cast<float*>(acc);
  float* mm = static_cast<float*>(m);
  float* ll = static_cast<float*>(l);
  switch (dtype) {
    case 0:
      return (int)launch_d<float>(d, q, k, v, qp, kp, a, mm, ll, p, b, hq,
                                  hkv, lq, lk, causal, window, softcap,
                                  sm_scale, s);
    case 1:
      return (int)launch_d<__nv_bfloat16>(d, q, k, v, qp, kp, a, mm, ll, p,
                                          b, hq, hkv, lq, lk, causal, window,
                                          softcap, sm_scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
