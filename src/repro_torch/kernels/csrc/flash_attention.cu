// Flash-attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (body _attn_kernel).  Same function: q (B,Hq,Lq,D), k (B,Hkv,Lk,D), v
// (B,Hkv,Lk,Dv), any D and Dv in 1..256; q head h reads KV head
// h / (Hq/Hkv); causal, sliding-window and ragged (lk_valid) masks; the
// logits (q.k) * sm_scale in f32, then the tanh softcap; an f32 online
// softmax; masked logits are -1e30, never -inf; out (B,Hq,Lq,Dv) =
// acc / max(l, 1e-30) in q's dtype.  A row that keeps no key comes out as
// the plain version's: the mean of v over all Lk slots, padding included.
//
// Design (csrc/attn_tile.cuh holds the loop and both routes).  bf16 at
// head dims that are multiples of 8, the path every model takes: one
// warpgroup of 128 threads per (64-row q tile, q head, batch row), the
// heaviest (last) q tiles first; Q, K and V by TMA into 128-byte-swizzled
// shared memory, K/V in a two-stage ring; S = Q K^T and O += P V on the
// tensor cores (wgmma m64n64k16, f32 accumulate; P from registers, split
// into two bf16 parts; a softmax in units of log2(e) on ex2.approx; key
// tiles that every row keeps whole skip the mask).  f32 (and bf16 that TMA
// cannot address): the CUDA-core loop, 32-row q tiles.  Both walk only the
// key tiles in [max(0, q0 - window + 1), min(lk_valid - 1, q0 + rows - 1
// if causal)]: every other tile is masked for every row of the q tile.  A
// row that
// keeps nothing is written in the epilogue from the sum of v over the
// head's Lk slots, which the block computes only when it has such a row.
//
// Bound.  At the serving prefill's shapes (1 request, Hq 14, Hkv 2,
// Lq 128, Lk 256, D 64, bf16, causal) the function reads q and the 128 K/V
// rows (of 256) that the causal mask keeps once and writes the output
// once, ~0.52 MB: about 0.16 us at 3.35 TB/s, against ~30 MFLOP of
// products (0.03 us at 989 TFLOP/s): bound by bytes, and 28 blocks on 132
// SMs are far from either bound.  At the gathered 32768-token sequence
// (B 1, Hq 14, Hkv 2, D 64, causal) the 536,887,296 kept pairs are 137.4
// GFLOP a head group, 1.924 TFLOP in all: 1.95 ms at the bf16 tensor-core
// rate, against 0.03 ms of bytes: bound by operations.  The split P adds
// a second P V product, 1.5x the products of the bound.
#include "attn_tile.cuh"

namespace {

using namespace attn;

template <int DVB>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc(__grid_constant__ const CUtensorMap tq,
             __grid_constant__ const CUtensorMap tk,
             __grid_constant__ const CUtensorMap tv,
             const bf16* __restrict__ v, bf16* __restrict__ o, int hq,
             int hkv, int lq, int lk, int d, int dv, int lk_valid,
             Mask mask) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTile;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kv_head = b * hkv + h / (hq / hkv);
  const int q_head = b * hq + h;
  const RangeVisit visit =
      range_visit(q0, kTile, lk_valid, mask.causal, mask.window);

  const TcSmem sm = tc_smem(smem_raw, (d + 63) / 64, DVB);
  TcState<DVB> st;
  tc_walk<DVB>(&tq, &tk, &tv, q_head, kv_head, q0, d, lk / kTile,
               DensePos{lk_valid}, visit, mask, sm, st);

  // rows that keep nothing: the mean of v over the Lk slots
  const bool dead = !(st.kept[0] && st.kept[1]);
  if (__syncthreads_or(dead)) {
    const bf16* vg = v + (size_t)kv_head * lk * dv;
    for (int c = threadIdx.x; c < dv; c += kTcThreads) {
      float sum = 0.f;
      for (int j = 0; j < lk; ++j)
        sum += __bfloat162float(vg[(size_t)j * dv + c]);
      sm.vsum[c] = sum;
    }
    __syncthreads();
  }
  const int r0 = tc_row0();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float den = fmaxf(st.l[hh], 1e-30f);
    bf16* og = o + ((size_t)q_head * lq + q0 + r0 + 8 * hh) * dv;
#pragma unroll
    for (int c = 0; c < DVB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * (lane & 3);
        if (col >= dv) continue;  // dv % 8 == 0: col + 1 < dv too
        float a = st.o[c][4 * j + 2 * hh] / den;
        float z = st.o[c][4 * j + 2 * hh + 1] / den;
        if (!st.kept[hh]) {
          a = sm.vsum[col] / fmaxf((float)lk, 1e-30f);
          z = sm.vsum[col + 1] / fmaxf((float)lk, 1e-30f);
        }
        *reinterpret_cast<__nv_bfloat162*>(og + col) =
            __floats2bfloat162_rn(a, z);
      }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(bf16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kCcThreads)
flash_fwd_cc(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int hq, int hkv,
             int lq, int lk, int d, int dv, int lk_valid, Mask mask) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kCcRows;  // heaviest first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t kv_head = (size_t)b * hkv + h / (hq / hkv);
  const size_t q_head = (size_t)b * hq + h;
  const RangeVisit visit =
      range_visit(q0, kCcRows, lk_valid, mask.causal, mask.window);

  const T* vg = v + kv_head * lk * dv;
  CcState<DP> st;
  cc_walk<T, DP>(q + (q_head * lq + q0) * d, k + kv_head * lk * d, vg,
                 kCcRows, q0, lk, d, dv, lk / kTile, DensePos{lk_valid},
                 visit, mask, smem, st);

  constexpr int kRows = kCcRowsPerWarp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  bool dead = false;
#pragma unroll
  for (int r = 0; r < kRows; ++r) dead = dead || !st.kept[r];
  float* vsum = smem;  // q's tile is no longer read
  if (__syncthreads_or(dead)) {
    for (int c = threadIdx.x; c < dv; c += kCcThreads) {
      float sum = 0.f;
      for (int j = 0; j < lk; ++j) sum += to_float(vg[(size_t)j * dv + c]);
      vsum[c] = sum;
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r;
    const float den = fmaxf(st.l[r], 1e-30f);
    T* og = o + (q_head * lq + q0 + row) * dv;
#pragma unroll
    for (int e = 0; e < DP / 32; ++e) {
      const int col = lane + 32 * e;
      if (col < dv)
        store(og + col, st.kept[r] ? st.acc[r][e] / den
                                   : vsum[col] / fmaxf((float)lk, 1e-30f));
    }
  }
}

template <int DVB>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      int b, int hq, int hkv, int lq, int lk, int d, int dv,
                      int lk_valid, const Mask& mask, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = encode_map(&tq, q, d, lq, b * hq);
  if (err == cudaSuccess) err = encode_map(&tk, k, d, lk, b * hkv);
  if (err == cudaSuccess) err = encode_map(&tv, v, dv, lk, b * hkv);
  if (err != cudaSuccess) return err;
  const size_t smem = tc_smem_bytes((d + 63) / 64, DVB);
  err = cudaFuncSetAttribute(flash_fwd_tc<DVB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lq / kTile, hq, b);
  flash_fwd_tc<DVB><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, static_cast<const bf16*>(v), static_cast<bf16*>(o), hq,
      hkv, lq, lk, d, dv, lk_valid, mask);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_cc(const void* q, const void* k, const void* v, void* o,
                      int b, int hq, int hkv, int lq, int lk, int d, int dv,
                      int lk_valid, const Mask& mask, cudaStream_t stream) {
  constexpr size_t smem = cc_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_cc<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(lq / kCcRows, hq, b);
  flash_fwd_cc<T, DP><<<grid, kCcThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, lq, lk, d, dv,
      lk_valid, mask);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cc_d(int dp, const void* q, const void* k, const void* v,
                        void* o, int b, int hq, int hkv, int lq, int lk,
                        int d, int dv, int lk_valid, const Mask& mask,
                        cudaStream_t s) {
  switch (dp) {
    case 32:
      return launch_cc<T, 32>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                              lk_valid, mask, s);
    case 64:
      return launch_cc<T, 64>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                              lk_valid, mask, s);
    case 128:
      return launch_cc<T, 128>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                               lk_valid, mask, s);
    default:
      return launch_cc<T, 256>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                               lk_valid, mask, s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Lq % 64 == 0, Lk % 64 == 0, D and Dv
// in 1..256, Hq % Hkv == 0, 0 <= lk_valid <= Lk; tensors contiguous.
// window <= 0 means no window, softcap <= 0 no softcap.  Launches on
// `stream` without synchronising; returns the launch's cudaError_t (0 on
// success).
extern "C" int repro_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int b,
    int hq, int hkv, int lq, int lk, int d, int dv, int lk_valid, int causal,
    int window, float softcap, float sm_scale, void* stream) {
  if (b <= 0 || hkv <= 0 || hq % hkv != 0 || lq % kTile != 0 ||
      lk % kTile != 0 || lq <= 0 || lk <= 0 || d < 1 || d > kMaxDim ||
      dv < 1 || dv > kMaxDim || lk_valid < 0 || lk_valid > lk ||
      hq > 65535 || b > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Mask mask = make_mask(causal, window, sm_scale, softcap);
  if (tc_route(dtype, d, dv, q, k, v)) {
    switch ((dv + 63) / 64) {
      case 1:
        return (int)launch_tc<1>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                                 lk_valid, mask, s);
      case 2:
        return (int)launch_tc<2>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                                 lk_valid, mask, s);
      case 3:
        return (int)launch_tc<3>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                                 lk_valid, mask, s);
      default:
        return (int)launch_tc<4>(q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                                 lk_valid, mask, s);
    }
  }
  const int dp = cc_pad(d > dv ? d : dv);
  if (dtype == 0)
    return (int)launch_cc_d<float>(dp, q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                                   lk_valid, mask, s);
  return (int)launch_cc_d<bf16>(dp, q, k, v, o, b, hq, hkv, lq, lk, d, dv,
                                lk_valid, mask, s);
}

// 1 if a call with these arguments runs on the tensor cores (bf16, D and
// Dv multiples of 8, q/k/v 16-byte aligned), else 0 (the CUDA cores).
extern "C" int repro_flash_attention_tc(int dtype, int d, int dv,
                                        const void* q, const void* k,
                                        const void* v) {
  return tc_route(dtype, d, dv, q, k, v) ? 1 : 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
