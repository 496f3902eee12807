// fused_update: the k-ary gradient combine + mean + AdamW update of the
// fused reduce-scatter -> optimizer path, for Hopper (sm_90a), with a
// plain C interface.
//
// Replaces the TPU kernel repro/kernels/fused_update.py::
// fused_adam_update_2d (body _fused_kernel).  Per element:
//   g   = (g_0 + g_1 + ... + g_{k-1}) / scale        (summed in order)
//   m'  = b1*m + (1-b1)*g
//   v'  = b2*v + ((1-b2)*g)*g
//   upd = (m'/c1) / (sqrt(v'/c2) + eps),  + wd*p where the int8 mask is
//         nonzero
//   p'  = p - lr*upd, stored as f32 or bf16 (round to nearest even);
//         m' and v' stay f32.
// c1 = 1 - b1^t and c2 = 1 - b2^t are read from a 2-element f32 array on
// the device, so a train step never reads the step count back.
//
// Bit for bit with the plain version (kernels/ref.py::fused_adam_ref) and
// with train/optimizer.py::apply_updates: every operation is an explicit
// round-to-nearest intrinsic (__fadd_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn,
// __fsub_rn) in the reference's order.  nvcc contracts a*b + c into an FMA
// under -O3 otherwise, which rounds once where the reference rounds twice.
//
// Layout.  p, m, v, the mask and the outputs are contiguous (rows, cols)
// arrays; each gradient has its own row stride, so the ring's last local
// partial (a column block of the PE-stacked buffer) is read in place.  A
// 2D grid: y walks rows (the PEs of a SIM bucket, or one row for a flat
// chunk), x walks a row in a grid-stride loop.  Where every pointer of a
// row agrees modulo 16 bytes (after a head of at most three elements),
// four elements move per thread with 16-byte loads and stores (4-byte
// for the mask, 8-byte for a bf16 output); else the row runs scalar.
//
// Bound.  One pass: per element (4k + 13) bytes read (k gradients, p, m,
// v in f32, the mask) and 12 written (p, m, v in f32), ~15 flops: far
// below the card's rate, so bound by bytes at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 4;
constexpr int kTargetBlocks = 2048;   // ~16 blocks per SM on 132 SMs

struct Grads {
  const float* p[kMaxK];
  int64_t ld[kMaxK];   // elements between rows
};

struct Hyper {
  float lr, b1, b2, omb1, omb2, eps, wd, scale;   // omb = 1 - b
};

struct Row {
  const float* g[kMaxK];
  const float* p;
  const float* m;
  const float* v;
  const int8_t* w;
  void* po;
  float* mo;
  float* vo;
};

__device__ __forceinline__ void adam(float gs, float p, float m, float v,
                                     bool decay, float c1, float c2,
                                     const Hyper& h, float& po, float& mo,
                                     float& vo) {
  gs = __fdiv_rn(gs, h.scale);
  mo = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.omb1, gs));
  vo = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.omb2, gs), gs));
  float upd = __fdiv_rn(__fdiv_rn(mo, c1),
                        __fadd_rn(__fsqrt_rn(__fdiv_rn(vo, c2)), h.eps));
  if (decay) upd = __fadd_rn(upd, __fmul_rn(h.wd, p));
  po = __fsub_rn(p, __fmul_rn(h.lr, upd));
}

template <bool BF16>
__device__ __forceinline__ void one(const Row& r, int k, int64_t i, float c1,
                                    float c2, const Hyper& h) {
  float gs = r.g[0][i];
#pragma unroll
  for (int j = 1; j < kMaxK; ++j)
    if (j < k) gs = __fadd_rn(gs, r.g[j][i]);
  float po, mo, vo;
  adam(gs, r.p[i], r.m[i], r.v[i], r.w[i] != 0, c1, c2, h, po, mo, vo);
  if (BF16)
    static_cast<__nv_bfloat16*>(r.po)[i] = __float2bfloat16_rn(po);
  else
    static_cast<float*>(r.po)[i] = po;
  r.mo[i] = mo;
  r.vo[i] = vo;
}

__device__ __forceinline__ bool at(const void* a, int64_t byte_off,
                                   uintptr_t align) {
  return ((reinterpret_cast<uintptr_t>(a) + byte_off) & (align - 1)) == 0;
}

// elements before the first 16-byte boundary of p (p is 4-byte aligned)
__device__ __forceinline__ int64_t head_of(const float* p, int64_t n) {
  const int64_t h =
      ((16 - (int64_t)(reinterpret_cast<uintptr_t>(p) & 15)) & 15) / 4;
  return h < n ? h : n;
}

template <bool BF16>
__device__ __forceinline__ bool vector_ok(const Row& r, int k, int64_t h) {
  const int64_t b = 4 * h;
  bool ok = at(r.p, b, 16) && at(r.m, b, 16) && at(r.v, b, 16) &&
            at(r.mo, b, 16) && at(r.vo, b, 16) && at(r.w, h, 4) &&
            (BF16 ? at(r.po, 2 * h, 8) : at(r.po, b, 16));
#pragma unroll
  for (int j = 0; j < kMaxK; ++j)
    if (j < k) ok = ok && at(r.g[j], b, 16);
  return ok;
}

__device__ __forceinline__ float lane(const float4& x, int c) {
  return c == 0 ? x.x : (c == 1 ? x.y : (c == 2 ? x.z : x.w));
}

template <bool BF16>
__device__ __forceinline__ void four(const Row& r, int k, int64_t i,
                                     float c1, float c2, const Hyper& h) {
  float4 g = *reinterpret_cast<const float4*>(r.g[0] + i);
#pragma unroll
  for (int j = 1; j < kMaxK; ++j) {
    if (j < k) {
      const float4 x = *reinterpret_cast<const float4*>(r.g[j] + i);
      g.x = __fadd_rn(g.x, x.x);
      g.y = __fadd_rn(g.y, x.y);
      g.z = __fadd_rn(g.z, x.z);
      g.w = __fadd_rn(g.w, x.w);
    }
  }
  const float4 p = *reinterpret_cast<const float4*>(r.p + i);
  const float4 m = *reinterpret_cast<const float4*>(r.m + i);
  const float4 v = *reinterpret_cast<const float4*>(r.v + i);
  const char4 w = *reinterpret_cast<const char4*>(r.w + i);
  const bool d[4] = {w.x != 0, w.y != 0, w.z != 0, w.w != 0};
  float po[4], mo[4], vo[4];
#pragma unroll
  for (int c = 0; c < 4; ++c)
    adam(lane(g, c), lane(p, c), lane(m, c), lane(v, c), d[c], c1, c2, h,
         po[c], mo[c], vo[c]);
  *reinterpret_cast<float4*>(r.mo + i) = make_float4(mo[0], mo[1], mo[2],
                                                     mo[3]);
  *reinterpret_cast<float4*>(r.vo + i) = make_float4(vo[0], vo[1], vo[2],
                                                     vo[3]);
  if (BF16) {
    __nv_bfloat162* o =
        reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(r.po)
                                          + i);
    o[0] = __floats2bfloat162_rn(po[0], po[1]);
    o[1] = __floats2bfloat162_rn(po[2], po[3]);
  } else {
    *reinterpret_cast<float4*>(static_cast<float*>(r.po) + i) =
        make_float4(po[0], po[1], po[2], po[3]);
  }
}

template <bool BF16>
__global__ void __launch_bounds__(kThreads)
    fused_adam_kernel(Grads g, int k, const float* __restrict__ p,
                      const float* __restrict__ m,
                      const float* __restrict__ v,
                      const int8_t* __restrict__ w,
                      const float* __restrict__ hyper, void* po, float* mo,
                      float* vo, int64_t rows, int64_t cols, Hyper h) {
  const float c1 = hyper[0], c2 = hyper[1];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t row = blockIdx.y; row < rows; row += gridDim.y) {
    const int64_t off = row * cols;
    Row r;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j)
      r.g[j] = j < k ? g.p[j] + row * g.ld[j] : nullptr;
    r.p = p + off;
    r.m = m + off;
    r.v = v + off;
    r.w = w + off;
    r.po = BF16 ? static_cast<void*>(static_cast<__nv_bfloat16*>(po) + off)
                : static_cast<void*>(static_cast<float*>(po) + off);
    r.mo = mo + off;
    r.vo = vo + off;
    const int64_t hd = head_of(r.p, cols);
    if (!vector_ok<BF16>(r, k, hd)) {
      for (int64_t i = t; i < cols; i += stride) one<BF16>(r, k, i, c1, c2, h);
      continue;
    }
    const int64_t nv = (cols - hd) / 4;
    for (int64_t q = t; q < nv; q += stride)
      four<BF16>(r, k, hd + 4 * q, c1, c2, h);
    const int64_t tail = cols - hd - 4 * nv;   // 0..3
    for (int64_t s = t; s < hd + tail; s += stride)
      one<BF16>(r, k, s < hd ? s : hd + 4 * nv + (s - hd), c1, c2, h);
  }
}

int64_t clamp_grid(int64_t want, int64_t cap) {
  return want < 1 ? 1 : (want > cap ? cap : want);
}

}  // namespace

// grads/lds: k <= 4 gradient pointers and their row strides (elements);
// p, m, v (f32), mask (int8) and the outputs are contiguous (rows, cols)
// arrays; hyper holds {c1, c2} in f32 on the device.  p_out is bf16 when
// out_bf16 is nonzero, else f32.
extern "C" int repro_fused_adam(const void* const* grads, const int64_t* lds,
                                int k, const void* p, const void* m,
                                const void* v, const void* mask,
                                const void* hyper, void* p_out, void* m_out,
                                void* v_out, int64_t rows, int64_t cols,
                                int out_bf16, float lr, float b1, float b2,
                                float omb1, float omb2, float eps, float wd,
                                float scale, void* stream) {
  if (k < 1 || k > kMaxK || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  Grads g = {};
  for (int j = 0; j < k; ++j) {
    g.p[j] = static_cast<const float*>(grads[j]);
    g.ld[j] = lds[j];
  }
  const Hyper h = {lr, b1, b2, omb1, omb2, eps, wd, scale};
  const int64_t gy = clamp_grid(rows, 65535);
  const int64_t gx = clamp_grid((kTargetBlocks + gy - 1) / gy,
                                ((cols + 3) / 4 + kThreads - 1) / kThreads);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pf = static_cast<const float*>(p);
  const float* mf = static_cast<const float*>(m);
  const float* vf = static_cast<const float*>(v);
  const int8_t* wf = static_cast<const int8_t*>(mask);
  const float* hf = static_cast<const float*>(hyper);
  float* mo = static_cast<float*>(m_out);
  float* vo = static_cast<float*>(v_out);
  if (out_bf16)
    fused_adam_kernel<true><<<grid, kThreads, 0, s>>>(
        g, k, pf, mf, vf, wf, hf, p_out, mo, vo, rows, cols, h);
  else
    fused_adam_kernel<false><<<grid, kThreads, 0, s>>>(
        g, k, pf, mf, vf, wf, hf, p_out, mo, vo, rows, cols, h);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
