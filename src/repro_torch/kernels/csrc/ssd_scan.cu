// Mamba2 SSD chunked scan for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).  Same function: x (Bt,L,H,P), dt (Bt,L,H) f32, A (H,) f32
// (negative), B/C (Bt,L,G,N) in x's dtype with head h reading group
// h / (H/G), h0 (Bt,H,P,N) f32 or none; L a multiple of the chunk Q.  Per
// (batch, head), over chunks of Q steps:
//
//   s     = cumsum(A * dt)                                    within chunk
//   y     = ((C B^T) * exp(s_t - s_u) * dt_u, u <= t) @ x
//         + exp(s_t) * (C @ state^T)
//   state = exp(s_Q) * state + (x * dt * exp(s_Q - s))^T @ B
//
// y is written in x's dtype, the final state in f32.  Above the diagonal
// (u > t) the decay-weighted term is exactly 0, as exp(-1e30) is in the
// reference: no exp of a positive difference is ever taken.
//
// Design: the chunk-parallel decomposition.  Only the state is carried
// from chunk to chunk; a chunk's products are not.  One entry launches
// three CUDA kernels on the caller's stream:
//
//   1. chunk_state_kernel, a block per (batch, chunk, slice of up to 16
//      heads of one group): a warp per head scans A * dt (s, kept in the
//      scratch `s_buf` (Bt, nc, H, Q)) and the block forms each head's
//      local state of the chunk, sum_u (w_u x_u) (x) B_u with w_u = dt_u
//      exp(s_Q - s_u), into the scratch `states` (Bt, nc, H, P, N) f32;
//   2. state_pass_kernel, a thread per 4 state elements of a (batch,
//      head), sequential over the chunks: states[c] becomes the state
//      ENTERING chunk c, S_in[c] = exp(s_Q[c-1]) S_in[c-1] + local[c-1]
//      from h0 (or 0), in place; the last carry is the final state;
//   3. chunk_output_kernel, a block per (batch, chunk, slice of heads):
//      C B^T once for the slice (its heads share the group's B and C),
//      then per head y = M @ x + exp(s_t) (C @ S_in^T), M the masked
//      decay-weighted C B^T; the blocks above the diagonal are skipped.
//
// At the prefill (Bt 1, L 32768, H 80, G 1, Q 128) that is 1280 blocks of
// 16 heads each in phases 1 and 3 (20480 (chunk, head) pairs) where one
// block per head gave 80, and 640 blocks in phase 2.  Staging a tile
// from device memory loads 8 pairs a thread before it stores any.
//
// The products run on the tensor cores: mma.sync m16n8k16, bf16 operands
// in shared memory, f32 accumulation.  Each operand is staged as it lies
// in device memory (16 bytes a load on the bf16 path); a fragment is read
// with 32-bit loads where the product's depth is the contiguous dim (C
// and B in C B^T, the state) and through ldmatrix's transpose where it is
// not (x, and w x and B in phase 1).  An f32 operand (w x, M, the state
// S_in, and on the f32-input path x, B and C too) is split into bf16
// hi + lo = rn(v) + rn(v - rn(v)), which keeps ~16 bits, and a product of
// a split operand with an exact one takes two passes (hi, lo); two split
// operands take three (hi hi, hi lo, lo hi).  On the bf16
// path x, B and C are exact in bf16, so C B^T is one pass of exact
// products and every other product two.  The intra-chunk M never leaves
// registers: C B^T's accumulator tiles are laid out as the A operand of
// the next product.  Sizes are padded with zeros to the tile (Q, P, N to
// multiples of 16): Q <= 128, P <= 64, N <= 128.
//
// Bound.  At the prefill's shapes (bf16) the function reads x, dt, B, C
// once and writes y and the state once, ~0.70 GB: 0.21 ms at 3.35 TB/s;
// its products, the kept u <= t pairs and C B^T once per group, are
// 108 GFLOP: 0.11 ms at the bf16 tensor-core rate (989 TFLOP/s).  So it
// is bound by bytes.  The scratch (the states written, passed in place and
// read: 4 x 671 MB at the prefill) and the split operands' second passes
// are this design's price for the chunk parallelism.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kMaxChunk = 128;     // Q (warp 0's scan holds 4 steps a lane)
constexpr int kMaxP = 64;
constexpr int kMaxN = 128;
constexpr int kHeadsPerBlock = 16;  // heads of one group per block
constexpr int kPad = 8;            // bf16 of row padding: conflict-free
constexpr int kPassThreads = 256;  // phase 2
// phases 1 and 3: two blocks per SM (registers capped at 128 a thread),
// so one block's staging overlaps the other's products
constexpr int kMinBlocks = 2;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// v = hi + lo (+ ~2^-18 |v|)
__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16_rn(v);
  lo = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// two consecutive values (element order: first in the low half) as the
// hi and lo words of their split
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  bf16 ah, al, bh, bl;
  split(a, ah, al);
  split(b, bh, bl);
  hi = pack2(ah, bh);
  lo = pack2(al, bl);
}

__device__ __forceinline__ uint32_t word(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D += A B: A 16x16 row-major, B 16x8 column-major, bf16, f32 accumulate
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragment of rows m0.., columns k0.. of a K-contiguous bf16 array
// with row stride ld (elements); lane = 4 g + t.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s,
                                       int ld, int m0, int k0, int lane) {
  const int g = lane >> 2, t = lane & 3;
  const bf16* p = s + (m0 + g) * ld + k0 + 2 * t;
  a[0] = word(p);
  a[1] = word(p + 8 * ld);
  a[2] = word(p + 8);
  a[3] = word(p + 8 * ld + 8);
}

// The B fragment of columns n0.., rows k0.. of a [n][k] bf16 array
__device__ __forceinline__ void frag_b(uint32_t& b0, uint32_t& b1,
                                       const bf16* s, int ld, int n0, int k0,
                                       int lane) {
  const bf16* p = s + (n0 + (lane >> 2)) * ld + k0 + 2 * (lane & 3);
  b0 = word(p);
  b1 = word(p + 8);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The A fragment of rows m0.., columns k0.. of an array stored [k][m]
// (m contiguous, row stride ld): four 8x8 tiles through ldmatrix's
// transpose (lanes 8i..8i+7 address tile i's rows)
__device__ __forceinline__ void frag_a_t(uint32_t (&a)[4], const bf16* s,
                                         int ld, int m0, int k0, int lane) {
  const int i = lane >> 3, r = lane & 7;
  const bf16* p = s + (k0 + r + 8 * (i >> 1)) * ld + m0 + 8 * (i & 1);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(smem_u32(p)));
}

// The B fragment of columns n0.., rows k0.. of an array stored [k][n]
// (n contiguous): two 8x8 tiles through ldmatrix's transpose
__device__ __forceinline__ void frag_b_t(uint32_t& b0, uint32_t& b1,
                                         const bf16* s, int ld, int n0,
                                         int k0, int lane) {
  const bf16* p = s + (k0 + (lane & 15)) * ld + n0;
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
      : "=r"(b0), "=r"(b1)
      : "r"(smem_u32(p)));
}

struct Dims {
  int L, H, G, P, N, Q;       // as given
  int Qp, Pp, Np, nc, hpg;    // padded to 16; chunks; heads per group
  long long sx_b, sx_l;       // x: batch and step strides (elements)
  long long sb_b, sb_l;       // B
  long long sc_b, sc_l;       // C
  int vec;                    // bf16 rows of x, B, C copy 16 bytes at a time
};

__host__ __device__ inline int pad16(int v) { return (v + 15) / 16 * 16; }

// the block's heads: slice blockIdx.x of the group's heads
struct Slice {
  int g, h0, nh;
  __device__ explicit Slice(const Dims& d) {
    const int per_group = (d.hpg + kHeadsPerBlock - 1) / kHeadsPerBlock;
    g = blockIdx.x / per_group;
    const int j = (blockIdx.x % per_group) * kHeadsPerBlock;
    h0 = g * d.hpg + j;
    nh = min(kHeadsPerBlock, d.hpg - j);
  }
};

// warp 0: s = cumsum(A dt) over the chunk's Q steps (lane k sums steps
// [k*per, k*per + per), then a warp scan adds the lanes before it); s_Q
// is the very sum stored as s[Q-1].  Writes s (and, with `w`, dt exp(s_Q - s))
// for u < Q, the padding u in [Q, Qp) as s_Q and 0; s to `s_out`.
__device__ void scan_chunk(const float* __restrict__ dt, float a,
                           const Dims& d, int b, int l0, int h, float* sv,
                           float* wv, float* s_out) {
  const int lane = threadIdx.x & 31, Q = d.Q;
  const int per = (Q + 31) / 32;
  float loc[kMaxChunk / 32], dtl[kMaxChunk / 32];
  float run = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunk / 32; ++j) {
    const int u = lane * per + j;
    dtl[j] = (j < per && u < Q) ? dt[((size_t)b * d.L + l0 + u) * d.H + h]
                                : 0.f;
    run += a * dtl[j];
    loc[j] = run;
  }
  float incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  float mine = 0.f;
#pragma unroll
  for (int j = 0; j < kMaxChunk / 32; ++j)
    if (j == (Q - 1) % per) mine = excl + loc[j];
  const float s_last = __shfl_sync(0xffffffffu, mine, (Q - 1) / per);
#pragma unroll
  for (int j = 0; j < kMaxChunk / 32; ++j) {
    const int u = lane * per + j;
    if (j < per && u < Q) {
      const float s = excl + loc[j];
      sv[u] = s;
      s_out[u] = s;
      if (wv) wv[u] = dtl[j] * expf(s_last - s);
    }
  }
  for (int u = Q + lane; u < d.Qp; u += 32) {
    sv[u] = s_last;
    if (wv) wv[u] = 0.f;
  }
}

constexpr int kBatch = 8;   // staging: pairs a thread loads at once

// [rows][cols] of a (step, row) source read as pairs along `cols` into
// K-contiguous bf16 planes (hi, and lo when split) with row stride ld:
// dst[r][c] = src(r, c), zero outside (nr, ncols).  `at(r, c)` reads it.
// A thread loads kBatch pairs before it stores any: the loads are in
// flight together.
template <bool kSplit, typename F>
__device__ __forceinline__ void stage_rows(bf16* hi, bf16* lo, int ld,
                                           int rows, int cols, int nr,
                                           int ncols, F at) {
  const int half = cols / 2, total = rows * half;
  for (int base = 0; base < total; base += kThreads * kBatch) {
    float v0[kBatch], v1[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      const int r = i / half, c = (i % half) * 2;
      const bool in = i < total && r < nr;
      v0[j] = (in && c < ncols) ? at(r, c) : 0.f;
      v1[j] = (in && c + 1 < ncols) ? at(r, c + 1) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i < total) {
        const int r = i / half, c = (i % half) * 2;
        uint32_t wh, wl;
        if (kSplit) {
          split2(v0[j], v1[j], wh, wl);
          *reinterpret_cast<uint32_t*>(lo + r * ld + c) = wl;
        } else {
          wh = pack2(__float2bfloat16_rn(v0[j]), __float2bfloat16_rn(v1[j]));
        }
        *reinterpret_cast<uint32_t*>(hi + r * ld + c) = wh;
      }
    }
  }
}

__device__ __forceinline__ float lo_half(uint32_t w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w & 0xffff)));
}
__device__ __forceinline__ float hi_half(uint32_t w) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(w >> 16)));
}

// The vector path of stage_rows for bf16 rows (Dims::vec): dst[r][c] =
// src[r * stride + c], zero outside (nr, ncols), 16 bytes a load; cols and
// ncols multiples of 8, src and stride 16-byte aligned.  With kScale each
// value of row r is multiplied by scale[r] and split into the hi and lo
// planes.
template <bool kScale>
__device__ __forceinline__ void copy_rows(bf16* hi, bf16* lo, int ld,
                                          int rows, int cols, int nr,
                                          int ncols, const bf16* src,
                                          long long stride,
                                          const float* scale) {
  const int per = cols / 8, total = rows * per;
  for (int base = 0; base < total; base += kThreads * kBatch) {
    uint4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      const int r = i / per, c = (i % per) * 8;
      v[j] = (i < total && r < nr && c < ncols)
                 ? *reinterpret_cast<const uint4*>(src + r * stride + c)
                 : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i < total) {
        const int r = i / per, c = (i % per) * 8;
        if (kScale) {
          const float sc = scale[r];
          const uint32_t w[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
          uint32_t wh[4], wl[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            split2(lo_half(w[q]) * sc, hi_half(w[q]) * sc, wh[q], wl[q]);
          *reinterpret_cast<uint4*>(hi + r * ld + c) =
              make_uint4(wh[0], wh[1], wh[2], wh[3]);
          *reinterpret_cast<uint4*>(lo + r * ld + c) =
              make_uint4(wl[0], wl[1], wl[2], wl[3]);
        } else {
          *reinterpret_cast<uint4*>(hi + r * ld + c) = v[j];
        }
      }
    }
  }
}

// An f32 state [nr][ncols] (contiguous, 16-byte aligned, ncols a multiple
// of 4) split into hi and lo planes [rows][ld], zero outside, 16 bytes a
// load
__device__ __forceinline__ void stage_state(bf16* hi, bf16* lo, int ld,
                                            int rows, int cols, int nr,
                                            int ncols,
                                            const float* __restrict__ src) {
  const int per = cols / 4, total = rows * per;
  for (int base = 0; base < total; base += kThreads * kBatch) {
    float4 v[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      const int r = i / per, c = (i % per) * 4;
      v[j] = (i < total && r < nr && c < ncols)
                 ? *reinterpret_cast<const float4*>(src + r * ncols + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int i = base + j * kThreads + threadIdx.x;
      if (i < total) {
        const int r = i / per, c = (i % per) * 4;
        uint32_t h0, l0, h1, l1;
        split2(v[j].x, v[j].y, h0, l0);
        split2(v[j].z, v[j].w, h1, l1);
        *reinterpret_cast<uint2*>(hi + r * ld + c) = make_uint2(h0, h1);
        *reinterpret_cast<uint2*>(lo + r * ld + c) = make_uint2(l0, l1);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// phase 1: s and the chunk's local state
// ---------------------------------------------------------------------------

// shared memory: B planes [NS][Qp][Np+8], (w x) planes [2][Qp][Pp+8]
// (bf16, both [u][...] as they lie in device memory), then s and w of
// each of the block's heads ([heads][Qp] f32 each)
__host__ __device__ inline size_t state_smem(const Dims& d, int ns) {
  return ((size_t)ns * d.Qp * (d.Np + kPad) +
          (size_t)2 * d.Qp * (d.Pp + kPad)) * 2 +
         (size_t)2 * kHeadsPerBlock * d.Qp * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chunk_state_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ a_vec, const T* __restrict__ bm,
                   float* __restrict__ states, float* __restrict__ s_buf,
                   Dims d) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NS = kF32 ? 2 : 1;
  extern __shared__ float4 smem_f4[];
  const int ldn = d.Np + kPad, ldp = d.Pp + kPad;
  bf16* bs = reinterpret_cast<bf16*>(smem_f4);         // [NS][Qp][ldn]
  bf16* xw = bs + (size_t)NS * d.Qp * ldn;             // [2][Qp][ldp]
  float* sv = reinterpret_cast<float*>(xw + (size_t)2 * d.Qp * ldp);
  float* wv = sv + kHeadsPerBlock * d.Qp;

  const Slice sl(d);
  const int c = blockIdx.y, b = blockIdx.z, l0 = c * d.Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the scans of the block's heads, a warp each
  for (int j = warp; j < sl.nh; j += kThreads / 32) {
    const int h = sl.h0 + j;
    scan_chunk(dt, a_vec[h], d, b, l0, h, sv + j * d.Qp, wv + j * d.Qp,
               s_buf + (((size_t)b * d.nc + c) * d.H + h) * d.Q);
  }
  const T* bb = bm + b * d.sb_b + (size_t)l0 * d.sb_l + (size_t)sl.g * d.N;
  if (!kF32 && d.vec)
    copy_rows<false>(bs, nullptr, ldn, d.Qp, d.Np, d.Q, d.N,
                     reinterpret_cast<const bf16*>(bb), d.sb_l, nullptr);
  else
    stage_rows<kF32>(bs, bs + (size_t)d.Qp * ldn, ldn, d.Qp, d.Np, d.Q, d.N,
                     [&](int u, int n) {
                       return to_float(bb[(size_t)u * d.sb_l + n]);
                     });

  // warp (pt, nh): rows 16 pt of P, columns [64 nh, 64 nh + 64) of N
  const int pt = warp >> 1, nh = warp & 1;
  const bool active = pt * 16 < d.Pp && nh * 64 < d.Np;
  __syncthreads();  // s, w and B ready
  for (int j = 0; j < sl.nh; ++j) {
    const int h = sl.h0 + j;
    const size_t sh = ((size_t)b * d.nc + c) * d.H + h;
    const T* xb = x + b * d.sx_b + (size_t)l0 * d.sx_l + (size_t)h * d.P;
    const float* w = wv + j * d.Qp;
    if (!kF32 && d.vec)
      copy_rows<true>(xw, xw + (size_t)d.Qp * ldp, ldp, d.Qp, d.Pp, d.Q, d.P,
                      reinterpret_cast<const bf16*>(xb), d.sx_l, w);
    else
      stage_rows<true>(xw, xw + (size_t)d.Qp * ldp, ldp, d.Qp, d.Pp, d.Q,
                       d.P, [&](int u, int p) {
                         return to_float(xb[(size_t)u * d.sx_l + p]) * w[u];
                       });
    __syncthreads();  // w x ready

    if (active) {
      // local[p][n] = sum_u (w x)[u][p] B[u][n]: A = (w x)^T, B = B
      float acc[8][4] = {};
      for (int k0 = 0; k0 < d.Qp; k0 += 16) {
        uint32_t ah[4], al[4];
        frag_a_t(ah, xw, ldp, pt * 16, k0, lane);
        frag_a_t(al, xw + (size_t)d.Qp * ldp, ldp, pt * 16, k0, lane);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn) {
          const int n0 = nh * 64 + jn * 8;
          if (n0 < d.Np) {
            uint32_t b0, b1;
            frag_b_t(b0, b1, bs, ldn, n0, k0, lane);
            mma(acc[jn], al, b0, b1);
            mma(acc[jn], ah, b0, b1);
            if (kF32) {
              frag_b_t(b0, b1, bs + (size_t)d.Qp * ldn, ldn, n0, k0, lane);
              mma(acc[jn], ah, b0, b1);
            }
          }
        }
      }
      float* st = states + sh * d.P * d.N;
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int jn = 0; jn < 8; ++jn) {
        const int n = nh * 64 + jn * 8 + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int p = pt * 16 + g + 8 * r;
          if (p < d.P && n < d.N) {
            st[(size_t)p * d.N + n] = acc[jn][2 * r];
            if (n + 1 < d.N) st[(size_t)p * d.N + n + 1] = acc[jn][2 * r + 1];
          }
        }
      }
    }
    __syncthreads();  // w x consumed
  }
}

// ---------------------------------------------------------------------------
// phase 2: the states entering each chunk, in place; the final state
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kPassThreads)
state_pass_kernel(float* __restrict__ states, const float* __restrict__ s_buf,
                  const float* __restrict__ h0, float* __restrict__ hout,
                  Dims d) {
  constexpr int kAhead = 4;   // chunks loaded ahead of the recursion
  const int h = blockIdx.y, b = blockIdx.z;
  const int pn = d.P * d.N;
  const int e = (blockIdx.x * kPassThreads + threadIdx.x) * 4;
  if (e >= pn) return;
  const size_t head = (size_t)b * d.H + h;
  float4 carry = h0 ? *reinterpret_cast<const float4*>(h0 + head * pn + e)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
  const size_t cstride = (size_t)d.H * pn;    // one chunk, in states
  float* sp = states + ((size_t)b * d.nc * d.H + h) * pn + e;
  const float* sq = s_buf + ((size_t)b * d.nc * d.H + h) * d.Q + d.Q - 1;
  for (int c0 = 0; c0 < d.nc; c0 += kAhead) {
    float4 loc[kAhead];
    float dec[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < d.nc) {
        loc[j] = *reinterpret_cast<const float4*>(sp + (c0 + j) * cstride);
        dec[j] = sq[(size_t)(c0 + j) * d.H * d.Q];
      }
#pragma unroll
    for (int j = 0; j < kAhead; ++j)
      if (c0 + j < d.nc) {
        *reinterpret_cast<float4*>(sp + (c0 + j) * cstride) = carry;
        const float decay = expf(dec[j]);
        carry.x = decay * carry.x + loc[j].x;
        carry.y = decay * carry.y + loc[j].y;
        carry.z = decay * carry.z + loc[j].z;
        carry.w = decay * carry.w + loc[j].w;
      }
  }
  *reinterpret_cast<float4*>(hout + head * pn + e) = carry;
}

// ---------------------------------------------------------------------------
// phase 3: the chunk's outputs
// ---------------------------------------------------------------------------

// shared memory: C planes [NS][Qp][Np+8]; then either B planes
// [NS][Qp][Np+8] (for C B^T) or, per head, x planes [NS][Qp][Pp+8] and
// S_in planes [2][Pp][Np+8] (bf16, each as it lies in device memory);
// then s and dt of each of the block's heads ([heads][Qp] f32 each)
__host__ __device__ inline size_t output_region(const Dims& d, int ns) {
  const size_t cb = (size_t)ns * d.Qp * (d.Np + kPad);
  const size_t head = (size_t)ns * d.Qp * (d.Pp + kPad) +
                      (size_t)2 * d.Pp * (d.Np + kPad);
  return cb > head ? cb : head;
}
__host__ __device__ inline size_t output_smem(const Dims& d, int ns) {
  return ((size_t)ns * d.Qp * (d.Np + kPad) + output_region(d, ns)) * 2 +
         (size_t)2 * kHeadsPerBlock * d.Qp * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
chunk_output_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                    const T* __restrict__ bm, const T* __restrict__ cm,
                    const float* __restrict__ states,
                    const float* __restrict__ s_buf, T* __restrict__ y,
                    Dims d) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int NS = kF32 ? 2 : 1;
  extern __shared__ float4 smem_f4[];
  const int ldn = d.Np + kPad, ldp = d.Pp + kPad;
  bf16* cs = reinterpret_cast<bf16*>(smem_f4);         // [NS][Qp][ldn]
  bf16* reg = cs + (size_t)NS * d.Qp * ldn;
  bf16* bs = reg;                                      // [NS][Qp][ldn]
  bf16* xs = reg;                                      // [NS][Qp][ldp]
  bf16* st = xs + (size_t)NS * d.Qp * ldp;             // [2][Pp][ldn]
  float* sv = reinterpret_cast<float*>(reg + output_region(d, NS));
  float* dv = sv + kHeadsPerBlock * d.Qp;

  const Slice sl(d);
  const int c = blockIdx.y, b = blockIdx.z, l0 = c * d.Q;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const T* cb_ = cm + b * d.sc_b + (size_t)l0 * d.sc_l + (size_t)sl.g * d.N;
  const T* bb = bm + b * d.sb_b + (size_t)l0 * d.sb_l + (size_t)sl.g * d.N;
  if (!kF32 && d.vec) {
    copy_rows<false>(cs, nullptr, ldn, d.Qp, d.Np, d.Q, d.N,
                     reinterpret_cast<const bf16*>(cb_), d.sc_l, nullptr);
    copy_rows<false>(bs, nullptr, ldn, d.Qp, d.Np, d.Q, d.N,
                     reinterpret_cast<const bf16*>(bb), d.sb_l, nullptr);
  } else {
    stage_rows<kF32>(cs, cs + (size_t)d.Qp * ldn, ldn, d.Qp, d.Np, d.Q, d.N,
                     [&](int r, int n) {
                       return to_float(cb_[(size_t)r * d.sc_l + n]);
                     });
    stage_rows<kF32>(bs, bs + (size_t)d.Qp * ldn, ldn, d.Qp, d.Np, d.Q, d.N,
                     [&](int r, int n) {
                       return to_float(bb[(size_t)r * d.sb_l + n]);
                     });
  }
  // s (padded with s_Q) and dt (padded with 0) of the block's heads
  for (int i = threadIdx.x; i < sl.nh * d.Qp; i += kThreads) {
    const int j = i / d.Qp, u = i % d.Qp, h = sl.h0 + j;
    sv[i] = s_buf[(((size_t)b * d.nc + c) * d.H + h) * d.Q +
                  (u < d.Q ? u : d.Q - 1)];
    dv[i] = u < d.Q ? dt[((size_t)b * d.L + l0 + u) * d.H + h] : 0.f;
  }
  __syncthreads();

  // warp w owns chunk rows [16 w, 16 w + 16); its C B^T tiles u < 16 w + 16
  // stay in registers, 8 columns of u each
  const int t0 = warp * 16;
  const bool active = t0 < d.Qp;
  float cbt[16][4] = {};
  if (active) {
    for (int k0 = 0; k0 < d.Np; k0 += 16) {
      uint32_t ah[4], al[4];
      frag_a(ah, cs, ldn, t0, k0, lane);
      if (kF32) frag_a(al, cs + (size_t)d.Qp * ldn, ldn, t0, k0, lane);
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (j <= 2 * warp + 1) {
          uint32_t b0, b1;
          frag_b(b0, b1, bs, ldn, 8 * j, k0, lane);
          if (kF32) {
            mma(cbt[j], al, b0, b1);
            uint32_t c0, c1;
            frag_b(c0, c1, bs + (size_t)d.Qp * ldn, ldn, 8 * j, k0, lane);
            mma(cbt[j], ah, c0, c1);
          }
          mma(cbt[j], ah, b0, b1);
        }
      }
    }
  }
  __syncthreads();  // B consumed: its region takes x and S_in

  for (int jh = 0; jh < sl.nh; ++jh) {
    const int h = sl.h0 + jh;
    const size_t sh = ((size_t)b * d.nc + c) * d.H + h;
    const T* xb = x + b * d.sx_b + (size_t)l0 * d.sx_l + (size_t)h * d.P;
    if (!kF32 && d.vec)
      copy_rows<false>(xs, nullptr, ldp, d.Qp, d.Pp, d.Q, d.P,
                       reinterpret_cast<const bf16*>(xb), d.sx_l, nullptr);
    else
      stage_rows<kF32>(xs, xs + (size_t)d.Qp * ldp, ldp, d.Qp, d.Pp, d.Q,
                       d.P, [&](int u, int p) {
                         return to_float(xb[(size_t)u * d.sx_l + p]);
                       });
    stage_state(st, st + (size_t)d.Pp * ldn, ldn, d.Pp, d.Np, d.P, d.N,
                states + sh * d.P * d.N);
    __syncthreads();  // x and S_in ready
    const float* svh = sv + jh * d.Qp;
    const float* dvh = dv + jh * d.Qp;

    if (active) {
      float acc[8][4] = {};
      // inter: C @ S_in^T, then scaled by exp(s_t) row by row
      for (int k0 = 0; k0 < d.Np; k0 += 16) {
        uint32_t ah[4], al[4];
        frag_a(ah, cs, ldn, t0, k0, lane);
        if (kF32) frag_a(al, cs + (size_t)d.Qp * ldn, ldn, t0, k0, lane);
#pragma unroll
        for (int jp = 0; jp < 8; ++jp) {
          if (jp * 8 < d.Pp) {
            uint32_t h0_, h1_, l0_, l1_;
            frag_b(h0_, h1_, st, ldn, 8 * jp, k0, lane);
            frag_b(l0_, l1_, st + (size_t)d.Pp * ldn, ldn, 8 * jp, k0, lane);
            mma(acc[jp], ah, l0_, l1_);
            if (kF32) mma(acc[jp], al, h0_, h1_);
            mma(acc[jp], ah, h0_, h1_);
          }
        }
      }
      const int ta = t0 + g, tb = ta + 8;
      const float sa = svh[ta], sb = svh[tb];
      const float ea = expf(sa), eb = expf(sb);
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        acc[jp][0] *= ea;
        acc[jp][1] *= ea;
        acc[jp][2] *= eb;
        acc[jp][3] *= eb;
      }
      // intra: M @ x over the u tiles at or below the diagonal, M from
      // the C B^T tiles: (C B^T)[t][u] * exp(s_t - s_u) * dt_u, u <= t
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i <= warp) {
          float m[8];
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            // fragment element q: tile 2i + (q >= 4), row +8 if q & 2
            const int u = 16 * i + 8 * (q >> 2) + 2 * t + (q & 1);
            const int row = (q & 2) ? tb : ta;
            const float srow = (q & 2) ? sb : sa;
            const float v = cbt[2 * i + (q >> 2)][q & 3];
            m[q] = u <= row ? v * expf(srow - svh[u]) * dvh[u] : 0.f;
          }
          uint32_t mh[4], ml[4];
          split2(m[0], m[1], mh[0], ml[0]);
          split2(m[2], m[3], mh[1], ml[1]);
          split2(m[4], m[5], mh[2], ml[2]);
          split2(m[6], m[7], mh[3], ml[3]);
#pragma unroll
          for (int jp = 0; jp < 8; ++jp) {
            if (jp * 8 < d.Pp) {
              uint32_t b0, b1;
              frag_b_t(b0, b1, xs, ldp, 8 * jp, 16 * i, lane);
              mma(acc[jp], ml, b0, b1);
              if (kF32) {
                uint32_t c0, c1;
                frag_b_t(c0, c1, xs + (size_t)d.Qp * ldp, ldp, 8 * jp,
                         16 * i, lane);
                mma(acc[jp], mh, c0, c1);
              }
              mma(acc[jp], mh, b0, b1);
            }
          }
        }
      }
      T* yb = y + ((size_t)b * d.L + l0) * d.H * d.P + (size_t)h * d.P;
#pragma unroll
      for (int jp = 0; jp < 8; ++jp) {
        const int p = 8 * jp + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = r ? tb : ta;
          if (row < d.Q && p < d.P) {
            T* yr = yb + (size_t)row * d.H * d.P + p;
            if (kF32) {
              yr[0] = acc[jp][2 * r];
              if (p + 1 < d.P) yr[1] = acc[jp][2 * r + 1];
            } else if (p + 1 < d.P) {
              *reinterpret_cast<__nv_bfloat162*>(yr) =
                  __floats2bfloat162_rn(acc[jp][2 * r], acc[jp][2 * r + 1]);
            } else {
              *reinterpret_cast<bf16*>(yr) =
                  __float2bfloat16_rn(acc[jp][2 * r]);
            }
          }
        }
      }
    }
    __syncthreads();  // x and S_in consumed
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* h0, void* y,
                   float* hout, float* states, float* s_buf, int bt,
                   int phases, const Dims& d, cudaStream_t stream) {
  constexpr int NS = std::is_same<T, float>::value ? 2 : 1;
  const int per_group = (d.hpg + kHeadsPerBlock - 1) / kHeadsPerBlock;
  const dim3 grid(d.G * per_group, d.nc, bt);
  const T* xp = static_cast<const T*>(x);
  const T* bt_ = static_cast<const T*>(bm);
  const size_t smem1 = state_smem(d, NS);
  cudaError_t err = cudaFuncSetAttribute(
      chunk_state_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem1);
  if (err != cudaSuccess) return err;
  chunk_state_kernel<T><<<grid, kThreads, smem1, stream>>>(
      xp, dt, a, bt_, states, s_buf, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || phases < 2) return err;

  const int pn4 = d.P * d.N / 4;
  const dim3 grid2((pn4 + kPassThreads - 1) / kPassThreads, d.H, bt);
  state_pass_kernel<<<grid2, kPassThreads, 0, stream>>>(states, s_buf, h0,
                                                        hout, d);
  err = cudaGetLastError();
  if (err != cudaSuccess || phases < 3) return err;

  const size_t smem3 = output_smem(d, NS);
  err = cudaFuncSetAttribute(chunk_output_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem3);
  if (err != cudaSuccess) return err;
  chunk_output_kernel<T><<<grid, kThreads, smem3, stream>>>(
      xp, dt, bt_, static_cast<const T*>(cm), states, s_buf,
      static_cast<T*>(y), d);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block of phase `phase` (1 or 3) takes
// for (P, N, Q) and `dtype` (0 f32, 1 bf16); phase 2 takes none.
extern "C" long long repro_ssd_scan_smem_bytes(int p, int n, int q,
                                               int dtype, int phase) {
  Dims d{};
  d.Qp = pad16(q);
  d.Pp = pad16(p);
  d.Np = pad16(n);
  const int ns = dtype == 0 ? 2 : 1;
  if (phase == 1) return (long long)state_smem(d, ns);
  if (phase == 3) return (long long)output_smem(d, ns);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  dt, A, h0, hout and
// the scratch are f32 and contiguous, h0 and hout 16-byte aligned; h0 may
// be null (a zero state).  x, B and C take any batch and step strides (in
// elements) with each head's (group's) row contiguous; y is contiguous
// (Bt, L, H, P).  `states` is scratch of (Bt, L/Q, H, P, N) f32 and
// `s_buf` of (Bt, L/Q, H, Q) f32.  L % Q == 0, Q <= 128, P <= 64,
// N <= 128, each a multiple of 4, H % G == 0.  `phases` 3 runs the whole
// scan; 1 stops after the chunk states (states holds each chunk's local
// state, s_buf its cumsum), 2 after the state passing (states holds the
// states entering each chunk, hout the final one).  Launches on `stream`
// without synchronising; returns the first launch's cudaError_t that is
// not 0, else 0.
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, const void* h0,
                              void* y, void* hout, void* states, void* s_buf,
                              int dtype, int bt, int L, int H, int G, int P,
                              int N, int Q, int phases, long long sx_b,
                              long long sx_l, long long sb_b, long long sb_l,
                              long long sc_b, long long sc_l, void* stream) {
  if (bt <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 ||
      Q > kMaxChunk || L % Q != 0 || Q % 4 != 0 || P <= 0 || P > kMaxP ||
      P % 4 != 0 || N <= 0 || N > kMaxN || N % 4 != 0 || phases < 1 ||
      phases > 3 || L / Q > 65535 || bt > 65535)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(h0) % 16 ||
      reinterpret_cast<uintptr_t>(hout) % 16 ||
      reinterpret_cast<uintptr_t>(states) % 16)
    return (int)cudaErrorMisalignedAddress;
  // the vector staging path: bf16 rows of x, B and C whose starts all
  // lie on 16-byte boundaries
  const bool vec =
      dtype == 1 && P % 8 == 0 && N % 8 == 0 &&
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(bm) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(cm) % 16 == 0 && sx_b % 8 == 0 &&
      sx_l % 8 == 0 && sb_b % 8 == 0 && sb_l % 8 == 0 && sc_b % 8 == 0 &&
      sc_l % 8 == 0;
  const Dims d{L,    H,    G,    P,    N,    Q,    pad16(Q), pad16(P),
               pad16(N), L / Q, H / G, sx_b, sx_l, sb_b, sb_l, sc_b, sc_l,
               vec};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  float* sf = static_cast<float*>(states);
  float* bf = static_cast<float*>(s_buf);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, dtf, af, bm, cm, h0f, y, hf, sf, bf, bt,
                                phases, d, s);
    case 1:
      return (int)launch<bf16>(x, dtf, af, bm, cm, h0f, y, hf, sf, bf, bt,
                               phases, d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
