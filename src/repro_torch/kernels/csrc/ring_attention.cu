// Ring-attention partials for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel repro/kernels/ring_attention.py::_partials_pallas
// (body _partials_kernel).  Same function: the un-normalised flash partial
// of a query shard against ONE KV block,
//   acc = sum_j exp(s_j - m) v_j   (B,Hq,Lq,D) f32
//   m   = max_j s_j                (B,Hq,Lq)   f32
//   l   = sum_j exp(s_j - m)       (B,Hq,Lq)   f32,
// with s = (q.k) * sm_scale in f32, the tanh softcap before the mask, and
// the mask built from GLOBAL positions: key slot j is kept for query row i
// iff k_pos[j] >= 0 (-1 marks a padded slot), k_pos[j] <= q_pos[i] when
// causal, and k_pos[j] > q_pos[i] - window with a window.  Masked logits
// are -1e30, never -inf, exactly as the reference: a row whose keys are all
// masked gets m = -1e30, l = Lk (every slot weighs exp(0) = 1) and acc =
// the sum of v over the block, all finite, which the merge later wipes
// with a weight exp(-1e30 - m) = 0.  q head h reads KV head h / (Hq/Hkv).
// Any D in 1..256, any Lq and Lk: a key slot past Lk is absent (-inf: it
// weighs 0 and is not counted in l) and query rows past Lq are neither
// read nor written, so nothing is padded in device memory.
//
// One launch is one ring step for every PE: the reference vmaps its Pallas
// call over the SIM's leading PE axis; here the P PEs and the B batch rows
// fold into the grid's z axis, and a block reads its PE's position tables
// q_pos[pe] (Lq,) and k_pos[pe] (Lk,).
//
// Design (csrc/attn_tile.cuh holds the loop and both routes).  One C entry
// runs two CUDA kernels.  The first, ring_prep, writes into the scratch the
// wrapper allocates (a) the sum of v over the block's Lk slots per (PE,
// batch row, KV head) and (b) per (PE, 64-key tile) the min and max of the
// tile's valid key positions and their count.  The second computes the
// partials: bf16 at D a multiple of 8 on the tensor cores (one warpgroup
// per 64 query rows; TMA, wgmma, P split into two bf16 parts, as kernel
// 4), f32 and the rest on the CUDA cores (32 query rows a block).  Each
// query tile walks only the key tiles that some of its rows may keep: a
// tile is skipped when its valid keys all lie after the tile's latest
// query position (causal) or at or before its earliest position's window,
// decided for every tile at once into a bitmask.  That is exact: a wholly
// masked tile changes nothing for a row that keeps a key somewhere (the
// first kept key wipes what masked slots added, alpha = exp(-1e30 - m) =
// 0), so only rows that keep nothing in the whole block depend on it, and
// those are written from (a) as (sum v, -1e30, Lk).  A query tile whose
// block is wholly masked, as 120 of the 256 PE-blocks of a causal ring of
// 16, does no products at all.
//
// Bound.  At the ring step of the port's main path (16 PEs, B 1, Hq 14,
// Hkv 2, Lq = Lk = 2048, D 64, bf16, causal, the diagonal block) the
// function reads q (58.7 MB), k and v (16.8 MB) and writes acc (117.4 MB),
// m and l (3.7 MB): 196.9 MB, 0.059 ms at 3.35 TB/s.  The 33,570,816 kept
// pairs are 4 D = 256 operations each, 120.3 GFLOP, 0.122 ms at the bf16
// tensor-core rate: bound by operations.  A wholly kept block is twice the
// products (0.243 ms); a wholly masked one is bound by its bytes alone.
#include "attn_tile.cuh"

namespace {

using namespace attn;

constexpr int kPrepThreads = 1024;
constexpr int kPrepWarps = kPrepThreads / 32;
constexpr int kPrepCols = 32;  // v columns per sum block

// Blocks [0, heads * ceil(d / 32)): the sum of v over the Lk slots of one
// (PE x batch row x KV head), 32 columns a block, 32 warps over the rows.
// Blocks after: one warp per 64-key tile of a PE (32 tiles a block), the
// min and max position of the tile's valid keys and their count.
template <typename T>
__global__ void __launch_bounds__(kPrepThreads)
ring_prep(const T* __restrict__ v, const int* __restrict__ kpos,
          float* __restrict__ vsum, int4* __restrict__ bounds, int heads,
          int p, int lk, int d) {
  __shared__ float part[kPrepWarps][kPrepCols];
  const int chunks = (d + kPrepCols - 1) / kPrepCols;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if ((int)blockIdx.x < heads * chunks) {
    const int head = blockIdx.x / chunks;
    const int col = (blockIdx.x % chunks) * kPrepCols + lane;
    const T* vg = v + (size_t)head * lk * d;
    float sum = 0.f;
    if (col < d) {
#pragma unroll 8
      for (int j = warp; j < lk; j += kPrepWarps)
        sum += to_float(vg[(size_t)j * d + col]);
    }
    part[warp][lane] = sum;
    __syncthreads();
    if (warp == 0 && col < d) {
      float total = 0.f;
#pragma unroll
      for (int w = 0; w < kPrepWarps; ++w) total += part[w][lane];
      vsum[(size_t)head * d + col] = total;
    }
    return;
  }
  const int n_tiles = (lk + kTile - 1) / kTile;
  const long long tile =
      (long long)(blockIdx.x - heads * chunks) * kPrepWarps + warp;
  if (tile >= (long long)p * n_tiles) return;
  const int pe = (int)(tile / n_tiles);
  const int t = (int)(tile % n_tiles);
  const int* kp = kpos + (size_t)pe * lk;
  int lo = INT_MAX, hi = INT_MIN, n = 0;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = t * kTile + lane + 32 * e;
    const int pos = j < lk ? kp[j] : -1;
    if (pos >= 0) {
      lo = min(lo, pos);
      hi = max(hi, pos);
      ++n;
    }
  }
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  n = __reduce_add_sync(0xffffffffu, n);
  if (lane == 0) bounds[tile] = make_int4(lo, hi, n, 0);
}

// The min and max position of the valid query rows q0 .. q0 + rows - 1
// (rows <= blockDim.x), over the whole block.
__device__ __forceinline__ int2 q_bounds(const int* qp, int q0, int rows) {
  __shared__ int red[2][32];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int i = threadIdx.x;
  int lo = i < rows ? qp[q0 + i] : INT_MAX;
  int hi = i < rows ? qp[q0 + i] : INT_MIN;
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  if (lane == 0) {
    red[0][warp] = lo;
    red[1][warp] = hi;
  }
  __syncthreads();
  lo = INT_MAX;
  hi = INT_MIN;
  for (int w = 0; w < (int)blockDim.x / 32; ++w) {
    lo = min(lo, red[0][w]);
    hi = max(hi, red[1][w]);
  }
  return make_int2(lo, hi);
}

template <int DVB>
__global__ void __launch_bounds__(kTcThreads)
ring_partials_tc(__grid_constant__ const CUtensorMap tq,
                 __grid_constant__ const CUtensorMap tk,
                 __grid_constant__ const CUtensorMap tv,
                 const int* __restrict__ qpos, const int* __restrict__ kpos,
                 const float* __restrict__ vsum,
                 const int4* __restrict__ bounds, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int b,
                 int hq, int hkv, int lq, int lk, int d, Mask mask) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int q0 = blockIdx.x * kTile;
  const int h = blockIdx.y;
  const int z = blockIdx.z;  // pe * b + batch row
  const int pe = z / b;
  const int kv_head = z * hkv + h / (hq / hkv);
  const int q_head = z * hq + h;
  const int rows = min(kTile, lq - q0);
  const int n_tiles = (lk + kTile - 1) / kTile;
  const int* qp = qpos + (size_t)pe * lq;
  const int2 qb = q_bounds(qp, q0, rows);
  const TcSmem sm = tc_smem(smem_raw, (d + 63) / 64, DVB);
  const BoundsVisit visit = bounds_visit(
      bounds + (size_t)pe * n_tiles, n_tiles, qb.x, qb.y, mask.causal,
      mask.window, reinterpret_cast<uint32_t*>(sm.vsum + kMaxDim));
  TcState<DVB> st;
  tc_walk<DVB>(&tq, &tk, &tv, q_head, kv_head, q0, d, n_tiles,
               TablePos{qp, kpos + (size_t)pe * lk, lq, lk}, visit, mask, sm,
               st);

  const float* vs = vsum + (size_t)kv_head * d;
  const int r0 = tc_row0();
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = r0 + 8 * hh;
    if (row >= rows) continue;
    const size_t at = (size_t)q_head * lq + q0 + row;
    const bool kept = st.kept[hh];
#pragma unroll
    for (int c = 0; c < DVB; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * c + 8 * j + 2 * (lane & 3);
        if (col >= d) continue;  // d % 8 == 0: col + 1 < d too
        const float2 val =
            kept ? make_float2(st.o[c][4 * j + 2 * hh],
                               st.o[c][4 * j + 2 * hh + 1])
                 : make_float2(vs[col], vs[col + 1]);
        *reinterpret_cast<float2*>(acc_out + at * d + col) = val;
      }
    if ((lane & 3) == 0) {
      m_out[at] = kept ? st.m[hh] * kLn2 : kNegInf;  // from log2(e) units
      l_out[at] = kept ? st.l[hh] : (float)lk;
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kCcThreads)
ring_partials_cc(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ qpos,
                 const int* __restrict__ kpos, const float* __restrict__ vsum,
                 const int4* __restrict__ bounds, float* __restrict__ acc_out,
                 float* __restrict__ m_out, float* __restrict__ l_out, int b,
                 int hq, int hkv, int lq, int lk, int d, Mask mask) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const int q0 = blockIdx.x * kCcRows;
  const int h = blockIdx.y;
  const int z = blockIdx.z;  // pe * b + batch row
  const int pe = z / b;
  const size_t kv_head = (size_t)z * hkv + h / (hq / hkv);
  const size_t q_head = (size_t)z * hq + h;
  const int rows = min(kCcRows, lq - q0);
  const int n_tiles = (lk + kTile - 1) / kTile;
  const int* qp = qpos + (size_t)pe * lq;
  const int2 qb = q_bounds(qp, q0, rows);
  const BoundsVisit visit = bounds_visit(
      bounds + (size_t)pe * n_tiles, n_tiles, qb.x, qb.y, mask.causal,
      mask.window, reinterpret_cast<uint32_t*>(smem_raw + cc_smem_bytes<DP>()));

  CcState<DP> st;
  cc_walk<T, DP>(q + (q_head * lq + q0) * d, k + kv_head * lk * d,
                 v + kv_head * lk * d, rows, q0, lk, d, d, n_tiles,
                 TablePos{qp, kpos + (size_t)pe * lk, lq, lk}, visit, mask,
                 reinterpret_cast<float*>(smem_raw), st);

  const float* vs = vsum + kv_head * d;
  constexpr int kRows = kCcRowsPerWarp;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = warp * kRows + r;
    if (row >= rows) continue;
    const size_t at = q_head * lq + q0 + row;
#pragma unroll
    for (int e = 0; e < DP / 32; ++e) {
      const int col = lane + 32 * e;
      if (col < d) acc_out[at * d + col] = st.kept[r] ? st.acc[r][e] : vs[col];
    }
    if (lane == 0) {
      m_out[at] = st.kept[r] ? st.m[r] : kNegInf;
      l_out[at] = st.kept[r] ? st.l[r] : (float)lk;
    }
  }
}

struct Args {
  const void *q, *k, *v;
  const int *qpos, *kpos;
  float* vsum;
  int4* bounds;
  float *acc, *m, *l;
  int p, b, hq, hkv, lq, lk, d;
  Mask mask;
};

int key_tiles(const Args& a) { return (a.lk + kTile - 1) / kTile; }

template <typename T>
cudaError_t launch_prep(const Args& a, cudaStream_t stream) {
  const int heads = a.p * a.b * a.hkv;
  const long long tiles = (long long)a.p * key_tiles(a);
  const long long blocks =
      (long long)heads * ((a.d + kPrepCols - 1) / kPrepCols) +
      (tiles + kPrepWarps - 1) / kPrepWarps;
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  ring_prep<T><<<(int)blocks, kPrepThreads, 0, stream>>>(
      static_cast<const T*>(a.v), a.kpos, a.vsum, a.bounds, heads, a.p, a.lk,
      a.d);
  return cudaGetLastError();
}

template <int DVB>
cudaError_t launch_tc(const Args& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  const int z = a.p * a.b;
  cudaError_t err = encode_map(&tq, a.q, a.d, a.lq, z * a.hq);
  if (err == cudaSuccess) err = encode_map(&tk, a.k, a.d, a.lk, z * a.hkv);
  if (err == cudaSuccess) err = encode_map(&tv, a.v, a.d, a.lk, z * a.hkv);
  if (err != cudaSuccess) return err;
  const size_t smem =
      tc_smem_bytes(DVB, DVB) + sizeof(uint32_t) * visit_words(key_tiles(a));
  err = cudaFuncSetAttribute(ring_partials_tc<DVB>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kTile - 1) / kTile, a.hq, z);
  ring_partials_tc<DVB><<<grid, kTcThreads, smem, stream>>>(
      tq, tk, tv, a.qpos, a.kpos, a.vsum, a.bounds, a.acc, a.m, a.l, a.b,
      a.hq, a.hkv, a.lq, a.lk, a.d, a.mask);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_cc(const Args& a, cudaStream_t stream) {
  const size_t smem =
      cc_smem_bytes<DP>() + sizeof(uint32_t) * visit_words(key_tiles(a));
  cudaError_t err = cudaFuncSetAttribute(
      ring_partials_cc<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.lq + kCcRows - 1) / kCcRows, a.hq, a.p * a.b);
  ring_partials_cc<T, DP><<<grid, kCcThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), a.qpos, a.kpos, a.vsum, a.bounds, a.acc,
      a.m, a.l, a.b, a.hq, a.hkv, a.lq, a.lk, a.d, a.mask);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_cc_d(const Args& a, cudaStream_t s) {
  switch (cc_pad(a.d)) {
    case 32:
      return launch_cc<T, 32>(a, s);
    case 64:
      return launch_cc<T, 64>(a, s);
    case 128:
      return launch_cc<T, 128>(a, s);
    default:
      return launch_cc<T, 256>(a, s);
  }
}

cudaError_t launch_partials(int dtype, const Args& a, cudaStream_t s) {
  if (tc_route(dtype, a.d, a.d, a.q, a.k, a.v)) {
    switch ((a.d + 63) / 64) {
      case 1:
        return launch_tc<1>(a, s);
      case 2:
        return launch_tc<2>(a, s);
      case 3:
        return launch_tc<3>(a, s);
      default:
        return launch_tc<4>(a, s);
    }
  }
  return dtype == 0 ? launch_cc_d<float>(a, s) : launch_cc_d<bf16>(a, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike).  q (P*B,Hq,Lq,D),
// k and v (P*B,Hkv,Lk,D), qpos (P,Lq) and kpos (P,Lk) int32; acc
// (P*B,Hq,Lq,D), m and l (P*B,Hq,Lq) f32; scratch vsum (P*B*Hkv, D) f32
// and bounds (P, ceil(Lk/64), 4) int32; all contiguous.  Any Lq, Lk >= 1;
// D in 1..256; Hq % Hkv == 0.  window <= 0 means no window, softcap <= 0
// no softcap.  Launches its two CUDA kernels on `stream` without
// synchronising; returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int repro_ring_partials(const void* q, const void* k,
                                   const void* v, const void* qpos,
                                   const void* kpos, void* acc, void* m,
                                   void* l, void* vsum, void* bounds,
                                   int dtype, int p, int b, int hq, int hkv,
                                   int lq, int lk, int d, int causal,
                                   int window, float softcap, float sm_scale,
                                   void* stream) {
  if (p <= 0 || b <= 0 || hkv <= 0 || hq % hkv != 0 || lq <= 0 || lk <= 0 ||
      hq > 65535 || p * b > 65535 || d < 1 || d > kMaxDim ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{q, k, v, static_cast<const int*>(qpos),
               static_cast<const int*>(kpos), static_cast<float*>(vsum),
               static_cast<int4*>(bounds), static_cast<float*>(acc),
               static_cast<float*>(m), static_cast<float*>(l), p, b, hq, hkv,
               lq, lk, d, make_mask(causal, window, sm_scale, softcap)};
  cudaError_t err = dtype == 0 ? launch_prep<float>(a, s)
                               : launch_prep<bf16>(a, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_partials(dtype, a, s);
}

// 1 if a call with these arguments computes on the tensor cores (bf16, D
// a multiple of 8, q/k/v 16-byte aligned), else 0 (the CUDA cores).
extern "C" int repro_ring_partials_tc(int dtype, int d, const void* q,
                                      const void* k, const void* v) {
  return tc_route(dtype, d, d, q, k, v) ? 1 : 0;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
