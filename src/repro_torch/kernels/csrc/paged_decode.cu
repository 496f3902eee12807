// Paged decode attention for Hopper (sm_90a), with a plain C interface.
//
// Replaces no TPU kernel: the reference's paged decode
// (repro/models/layers.py attention_paged, its L == 1 branch) is plain jnp,
// a gather of every row's pages out to max_seq and then _attend_mq's f32
// einsums.  This kernel computes the same function on the page pool in
// place: q (B, Hq, hd) attends over the K/V rows (num_pages, page_size,
// Hkv, hd) that row b's page table names, positions [lo, pos[b]] with
// lo = pos - window + 1 under a window, else 0; q head h reads stored head
// h / (Hq / Hkv), or q2slot[h] under the replicated-KV plan.  The
// arithmetic is _attend_mq's, in f32: q scaled by 1 / sqrt(hd), the logits
// capped by softcap * tanh(x / softcap), an exact softmax, out = acc /
// max(l, 1e-30) in f32.  bf16 K/V rows are widened in registers.
//
// Bound.  The work is bound by the bytes of the live K/V rows: a position
// of a kv head costs 4 x group x hd f32 operations over 4 x hd bytes of
// bf16 K and V, `group` operations a byte (6 at internlm2-20b), under the
// card's ~20 f32 operations a byte.  At internlm2-20b's chat decode (64
// rows of ~485 live positions, Hkv 8, hd 128) a layer reads ~127 MB, ~38 us
// at 3.35 TB/s.  The path it replaces moved ~7x the bytes of a position
// (the gathered copy, its f32 cast, the einsums' reads) for all max_seq
// positions of every row, 3.7x the live ones.
//
// Design.
//  * One block of 128 threads per (row, stored kv head, split of the row's
//    pages).  A split is `split_pages` pages (the wrapper's choice, ~256
//    positions); a block reads only the pages of its split that hold a
//    position in [lo, pos]: no page wholly outside the window or past pos
//    is read, and a split with none exits at once.
//  * The block computes every q head that reads its kv head (up to kMaxG
//    of them, the group as a template parameter; more heads take more
//    blocks), so each K/V row is loaded once for the whole group.
//  * K then V stream through shared memory in chunks of kTile rows with
//    cp.async (16-byte copies, kStages chunks in flight).  Rows sit at a
//    stride of an odd number of 16-byte units, so the lanes of q . k,
//    reading eight values of 32 different rows, hit distinct banks.
//  * q . k: a lane a position, a warp a quarter of the head dim, q / sqrt(hd)
//    in shared memory (the same address for every lane); the four warps'
//    partial sums are added in warp order.  The logits of the split stay
//    in shared memory; one exact softmax over them; then p . v with the
//    head dim across lanes (eight values a lane; R lanes a row, the
//    template parameter hd chooses), each group of R lanes over its own
//    rows, summed in a fixed order at the end.
//  * The block writes its split's (m, l, acc) per q head to scratch, and a
//    second kernel combines a row's splits in split order, a warp a head.
//  * Batch-invariant by construction: a block's work, its split bounds and
//    every order of summation depend only on its own row's position and
//    the pool's static shape, never on B or on the other rows, and no
//    atomics take part.  A request's greedy tokens are then the same
//    batched or alone, run after run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxG = 8;            // q heads a block computes
constexpr int kStages = 4;          // K/V chunks in flight
constexpr int kTile = 32;           // rows a chunk: a lane each in q . k
constexpr int kSmemDefault = 48 * 1024;

struct Args {
  const void* q;           // (B, Hq, hd), f32 or bf16
  const void* k;           // (num_pages, page_size, Hkv, hd)
  const void* v;
  const int64_t* table;    // (B, max_pages)
  const int64_t* pos;      // (B,)
  const int64_t* q2slot;   // (Hq,) or null
  float* part_acc;         // (B, Hq, max_splits, hd)
  float* part_ml;          // (B, Hq, max_splits, 2)
  float* out;              // (B, Hq, hd)
  int hq, hkv, hd, page_size, max_pages;
  int group;               // q heads a kv head (q2slot null)
  int chunks;              // blocks a kv head (grid.y = hkv * chunks)
  int split_pages, max_splits;
  int window;              // <= 0: none
  float softcap;           // <= 0: none
  int q_bf16;
};

// Pages [p_lo, p_hi) of row b hold its positions [lo, pos]; lo is returned.
__device__ __forceinline__ int64_t live_pages(const Args& a, int64_t pos,
                                              int& p_lo, int& p_hi) {
  int64_t lo = 0;
  if (a.window > 0 && pos - a.window + 1 > 0) lo = pos - a.window + 1;
  p_lo = static_cast<int>(lo / a.page_size);
  int64_t hi = pos / a.page_size + 1;
  p_hi = static_cast<int>(hi < a.max_pages ? hi : a.max_pages);
  return lo;
}

// Row stride in shared memory, in values: a row of hd values padded to an
// odd number of 16-byte units.
template <typename T>
__host__ __device__ __forceinline__ int row_stride(int hd) {
  const int units = hd * static_cast<int>(sizeof(T)) / 16;
  return (units | 1) * 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Eight values of a row in memory, widened to f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* f) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void load8(const float* p, float* f) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w;
  f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
}

// The q heads of block (kv head `kvh`, head chunk `chunk`): up to G of
// the heads that read `kvh`, in head order.
template <int G>
__device__ int block_heads(const Args& a, int kvh, int chunk, int* heads) {
  int n = 0;
  if (a.q2slot == nullptr) {
    for (int i = chunk * G; i < a.group && n < G; ++i)
      heads[n++] = kvh * a.group + i;
    return n;
  }
  int seen = 0;
  for (int h = 0; h < a.hq && n < G; ++h) {
    if (a.q2slot[h] != kvh) continue;
    if (seen++ >= chunk * G) heads[n++] = h;
  }
  return n;
}

// Bytes of dynamic shared memory a block takes; *region0 the bytes of the
// K/V ring, which the row groups' accumulators reuse at the end.
template <typename T, int R, int G>
__host__ __device__ int smem_layout(int hd, int split_len, int* region0) {
  const int ring = kStages * kTile * row_stride<T>(hd) *
                   static_cast<int>(sizeof(T));
  const int red = (kThreads / R) * G * hd * 4;
  *region0 = ring > red ? ring : red;
  // region0 | q (G, hd) | q . k partials (warps, G, kTile) | logits
  // (G, split_len) | pool rows (split_len)
  return *region0 + 4 * (G * hd + kWarps * G * kTile + (G + 1) * split_len);
}

template <typename T, int R, int G>
__global__ void __launch_bounds__(kThreads)
paged_decode_partials(const Args a) {
  constexpr int kSlots = kThreads / R;    // rows of p . v at once
  constexpr int kPieces = sizeof(T) / 2;  // 16-byte copies of 8 values
  const int split = blockIdx.x, b = blockIdx.z;
  const int kvh = blockIdx.y / a.chunks, chunk = blockIdx.y % a.chunks;
  const int64_t pos = a.pos[b];
  int p_lo, p_hi;
  const int64_t lo = live_pages(a, pos, p_lo, p_hi);
  const int pg0 = max(p_lo, split * a.split_pages);
  const int pg1 = min(p_hi, (split + 1) * a.split_pages);
  if (pg0 >= pg1) return;                 // no live page in this split

  __shared__ int s_heads[G];
  __shared__ int s_nh;
  __shared__ float s_wred[kWarps][G];     // per-warp maxima, then sums
  __shared__ float s_m[G];
  extern __shared__ __align__(16) uint8_t smem[];
  const int hd = a.hd, ps = a.page_size, rs = row_stride<T>(hd);
  const int split_len = a.split_pages * ps;
  int region0;
  smem_layout<T, R, G>(hd, split_len, &region0);
  float* s_q = reinterpret_cast<float*>(smem + region0);     // (G, hd)
  float* s_part = s_q + G * hd;                    // (warps, G, kTile)
  float* s_logit = s_part + kWarps * G * kTile;    // (G, split_len)
  int* s_row = reinterpret_cast<int*>(s_logit + G * split_len);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid / 32;
  const int len = (pg1 - pg0) * ps;       // positions read
  if (tid == 0) s_nh = block_heads<G>(a, kvh, chunk, s_heads);
  // the pool row (page x page_size + offset) of each position read
  const int64_t* table = a.table + static_cast<int64_t>(b) * a.max_pages;
  for (int t = tid; t < len; t += kThreads)
    s_row[t] = static_cast<int>(table[pg0 + t / ps]) * ps + t % ps;
  __syncthreads();
  const int nh = s_nh;
  if (nh == 0) return;

  const int64_t t0 = static_cast<int64_t>(pg0) * ps;  // first position read
  const int n_chunks = (len + kTile - 1) / kTile;
  const int64_t row_elems = static_cast<int64_t>(a.hkv) * hd;
  const int c8 = (tid % R) * 8, slot = tid / R;
  const bool active = c8 < hd;            // lanes past hd hold zeros
  T* ring = reinterpret_cast<T*>(smem);

  // chunk c < n_chunks: K rows [c * kTile, ...) of the block's range;
  // after that V rows.  Each lane copies its eight values of its group's
  // rows; rows past the range are not copied and never read.
  auto issue = [&](int c) {
    if (c < 2 * n_chunks && active) {
      const T* base = static_cast<const T*>(c < n_chunks ? a.k : a.v) +
                      kvh * hd + c8;
      const int cc = c < n_chunks ? c : c - n_chunks;
      const int rows = min(kTile, len - cc * kTile);
      T* dst = ring + (c % kStages) * kTile * rs + c8;
      for (int r = slot; r < rows; r += kSlots) {
        const T* src = base + s_row[cc * kTile + r] * row_elems;
#pragma unroll
        for (int i = 0; i < kPieces; ++i)
          cp_async16(dst + r * rs + i * 8 / kPieces, src + i * 8 / kPieces);
      }
    }
    cp_async_commit();
  };
#pragma unroll
  for (int c = 0; c < kStages - 1; ++c) issue(c);

  // q / sqrt(hd) of each head in f32; zeros for a missing head
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  for (int i = tid; i < G * hd; i += kThreads) {
    const int g = i / hd, d = i - g * hd;
    float x = 0.f;
    if (g < nh) {
      const int64_t off =
          (static_cast<int64_t>(b) * a.hq + s_heads[g]) * hd + d;
      x = a.q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(a.q)[off])
                   : static_cast<const float*>(a.q)[off];
    }
    s_q[i] = x * scale;
  }
  float acc[G][8];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[g][i] = 0.f;

  for (int c = 0; c < 2 * n_chunks; ++c) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                      // chunk c landed; c - 1 consumed
    issue(c + kStages - 1);
    const T* rows = ring + (c % kStages) * kTile * rs;
    const int cc = c < n_chunks ? c : c - n_chunks;
    const int rows_here = min(kTile, len - cc * kTile);
    if (c < n_chunks) {
      // q . k: lane = row, this warp's eight-value pieces of the head dim;
      // a row past the chunk's is computed from stale values and dropped
      float dot[G];
#pragma unroll
      for (int g = 0; g < G; ++g) dot[g] = 0.f;
      for (int j = warp * 8; j < hd; j += kWarps * 8) {
        float kf[8];
        load8(rows + lane * rs + j, kf);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qa = *reinterpret_cast<const float4*>(s_q + g * hd + j);
          const float4 qb =
              *reinterpret_cast<const float4*>(s_q + g * hd + j + 4);
          float x = dot[g];
          x = fmaf(qa.x, kf[0], x);
          x = fmaf(qa.y, kf[1], x);
          x = fmaf(qa.z, kf[2], x);
          x = fmaf(qa.w, kf[3], x);
          x = fmaf(qb.x, kf[4], x);
          x = fmaf(qb.y, kf[5], x);
          x = fmaf(qb.z, kf[6], x);
          x = fmaf(qb.w, kf[7], x);
          dot[g] = x;
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g)
        s_part[(warp * G + g) * kTile + lane] = dot[g];
      __syncthreads();
      // the logits: the warps' partial sums in warp order, capped, masked
      for (int i = tid; i < nh * kTile; i += kThreads) {
        const int g = i / kTile, r = i % kTile;
        if (r >= rows_here) continue;
        float x = s_part[g * kTile + r];
#pragma unroll
        for (int w = 1; w < kWarps; ++w)
          x += s_part[(w * G + g) * kTile + r];
        if (a.softcap > 0.f) x = a.softcap * tanhf(x / a.softcap);
        const int t = cc * kTile + r;
        const bool valid = t0 + t >= lo && t0 + t <= pos;
        s_logit[g * split_len + t] = valid ? x : -INFINITY;
      }
      continue;
    }
    if (c == n_chunks) {
      // the split's exact softmax over its logits, all warps sharing the
      // positions: the maxima, then p = e^(x - m) and the sums
      float part[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        part[g] = -INFINITY;
        if (g < nh)
          for (int t = tid; t < len; t += kThreads)
            part[g] = fmaxf(part[g], s_logit[g * split_len + t]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part[g] =
              fmaxf(part[g], __shfl_xor_sync(0xffffffffu, part[g], o));
        if (lane == 0) s_wred[warp][g] = part[g];
      }
      __syncthreads();
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float m = s_wred[0][g];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) m = fmaxf(m, s_wred[w][g]);
        part[g] = 0.f;
        if (g < nh) {
          for (int t = tid; t < len; t += kThreads) {
            float* x = s_logit + g * split_len + t;
            const float p = *x == -INFINITY ? 0.f : expf(*x - m);
            *x = p;
            part[g] += p;
          }
        }
        if (tid == 0) s_m[g] = m;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          part[g] += __shfl_xor_sync(0xffffffffu, part[g], o);
      }
      __syncthreads();                    // maxima read: reuse s_wred
#pragma unroll
      for (int g = 0; g < G; ++g)
        if (lane == 0) s_wred[warp][g] = part[g];
      __syncthreads();
    }
    // p . v of this chunk's rows, into this row group's accumulators
    for (int r = slot; r < rows_here; r += kSlots) {
      const int t = cc * kTile + r;
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g)
        p[g] = g < nh ? s_logit[g * split_len + t] : 0.f;
      if (active) {
        float vf[8];
        load8(rows + r * rs + c8, vf);
#pragma unroll
        for (int g = 0; g < G; ++g)
#pragma unroll
          for (int i = 0; i < 8; ++i)
            acc[g][i] = fmaf(p[g], vf[i], acc[g][i]);
      }
    }
  }

  // sum the row groups' accumulators in slot order; write the split's
  // (m, l, acc) of each head
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);           // (slots, G, hd)
  if (active) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float4* d = reinterpret_cast<float4*>(red + (slot * G + g) * hd + c8);
      d[0] = make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
      d[1] = make_float4(acc[g][4], acc[g][5], acc[g][6], acc[g][7]);
    }
  }
  __syncthreads();
  for (int g = 0; g < nh; ++g) {
    const int64_t row =
        (static_cast<int64_t>(b) * a.hq + s_heads[g]) * a.max_splits +
        split;
    for (int d = tid; d < hd; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kSlots; ++j) s += red[(j * G + g) * hd + d];
      a.part_acc[row * hd + d] = s;
    }
    if (tid == 0) {
      float l = 0.f;
      for (int w = 0; w < kWarps; ++w) l += s_wred[w][g];
      a.part_ml[2 * row] = s_m[g];
      a.part_ml[2 * row + 1] = l;
    }
  }
}

// out[b, h] = sum over row b's splits of acc_s e^(m_s - M), over the same
// sum of l_s e^(m_s - M), M the largest m_s; splits in order.  A warp a
// (row, q head): a lane a split for M and the denominator, then a lane a
// value of the head dim, up to kMaxDim / 32 of them.
constexpr int kMaxDim = 256;
__global__ void __launch_bounds__(kThreads)
paged_decode_combine(const Args a, int rows) {
  const int idx = blockIdx.x * kWarps + threadIdx.x / 32;
  if (idx >= rows) return;
  const int b = idx / a.hq, lane = threadIdx.x & 31;
  int p_lo, p_hi;
  live_pages(a, a.pos[b], p_lo, p_hi);
  const int s0 = p_lo / a.split_pages;
  const int s1 = (p_hi - 1) / a.split_pages + 1;
  const int64_t row = static_cast<int64_t>(idx) * a.max_splits;
  const float* ml = a.part_ml + 2 * row;
  float m = -INFINITY;
  for (int s = s0 + lane; s < s1; s += 32) m = fmaxf(m, ml[2 * s]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  float l = 0.f;
  for (int s = s0 + lane; s < s1; s += 32)
    l += ml[2 * s + 1] * expf(ml[2 * s] - m);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  const float den = fmaxf(l, 1e-30f);
  float acc[kMaxDim / 32];
#pragma unroll
  for (int k = 0; k < kMaxDim / 32; ++k) acc[k] = 0.f;
  for (int s = s0; s < s1; ++s) {
    const float w = expf(ml[2 * s] - m);
    const float* src = a.part_acc + (row + s) * a.hd;
#pragma unroll
    for (int k = 0; k < kMaxDim / 32; ++k)
      if (lane + 32 * k < a.hd) acc[k] += src[lane + 32 * k] * w;
  }
  float* out = a.out + static_cast<int64_t>(idx) * a.hd;
#pragma unroll
  for (int k = 0; k < kMaxDim / 32; ++k)
    if (lane + 32 * k < a.hd) out[lane + 32 * k] = acc[k] / den;
}

template <typename T, int R, int G>
cudaError_t launch(const Args& a, int b, cudaStream_t s) {
  int region0;
  const int smem =
      smem_layout<T, R, G>(a.hd, a.split_pages * a.page_size, &region0);
  if (smem > kSmemDefault) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_partials<T, R, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  paged_decode_partials<T, R, G>
      <<<dim3(a.max_splits, a.hkv * a.chunks, b), kThreads, smem, s>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int rows = b * a.hq;
  paged_decode_combine<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      a, rows);
  return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_g(const Args& a, int g, int b, cudaStream_t s) {
  switch (g) {
    case 1: return launch<T, R, 1>(a, b, s);
    case 2: return launch<T, R, 2>(a, b, s);
    case 3: return launch<T, R, 3>(a, b, s);
    case 4: return launch<T, R, 4>(a, b, s);
    case 5: return launch<T, R, 5>(a, b, s);
    case 6: return launch<T, R, 6>(a, b, s);
    case 7: return launch<T, R, 7>(a, b, s);
    default: return launch<T, R, 8>(a, b, s);
  }
}

template <typename T>
cudaError_t launch_r(const Args& a, int g, int b, cudaStream_t s) {
  if (a.hd <= 64) return launch_g<T, 8>(a, g, b, s);
  if (a.hd <= 128) return launch_g<T, 16>(a, g, b, s);
  return launch_g<T, 32>(a, g, b, s);
}

}  // namespace

// kv_dtype, q_dtype: 0 = float32, 1 = bfloat16.  hd a multiple of 8 in
// 8..256; k, v, q contiguous and 16-byte aligned; table (b, max_pages) and
// pos (b,) int64, each pos in [0, max_pages * page_size); q2slot (hq,)
// int64 or null (then hq % hkv == 0).  part_acc (b, hq, max_splits, hd)
// and part_ml (b, hq, max_splits, 2) f32 scratch, max_splits =
// ceil(max_pages / split_pages); out (b, hq, hd) f32.  window <= 0 means
// no window, softcap <= 0 no softcap.  Launches two kernels on `stream`
// without synchronising; returns the first launch error (0 on success).
extern "C" int repro_paged_decode(
    const void* q, const void* k, const void* v, const void* table,
    const void* pos, const void* q2slot, void* part_acc, void* part_ml,
    void* out, int kv_dtype, int q_dtype, int b, int hq,
    int hkv, int hd, int page_size, int max_pages, int split_pages,
    int window, float softcap, void* stream) {
  if (b <= 0 || b > 65535 || hq <= 0 || hkv <= 0 || hd < 8 || hd > 256 ||
      hd % 8 != 0 || page_size <= 0 || max_pages <= 0 || split_pages <= 0 ||
      (kv_dtype != 0 && kv_dtype != 1) || (q_dtype != 0 && q_dtype != 1) ||
      (q2slot == nullptr && hq % hkv != 0))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.q = q, a.k = k, a.v = v;
  a.table = static_cast<const int64_t*>(table);
  a.pos = static_cast<const int64_t*>(pos);
  a.q2slot = static_cast<const int64_t*>(q2slot);
  a.part_acc = static_cast<float*>(part_acc);
  a.part_ml = static_cast<float*>(part_ml);
  a.out = static_cast<float*>(out);
  a.hq = hq, a.hkv = hkv, a.hd = hd, a.page_size = page_size;
  a.max_pages = max_pages, a.split_pages = split_pages;
  a.max_splits = (max_pages + split_pages - 1) / split_pages;
  a.window = window, a.softcap = softcap, a.q_bf16 = q_dtype;
  // q heads a block: the group, or under q2slot as many as could read one
  // stored head; more than kMaxG take more blocks a kv head
  const int heads = q2slot == nullptr ? hq / hkv : hq;
  const int g = heads < kMaxG ? heads : kMaxG;
  a.group = hq / hkv;
  a.chunks = (heads + g - 1) / g;
  if (static_cast<int64_t>(hkv) * a.chunks > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv_dtype == 1) return (int)launch_r<__nv_bfloat16>(a, g, b, s);
  return (int)launch_r<float>(a, g, b, s);
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
