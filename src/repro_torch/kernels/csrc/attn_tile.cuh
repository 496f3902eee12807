// The tile core shared by the two attention kernels, csrc/flash_attention.cu
// (kernel 4) and csrc/ring_attention.cu (kernel 6), for Hopper (sm_90a).
//
// Both run one flash loop over a tile of query rows: S = Q K^T, an f32
// online softmax with masked logits at -1e30 (never -inf), O += P V,
// walking only the key tiles that some row of the tile keeps.  They differ
// in where positions come from (the row index, or the PE's tables), in the
// ragged edge (a key slot past lk_valid is masked, a slot past Lk absent),
// in which tiles they may skip, and in their epilogue.  Those differences
// enter as two small objects: a positions object (DensePos, TablePos) and
// a tile visitor (RangeVisit, BoundsVisit).
//
// Skipping is exact.  A key tile that no row of the query tile keeps adds,
// to a row that has kept a key, exp(-1e30 - m) = 0; to a row that has kept
// nothing yet, 1 per slot and its v, which the first kept key wipes with
// alpha = exp(-1e30 - m_new) = 0.  So a row's result depends on the
// skipped tiles only when the row keeps nothing at all, and each walk
// records per row whether it kept anything (`kept`): the epilogue writes
// such a row from the sum of v over every slot, as the plain version has it.
//
// Two routes, chosen per call by the C entry (tc_route):
//
// * Tensor cores: bf16 inputs whose head dims are multiples of 8 and whose
//   base pointers are 16-byte aligned (TMA needs 16-byte row strides), which
//   covers every head dim of the model zoo.  One warpgroup of 128 threads
//   owns 64 query rows.  Q (once) and each 64-key K and V tile come in by
//   TMA (cp.async.bulk.tensor, 3-D maps over (heads, rows, dim)) into
//   64 x 64 bf16 blocks with 128-byte swizzled rows, in a ring of two
//   stages on mbarriers: while the warpgroup works on one tile, the next
//   is in flight.  A head dim that is not a multiple of 64 is padded with
//   zeros by TMA's out-of-bounds fill, in shared memory only: a zero column
//   adds nothing to q.k, and a padded v column is never stored.
//   S = Q K^T is wgmma m64n64k16 with both operands in shared memory
//   (K-major), ceil(D/16) steps, f32 accumulate.  The scale and the softcap
//   apply to the f32 logits after the product, as in the plain version.
//   O += P V takes P from registers as the A operand: the S accumulator's
//   fragment layout is the A fragment layout, so each pair of f32
//   probabilities packs into one bf16x2 register without a shuffle.  P is
//   split into a bf16 high part and a bf16 remainder and both are
//   multiplied (two wgmmas per step): a single rounding of P to bf16 errs
//   by up to 2^-9 of each weight, which (a) kernel 6's f32 partials cannot
//   carry (its reference does not round P: acc within 2e-5 of l |v|max),
//   and (b) at a long sequence's near-uniform weights moves kernel 4's
//   output by about half a bf16 step, beyond the one step that holds the
//   ring's output to kernel 4's.  The split errs by at most 2^-16.  V is the
//   MN-major (transposed) B operand, which wgmma allows for 16-bit types,
//   one m64n64k16 per 64 v columns.
// * CUDA cores (f32 inputs, and bf16 that TMA cannot address): a block of
//   128 threads owns 32 query rows, in f32 but for the logits' sums, which
//   run in f64.  f32 keeps this route because its tolerance (3e-5) is below
//   what bf16 operands give: a split into two bf16 parts keeps ~16 bits,
//   and 3xTF32 would need a K-major V that TMA does not give.  Its logits
//   are summed in f64 (each f32 product exact, one rounding to f32), which
//   keeps its output within ~1e-5 of the function's f64 value at head
//   dims 192 and 256 over 4096 tokens on an H100, where an f32 GEMM's
//   logits alone reach 3e-5.  Each warp owns 8 rows; a lane
//   computes the logits of those rows against keys `lane` and `lane + 32`
//   and keeps the output columns `lane + 32 e`.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: no libcuda is linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace attn {

using bf16 = __nv_bfloat16;

constexpr float kNegInf = -1e30f;  // a masked logit, as the reference's
constexpr int kMaxDim = 256;       // the largest head dim of q/k and of v
constexpr int kTile = 64;          // keys per K/V tile; query rows per
                                   // tensor-core block
constexpr int kBlockBytes = kTile * 64 * 2;  // one 64 x 64 bf16 block
constexpr int kTcThreads = 128;              // one warpgroup
constexpr int kCcRows = 32;                  // query rows per CUDA-core block
constexpr int kCcThreads = 128;
constexpr int kCcRowsPerWarp = kCcRows / (kCcThreads / 32);

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(bf16 x) {
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

// ---- positions, masks and tile visitors -----------------------------------

// Kernel 4: query row i sits at position i and key slot j at j; a slot at
// or past lk_valid is masked (present, at -1e30).
struct DensePos {
  int lk_valid;
  __device__ int qpos(int row) const { return row; }
  __device__ int kpos(int slot) const { return slot < lk_valid ? slot : -1; }
  __device__ bool absent(int) const { return false; }
};

// Kernel 6: positions from the PE's tables, -1 marking a padded (masked)
// key slot; a slot at or past lk is absent: -inf, weighing exp(-inf) = 0
// and not counted in l.  A query row past lq reads position -1.
struct TablePos {
  const int* qp;
  const int* kp;
  int lq, lk;
  __device__ int qpos(int row) const { return row < lq ? __ldg(qp + row) : -1; }
  __device__ int kpos(int slot) const {
    return slot < lk ? __ldg(kp + slot) : -1;
  }
  __device__ bool absent(int slot) const { return slot >= lk; }
};

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Mask {
  int causal, window;    // window <= 0: none
  float scale, softcap;  // softcap <= 0: none
  float scale2, softcap2;  // scale and softcap times log2(e)
  __device__ bool keep(int qp, int kp) const {
    return kp >= 0 && (!causal || kp <= qp) &&
           (window <= 0 || (long long)kp > (long long)qp - window);
  }
  // the logit of a raw product s: scaled, capped with tanhf, then masked
  __device__ float logit(float s, bool ok, bool absent) const {
    float x = s * scale;
    if (softcap > 0.f) x = softcap * tanhf(x / softcap);
    return absent ? -CUDART_INF_F : (ok ? x : kNegInf);
  }
  // the same logit in units of log2(e) (masked and absent slots keep their
  // -1e30 and -inf: exp2 of their difference from a kept maximum is 0)
  __device__ float logit2(float s) const {
    return softcap > 0.f ? softcap2 * tanhf(s * scale / softcap) : s * scale2;
  }
  __device__ float logit2(float s, bool ok, bool absent) const {
    return absent ? -CUDART_INF_F : (ok ? logit2(s) : kNegInf);
  }
};

inline Mask make_mask(int causal, int window, float scale, float softcap) {
  return Mask{causal, window, scale, softcap, scale * kLog2e,
              softcap * kLog2e};
}

// Kernel 4: the key tiles [lo, hi] holding the keys some row of the query
// tile keeps (the causal edge above, the window's lower edge below), and
// within them [full_lo, full_hi], the tiles every row keeps whole.
struct RangeVisit {
  int lo, hi, full_lo, full_hi;
  __device__ int next(int t, int n) const {
    const int u = max(t + 1, lo);
    return u <= hi && u < n ? u : n;
  }
  __device__ bool full(int t) const { return t >= full_lo && t <= full_hi; }
};

// The RangeVisit of the query rows q0 .. q0 + rows - 1 (q0 >= 0).
__device__ __forceinline__ RangeVisit range_visit(int q0, int rows,
                                                  int lk_valid, int causal,
                                                  int window) {
  const int q1 = q0 + rows - 1;
  int hi = lk_valid - 1;
  if (causal) hi = min(hi, q1);
  const int lo = window > 0 ? max(0, q0 - window + 1) : 0;
  // a tile t is whole for every row when 64 t + 63 < lk_valid, when
  // 64 t + 63 <= q0 (causal), and when 64 t > q1 - window (window)
  int full_hi = lk_valid / kTile - 1;
  if (causal) full_hi = min(full_hi, (q0 + 1) / kTile - 1);
  int full_lo = 0;
  if (window > 0) {
    const long long edge = (long long)q1 + 1 - window;  // 64 t >= edge
    full_lo = edge <= 0 ? 0 : (int)((edge + kTile - 1) / kTile);
  }
  return RangeVisit{lo / kTile, hi >= lo ? hi / kTile : -1, full_lo,
                    full_hi};
}

// Kernel 6: a key tile is skipped when its valid keys (bounds[t] = their
// min and max position and their count; min > max when it has none) are
// masked for every row of the query tile, whose positions lie in [qmin,
// qmax]: all after the latest row (causal), or all at or before the
// earliest row's window.  It is whole for every row when all its 64 slots
// are valid keys, none after the earliest row (causal) and none at or
// before the latest row's window.  The block decides every tile at once
// (bounds_visit) into two bitmasks in shared memory.
struct BoundsVisit {
  const uint32_t* visit_bits;  // ceil(n / 32) words each
  const uint32_t* full_bits;
  __device__ int next(int t, int n) const {
    for (int u = t + 1; u < n; u = (u | 31) + 1) {
      const uint32_t w = visit_bits[u >> 5] >> (u & 31);
      if (w) return u + __ffs(w) - 1;
    }
    return n;
  }
  __device__ bool full(int t) const {
    return (full_bits[t >> 5] >> (t & 31)) & 1u;
  }
};

// Shared-memory words of a BoundsVisit of n tiles.
__host__ __device__ inline size_t visit_words(int n) {
  return 2 * static_cast<size_t>((n + 31) / 32);
}

// Fills `words` (visit_words(n) of them) from the tiles' bounds for query
// positions in [qmin, qmax]; all threads of the block call it, and it ends
// in a barrier.
__device__ __forceinline__ BoundsVisit bounds_visit(const int4* bounds,
                                                    int n, int qmin,
                                                    int qmax, int causal,
                                                    int window,
                                                    uint32_t* words) {
  const int nw = (n + 31) / 32;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int base = 0; base < n; base += blockDim.x) {
    const int t = base + threadIdx.x;
    bool visit = false, full = false;
    if (t < n) {
      const int4 b = bounds[t];
      visit = b.x <= b.y && !(causal && b.x > qmax) &&
              !(window > 0 && (long long)b.y <= (long long)qmin - window);
      full = b.z == kTile && (!causal || b.y <= qmin) &&
             (window <= 0 || (long long)b.x > (long long)qmax - window);
    }
    const uint32_t vb = __ballot_sync(0xffffffffu, visit);
    const uint32_t fb = __ballot_sync(0xffffffffu, full);
    const int w = base / 32 + warp;
    if (lane == 0 && w < nw) {
      words[w] = vb;
      words[nw + w] = fb;
    }
  }
  __syncthreads();
  return BoundsVisit{words, words + nw};
}

// ---- Hopper primitives ----------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// Waits for the phase of `bar` with this parity.  A wait that outlasts
// ~2^35 cycles (tens of seconds) traps: a fault, not a hung card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  do {
    if (clock64() - start > (1ll << 35)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D map (dim, rows, heads) into shared memory; the
// box's bytes count against `bar`'s expected transaction.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// A wgmma shared-memory descriptor of a 128-byte-swizzled operand: rows of
// 128 bytes, 8-row groups 1024 bytes apart.  The leading offset is unused
// by these operands (K-major, or MN-major no wider than one 64-column
// atom); it is set to the group stride as well.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// 2^x (ex2.approx, relative error ~2^-22; 0 for -inf and below -126)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accesses of an accumulator across the
// asynchronous products
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (+)= A B over k 16: A 64 x 16 and B 16 x 64 (K-major, N x K in memory)
// from shared memory; scale_d 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d += A B over k 16: A 64 x 16 from registers (the m16n8k16 A fragment of
// each warp's 16 rows), B 16 x 64 MN-major (K x N in memory, N
// contiguous) from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// (lo, hi) f32 -> one bf16x2 word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo in bf16 (the remainder x - hi is exact in f32)
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - __low2float(h), b - __high2float(h));
}

// ---- the tensor-core walk -------------------------------------------------

// Shared memory of a tensor-core block, from a 1024-aligned base: Q (dqb
// blocks), then two stages of K (dqb blocks) and V (dvb blocks), then
// three mbarriers and kMaxDim floats for the epilogue's sum of v.
__host__ __device__ inline size_t tc_smem_bytes(int dqb, int dvb) {
  return 1024 + static_cast<size_t>(dqb + 2 * (dqb + dvb)) * kBlockBytes +
         32 + sizeof(float) * kMaxDim;
}

template <int DVB>
struct TcState {
  float o[DVB][32];  // the warpgroup's m64n64 accumulator of each v atom
  float m[2], l[2];  // rows r0 and r0 + 8 of this thread; m in log2(e) units
  bool kept[2];
};

struct TcSmem {
  uint32_t base;   // shared address, 1024-aligned
  uint8_t* ptr;    // the same, generic
  uint64_t* bars;  // Q, stage 0, stage 1
  float* vsum;     // kMaxDim floats
};

__device__ __forceinline__ TcSmem tc_smem(uint8_t* raw, int dqb, int dvb) {
  TcSmem s;
  const uint32_t r = smem_u32(raw);
  s.base = (r + 1023u) & ~1023u;
  s.ptr = raw + (s.base - r);
  s.bars = reinterpret_cast<uint64_t*>(
      s.ptr + static_cast<size_t>(dqb + 2 * (dqb + dvb)) * kBlockBytes);
  s.vsum = reinterpret_cast<float*>(s.bars + 4);
  return s;
}

// This thread's first row r0 in the warpgroup's accumulator fragments: it
// holds rows r0 and r0 + 8 of the 64, columns 8 j + 2 (lane % 4) + e.
__device__ __forceinline__ int tc_row0() {
  return (threadIdx.x / 32) * 16 + (threadIdx.x % 32) / 4;
}

// Walks the visited key tiles of the 64-row query tile at q0 of head
// q_head (KV head kv_head) and leaves the un-normalised state in `st`
// (kept[] reduced over the row's four threads).  All 128 threads call it.
// The softmax runs in units of log2(e): logits times log2(e), p =
// exp2(x - m) by ex2.approx, and m comes out in those units.  A tile whole
// for every row (visit.full) skips the mask; one that no row keeps is not
// loaded, and a query tile with no tile to walk does not load Q either.
template <int DVB, class Pos, class Visit>
__device__ __forceinline__ void tc_walk(const CUtensorMap* tq,
                                        const CUtensorMap* tk,
                                        const CUtensorMap* tv, int q_head,
                                        int kv_head, int q0, int d,
                                        int n_tiles, const Pos& pos,
                                        const Visit& visit, const Mask& mask,
                                        const TcSmem& sm, TcState<DVB>& st) {
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int dqb = (d + 63) / 64;
  const int nk16 = (d + 15) / 16;
  const uint32_t sq = sm.base;
  const uint32_t skv = sm.base + dqb * kBlockBytes;
  const uint32_t stage_bytes = (dqb + DVB) * kBlockBytes;
  const uint32_t bar_q = smem_u32(sm.bars);
  const uint32_t bar_kv[2] = {smem_u32(sm.bars + 1), smem_u32(sm.bars + 2)};

  auto issue = [&](int stage, int t) {
    const uint32_t ks = skv + stage * stage_bytes;
    const uint32_t vs = ks + dqb * kBlockBytes;
    mbar_expect_tx(bar_kv[stage], stage_bytes);
    for (int c = 0; c < dqb; ++c)
      tma_load_3d(ks + c * kBlockBytes, tk, bar_kv[stage], 64 * c, kTile * t,
                  kv_head);
    for (int c = 0; c < DVB; ++c)
      tma_load_3d(vs + c * kBlockBytes, tv, bar_kv[stage], 64 * c, kTile * t,
                  kv_head);
  };

  if (tid == 0) {
    mbar_init(bar_q, 1);
    mbar_init(bar_kv[0], 1);
    mbar_init(bar_kv[1], 1);
    mbar_fence_init();
  }
  __syncthreads();
  const int t_first = visit.next(-1, n_tiles);
  int t_issue = t_first;  // thread 0's: the next tile to load
  if (tid == 0 && t_first < n_tiles) {
    mbar_expect_tx(bar_q, dqb * kBlockBytes);
    for (int c = 0; c < dqb; ++c)
      tma_load_3d(sq + c * kBlockBytes, tq, bar_q, 64 * c, q0, q_head);
    for (int s = 0; s < 2 && t_issue < n_tiles; ++s) {
      issue(s, t_issue);
      t_issue = visit.next(t_issue, n_tiles);
    }
  }

#pragma unroll
  for (int c = 0; c < DVB; ++c)
#pragma unroll
    for (int x = 0; x < 32; ++x) st.o[c][x] = 0.f;
  const int r0 = tc_row0();
  int qp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    st.m[h] = kNegInf;
    st.l[h] = 0.f;
    st.kept[h] = false;
    qp[h] = pos.qpos(q0 + r0 + 8 * h);
  }
  if (t_first < n_tiles) mbar_wait(bar_q, 0);

  int i = 0;
  for (int t = t_first; t < n_tiles; t = visit.next(t, n_tiles), ++i) {
    const int stage = i & 1;
    const uint32_t ks = skv + stage * stage_bytes;
    const uint32_t vs = ks + dqb * kBlockBytes;
    const bool full = visit.full(t);
    // this thread's 16 key columns: 8 j + 2 (lane % 4) + e
    int kp[16];
    bool ab[16];
    if (!full) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int slot = kTile * t + 8 * (c >> 1) + 2 * (lane & 3) + (c & 1);
        kp[c] = pos.kpos(slot);
        ab[c] = pos.absent(slot);
      }
    }
    mbar_wait(bar_kv[stage], (i >> 1) & 1);

    float s[32];
#pragma unroll
    for (int x = 0; x < 32; ++x) s[x] = 0.f;
    fence_regs(s);
    wgmma_fence();
    for (int kk = 0; kk < nk16; ++kk) {
      const uint32_t off = (kk >> 2) * kBlockBytes + (kk & 3) * 32;
      wgmma_ss(s, desc_sw128(sq + off), desc_sw128(ks + off), kk);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the online softmax of rows r0 (h 0) and r0 + 8 (h 1); element x
    // sits in row h = (x / 2) % 2, column c = 2 (x / 4) + x % 2 of kp[]
    float mx[2] = {st.m[0], st.m[1]};
    if (full) {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        s[x] = mask.logit2(s[x]);
        mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], s[x]);
      }
      st.kept[0] = st.kept[1] = true;
    } else {
#pragma unroll
      for (int x = 0; x < 32; ++x) {
        const int h = (x >> 1) & 1;
        const int c = ((x >> 2) << 1) | (x & 1);
        const bool ok = mask.keep(qp[h], kp[c]);
        st.kept[h] = st.kept[h] || ok;
        s[x] = mask.logit2(s[x], ok, ab[c]);
        mx[h] = fmaxf(mx[h], s[x]);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      // st.m >= -1e30, so mx is finite and no exp2 sees inf - inf
      alpha[h] = ex2(st.m[h] - mx[h]);
      st.m[h] = mx[h];
    }
#pragma unroll
    for (int x = 0; x < 32; ++x) {
      const int h = (x >> 1) & 1;
      s[x] = ex2(s[x] - st.m[h]);
      sum[h] += s[x];
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
      sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
      st.l[h] = alpha[h] * st.l[h] + sum[h];
    }
#pragma unroll
    for (int c = 0; c < DVB; ++c)
#pragma unroll
      for (int x = 0; x < 32; ++x) st.o[c][x] *= alpha[(x >> 1) & 1];

    // P as A fragments, high and remainder parts: step kk covers keys
    // 16 kk .. 16 kk + 15, a[r] = (s[8 kk + 2 r], s[8 kk + 2 r + 1])
    uint32_t ph[4][4], pl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split_pair(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], ph[kk][r],
                   pl[kk][r]);

#pragma unroll
    for (int c = 0; c < DVB; ++c) fence_regs(st.o[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int c = 0; c < DVB; ++c) {
        // V atom c, keys 16 kk ..: 16 rows of 128 bytes in
        const uint64_t dv = desc_sw128(vs + c * kBlockBytes + kk * 16 * 128);
        wgmma_rs(st.o[c], ph[kk], dv);
        wgmma_rs(st.o[c], pl[kk], dv);
      }
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < DVB; ++c) fence_regs(st.o[c]);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && t_issue < n_tiles) {
      issue(stage, t_issue);
      t_issue = visit.next(t_issue, n_tiles);
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    int k = st.kept[h];
    k |= __shfl_xor_sync(0xffffffffu, k, 1);
    k |= __shfl_xor_sync(0xffffffffu, k, 2);
    st.kept[h] = k != 0;
  }
}

// ---- the CUDA-core walk ---------------------------------------------------

// Shared memory of a CUDA-core block for head dims padded to DP: q
// [kCcRows][DP], K [kTile][DP + 4] (the pad spreads a float4 read of 8
// neighbouring lanes over all banks), V [kTile][DP], P [kCcRows][kTile],
// all f32.
template <int DP>
__host__ __device__ constexpr size_t cc_smem_bytes() {
  return sizeof(float) *
         (kCcRows * DP + kTile * (DP + 4) + kTile * DP + kCcRows * kTile);
}

template <int DP>
struct CcState {
  float acc[kCcRowsPerWarp][DP / 32];  // columns lane + 32 e
  float m[kCcRowsPerWarp], l[kCcRowsPerWarp];
  bool kept[kCcRowsPerWarp];  // uniform across the warp after the walk
};

// Walks the visited key tiles of the query rows q0 .. q0 + rows - 1 (qg
// points at row q0, kg/vg at the head's row 0; row strides d and dv);
// warp w owns rows 8 w .. 8 w + 7.
template <typename T, int DP, class Pos, class Visit>
__device__ __forceinline__ void cc_walk(const T* qg, const T* kg, const T* vg,
                                        int rows, int q0, int lk, int d,
                                        int dv, int n_tiles, const Pos& pos,
                                        const Visit& visit, const Mask& mask,
                                        float* smem, CcState<DP>& st) {
  constexpr int kKS = DP + 4;
  constexpr int kCols = DP / 32;
  constexpr int kRows = kCcRowsPerWarp;
  float* qs = smem;                 // [kCcRows][DP]
  float* ks = qs + kCcRows * DP;    // [kTile][kKS]
  float* vs = ks + kTile * kKS;     // [kTile][DP]
  float* ps = vs + kTile * DP;      // [kCcRows][kTile]
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  for (int i = threadIdx.x; i < kCcRows * DP; i += kCcThreads) {
    const int r = i / DP, c = i % DP;
    qs[i] = r < rows && c < d ? to_float(qg[(size_t)r * d + c]) : 0.f;
  }
  int qp[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    qp[r] = pos.qpos(q0 + warp * kRows + r);
    st.m[r] = kNegInf;
    st.l[r] = 0.f;
    st.kept[r] = false;
#pragma unroll
    for (int e = 0; e < kCols; ++e) st.acc[r][e] = 0.f;
  }

  for (int t = visit.next(-1, n_tiles); t < n_tiles;
       t = visit.next(t, n_tiles)) {
    const int k0 = t * kTile;
    const int keys = min(kTile, lk - k0);  // key slots present in the tile
    __syncthreads();  // the previous tile is consumed (and q is loaded)
    for (int i = threadIdx.x; i < kTile * DP; i += kCcThreads) {
      const int r = i / DP, c = i % DP;
      const size_t row = (size_t)(k0 + r);
      ks[r * kKS + c] = r < keys && c < d ? to_float(kg[row * d + c]) : 0.f;
      vs[i] = r < keys && c < dv ? to_float(vg[row * dv + c]) : 0.f;
    }
    int kp[2];
    bool ab[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      kp[j] = pos.kpos(k0 + lane + 32 * j);
      ab[j] = pos.absent(k0 + lane + 32 * j);
    }
    __syncthreads();

    // products of this warp's rows with keys `lane` and `lane + 32`,
    // summed in f64: a product of two f32 is exact there, so a logit
    // rounds once, to f32, however wide the head
    double s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0;
#pragma unroll 2
    for (int c = 0; c < DP; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(ks + lane * kKS + c);
      const float4 kc =
          *reinterpret_cast<const float4*>(ks + (lane + 32) * kKS + c);
      const double ka4[4] = {ka.x, ka.y, ka.z, ka.w};
      const double kc4[4] = {kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qa =
            *reinterpret_cast<const float4*>(qs + (warp * kRows + r) * DP + c);
        const double qa4[4] = {qa.x, qa.y, qa.z, qa.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[r][0] = fma(qa4[u], ka4[u], s[r][0]);
          s[r][1] = fma(qa4[u], kc4[u], s[r][1]);
        }
      }
    }

    // online softmax, one row at a time across the warp
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = warp * kRows + r;
      float x[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = mask.keep(qp[r], kp[j]);
        st.kept[r] = st.kept[r] || ok;
        x[j] = mask.logit(static_cast<float>(s[r][j]), ok, ab[j]);
      }
      // st.m >= -1e30, so m_new is finite and no exp sees inf - inf
      const float m_new = fmaxf(st.m[r], warp_max(fmaxf(x[0], x[1])));
      const float p0 = expf(x[0] - m_new);
      const float p1 = expf(x[1] - m_new);
      const float alpha = expf(st.m[r] - m_new);
      st.l[r] = alpha * st.l[r] + warp_sum(p0 + p1);
      st.m[r] = m_new;
#pragma unroll
      for (int e = 0; e < kCols; ++e) st.acc[r][e] *= alpha;
      ps[row * kTile + lane] = p0;
      ps[row * kTile + lane + 32] = p1;
    }
    __syncwarp();  // a warp reads back only its own rows of P

    // acc += P V over this tile, four keys at a time (absent keys have
    // p = 0 and v = 0)
    for (int c = 0; c < kTile; c += 4) {
      float v4[kCols][4];
#pragma unroll
      for (int e = 0; e < kCols; ++e)
#pragma unroll
        for (int u = 0; u < 4; ++u) v4[e][u] = vs[(c + u) * DP + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 pr = *reinterpret_cast<const float4*>(
            ps + (warp * kRows + r) * kTile + c);
#pragma unroll
        for (int e = 0; e < kCols; ++e)
          st.acc[r][e] += pr.x * v4[e][0] + pr.y * v4[e][1] +
                          pr.z * v4[e][2] + pr.w * v4[e][3];
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    st.kept[r] = __any_sync(0xffffffffu, st.kept[r]);
}

// ---- host -----------------------------------------------------------------

// The tensor-core route takes bf16 (dtype 1) whose head dims are multiples
// of 8 (TMA's 16-byte row strides) at 16-byte-aligned base pointers.
inline bool tc_route(int dtype, int d, int dv, const void* q, const void* k,
                     const void* v) {
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return dtype == 1 && d % 8 == 0 && dv % 8 == 0 && aligned(q) &&
         aligned(k) && aligned(v);
}

// The CUDA-core route's padded head dim: 32, 64, 128 or 256.
inline int cc_pad(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : d <= 128 ? 128 : 256;
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point (the
// library links no libcuda); null if the driver does not offer it.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// A map of a contiguous bf16 tensor (heads, rows, cols) read in boxes of
// 64 columns x 64 rows of one head, 128-byte swizzled; out-of-bounds rows
// and columns read as zeros.
inline cudaError_t encode_map(CUtensorMap* map, const void* ptr, int cols,
                              int rows, int heads) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)cols, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)cols * 2,
                                 (cuuint64_t)cols * 2 * rows};
  const cuuint32_t box[3] = {64, kTile, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, unit,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

}  // namespace attn
