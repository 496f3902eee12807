// reduce_combine: the k-ary combine of a reduction stage, for Hopper
// (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel repro/kernels/reduce_combine.py::
// reduce_combine_2d (body _combine_kernel): out = op(...op(op(b0, b1),
// b2)..., b_{k-1}) elementwise over k >= 2 same-shape buffers, op one of
// sum, prod, max, min.  Every stage of the runtime's rd and ring
// reductions combines through it, and the congestion-faithful SIM folds
// its link-disjoint waves with it (a k-ary sum).
//
// Semantics kept bit for bit with the plain version (torch.add, mul,
// maximum, minimum folded in order from b0):
//   * the fold runs in the storage type: bf16 and f16 round to storage
//     after EVERY step (computed in f32, rounded to nearest even), as the
//     TPU kernel does on bf16 refs; there is no f32 accumulation across
//     buffers;
//   * max/min propagate NaN as torch.maximum/minimum do (a NaN operand
//     wins); fmaxf/fminf would return the other operand;
//   * integer sum and prod wrap (computed in the unsigned type);
//   * no step pairs a multiply with an add, so no FMA contraction exists
//     to change a result.
//
// Each buffer is a (rows, cols) element array with its own row stride, so
// a block of a PE-stacked tensor (the ring reduce-scatter's chunk of every
// PE) is combined in place without a gather copy; the output is
// contiguous.  Buffers that are all contiguous are walked as one row.
//
// Bound.  The function reads k buffers and writes one; one operation per
// input element is far below the card's rate, so it is bound by bytes: at
// the runtime's real size (two 1 GiB PE-stacked f32 buffers) 3 GiB,
// ~0.96 ms at 3.35 TB/s.
//
// Design (for the byte bound).  A thread moves 16 bytes of every buffer
// per load (4 f32, 8 bf16/f16, 16 int8) whenever every buffer's base and
// row stride and the output's are 16-byte aligned; the rest of a row (the
// tail past the last whole vector, or all of it on the scalar path: odd
// bases or strides, the NoC SIM's strided wave blocks) goes element by
// element.  k = 2, 3 and 4 (the rd/ring stages, the wave folds) are
// template parameters: the row pointers sit in registers and each thread
// loads 2 vectors of every buffer before it folds any; larger k (up to
// kMaxK) loops over the buffers at run time, one vector at a time.  Loads
// and stores carry the streaming hint (.cs: no byte is reused).  A block
// of 512 threads takes one tile of 1024 consecutive vectors (16 KB of
// each buffer) and the grid covers the row: at the rd stage's 1 GiB
// combine 65536 blocks.  A grid sized to the card instead (132 SMs x 8
// resident blocks walking the row with a grid stride) was slower on the
// H100.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 32;
constexpr int kMaxGridY = 65535;

struct Bufs {
  const void* p[kMaxK];
  int64_t ld[kMaxK];   // elements between rows
};

enum Op { kSum = 0, kProd = 1, kMax = 2, kMin = 3 };

// floating point in its own type (f32, f64)
template <typename T, int OP>
__device__ __forceinline__ T apply_float(T a, T b) {
  if (OP == kSum) return a + b;
  if (OP == kProd) return a * b;
  if (a != a) return a;            // NaN propagates, as torch.maximum
  if (b != b) return b;
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

template <typename T, int OP>
struct Combine {
  __device__ static T apply(T a, T b) { return apply_float<T, OP>(a, b); }
};

template <int OP>
struct Combine<__nv_bfloat16, OP> {
  __device__ static __nv_bfloat16 apply(__nv_bfloat16 a, __nv_bfloat16 b) {
    const float x = __bfloat162float(a), y = __bfloat162float(b);
    if (OP == kSum || OP == kProd)   // one f32 op, rounded to storage
      return __float2bfloat16_rn(apply_float<float, OP>(x, y));
    if (x != x) return a;
    if (y != y) return b;
    if (OP == kMax) return x > y ? a : b;
    return x < y ? a : b;
  }
};

template <int OP>
struct Combine<__half, OP> {
  __device__ static __half apply(__half a, __half b) {
    const float x = __half2float(a), y = __half2float(b);
    if (OP == kSum || OP == kProd)
      return __float2half_rn(apply_float<float, OP>(x, y));
    if (x != x) return a;
    if (y != y) return b;
    if (OP == kMax) return x > y ? a : b;
    return x < y ? a : b;
  }
};

// integers: sum and prod wrap in the unsigned type of the same width
template <typename T, typename U, int OP>
struct CombineInt {
  __device__ static T apply(T a, T b) {
    if (OP == kSum) return (T)(U)((U)a + (U)b);
    if (OP == kProd) return (T)(U)((U)a * (U)b);
    if (OP == kMax) return a > b ? a : b;
    return a < b ? a : b;
  }
};
template <int OP>
struct Combine<int32_t, OP> : CombineInt<int32_t, uint32_t, OP> {};
template <int OP>
struct Combine<int64_t, OP> : CombineInt<int64_t, uint64_t, OP> {};
template <int OP>
struct Combine<int16_t, OP> : CombineInt<int16_t, uint32_t, OP> {};
template <int OP>
struct Combine<int8_t, OP> : CombineInt<int8_t, uint32_t, OP> {};
template <int OP>
struct Combine<uint8_t, OP> : CombineInt<uint8_t, uint32_t, OP> {};

template <typename T>
struct alignas(16) Pack {
  T e[16 / sizeof(T)];
};

template <typename T, int OP>
__device__ __forceinline__ uint4 fold(uint4 a, uint4 b) {
  Pack<T> x, y;
  memcpy(&x, &a, 16);
  memcpy(&y, &b, 16);
#pragma unroll
  for (int i = 0; i < (int)(16 / sizeof(T)); ++i)
    x.e[i] = Combine<T, OP>::apply(x.e[i], y.e[i]);
  uint4 r;
  memcpy(&r, &x, 16);
  return r;
}

__device__ __forceinline__ uint4 load_cs(const void* p) {
  return __ldcs(static_cast<const uint4*>(p));
}
__device__ __forceinline__ void store_cs(void* p, uint4 v) {
  __stcs(static_cast<uint4*>(p), v);
}

// Row r = blockIdx.y (+ gridDim.y ...): its vectors [0, nvec) 16 bytes at
// a time, then its elements [nvec * V, cols) one at a time (all of them
// when nvec = 0).  A block takes U x kThreads consecutive vectors (a
// thread the U at stride kThreads), then the tile gridDim.x tiles on.
// K > 0: k = K buffers, the row pointers in registers; K = 0: k at run
// time, one vector at a time.
template <typename T, int OP, int K>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(Bufs bufs, int k, T* __restrict__ out, int64_t rows,
                   int64_t cols, int64_t nvec) {
  constexpr int V = 16 / sizeof(T);
  constexpr int U = K > 0 ? 2 : 1;   // vectors per buffer loaded at once
  constexpr int KR = K > 0 ? K : 1;
  const int64_t tile = (int64_t)kThreads * U;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    T* o = out + r * cols;
    const T* p[KR];
#pragma unroll
    for (int j = 0; j < KR; ++j)
      p[j] = static_cast<const T*>(bufs.p[j]) + r * bufs.ld[j];
    for (int64_t base = blockIdx.x * tile + threadIdx.x; base < nvec;
         base += gridDim.x * tile) {
      uint4 a[U][KR];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t v = base + u * kThreads;
        if (v < nvec) {
#pragma unroll
          for (int j = 0; j < KR; ++j) a[u][j] = load_cs(p[j] + v * V);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int64_t v = base + u * kThreads;
        if (v < nvec) {
          uint4 acc = a[u][0];
          if constexpr (K > 0) {
#pragma unroll
            for (int j = 1; j < K; ++j) acc = fold<T, OP>(acc, a[u][j]);
          } else {
            for (int j = 1; j < k; ++j)
              acc = fold<T, OP>(acc, load_cs(static_cast<const T*>(
                                                 bufs.p[j]) +
                                             r * bufs.ld[j] + v * V));
          }
          store_cs(o + v * V, acc);
        }
      }
    }
    const int nk = K > 0 ? K : k;
    for (int64_t c = nvec * V + blockIdx.x * kThreads + threadIdx.x; c < cols;
         c += gridDim.x * kThreads) {
      T acc = static_cast<const T*>(bufs.p[0])[r * bufs.ld[0] + c];
      for (int j = 1; j < nk; ++j)
        acc = Combine<T, OP>::apply(
            acc, static_cast<const T*>(bufs.p[j])[r * bufs.ld[j] + c]);
      o[c] = acc;
    }
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T, int OP>
cudaError_t launch_op(const Bufs& bufs, int k, T* out, int64_t rows,
                      int64_t cols, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T);
  // the vector path: every row start of every buffer and of the output
  // on a 16-byte boundary
  bool vec = aligned16(out) && (rows == 1 || (cols * sizeof(T)) % 16 == 0);
  for (int j = 0; j < k; ++j)
    vec = vec && aligned16(bufs.p[j]) &&
          (rows == 1 || (bufs.ld[j] * (int64_t)sizeof(T)) % 16 == 0);
  const int64_t nvec = vec ? cols / V : 0;
  const int64_t per_row = nvec > cols - nvec * V ? nvec : cols - nvec * V;
  // one tile of a row per block: the whole row in one wave of blocks
  const int64_t gy = rows < kMaxGridY ? rows : kMaxGridY;
  const int64_t tile = (int64_t)kThreads * (k <= 4 ? 2 : 1);
  int64_t gx = (per_row + tile - 1) / tile;
  if (gx > INT32_MAX) gx = INT32_MAX;
  if (gx < 1) gx = 1;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  switch (k) {
    case 2:
      combine_kernel<T, OP, 2><<<grid, kThreads, 0, s>>>(bufs, k, out, rows,
                                                         cols, nvec);
      break;
    case 3:
      combine_kernel<T, OP, 3><<<grid, kThreads, 0, s>>>(bufs, k, out, rows,
                                                         cols, nvec);
      break;
    case 4:
      combine_kernel<T, OP, 4><<<grid, kThreads, 0, s>>>(bufs, k, out, rows,
                                                         cols, nvec);
      break;
    default:
      combine_kernel<T, OP, 0><<<grid, kThreads, 0, s>>>(bufs, k, out, rows,
                                                         cols, nvec);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(int op, const Bufs& bufs, int k, void* out, int64_t rows,
                   int64_t cols, cudaStream_t s) {
  T* o = static_cast<T*>(out);
  switch (op) {
    case kSum: return launch_op<T, kSum>(bufs, k, o, rows, cols, s);
    case kProd: return launch_op<T, kProd>(bufs, k, o, rows, cols, s);
    case kMax: return launch_op<T, kMax>(bufs, k, o, rows, cols, s);
    case kMin: return launch_op<T, kMin>(bufs, k, o, rows, cols, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// ptrs/lds: k buffer pointers and their row strides (elements); out is a
// contiguous (rows, cols) array.  dtype: 0 f32, 1 f64, 2 bf16, 3 f16,
// 4 i32, 5 i64, 6 i16, 7 i8, 8 u8.  op: 0 sum, 1 prod, 2 max, 3 min.
extern "C" int repro_reduce_combine(const void* const* ptrs,
                                    const int64_t* lds, int k, void* out,
                                    int64_t rows, int64_t cols, int dtype,
                                    int op, void* stream) {
  if (k < 2 || k > kMaxK || rows <= 0 || cols <= 0)
    return (int)cudaErrorInvalidValue;
  Bufs bufs = {};
  bool dense = true;   // every buffer contiguous: walk it as one row
  for (int j = 0; j < k; ++j) {
    bufs.p[j] = ptrs[j];
    bufs.ld[j] = lds[j];
    dense = dense && (rows == 1 || lds[j] == cols);
  }
  if (dense && rows > 1) {
    cols *= rows;
    rows = 1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(op, bufs, k, out, rows, cols, s);
    case 1: return (int)launch<double>(op, bufs, k, out, rows, cols, s);
    case 2: return (int)launch<__nv_bfloat16>(op, bufs, k, out, rows, cols, s);
    case 3: return (int)launch<__half>(op, bufs, k, out, rows, cols, s);
    case 4: return (int)launch<int32_t>(op, bufs, k, out, rows, cols, s);
    case 5: return (int)launch<int64_t>(op, bufs, k, out, rows, cols, s);
    case 6: return (int)launch<int16_t>(op, bufs, k, out, rows, cols, s);
    case 7: return (int)launch<int8_t>(op, bufs, k, out, rows, cols, s);
    case 8: return (int)launch<uint8_t>(op, bufs, k, out, rows, cols, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
