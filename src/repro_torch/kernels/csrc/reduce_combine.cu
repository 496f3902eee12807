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
// contiguous.  A 2D grid: y walks rows, x walks columns with coalesced
// loads; k pointers ride in the kernel's parameters.
//
// Bound.  The function reads k buffers and writes one; one operation per
// input element is far below the card's rate, so it is bound by bytes: at
// the runtime's real size (two 1 GiB PE-stacked f32 buffers) 3 GiB,
// ~0.96 ms at 3.35 TB/s.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 32;
constexpr int kTargetBlocks = 2048;

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

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    combine_kernel(Bufs bufs, int k, T* __restrict__ out, int64_t rows,
                   int64_t cols) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = blockIdx.y; r < rows; r += gridDim.y) {
    T* o = out + r * cols;
    for (int64_t c = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
         c < cols; c += stride) {
      T acc = static_cast<const T*>(bufs.p[0])[r * bufs.ld[0] + c];
      for (int j = 1; j < k; ++j)
        acc = Combine<T, OP>::apply(
            acc, static_cast<const T*>(bufs.p[j])[r * bufs.ld[j] + c]);
      o[c] = acc;
    }
  }
}

int64_t clamp_grid(int64_t want, int64_t cap) {
  return want < 1 ? 1 : (want > cap ? cap : want);
}

template <typename T>
cudaError_t launch(int op, const Bufs& bufs, int k, void* out, int64_t rows,
                   int64_t cols, cudaStream_t s) {
  const int64_t gy = clamp_grid(rows, 65535);
  const int64_t gx = clamp_grid(
      (kTargetBlocks + gy - 1) / gy, (cols + kThreads - 1) / kThreads);
  const dim3 grid((unsigned)gx, (unsigned)gy);
  T* o = static_cast<T*>(out);
  switch (op) {
    case kSum:
      combine_kernel<T, kSum><<<grid, kThreads, 0, s>>>(bufs, k, o, rows, cols);
      break;
    case kProd:
      combine_kernel<T, kProd><<<grid, kThreads, 0, s>>>(bufs, k, o, rows, cols);
      break;
    case kMax:
      combine_kernel<T, kMax><<<grid, kThreads, 0, s>>>(bufs, k, o, rows, cols);
      break;
    case kMin:
      combine_kernel<T, kMin><<<grid, kThreads, 0, s>>>(bufs, k, o, rows, cols);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
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
  for (int j = 0; j < k; ++j) {
    bufs.p[j] = ptrs[j];
    bufs.ld[j] = lds[j];
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
