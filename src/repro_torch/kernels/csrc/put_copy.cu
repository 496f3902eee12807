// put_copy and dma_copy: the byte movers of the SIM runtime, for Hopper
// (sm_90a), with a plain C interface.
//
// repro_put_copy replaces the TPU kernel repro/kernels/put_copy.py::
// put_copy_2d (body _copy_kernel), the paper's hand-tuned shmem_put copy
// loop.  It copies row rows[i] of a (rows, row_bytes) source into row i of
// the output, and writes zeros where rows[i] is -1; without a table row i
// comes from row i (put_copy_2d itself).  With the table it is one whole
// SIM delivery: SimNetOps.ppermute moves every PE's payload in ONE launch.
//
// repro_dma_copy replaces repro/kernels/put_copy.py::dma_copy_2d, the
// e-DMA engine's 2D stride capability: a batch of 2D descriptors
// (src_origin, dst_origin, region) over (rows, cols) element arrays, all
// in one launch.  The part of dst outside every region is not touched.
// The TPU kernel's 32x128 block alignment is a VMEM tiling rule, not part
// of the function, so any region is copied.
//
// Design.  Both kernels move bytes and never look at the dtype.  The work
// is cut into (row, 16 KB segment) items that blocks of 256 threads take
// in a grid-stride loop, so one launch serves sixteen 64 MB rows and
// thousands of 8-byte rows alike.  A span is copied with the widest
// vector that the source and destination addresses share modulo 16
// (16-byte uint4 loads and stores when they agree, down to single bytes),
// after a scalar head that brings the destination to that alignment and
// before a scalar tail: the Hopper analogue of the paper's unaligned-edge
// specialisation.  The vector loop keeps four loads in flight per thread
// before it stores them, as the paper's 4-way unrolled dword loop did.
//
// Bound.  Each byte is read once and written once; nothing is computed.
// At the runtime's real size (sixteen PEs of 64 MiB each, 1 GiB stacked)
// a delivery moves 2 GiB, ~0.64 ms at 3.35 TB/s.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kSeg = 16 * 1024;   // bytes per work item, a multiple of 16
constexpr int kTargetBlocks = 2048;   // ~16 blocks per SM on 132 SMs

template <typename V>
__device__ __forceinline__ void copy_aligned(const char* __restrict__ s,
                                             char* __restrict__ d,
                                             int64_t n) {
  // s and d agree modulo sizeof(V): a byte head aligns both
  constexpr int64_t a = sizeof(V);
  int64_t head = (a - (int64_t)(reinterpret_cast<uintptr_t>(d) & (a - 1))) &
                 (a - 1);
  if (head > n) head = n;
  const int64_t t = threadIdx.x, bd = blockDim.x;
  for (int64_t i = t; i < head; i += bd) d[i] = s[i];
  const int64_t nv = (n - head) / a;
  const V* __restrict__ sv = reinterpret_cast<const V*>(s + head);
  V* __restrict__ dv = reinterpret_cast<V*>(d + head);
  int64_t i = t;
  for (; i + 3 * bd < nv; i += 4 * bd) {
    const V v0 = sv[i], v1 = sv[i + bd], v2 = sv[i + 2 * bd],
            v3 = sv[i + 3 * bd];
    dv[i] = v0;
    dv[i + bd] = v1;
    dv[i + 2 * bd] = v2;
    dv[i + 3 * bd] = v3;
  }
  for (; i < nv; i += bd) dv[i] = sv[i];
  for (int64_t j = head + nv * a + t; j < n; j += bd) d[j] = s[j];
}

__device__ __forceinline__ void copy_span(const char* s, char* d, int64_t n) {
  const uintptr_t x =
      reinterpret_cast<uintptr_t>(s) ^ reinterpret_cast<uintptr_t>(d);
  if ((x & 15) == 0)
    copy_aligned<uint4>(s, d, n);
  else if ((x & 7) == 0)
    copy_aligned<uint2>(s, d, n);
  else if ((x & 3) == 0)
    copy_aligned<unsigned>(s, d, n);
  else if ((x & 1) == 0)
    copy_aligned<unsigned short>(s, d, n);
  else
    copy_aligned<unsigned char>(s, d, n);
}

__device__ __forceinline__ void zero_span(char* d, int64_t n) {
  int64_t head = (16 - (int64_t)(reinterpret_cast<uintptr_t>(d) & 15)) & 15;
  if (head > n) head = n;
  const int64_t t = threadIdx.x, bd = blockDim.x;
  for (int64_t i = t; i < head; i += bd) d[i] = 0;
  const int64_t nv = (n - head) / 16;
  uint4* dv = reinterpret_cast<uint4*>(d + head);
  for (int64_t i = t; i < nv; i += bd) dv[i] = make_uint4(0, 0, 0, 0);
  for (int64_t j = head + nv * 16 + t; j < n; j += bd) d[j] = 0;
}

__global__ void __launch_bounds__(kThreads)
    put_rows_kernel(const char* src, char* dst, const int32_t* rows,
                    int64_t n_rows, int64_t row_bytes, int64_t src_stride,
                    int64_t n_segs) {
  const int64_t total = n_rows * n_segs;
  for (int64_t w = blockIdx.x; w < total; w += gridDim.x) {
    const int64_t i = w / n_segs;
    const int64_t lo = (w - i * n_segs) * kSeg;
    const int64_t n = row_bytes - lo < kSeg ? row_bytes - lo : kSeg;
    char* d = dst + i * row_bytes + lo;
    const int64_t r = rows != nullptr ? (int64_t)rows[i] : i;
    if (r < 0)
      zero_span(d, n);
    else
      copy_span(src + r * src_stride + lo, d, n);
  }
}

// one descriptor, in elements: rows [sr, sr+nr) x cols [sc, sc+nc) of src
// go to rows [dr, dr+nr) x cols [dc, dc+nc) of dst
struct Desc {
  int64_t sr, sc, dr, dc, nr, nc;
};

__global__ void __launch_bounds__(kThreads)
    dma_kernel(const char* src, char* dst, const Desc* descs, int64_t n_desc,
               int64_t elem, int64_t src_ld, int64_t dst_ld) {
  for (int64_t q = blockIdx.y; q < n_desc; q += gridDim.y) {
    const Desc g = descs[q];
    const int64_t row_bytes = g.nc * elem;
    const int64_t n_segs = (row_bytes + kSeg - 1) / kSeg;
    const int64_t total = g.nr * n_segs;
    for (int64_t w = blockIdx.x; w < total; w += gridDim.x) {
      const int64_t r = w / n_segs;
      const int64_t lo = (w - r * n_segs) * kSeg;
      const int64_t n = row_bytes - lo < kSeg ? row_bytes - lo : kSeg;
      copy_span(src + ((g.sr + r) * src_ld + g.sc) * elem + lo,
                dst + ((g.dr + r) * dst_ld + g.dc) * elem + lo, n);
    }
  }
}

int64_t clamp_grid(int64_t want, int64_t cap) {
  return want < 1 ? 1 : (want > cap ? cap : want);
}

}  // namespace

// rows: int32 device table of n_rows source rows (-1: zeros), or null for
// the identity.  src_stride: bytes between source rows (>= row_bytes).
extern "C" int repro_put_copy(const void* src, void* dst, const void* rows,
                              int64_t n_rows, int64_t row_bytes,
                              int64_t src_stride, void* stream) {
  if (n_rows <= 0 || row_bytes <= 0 || src_stride < row_bytes)
    return (int)cudaErrorInvalidValue;
  const int64_t n_segs = (row_bytes + kSeg - 1) / kSeg;
  const int64_t grid = clamp_grid(n_rows * n_segs, kTargetBlocks);
  put_rows_kernel<<<(unsigned)grid, kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst),
      static_cast<const int32_t*>(rows), n_rows, row_bytes, src_stride,
      n_segs);
  return (int)cudaGetLastError();
}

// descs: device array of n_desc descriptors (6 int64 each, in elements);
// max_items: the largest nr * ceil(nc * elem / 16 KB) over the batch, from
// the host's copy of the descriptors; src_ld/dst_ld: elements per row.
extern "C" int repro_dma_copy(const void* src, void* dst, const void* descs,
                              int64_t n_desc, int64_t max_items, int64_t elem,
                              int64_t src_ld, int64_t dst_ld, void* stream) {
  if (n_desc <= 0 || max_items <= 0 || elem <= 0)
    return (int)cudaErrorInvalidValue;
  const int64_t gy = clamp_grid(n_desc, 65535);
  const int64_t gx = clamp_grid((kTargetBlocks + gy - 1) / gy, max_items);
  dma_kernel<<<dim3((unsigned)gx, (unsigned)gy), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const char*>(src), static_cast<char*>(dst),
      static_cast<const Desc*>(descs), n_desc, elem, src_ld, dst_ld);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
