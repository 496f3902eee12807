// Mamba2 SSD chunked scan for Hopper (sm_90a), with a plain C interface.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel).  Same function: x (Bt,L,H,P), dt (Bt,L,H) f32, A (H,) f32
// (negative), B/C (Bt,L,G,N) in x's dtype with head h reading group
// h / (H/G), h0 (Bt,H,P,N) f32 or none; L a multiple of the chunk Q.  Per
// (batch, head), over chunks of Q steps, every product in f32:
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
// Design.  One block of 256 threads per (batch, head) walks the chunks in
// order (the TPU kernel's fori_loop), the P x N state resident in shared
// memory for the whole sequence.  Per chunk it stages x (Q x P) and B
// (Q x N) as f32; warp 0 scans A * dt (a warp scan over lanes holding
// ceil(Q/32) steps each) and keeps s, exp(s) and dt * exp(s_Q - s).  The
// Q x Q decay-weighted C B^T is never whole: the chunk's rows go in tiles
// of up to 64, each tile staging its C rows transposed, computing its lower
// block-triangle of M (columns u < t0 + 64 only), transposed into shared
// memory, and then y = M @ x + exp(s_t) * C @ state^T for its rows.  After
// the last tile the state is updated in place.  Every product is a 4 x 4
// register tile per thread over float4 reads of shared memory, laid out so
// that a warp reads one broadcast operand and one run of consecutive
// 16-byte words.  At Q 128, P 64, N 128 the block holds 201 KB of shared
// memory (x 32 KB, B 66, C^T 34, the state 34, M^T 34, vectors 2).
//
// Bound.  At the serving prefill's shapes (Bt 1, L 32768, H 80, P 64,
// G 1, N 128, Q 128, bf16) the function reads x, dt, B, C once and writes
// y and the state once, ~0.70 GB: 0.21 ms at 3.35 TB/s; its products are
// 2 Q^2 N + 2 Q^2 P + 4 Q N P = 10.49 MFLOP per (head, chunk), 214.7 GFLOP
// in all, 3.20 ms at the f32 CUDA-core rate (67 TFLOP/s).  So it is bound
// by operations.  This first kernel computes on the CUDA cores in f32 as
// the reference does; it skips the masked blocks above the diagonal (about
// a third of the intra-chunk products), recomputes the group's C B^T per
// head as the TPU kernel does, and fills 80 of 132 SMs at Bt 1.  Tensor
// cores (bf16 mma/wgmma: a bound of 0.22 ms), C B^T once per group and
// blocks split over P are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kTileRows = 64;   // chunk rows per tile of the intra-chunk term
constexpr int kMaxChunk = 128;  // warp 0's scan holds 4 steps a lane
constexpr int kPad = 4;         // floats of row padding (bank spread)
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Dims {
  int L, H, G, P, N, Q;
  long long sx_b, sx_l;   // x: batch and step strides (elements)
  long long sb_b, sb_l;   // B
  long long sc_b, sc_l;   // C
};

// Shared memory, in floats: x [Q][P], B [Q][N+4], C^T [N][TR+4] (the
// tile's rows), state^T [N][P+4], M^T [Q][TR+4], then s, exp(s),
// dt * exp(s_Q - s) and dt, Q each.  All offsets are multiples of 4.
struct Layout {
  int tr, bs, cs, ss, ms;
  size_t x, b, c, st, m, s, es, w, dt, total;
  __host__ __device__ explicit Layout(const Dims& d) {
    tr = d.Q < kTileRows ? d.Q : kTileRows;
    bs = d.N + kPad;
    cs = tr + kPad;
    ss = d.P + kPad;
    ms = tr + kPad;
    x = 0;
    b = x + (size_t)d.Q * d.P;
    c = b + (size_t)d.Q * bs;
    st = c + (size_t)d.N * cs;
    m = st + (size_t)d.N * ss;
    s = m + (size_t)d.Q * ms;
    es = s + d.Q;
    w = es + d.Q;
    dt = w + d.Q;
    total = dt + d.Q;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_vec, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ hout, Dims d) {
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  const Layout lay(d);
  float* xs = smem + lay.x;     // [Q][P]
  float* bs = smem + lay.b;     // [Q][N + 4]
  float* ct = smem + lay.c;     // [N][TR + 4]
  float* st = smem + lay.st;    // [N][P + 4]  (the state, transposed)
  float* mt = smem + lay.m;     // [Q][TR + 4] (M, transposed)
  float* sv = smem + lay.s;
  float* es = smem + lay.es;
  float* wv = smem + lay.w;
  float* dv = smem + lay.dt;

  const int Q = d.Q, P = d.P, N = d.N, TR = lay.tr;
  const int BS = lay.bs, CS = lay.cs, SS = lay.ss, MS = lay.ms;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (d.H / d.G);
  const float a = a_vec[h];
  const int tid = threadIdx.x;

  const size_t state_off = ((size_t)b * d.H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads)
    st[(i % N) * SS + i / N] = h0 ? h0[state_off + i] : 0.f;

  const T* xb = x + b * d.sx_b + (size_t)h * P;
  const T* bb = bm + b * d.sb_b + (size_t)g * N;
  const T* cb = cm + b * d.sc_b + (size_t)g * N;
  T* yb = y + (size_t)b * d.L * d.H * P + (size_t)h * P;
  const size_t y_step = (size_t)d.H * P;

  for (int l0 = 0; l0 < d.L; l0 += Q) {
    __syncthreads();  // the previous chunk's x, B and vectors are consumed
    for (int i = tid; i < Q * P; i += kThreads)
      xs[i] = to_float(xb[(l0 + i / P) * d.sx_l + i % P]);
    for (int i = tid; i < Q * N; i += kThreads)
      bs[(i / N) * BS + i % N] = to_float(bb[(l0 + i / N) * d.sb_l + i % N]);
    if (tid < 32) {
      // s = cumsum(A * dt): lane k holds steps [k*per, k*per + per)
      const int per = (Q + 31) / 32;
      float loc[kMaxChunk / 32], dtl[kMaxChunk / 32];
      float run = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxChunk / 32; ++j) {
        const int u = tid * per + j;
        dtl[j] = (j < per && u < Q)
                     ? dt[((size_t)b * d.L + l0 + u) * d.H + h] : 0.f;
        run += a * dtl[j];
        loc[j] = run;
      }
      float incl = run;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, incl, o);
        if (tid >= o) incl += t;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      // s_Q is the very sum stored as s[Q - 1]
      float mine = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxChunk / 32; ++j)
        if (j == (Q - 1) % per) mine = excl + loc[j];
      const float s_last = __shfl_sync(0xffffffffu, mine, (Q - 1) / per);
#pragma unroll
      for (int j = 0; j < kMaxChunk / 32; ++j) {
        const int u = tid * per + j;
        if (j < per && u < Q) {
          const float s = excl + loc[j];
          sv[u] = s;
          es[u] = expf(s);
          wv[u] = dtl[j] * expf(s_last - s);
          dv[u] = dtl[j];
        }
      }
    }

    for (int t0 = 0; t0 < Q; t0 += TR) {
      const int rows = min(TR, Q - t0);
      for (int i = tid; i < rows * N; i += kThreads)
        ct[(i % N) * CS + i / N] =
            to_float(cb[(l0 + t0 + i / N) * d.sc_l + i % N]);
      __syncthreads();  // C^T of the tile (and x, B, s of the chunk) ready

      // M[r][u] = (C_r . B_u) * exp(s_t - s_u) * dt_u for u <= t = t0 + r,
      // else 0, over u < t0 + rows; a thread's rows r0..r0+3, columns
      // cu + j * (ucols/4) (a warp reads consecutive rows of B)
      const int ucols = t0 + rows;
      const int ctiles = ucols / 4;
      for (int tile = tid; tile < (rows / 4) * ctiles; tile += kThreads) {
        const int r0 = (tile / ctiles) * 4, cu = tile % ctiles;
        float acc[4][4] = {};
        if (cu <= t0 + r0 + 3) {  // else every column of the tile is masked
          for (int n = 0; n < N; n += 4) {
            float4 cr[4], bu[4];
#pragma unroll
            for (int k = 0; k < 4; ++k) cr[k] = ld4(ct + (n + k) * CS + r0);
#pragma unroll
            for (int j = 0; j < 4; ++j)
              bu[j] = ld4(bs + (cu + j * ctiles) * BS + n);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j)
                acc[i][j] += at(cr[0], i) * bu[j].x + at(cr[1], i) * bu[j].y +
                             at(cr[2], i) * bu[j].z + at(cr[3], i) * bu[j].w;
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int u = cu + j * ctiles;
          float m[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int t = t0 + r0 + i;
            m[i] = u <= t ? acc[i][j] * expf(sv[t] - sv[u]) * dv[u] : 0.f;
          }
          *reinterpret_cast<float4*>(mt + u * MS + r0) =
              make_float4(m[0], m[1], m[2], m[3]);
        }
      }
      __syncthreads();  // M^T of the tile ready

      // y[r][p] = sum_u M[r][u] x[u][p] + exp(s_t) * sum_n C[r][n] S[p][n]
      const int ptiles = P / 4;
      for (int tile = tid; tile < (rows / 4) * ptiles; tile += kThreads) {
        const int r0 = (tile / ptiles) * 4, p0 = (tile % ptiles) * 4;
        float intra[4][4] = {}, inter[4][4] = {};
        const int u_end = min(ucols, t0 + r0 + 4);  // M[r][u] = 0 past r
        for (int u = 0; u < u_end; ++u) {
          const float4 mr = ld4(mt + u * MS + r0);
          const float4 xv = ld4(xs + u * P + p0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float mi = at(mr, i);
            intra[i][0] += mi * xv.x;
            intra[i][1] += mi * xv.y;
            intra[i][2] += mi * xv.z;
            intra[i][3] += mi * xv.w;
          }
        }
        for (int n = 0; n < N; ++n) {
          const float4 cr = ld4(ct + n * CS + r0);
          const float4 sp = ld4(st + n * SS + p0);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float ci = at(cr, i);
            inter[i][0] += ci * sp.x;
            inter[i][1] += ci * sp.y;
            inter[i][2] += ci * sp.z;
            inter[i][3] += ci * sp.w;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int t = t0 + r0 + i;
          T* yr = yb + (size_t)(l0 + t) * y_step + p0;
#pragma unroll
          for (int j = 0; j < 4; ++j)
            store(yr + j, intra[i][j] + es[t] * inter[i][j]);
        }
      }
      __syncthreads();  // C^T and M^T consumed; the state read for y
    }

    // state[p][n] = exp(s_Q) state[p][n] + sum_u (x[u][p] w_u) B[u][n],
    // in place: a thread owns rows n0..n0+3 and columns p0..p0+3 of S^T
    const float decay = expf(sv[Q - 1]);
    const int ptiles = P / 4;
    for (int tile = tid; tile < (N / 4) * ptiles; tile += kThreads) {
      const int n0 = (tile / ptiles) * 4, p0 = (tile % ptiles) * 4;
      float acc[4][4] = {};
      for (int u = 0; u < Q; ++u) {
        const float4 bu = ld4(bs + u * BS + n0);
        const float4 xv = ld4(xs + u * P + p0);
        const float w = wv[u];
        const float xw[4] = {xv.x * w, xv.y * w, xv.z * w, xv.w * w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bi = at(bu, i);
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += xw[j] * bi;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float* sp = st + (n0 + i) * SS + p0 + j;
          *sp = decay * *sp + acc[i][j];
        }
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads)
    hout[state_off + i] = st[(i % N) * SS + i / N];
}

template <typename T>
cudaError_t launch(const void* x, const float* dt, const float* a,
                   const void* bm, const void* cm, const float* h0, void* y,
                   float* hout, int bt, const Dims& d, cudaStream_t stream) {
  const size_t smem = Layout(d).total * sizeof(float);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(d.H, bt);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(bm),
      static_cast<const T*>(cm), h0, static_cast<T*>(y), hout, d);
  return cudaGetLastError();
}

}  // namespace

// Bytes of shared memory one block needs for (P, N, Q); more than
// 232,448 means the kernel does not take the shape.
extern "C" long long repro_ssd_scan_smem_bytes(int p, int n, int q) {
  Dims d{};
  d.P = p;
  d.N = n;
  d.Q = q;
  return (long long)(Layout(d).total * sizeof(float));
}

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y).  dt, A, h0 and hout
// are f32 and contiguous; h0 may be null (a zero state).  x, B and C take
// any batch and step strides (in elements) with each head's (group's) row
// contiguous; y is contiguous (Bt, L, H, P).  L % Q == 0, Q <= 128,
// P, N, Q multiples of 4, H % G == 0.  Launches on `stream` without
// synchronising; returns the launch's cudaError_t (0 on success).
extern "C" int repro_ssd_scan(const void* x, const void* dt, const void* a,
                              const void* bm, const void* cm, const void* h0,
                              void* y, void* hout, int dtype, int bt, int L,
                              int H, int G, int P, int N, int Q,
                              long long sx_b, long long sx_l, long long sb_b,
                              long long sb_l, long long sc_b, long long sc_l,
                              void* stream) {
  if (bt <= 0 || L <= 0 || H <= 0 || G <= 0 || H % G != 0 || Q <= 0 ||
      Q > kMaxChunk || L % Q != 0 || Q % 4 != 0 || P <= 0 || P % 4 != 0 ||
      N <= 0 || N % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const Dims d{L, H, G, P, N, Q, sx_b, sx_l, sb_b, sb_l, sc_b, sc_l};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(a);
  const float* h0f = static_cast<const float*>(h0);
  float* hf = static_cast<float*>(hout);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, dtf, af, bm, cm, h0f, y, hf, bt, d, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, dtf, af, bm, cm, h0f, y, hf, bt,
                                        d, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
