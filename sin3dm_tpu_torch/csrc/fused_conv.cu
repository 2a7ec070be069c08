// Fused 3x3 rollout conv for Hopper (sm_90a) — kernels K1 and K1′ of the
// port.
//
// Replaces the Pallas TPU kernel `conv3x3_rollout_fused`
// (sin3dm_tpu/ops/fused_conv.py:177, body `_kernel` :47) in all its
// forms.  Per plane, channels-last:
//
//   y[b,h,w,:] = conv3x3_SAME(act(x))[b,h,w,:] + bias
//              + col[b, w, cls(h), :] + row[b, h, cls(w), :]
//              + skip[b,h,w,:]
//
// with zero halo, fp32 accumulation and ONE rounding to x's dtype.
// cls(h) is 0 on row 0 (s_top), 2 on row H-1 (s_bot), 1 elsewhere
// (s_full); cls(w) likewise picks r_left / r_right / r_full on columns
// 0 / W-1 / interior.  Row 0 and column 0 win ties (H or W == 1).  col
// is [B, W, 3, Co] and row is [B, H, 3, Co], in x's dtype; either both
// are given or neither (then it is a plain 3x3 conv + bias).  Each of
// the three epilogue features of the Pallas body is a nullable pointer:
//
// - act_a/act_b [B, C] fp32 (`act=`, body :93-107): every gathered input
//   value becomes silu(float(x)*A + B) in fp32, rounded to x's dtype;
//   halo pixels stay zero, as the TPU kernel zeroes its staging scratch
//   and activates only the interior.  A pixel is activated once per tap
//   that reads it (9 times), instead of once in a staging pass.
// - skip [B, H, W, Co] in x's dtype (`skip=`, :145-148): added in fp32
//   before the rounding.
// - stats [B, n_blk, 2, Co] fp32 (`emit_stats=`, :152-170): each block
//   writes the per-channel sum and sum of squares of its ROUNDED outputs
//   (the TPU kernel re-reads its written tile); the wrapper sums the
//   n_blk partials in a fixed order.  No atomics: the same every run.
//
// Design: an implicit GEMM per batch item (grid.z), M = H*W output
// pixels, N = Co, K = 9*C.  A block owns a 64-pixel x 64-channel output
// tile of one batch item (so its stats partial belongs to one item) and
// walks K one tap at a time in 32-channel chunks: the A chunk is
// gathered straight from x with the halo test (zero outside the plane)
// and the optional activation, the B chunk is the matching rows of
// w [9C, Co]; both go through shared memory.  bf16 inputs multiply on
// the tensor cores (wmma 16x16x16, fp32 accumulate); fp32 inputs use
// fp32 FMAs (no TF32).  The bias, the border-select rollout terms and
// the skip are added in fp32 and y is written once.  Unlike the TPU
// kernel there is no im2col or staging scratch and no 128-channel split
// (that split existed for the TPU's 16 MB scoped-VMEM budget): C = 192
// runs in one call in every form.  The JAX split path rounds each
// partial sum to bf16 before adding them, so on that shape the two
// differ by that extra rounding.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): per call
// max(2*B*H*W*9*C*Co / 989e12, bytes / 3.35e12); a batch-2 level-0 xy
// call (92x128, 64->64) is 1.7 GFLOP and ~3.3 MB, about 1.8 us, so at
// the sampling chain's sizes the kernel is bound by launch latency and
// by its own un-pipelined load/compute loop, not by either roof.  The
// act/skip/stats forms add [B, C] coefficients, one read of skip and a
// [B, 2, Co] write to the bytes, and a few fp32 operations per gathered
// input value, off the tensor cores.  wgmma/TMA and a multi-stage
// pipeline are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;   // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per K chunk (within one tap)
constexpr int NT = 128;  // threads per block (4 warps)
constexpr int PAD = 8;   // smem row padding (elements)

template <typename T>
struct Smem {
  T a[BM][BK + PAD];
  T b[BK][BN + PAD];
  float c[BM][BN + 4];
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even
}

// silu(x*a + b) in fp32, each operation rounded on its own (no fused
// multiply-add), as the plain version computes it
__device__ __forceinline__ float act_f(float x, float a, float b) {
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  return __fmul_rn(v, 1.0f / (1.0f + expf(-v)));
}

// bf16: 4 warps in a 2x2 layout, each a 32x32 sub-tile of 2x2 fragments.
struct MmaBF16 {
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  }

  __device__ void compute(const Smem<__nv_bfloat16>& s) {
    const int warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fa[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> fb[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(fa[i], &s.a[wm * 32 + i * 16][kk], BK + PAD);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &s.b[kk][wn * 32 + j * 16], BN + PAD);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  __device__ void store(Smem<__nv_bfloat16>& s) {
    const int warp = threadIdx.x / 32;
    const int wm = warp / 2, wn = warp % 2;
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&s.c[wm * 32 + i * 16][wn * 32 + j * 16],
                                acc[i][j], BN + 4, wmma::mem_row_major);
  }
};

// fp32: thread (ty, tx) owns rows ty*8..ty*8+7 and columns tx*4..tx*4+3.
struct SimtF32 {
  float acc[8][4];

  __device__ void zero() {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  }

  __device__ void compute(const Smem<float>& s) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i) av[i] = s.a[ty * 8 + i][kk];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = s.b[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }

  __device__ void store(Smem<float>& s) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s.c[ty * 8 + i][tx * 4 + j] = acc[i][j];
  }
};

template <typename T, typename Mma>
__global__ void __launch_bounds__(NT)
conv3x3_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const float* __restrict__ bias, const T* __restrict__ col,
               const T* __restrict__ row, const float* __restrict__ act_a,
               const float* __restrict__ act_b, const T* __restrict__ skip,
               T* __restrict__ y, float* __restrict__ stats, int H, int W,
               int C, int Co, int vec_x, int vec_w) {
  __shared__ __align__(128) unsigned char raw[sizeof(Smem<T>)];
  __shared__ float red[2][NT];
  Smem<T>& s = *reinterpret_cast<Smem<T>*>(raw);

  constexpr int VEC = 16 / sizeof(T);        // elements per 16-byte load
  constexpr int A_VPR = BK / VEC;            // vectors per A row
  constexpr int A_ITERS = BM * A_VPR / NT;
  constexpr int B_VPR = BN / VEC;            // vectors per B row
  constexpr int B_ITERS = BK * B_VPR / NT;
  static_assert(BM * A_VPR % NT == 0 && BK * B_VPR % NT == 0, "tiling");
  static_assert(NT % BN == 0, "epilogue: each thread keeps one column");

  const int tid = threadIdx.x;
  const int HW = H * W;
  const int m0 = blockIdx.x * BM;            // pixel offset in the plane
  const int n0 = blockIdx.y * BN;
  const int bz = blockIdx.z;                 // batch item
  const T zero = from_f<T>(0.0f);
  const T* xb = x + (size_t)bz * HW * C;
  const float* ab = act_a ? act_a + (size_t)bz * C : nullptr;
  const float* bb = act_b ? act_b + (size_t)bz * C : nullptr;

  // output-pixel coordinates of this thread's A rows (fixed over K)
  int ph[A_ITERS], pw[A_ITERS];
  bool pok[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) {
    const int m = m0 + (tid + i * NT) / A_VPR;
    pok[i] = m < HW;
    const int mm = pok[i] ? m : 0;
    pw[i] = mm % W;
    ph[i] = mm / W;
  }

  Mma mma;
  mma.zero();
  const int n_kc = (C + BK - 1) / BK;
  for (int tap = 0; tap < 9; ++tap) {
    const int dh = tap / 3 - 1, dw = tap % 3 - 1;
    for (int kc = 0; kc < n_kc; ++kc) {
      const int c0 = kc * BK;
      // A chunk: the tap-shifted input pixels, zero outside the plane,
      // activated in fp32 where act is given
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int idx = tid + i * NT;
        const int r = idx / A_VPR, cv = (idx % A_VPR) * VEC;
        const int hh = ph[i] + dh, ww = pw[i] + dw;
        const bool inb = pok[i] && hh >= 0 && hh < H && ww >= 0 && ww < W;
        alignas(16) T v[VEC];
        if (inb) {
          const T* src = xb + ((size_t)hh * W + ww) * C + c0 + cv;
          if (vec_x && c0 + cv + VEC <= C) {
            *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(src);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e)
              v[e] = (c0 + cv + e < C) ? src[e] : zero;
          }
          if (ab) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              const int c = c0 + cv + e;
              if (c < C) v[e] = from_f<T>(act_f(to_f(v[e]), ab[c], bb[c]));
            }
          }
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[e] = zero;
        }
        *reinterpret_cast<uint4*>(&s.a[r][cv]) =
            *reinterpret_cast<const uint4*>(v);
      }
      // B chunk: rows tap*C + c0 .. +BK of w [9C, Co]
#pragma unroll
      for (int i = 0; i < B_ITERS; ++i) {
        const int idx = tid + i * NT;
        const int kr = idx / B_VPR, nv = (idx % B_VPR) * VEC;
        const int c = c0 + kr, n = n0 + nv;
        T* dst = &s.b[kr][nv];
        if (c < C) {
          const T* src = w + ((size_t)tap * C + c) * Co + n;
          if (vec_w && n + VEC <= Co) {
            *reinterpret_cast<uint4*>(dst) =
                *reinterpret_cast<const uint4*>(src);
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) dst[e] = (n + e < Co) ? src[e] : zero;
          }
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) dst[e] = zero;
        }
      }
      __syncthreads();
      mma.compute(s);
      __syncthreads();
    }
  }
  mma.store(s);
  __syncthreads();

  // epilogue: + bias + rollout border select + skip, one rounding, one
  // write; each thread keeps one column and sums its rounded outputs
  const int cn = tid % BN, n = n0 + cn;
  float s1 = 0.0f, s2 = 0.0f;
  for (int r = tid / BN; r < BM; r += NT / BN) {
    const int m = m0 + r;
    if (m >= HW || n >= Co) continue;
    const int wq = m % W, hq = m / W;
    float v = s.c[r][cn];
    if (bias) v += bias[n];
    if (col) {
      const int cls = hq == 0 ? 0 : (hq == H - 1 ? 2 : 1);
      v += to_f(col[(((size_t)bz * W + wq) * 3 + cls) * Co + n]);
    }
    if (row) {
      const int cls = wq == 0 ? 0 : (wq == W - 1 ? 2 : 1);
      v += to_f(row[(((size_t)bz * H + hq) * 3 + cls) * Co + n]);
    }
    const size_t o = ((size_t)bz * HW + m) * Co + n;
    if (skip) v += to_f(skip[o]);
    const T yr = from_f<T>(v);
    y[o] = yr;
    const float f = to_f(yr);
    s1 += f;
    s2 += f * f;
  }
  if (stats) {  // uniform over the block
    red[0][tid] = s1;
    red[1][tid] = s2;
    __syncthreads();
    if (tid < BN && n < Co) {
      float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int k = 0; k < NT / BN; ++k) {
        a1 += red[0][tid + k * BN];
        a2 += red[1][tid + k * BN];
      }
      float* out = stats + (((size_t)bz * gridDim.x + blockIdx.x) * 2) * Co;
      out[n] = a1;
      out[Co + n] = a2;
    }
  }
}

template <typename T, typename Mma>
int launch(const void* x, const void* w, const float* b, const void* col,
           const void* row, const float* act_a, const float* act_b,
           const void* skip, void* y, float* stats, int B, int H, int W,
           int C, int Co, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int vec_x = (C % VEC == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_w = (Co % VEC == 0) && ((uintptr_t)w % 16 == 0);
  dim3 grid((H * W + BM - 1) / BM, (Co + BN - 1) / BN, B);
  conv3x3_kernel<T, Mma><<<grid, NT, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), b,
      static_cast<const T*>(col), static_cast<const T*>(row), act_a, act_b,
      static_cast<const T*>(skip), static_cast<T*>(y), stats, H, W, C, Co,
      vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

// Output pixels per block: `stats` holds ceil(H*W / this) partials per
// batch item.
extern "C" int sin3dm_conv3x3_rows_per_block() { return BM; }

// Plain C entry point (bound with ctypes).  is_bf16 selects the element
// type of x, w, col, row, skip and y; b is fp32 [Co] or null; col/row
// null for a plain conv; act_a/act_b fp32 [B, C] or null; skip null or
// [B, H, W, Co]; stats null or fp32 [B, ceil(H*W/64), 2, Co], every
// entry written.  Launches on `stream`, does not synchronise, returns
// the launch's cudaError_t.
extern "C" int sin3dm_conv3x3_rollout(const void* x, const void* w,
                                      const float* b, const void* col,
                                      const void* row, const float* act_a,
                                      const float* act_b, const void* skip,
                                      void* y, float* stats, int B, int H,
                                      int W, int C, int Co, int is_bf16,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch<__nv_bfloat16, MmaBF16>(x, w, b, col, row, act_a, act_b,
                                          skip, y, stats, B, H, W, C, Co, st);
  return launch<float, SimtF32>(x, w, b, col, row, act_a, act_b, skip, y,
                                stats, B, H, W, C, Co, st);
}
