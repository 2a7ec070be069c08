// Fused skip-concat MLP head for Hopper (sm_90a) — kernel K2 of the port.
//
// Replaces the Pallas TPU kernel `skip_mlp_fused`
// (sin3dm_tpu/ops/fused_mlp.py:79, body `_kernel` :52).  Per row of
// x [N, cin] (fp32):
//
//   h = relu(x W0 + b0); h = relu(h Wi + bi) for the other `first` layers
//   h = relu(x Ws[:cin] + h Ws[cin:] + bs)          (skip concat, never built)
//   h = relu(h Wj + bj) for the middle `second` layers
//   out = h Wlast + blast                          (fp32 [N, cout])
//
// Operands are cast to the "mxu" type (bf16 or fp32) before every
// product, exactly as the TPU kernel does; accumulation, bias and ReLU
// are fp32 and the output is fp32.
//
// Design: the TPU kernel keeps all weights (~0.6 MB) resident in VMEM;
// that does not fit in the 227 KB of shared memory a Hopper block can
// use.  Here a block owns a 64-row tile and keeps its input tile and its
// [64, hidden] activation in shared memory for the whole network; each
// layer's weights stream through shared memory in K-chunks (64 rows for
// bf16, 32 for fp32).  bf16 products use the tensor cores (wmma
// 16x16x16, fp32 accumulate): each of the 8 warps owns one 16-row slab
// and every other 16-column fragment, and moves its finished fragments
// through a private 16x16 fp32 scratch to add bias and ReLU.  fp32
// products use fp32 FMAs, 8x8 outputs per thread.  Only x is read and
// only out is written in device memory.
//
// Bound on the H100: compute.  The towerruins heads (64->256x3,
// 320->256->256->cout) cost ~1.18 MFLOP per grid point for both heads,
// 10.2 TFLOP per 184x256x184 grid, ~10.4 ms at 989 TFLOP/s bf16 dense.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int TM = 64;    // rows per block
constexpr int NTH = 256;  // threads per block (8 warps)
constexpr int PAD = 8;    // smem row padding (elements)

struct Layer {
  int K, N, src;  // src: 0 = x tile, 1 = h tile, 2 = [x | h] (skip)
  bool relu;
  size_t w_off, b_off;
};

__device__ Layer layer_desc(int l, int cin, int hid, int cout, int n_first,
                            int n_second) {
  Layer L;
  size_t w_off = 0, b_off = 0;
  const int n_layers = n_first + n_second;
  for (int i = 0; i <= l; ++i) {
    int K, N, src;
    if (i == 0) { K = cin; src = 0; }
    else if (i < n_first) { K = hid; src = 1; }
    else if (i == n_first) { K = cin + hid; src = 2; }
    else { K = hid; src = 1; }
    N = (i == n_layers - 1) ? cout : hid;
    if (i == l) {
      L.K = K; L.N = N; L.src = src; L.relu = (i != n_layers - 1);
      L.w_off = w_off; L.b_off = b_off;
    }
    w_off += (size_t)K * N;
    b_off += N;
  }
  return L;
}

__device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }

// ------------------------------------------------------------------ bf16
constexpr int KC_BF16 = 64;

__global__ void __launch_bounds__(NTH)
mlp_bf16_kernel(const float* __restrict__ x,
                const __nv_bfloat16* __restrict__ wts,
                const float* __restrict__ bias, float* __restrict__ out,
                int n_rows, int cin, int hid, int cout, int n_first,
                int n_second) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NW = round16(hid > cout ? hid : cout);
  const int ldx = cin + PAD, ldh = hid + PAD, ldw = NW + PAD;
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* hs = xs + TM * ldx;
  __nv_bfloat16* ws = hs + TM * ldh;
  float* scratch = reinterpret_cast<float*>(ws + KC_BF16 * ldw);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int row0 = blockIdx.x * TM;
  float* wscr = scratch + warp * 256;

  for (int idx = tid; idx < TM * cin; idx += NTH) {
    const int r = idx / cin, c = idx % cin;
    const int gr = row0 + r;
    xs[r * ldx + c] = __float2bfloat16(gr < n_rows ? x[(size_t)gr * cin + c]
                                                   : 0.0f);
  }

  const int mi = warp % 4;  // this warp's 16-row slab
  const int n_layers = n_first + n_second;
  for (int l = 0; l < n_layers; ++l) {
    const Layer L = layer_desc(l, cin, hid, cout, n_first, n_second);
    const int n_frag = (L.N + 15) / 16;
    const int npad = n_frag * 16;
    const __nv_bfloat16* W = wts + L.w_off;
    const bool vec_w = (L.N % 8 == 0) && ((uintptr_t)W % 16 == 0);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) wmma::fill_fragment(acc[j], 0.0f);

    for (int k0 = 0; k0 < L.K; k0 += KC_BF16) {
      const int kn = min(KC_BF16, L.K - k0);
      __syncthreads();  // previous chunk (or layer output) complete
      if (vec_w) {
        const int vpr = npad / 8;
        for (int idx = tid; idx < kn * vpr; idx += NTH) {
          const int r = idx / vpr, c = (idx % vpr) * 8;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (c < L.N)
            v = *reinterpret_cast<const uint4*>(W + (size_t)(k0 + r) * L.N + c);
          *reinterpret_cast<uint4*>(ws + r * ldw + c) = v;
        }
      } else {
        for (int idx = tid; idx < kn * npad; idx += NTH) {
          const int r = idx / npad, c = idx % npad;
          ws[r * ldw + c] = c < L.N ? W[(size_t)(k0 + r) * L.N + c]
                                    : __float2bfloat16(0.0f);
        }
      }
      __syncthreads();
      for (int kk = 0; kk < kn; kk += 16) {
        const int kg = k0 + kk;
        const __nv_bfloat16* ap;
        int lda;
        if (L.src == 0 || (L.src == 2 && kg < cin)) {
          ap = xs + mi * 16 * ldx + kg;
          lda = ldx;
        } else {
          ap = hs + mi * 16 * ldh + (L.src == 2 ? kg - cin : kg);
          lda = ldh;
        }
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> fa;
        wmma::load_matrix_sync(fa, ap, lda);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int ni = warp / 4 + 2 * j;
          if (ni < n_frag) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major> fb;
            wmma::load_matrix_sync(fb, ws + kk * ldw + ni * 16, ldw);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
      }
    }
    __syncthreads();  // every warp done reading hs before it is rewritten

    const float* bl = bias + L.b_off;
    const bool last = (l == n_layers - 1);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int ni = warp / 4 + 2 * j;
      if (ni < n_frag) {
        wmma::store_matrix_sync(wscr, acc[j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = e / 16, c = ni * 16 + e % 16;
          const int rr = mi * 16 + r;
          if (c < L.N) {
            float v = wscr[e] + bl[c];
            if (L.relu) v = fmaxf(v, 0.0f);
            if (last) {
              if (row0 + rr < n_rows) out[(size_t)(row0 + rr) * cout + c] = v;
            } else {
              hs[rr * ldh + c] = __float2bfloat16(v);
            }
          }
        }
        __syncwarp();
      }
    }
  }
}

// ------------------------------------------------------------------ fp32
constexpr int KC_F32 = 32;

__global__ void __launch_bounds__(NTH)
mlp_f32_kernel(const float* __restrict__ x, const float* __restrict__ wts,
               const float* __restrict__ bias, float* __restrict__ out,
               int n_rows, int cin, int hid, int cout, int n_first,
               int n_second) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int NW = round16(hid > cout ? hid : cout);
  float* xs = reinterpret_cast<float*>(smem);
  float* hs = xs + TM * cin;
  float* ws = hs + TM * hid;

  const int tid = threadIdx.x;
  const int tx = tid % 32, ty = tid / 32;  // rows ty + 8i, cols tx + 32j
  const int row0 = blockIdx.x * TM;

  for (int idx = tid; idx < TM * cin; idx += NTH) {
    const int r = idx / cin, c = idx % cin;
    const int gr = row0 + r;
    xs[idx] = gr < n_rows ? x[(size_t)gr * cin + c] : 0.0f;
  }

  const int n_layers = n_first + n_second;
  for (int l = 0; l < n_layers; ++l) {
    const Layer L = layer_desc(l, cin, hid, cout, n_first, n_second);
    const float* W = wts + L.w_off;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    for (int k0 = 0; k0 < L.K; k0 += KC_F32) {
      const int kn = min(KC_F32, L.K - k0);
      __syncthreads();
      for (int idx = tid; idx < kn * NW; idx += NTH) {
        const int r = idx / NW, c = idx % NW;
        ws[idx] = c < L.N ? W[(size_t)(k0 + r) * L.N + c] : 0.0f;
      }
      __syncthreads();
      for (int kk = 0; kk < kn; ++kk) {
        const int kg = k0 + kk;
        const float* ap;
        int lda;
        if (L.src == 0 || (L.src == 2 && kg < cin)) {
          ap = xs + kg;
          lda = cin;
        } else {
          ap = hs + (L.src == 2 ? kg - cin : kg);
          lda = hid;
        }
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = ap[(ty + 8 * i) * lda];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 32 * j;
          bv[j] = c < NW ? ws[kk * NW + c] : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();

    const float* bl = bias + L.b_off;
    const bool last = (l == n_layers - 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int rr = ty + 8 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 32 * j;
        if (c < L.N) {
          float v = acc[i][j] + bl[c];
          if (L.relu) v = fmaxf(v, 0.0f);
          if (last) {
            if (row0 + rr < n_rows) out[(size_t)(row0 + rr) * cout + c] = v;
          } else {
            hs[rr * hid + c] = v;
          }
        }
      }
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory a launch with these widths needs.
extern "C" size_t sin3dm_skip_mlp_smem(int cin, int hid, int cout,
                                       int is_bf16) {
  const int NW = ((hid > cout ? hid : cout) + 15) / 16 * 16;
  if (is_bf16)
    return (size_t)(TM * (cin + PAD) + TM * (hid + PAD) +
                    KC_BF16 * (NW + PAD)) * 2 + 8 * 256 * sizeof(float);
  return (size_t)(TM * cin + TM * hid + KC_F32 * NW) * sizeof(float);
}

// Plain C entry point (bound with ctypes).  wts holds every layer's
// [K, N] weight row-major in layer order (first..., second...), in bf16
// when is_bf16 else fp32; bias holds every layer's [N] fp32 bias.
// Launches on `stream`, does not synchronise, returns the cudaError_t.
extern "C" int sin3dm_skip_mlp(const float* x, const void* wts,
                               const float* bias, float* out, int n_rows,
                               int cin, int hid, int cout, int n_first,
                               int n_second, int is_bf16, void* stream) {
  const size_t smem = sin3dm_skip_mlp_smem(cin, hid, cout, is_bf16);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((n_rows + TM - 1) / TM);
  cudaError_t err;
  if (is_bf16) {
    err = cudaFuncSetAttribute(mlp_bf16_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_bf16_kernel<<<grid, NTH, smem, st>>>(
        x, static_cast<const __nv_bfloat16*>(wts), bias, out, n_rows, cin,
        hid, cout, n_first, n_second);
  } else {
    err = cudaFuncSetAttribute(mlp_f32_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
    mlp_f32_kernel<<<grid, NTH, smem, st>>>(
        x, static_cast<const float*>(wts), bias, out, n_rows, cin, hid, cout,
        n_first, n_second);
  }
  return (int)cudaGetLastError();
}
