// Triplane GroupNorm32 [+ FiLM] + SiLU of the sampler's bf16 torso, with
// the rollout axis means of its output, in one launch — kernel "tnorm" of
// the port.
//
// Replaces no Pallas kernel: the JAX package leaves the norm
// (sin3dm_tpu/core/nn.py:group_norm32_film_silu) and the rollout conv's
// axis means (sin3dm_tpu/models/unet.py:_tconv_apply_rollout_fast) to
// XLA, which fuses them.  Run eagerly they cost the port some 60 small
// launches a triplane norm and a dozen more for the means; inside the
// reverse chain's CUDA graph each launch costs ~2.5 us of a step while
// moving a few MB.  Per plane x [B, R, S, C] (C = 32 cpg), per item b:
//
//   mean[g], var[g]: the fp32 statistics of group g's R*S*cpg values,
//     two-pass (the mean, then the mean of squared deviations from it);
//     rstd = rsqrt(var + eps)
//   A[c] = rstd[g] gamma[c];  B[c] = beta[c] - mean[g] A[c]; with FiLM
//     (scale = film[b, :C], shift = film[b, C:], bf16): A *= 1 + scale,
//     B = B (1 + scale) + shift; each operation rounded on its own
//     (core/nn.py:_fold_coeffs); written to coef [3, 2, B, C] fp32
//   y = silu(x bf16(A) + bf16(B)), each operation in fp32 rounded to
//     bf16 (the apply in the planes' dtype, core/nn.py:apply_film_coeffs)
//   where asked, the means of y over S (per row) and over R (per column)
//     in bf16, written in the stacked layout [B, L, 3, C] that the rollout
//     products read: line l holds (m[l-1], m[l], m[l+1]), zeros past the
//     ends (ops/tnorm.py:stack3).
//
// Bound on the H100: bytes.  A launch reads the planes once and writes
// them once (4 B a value) besides [B, L, C] means and [B, C]
// coefficients; a level-0 triplane of 32,016 pixels at C = 192 is ~24.6
// MB, 7.3 us at 3.35 TB/s.  What holds it is instruction throughput:
// the apply rounds to bf16 after each operation and takes IEEE expf and
// divide (some 30 instructions a value, so that its bits are torch's),
// and a batch-1 norm has only 96-192 blocks; it runs at ~10 % of the
// bytes' bound.
//
// Design: one cluster of 8 blocks per (plane, item, channel slice).  A
// slice holds whole groups in lcm(8, C / 32) channels, at least 16 (at
// the tag's widths 16 or 24 channels, 32 or 48 bytes of each pixel; up
// to 256 at other widths, 8 channels a thread), so every pixel's slice
// is a few full sectors and a level-0 norm runs 96 to 192 blocks even
// at batch 1.  The 8 blocks take bands
// of rows.  A block is latency-bound, not bandwidth-bound: so it stages
// its band in shared memory with one burst of cp.async (all its loads in
// flight at once), where the band fits (49-74 KB at the tag's planes;
// else every pass reads the band from device memory, the later ones
// from L2), and its passes read that copy.  Each statistic is summed per
// thread, then over the block in a fixed order, then over the cluster
// through distributed shared memory, 8 lanes reading the 8 ranks at once
// and adding them in a fixed tree: no atomics, the same bits every run,
// and no scratch in device memory to zero.  The apply writes y (and over
// the staged x) and keeps column sums in shared memory; a last pass sums
// each row of the band (one warp a row) and the cluster sums the bands'
// column sums.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int CL = 8;       // blocks a cluster: the row bands of one slice
constexpr int NT = 256;     // threads a block
constexpr int MAX_SW = 256; // channels a slice, at most: lcm(8, C / 32)
constexpr int MAX_G = 16;   // groups a slice, at most: max(16 / cpg, 8)
static_assert(MAX_SW <= NT, "one thread a channel of the slice");

struct NormPlane {
  const __nv_bfloat16* x;   // [B, R, S, C]
  __nv_bfloat16* y;         // [B, R, S, C]
  const float* gamma;       // [C]
  const float* beta;        // [C]
  __nv_bfloat16* rows;      // [B, R, 3, C] stacked means over S, or null
  __nv_bfloat16* cols;      // [B, S, 3, C] stacked means over R, or null
  int R, S;
};

struct NormArgs {
  NormPlane p[3];
  const __nv_bfloat16* film;  // [B, 2C]: scale then shift, or null
  float* coef;                // [3, 2, B, C]: A then B of each plane
  int B, C, cpg, sw, n_slices;
  int staged;                 // bands staged in shared memory
  int col_at;                 // shared-memory floats before the column sums
  float eps;
};

__device__ __forceinline__ float bf(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// The mean m of line l of L into an item's stacked layout s [L, 3, C]:
// tap 1 of line l, tap 0 of line l+1, tap 2 of line l-1; the taps past
// the ends are zeros.
__device__ __forceinline__ void put3(__nv_bfloat16* s, int l, int L, int C,
                                     int c, float m) {
  const __nv_bfloat16 v = __float2bfloat16_rn(m);
  const __nv_bfloat16 z = __float2bfloat16_rn(0.0f);
  s[((size_t)l * 3 + 1) * C + c] = v;
  s[((size_t)l * 3 + (l + 1 < L ? 3 : 2)) * C + c] = l + 1 < L ? v : z;
  s[((size_t)l * 3 - (l > 0 ? 1 : 0)) * C + c] = l > 0 ? v : z;
}

// The block's per-thread sums acc[8] (channels 8j..8j+7 of the slice)
// summed per group of the slice into out[sw / cpg], in a fixed order:
// over the pixel lanes l = q (mod 8), then over q, then over the group's
// channels.
__device__ void group_sums(const float* acc, float (*red)[8],
                           float (*red2)[MAX_SW], float* out, int tpp,
                           int lanes, int sw, int cpg) {
  const int t = threadIdx.x;
#pragma unroll
  for (int i = 0; i < 8; ++i) red[t][i] = acc[i];
  __syncthreads();
  for (int k = t; k < 8 * sw; k += NT) {
    const int cc = k % sw, q = k / sw;
    float s = 0.0f;
    for (int l = q; l < lanes; l += 8) s += red[l * tpp + cc / 8][cc % 8];
    red2[q][cc] = s;
  }
  __syncthreads();
  if (t < sw / cpg) {
    float s = 0.0f;
    for (int k = 0; k < cpg; ++k) {
      float sc = 0.0f;
      for (int q = 0; q < 8; ++q) sc += red2[q][t * cpg + k];
      s += sc;
    }
    out[t] = s;
  }
  __syncthreads();
}

// The sum over the cluster's blocks of their float at `p` (shared), for
// the k-th value of each of 32 slots: lanes 8k'..8k'+7 each read one rank
// and a fixed tree of shuffles adds them (every lane of the 8 gets it).
__device__ __forceinline__ float cluster_sum(cg::cluster_group& cluster,
                                             float* p, bool valid) {
  const int r = threadIdx.x % CL;
  float v = valid ? *cluster.map_shared_rank(p, r) : 0.0f;
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

__global__ void __cluster_dims__(CL, 1, 1) __launch_bounds__(NT)
    sin3dm_tnorm_kernel(const __grid_constant__ NormArgs a) {
  // [band pixels][sw] bf16 where staged, then [S][sw] fp32 column sums
  extern __shared__ __align__(16) float dyn[];
  __shared__ float red[NT][8];
  __shared__ float red2[8][MAX_SW];
  __shared__ float xch[2][NT / CL];      // group sums the cluster reads
  __shared__ float mean_s[MAX_G], rstd_s[MAX_G];
  __shared__ float ca[MAX_SW], cb[MAX_SW];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  int q = blockIdx.x / CL;
  const int slice = q % a.n_slices;
  q /= a.n_slices;
  const int b = q % a.B;
  const int pi = q / a.B;
  const NormPlane& P = a.p[pi];
  const int R = P.R, S = P.S, C = a.C, sw = a.sw, cpg = a.cpg;
  const int G = sw / cpg;
  const int tpp = sw / 8, lanes = NT / tpp;   // threads a pixel, pixel lanes
  const int t = threadIdx.x;
  const int j = t % tpp, lane = t / tpp;
  const bool active = lane < lanes;
  const int s0 = slice * sw;
  const int rpb = (R + CL - 1) / CL;
  const int r0 = min(R, rank * rpb), r1 = min(R, r0 + rpb);
  const size_t item = (size_t)b * R * S;
  const int px0 = r0 * S, npx = (r1 - r0) * S;   // the band's pixels
  const float n = (float)R * (float)S * (float)cpg;
  // the band's x (and after the apply its y) at pixel p: src + p * stride
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(dyn);
  float* colpart = dyn + a.col_at;
  const __nv_bfloat16* xg = P.x + (item + px0) * C + s0;
  __nv_bfloat16* yg = P.y + (item + px0) * C + s0;
  if (a.staged) {
    for (int k = t; k < npx * tpp; k += NT)
      hopper::cp_async16(xs + 8 * k, xg + (size_t)(k / tpp) * C + 8 * (k % tpp));
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
  }
  const __nv_bfloat16* src = a.staged ? xs : xg;
  const size_t stride = a.staged ? sw : C;

  // 1. each group's mean
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.0f;
  if (active) {
#pragma unroll 4
    for (int p = lane; p < npx; p += lanes) {
      float v[8];
      load8(src + p * stride + 8 * j, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += v[i];
    }
  }
  group_sums(acc, red, red2, xch[0], tpp, lanes, sw, cpg);
  cluster.sync();
  {
    const float s = cluster_sum(cluster, &xch[0][t / CL], t / CL < G);
    if (t % CL == 0 && t / CL < G) mean_s[t / CL] = s / n;
  }
  __syncthreads();

  // 2. each group's mean of squared deviations from its mean
  float mu[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mu[i] = mean_s[(8 * j + i) / cpg];
    acc[i] = 0.0f;
  }
  if (active) {
#pragma unroll 4
    for (int p = lane; p < npx; p += lanes) {
      float v[8];
      load8(src + p * stride + 8 * j, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float d = v[i] - mu[i];
        acc[i] += __fmul_rn(d, d);
      }
    }
  }
  group_sums(acc, red, red2, xch[1], tpp, lanes, sw, cpg);
  cluster.sync();
  {
    const float s = cluster_sum(cluster, &xch[1][t / CL], t / CL < G);
    if (t % CL == 0 && t / CL < G) rstd_s[t / CL] = rsqrtf(s / n + a.eps);
  }
  __syncthreads();

  // 3. gamma, beta and the FiLM folded into per-channel (A, B)
  if (t < sw) {
    const int c = s0 + t, g = t / cpg;
    float A = __fmul_rn(rstd_s[g], P.gamma[c]);
    float Bc = __fsub_rn(P.beta[c], __fmul_rn(mean_s[g], A));
    if (a.film) {
      const __nv_bfloat16* f = a.film + (size_t)b * 2 * C;
      const float onep = __fadd_rn(1.0f, __bfloat162float(f[c]));
      A = __fmul_rn(A, onep);
      Bc = __fadd_rn(__fmul_rn(Bc, onep), __bfloat162float(f[C + c]));
    }
    if (rank == 0) {
      a.coef[((size_t)(2 * pi) * a.B + b) * C + c] = A;
      a.coef[((size_t)(2 * pi + 1) * a.B + b) * C + c] = Bc;
    }
    ca[t] = bf(A);
    cb[t] = bf(Bc);
  }
  __syncthreads();

  // 4. the apply, in bf16 as the plain version rounds it, and the band's
  // column sums of y
  const bool means = P.rows != nullptr;
  float ka[8], kb[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    ka[i] = ca[8 * j + i];
    kb[i] = cb[8 * j + i];
  }
  if (active) {
    for (int s = lane; s < S; s += lanes) {
      float cs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) cs[i] = 0.0f;
#pragma unroll 4
      for (int p = s; p < npx; p += S) {
        float v[8];
        load8(src + p * stride + 8 * j, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float u = bf(__fadd_rn(bf(__fmul_rn(v[i], ka[i])), kb[i]));
          const float sg = bf(1.0f / (1.0f + expf(-u)));
          v[i] = bf(__fmul_rn(u, sg));
          cs[i] += v[i];
        }
        store8(yg + (size_t)p * C + 8 * j, v);
        if (a.staged) store8(xs + p * sw + 8 * j, v);
      }
      if (means) {
#pragma unroll
        for (int i = 0; i < 8; ++i) colpart[s * sw + 8 * j + i] = cs[i];
      }
    }
  }
  __syncthreads();

  if (means) {
    // 5. the band's row means: one warp a row, its lanes over the columns
    const int w = t / 32, u = t % 32;
    const int nl = 32 / tpp, jw = u % tpp, cl = u / tpp;
    float(*wred)[8] = red + 32 * w;
    __nv_bfloat16* rows = P.rows + (size_t)b * R * 3 * C;
    const __nv_bfloat16* ysrc = a.staged ? xs : yg;
    for (int r = r0 + w; r < r1; r += NT / 32) {
      float rs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) rs[i] = 0.0f;
      if (cl < nl) {
        const __nv_bfloat16* yr = ysrc + (size_t)(r - r0) * S * stride + 8 * jw;
#pragma unroll 4
        for (int s = cl; s < S; s += nl) {
          float v[8];
          load8(yr + s * stride, v);
#pragma unroll
          for (int i = 0; i < 8; ++i) rs[i] += v[i];
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) wred[u][i] = rs[i];
      __syncwarp();
      for (int cc = u; cc < sw; cc += 32) {
        float sum = 0.0f;
        for (int l = 0; l < nl; ++l) sum += wred[l * tpp + cc / 8][cc % 8];
        put3(rows, r, R, C, s0 + cc, sum * (1.0f / (float)S));
      }
      __syncwarp();
    }

    // 6. the column means: the cluster's band sums, each block a share of
    // the columns, summed in rank order
    cluster.sync();
    __nv_bfloat16* cols = P.cols + (size_t)b * S * 3 * C;
    const int spb = (S + CL - 1) / CL;
    const int c_lo = min(S, rank * spb), c_hi = min(S, c_lo + spb);
    const int items = (c_hi - c_lo) * sw;
    for (int k0 = 0; k0 < items; k0 += NT / CL) {
      const int k = k0 + t / CL;
      const int s = c_lo + k / sw, cc = k % sw;
      const float sum = cluster_sum(cluster, colpart + s * sw + cc, k < items);
      if (t % CL == 0 && k < items)
        put3(cols, s, S, C, s0 + cc, sum * (1.0f / (float)R));
    }
  }
  // no block leaves while another may still read its shared memory
  cluster.sync();
}

// Channels a slice for C channels: whole groups, a multiple of 8 (the
// 16-byte loads) and at least 16, so lcm(8, C / 32) or 16; 0 where that
// exceeds MAX_SW, which no C of at most 1024 channels does.
int slice_width(int C) {
  if (C < 32 || C % 32) return 0;
  const int cpg = C / 32;
  int g = 8, c = cpg;
  while (c) {
    const int r = g % c;
    g = c;
    c = r;
  }
  int sw = 8 / g * cpg;                   // lcm(8, cpg)
  if (sw < 16) sw = 16;
  return sw <= MAX_SW ? sw : 0;
}

}  // namespace

// Plain C entry point (bound with ctypes): one launch over a triplane's
// three planes.  ptrs holds per plane x, y, gamma, beta, rows, cols (rows
// and cols both null where no means are wanted; x and y 16-byte aligned);
// rs holds R, S per plane; film null or [B, 2C] bf16; coef [3, 2, B, C]
// fp32.  Launches on `stream`, does not synchronise, returns the
// cudaError_t.
extern "C" int sin3dm_tnorm(const void* const* ptrs, const int* rs, int B,
                            int C, const void* film, float* coef, float eps,
                            void* stream) {
  const int sw = slice_width(C);
  if (B < 1 || !sw || !coef) return (int)cudaErrorInvalidValue;
  NormArgs a;
  a.film = static_cast<const __nv_bfloat16*>(film);
  a.coef = coef;
  a.B = B;
  a.C = C;
  a.cpg = C / 32;
  a.sw = sw;
  a.n_slices = C / sw;
  a.eps = eps;
  size_t band = 0, cols = 0;   // bytes: the largest band, column sums
  for (int i = 0; i < 3; ++i) {
    NormPlane& p = a.p[i];
    const void* const* pp = ptrs + 6 * i;
    p.x = static_cast<const __nv_bfloat16*>(pp[0]);
    p.y = static_cast<__nv_bfloat16*>(const_cast<void*>(pp[1]));
    p.gamma = static_cast<const float*>(pp[2]);
    p.beta = static_cast<const float*>(pp[3]);
    p.rows = static_cast<__nv_bfloat16*>(const_cast<void*>(pp[4]));
    p.cols = static_cast<__nv_bfloat16*>(const_cast<void*>(pp[5]));
    p.R = rs[2 * i];
    p.S = rs[2 * i + 1];
    if (p.R < 1 || p.S < 1 || !p.x || !p.y || !p.gamma || !p.beta ||
        (p.rows == nullptr) != (p.cols == nullptr) ||
        (uintptr_t)p.x % 16 || (uintptr_t)p.y % 16)
      return (int)cudaErrorInvalidValue;
    const size_t bb = (size_t)((p.R + CL - 1) / CL) * p.S * sw * 2;
    if (bb > band) band = bb;
    if (p.rows && sizeof(float) * (size_t)p.S * sw > cols)
      cols = sizeof(float) * (size_t)p.S * sw;
  }
  if (cols > 160 * 1024) return (int)cudaErrorInvalidValue;
  band = (band + 15) / 16 * 16;
  a.staged = band + cols <= 160 * 1024;
  a.col_at = a.staged ? (int)(band / sizeof(float)) : 0;
  const size_t smem = (a.staged ? band : 0) + cols;
  cudaError_t err = cudaFuncSetAttribute(
      sin3dm_tnorm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(3 * B * a.n_slices * CL);
  sin3dm_tnorm_kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
