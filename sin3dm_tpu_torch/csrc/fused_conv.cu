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
// - act_a/act_b [B, C] fp32 (`act=`, body :93-107): every input value
//   becomes silu(float(x)*A + B) in fp32, rounded to x's dtype; halo
//   pixels stay zero, as the TPU kernel zeroes its staging scratch and
//   activates only the interior.  bf16 activates each staged value once;
//   fp32 activates a pixel once per tap that reads it.
// - skip [B, H, W, Co] in x's dtype (`skip=`, :145-148): added in fp32
//   before the rounding.
// - stats (`emit_stats=`, :152-170): each block writes the per-channel
//   sum and sum of squares of its ROUNDED outputs (the TPU kernel
//   re-reads its written tile) as a partial; fp32 leaves the [B, n_blk,
//   2, Co] partials to the wrapper, bf16 has the last block of each
//   batch item sum them into [B, 2, Co].  Both sum in a fixed order, with
//   no atomics on the values: the same bits every run.
//
// Design: an implicit GEMM per batch item, M = H*W output pixels,
// N = Co, K = 9*C.  bf16 (the sampling path): below, at "bf16" — a 2-D
// pixel tile staged once with its halo, 9 taps read from shared memory,
// mma.sync on the tensor cores, one launch per triplane conv.  fp32 (not
// on the main path): a block owns a 64-pixel x 64-channel output tile of
// one batch item and walks K one tap at a time in 32-channel chunks
// gathered straight from x, fp32 FMAs (no TF32), no pipelining.  Both
// add the bias, the border-select rollout terms and the skip in fp32 and
// write y once.  Unlike the TPU kernel there is no im2col and no
// 128-channel split (that split existed for the TPU's 16 MB scoped-VMEM
// budget): C = 192 runs in one call in every form.  The JAX split path
// rounds each partial sum to bf16 before adding them, so on that shape
// the two differ by that extra rounding.
//
// Bound on the H100 (989 TFLOP/s bf16 dense, 3.35 TB/s): per call
// max(2*B*H*W*9*C*Co / 989e12, bytes / 3.35e12); a batch-2 level-0 xy
// call (92x128, 64->64) is 1.7 GFLOP and ~3.3 MB, about 1.8 us.  The
// act/skip/stats forms add [B, C] coefficients, one read of skip and a
// [B, 2, Co] write to the bytes, and a few fp32 operations per staged
// input value, off the tensor cores.

#include "hopper.cuh"

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

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}

// silu(x*a + b) in fp32, each operation rounded on its own (no fused
// multiply-add), as the plain version computes it
__device__ __forceinline__ float act_f(float x, float a, float b) {
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  return __fmul_rn(v, 1.0f / (1.0f + expf(-v)));
}

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

// ------------------------------------------------------------------ bf16
// A block owns a TH x TW tile of output pixels of one plane and one batch
// item and BN output channels: 8 x 16 pixels and BN = 64 for Co <= 64,
// else 8 x 8 pixels and BN = 128; 8 warps of 32 pixels x 32 channels.  It
// stages the (TH + 2) x (TW + 2) input pixels the tile reads, the zero
// halo included, 64 input channels at a time, into shared memory with
// cp.async (a pixel's 64 channels are 128 bytes, their 16-byte groups
// XOR-swizzled by the pixel index so ldmatrix is conflict-free); chunks
// are double-buffered, so chunk cc + 1 loads while chunk cc computes.
// With act (a separate instantiation, so the default form carries none of
// it) a pass writes silu(x*A + B) of each staged value once into a third
// buffer, exactly as act_f rounds (fast_act, and act_f for the few values
// it flags); the taps read that buffer.  A 2-D tile stages 1.4x (8 x 16)
// or 1.56x (8 x 8) the pixels it writes, where a band of consecutive
// pixels one plane row long stages 3 rows per row.
// The 9 taps then read shifted windows of that tile: A fragments by
// ldmatrix at per-lane pixel addresses, B (the tap's [BN x 64] weights,
// packed once by ops/fused_conv.py:pack_conv_weights as
// [C/64][9][Co_pad][64]) from a 3-stage cp.async ring that loads two taps
// ahead, mma.sync m16n8k16 with fp32 accumulation.  One launch covers up
// to three planes (a triplane conv) through a table: block index ->
// (plane, item, tile).

constexpr int NT16 = 256;   // threads per block (8 warps)
constexpr int KCH = 64;     // input channels per staged chunk
constexpr int WSTAGES = 3;  // weight ring stages
constexpr int TH = 8;       // tile rows

template <int BN>
struct Tile {
  static constexpr int BM = 8192 / BN;       // output pixels per block
  static constexpr int TW = BM / TH;         // tile columns
  static constexpr int SW = TW + 2;          // staged row width
  static constexpr int PX = (TH + 2) * SW;   // staged pixels per chunk
};

struct ConvPlane {
  const __nv_bfloat16* x;     // [B, H, W, C]
  const __nv_bfloat16* w;     // packed [C/64][9][co_pad][64]
  const float* bias;          // [Co] or null
  const __nv_bfloat16* col;   // [B, W, 3, Co] or null
  const __nv_bfloat16* row;   // [B, H, 3, Co] or null
  const float* act_a;         // [B, C] or null
  const float* act_b;         // [B, C] or null
  const __nv_bfloat16* skip;  // [B, H, W, Co] or null
  __nv_bfloat16* y;           // [B, H, W, Co]
  float* stats;               // [B, 2, Co] or null
  float* part;                // [B, n_tiles, 2, co_pad] scratch (stats)
  int* cnt;                   // [B, co_pad / BN] zeros (with stats)
  int H, W, tiles_w, n_tiles, blk0;  // blocks blk0 .. blk0 + B n_tiles - 1
};

struct ConvPlanes {
  ConvPlane p[3];
  int n_planes, C, Co, n_cc, co_pad, vec_x;
};

__device__ __forceinline__ float bf(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// act_f's value rounded to bf16 is act_f's value rounded to bf16 whenever
// a cheaper value lies close enough to it and far enough from a bf16
// rounding midpoint.  The fast value v / (1 + __expf(-v)) is within
// 8 + 1.173|v| fp32 ulps of act_f's (the CUDA bounds: __expf 2 + 1.173|v|,
// expf 2, __fdividef 2; four roundings of half an ulp each), so for |v|
// in [1e-30, 30] (the approximations' ranges) their bit patterns are at
// most 16 + 2.35|v| <= 87 apart; both share v's sign, so the patterns
// order as the values do.  fast_act returns the fast value and sets
// `exact` where that value's low 16 bits lie within 128 of 0x8000 or |v|
// is out of range (0, NaN and infinities included): there act_f must be
// computed.  Integer tests on the bit patterns keep the check short.
__device__ __forceinline__ float fast_act(float x, float a, float b,
                                          bool& exact) {
  const float v = __fadd_rn(__fmul_rn(x, a), b);
  const float f = __fdividef(v, 1.0f + __expf(-v));
  const uint32_t av = __float_as_uint(v) & 0x7FFFFFFFu;   // |v|
  const bool in_range = av - 0x0DA24260u <= 0x41F00000u - 0x0DA24260u;
  const bool near_mid = ((__float_as_uint(f) - 0x7F80u) & 0xFFFFu) <= 0x100u;
  exact = !in_range || near_mid;
  return f;
}

template <int BN, bool ACT>
__global__ void __launch_bounds__(NT16, 2)
conv3x3_bf16_kernel(const ConvPlanes P) {
  using namespace hopper;
  constexpr int BM = Tile<BN>::BM, TW = Tile<BN>::TW, SW = Tile<BN>::SW;
  constexpr int PX = Tile<BN>::PX;
  constexpr int WN = BN / 32, WM = 8 / WN;
  constexpr int ROUNDS = (PX * 8 + NT16 - 1) / NT16;  // staged groups a thread
  static_assert(WM * 32 == BM, "warp grid");
  static_assert(ROUNDS * 8 <= 64, "one bit a value of a thread's groups");
  extern __shared__ __align__(128) unsigned char smem[];
  const int n_buf = P.n_cc > 1 ? 2 : 1;
  unsigned char* in_s = smem;                   // [n_buf][PX][128 B] staged
  unsigned char* act_s = in_s + n_buf * PX * 128;   // [PX][128 B] with act
  unsigned char* w_s = act_s + (ACT ? PX * 128 : 0);       // [3][BN][128 B]
  float* red = reinterpret_cast<float*>(w_s + WSTAGES * BN * 128);  // [4 NT16]
  float* a_s = red + 4 * NT16;                             // act coefficients
  float* b_s = a_s + P.n_cc * KCH;

  // this block's plane, batch item and tile
  const int bid = blockIdx.x;
  const int pi = (P.n_planes > 2 && bid >= P.p[2].blk0)   ? 2
                 : (P.n_planes > 1 && bid >= P.p[1].blk0) ? 1
                                                          : 0;
  const ConvPlane pl = pi == 2 ? P.p[2] : (pi == 1 ? P.p[1] : P.p[0]);
  const int H = pl.H, W = pl.W, HW = H * W, C = P.C, Co = P.Co;
  const int local = bid - pl.blk0;
  const int b = local / pl.n_tiles, tile = local - b * pl.n_tiles;
  const int ty = tile / pl.tiles_w;
  const int h0 = ty * TH, w0 = (tile - ty * pl.tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const __nv_bfloat16* xb = pl.x + (size_t)b * HW * C;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wm = warp / WN, wn = warp % WN;
  const int g = tid & 7;   // the 16-byte channel group this thread stages

  // staged group q (pixel q / 8, channels 8 (q % 8) ..): its byte offset
  // in a [PX][128 B] buffer, and whether the pixel lies in the plane (its
  // plane coordinates in h, w)
  auto group_at = [&](int q, bool& inside, int& h, int& w) {
    const int sp = q >> 3, sr = sp / SW;
    h = h0 - 1 + sr;
    w = w0 - 1 + sp - sr * SW;
    inside = h >= 0 && h < H && w >= 0 && w < W;
    return sp * 128 + ((g ^ (sp & 7)) << 4);
  };
  // Stage chunk cc into buffer cc % 2: thread tid takes the 16-byte
  // channel group g of every 32nd staged pixel, by cp.async; zero outside
  // the plane and past C.
  auto stage_input = [&](int cc) {
    unsigned char* buf = in_s + (cc & 1) * PX * 128;
    const int c = cc * KCH + g * 8;
    for (int q = tid; q < PX * 8; q += NT16) {
      bool inside;
      int h, w;
      unsigned char* dst = buf + group_at(q, inside, h, w);
      if (!inside || c >= C) {
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
        continue;
      }
      const __nv_bfloat16* src = xb + ((size_t)h * W + w) * C + c;
      if (P.vec_x && c + 8 <= C) {
        cp_async16(dst, src);
      } else {
        alignas(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = c + e < C ? src[e] : __float2bfloat16(0.0f);
        *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };
  // silu(x*A + B) of staged chunk cc into act_s, once per staged value,
  // rounded to bf16 exactly as act_f's value rounds: fast_act everywhere,
  // then act_f, from the staged value, where fast_act asks for it.  Halo
  // pixels and padding channels are written as zeros.
  auto act_pass = [&](int cc) {
    const unsigned char* src = in_s + (cc & 1) * PX * 128;
    const int c = cc * KCH + g * 8;
    float ca[8], cb[8];
#pragma unroll
    for (int e = 0; e < 8; e += 4) {
      *reinterpret_cast<float4*>(ca + e) =
          *reinterpret_cast<const float4*>(a_s + c + e);
      *reinterpret_cast<float4*>(cb + e) =
          *reinterpret_cast<const float4*>(b_s + c + e);
    }
    unsigned long long need = 0;   // bit 8 k + e: value e of round k
#pragma unroll 2
    for (int k = 0; k < ROUNDS; ++k) {
      const int q = tid + k * NT16;
      if (q >= PX * 8) break;
      bool inside;
      int h, w;
      const int off = group_at(q, inside, h, w);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (inside && c < C) {
        v = *reinterpret_cast<const uint4*>(src + off);
        __nv_bfloat162* hv = reinterpret_cast<__nv_bfloat162*>(&v);
        uint32_t m = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(hv[j]);
          bool e0, e1;
          const float r0 = fast_act(f.x, ca[2 * j], cb[2 * j], e0);
          const float r1 = fast_act(f.y, ca[2 * j + 1], cb[2 * j + 1], e1);
          m |= (e0 ? 1u << (2 * j) : 0u) | (e1 ? 2u << (2 * j) : 0u);
          hv[j] = __floats2bfloat162_rn(r0, r1);
        }
        need |= (unsigned long long)m << (8 * k);
      }
      *reinterpret_cast<uint4*>(act_s + off) = v;
    }
    // rare (well under 1 % of values): each lane takes its flagged values
    // in turn, all lanes with one left together, so a warp computes act_f
    // as often as its busiest lane needs it
    while (need) {
      const int bit = __ffsll(need) - 1;
      need &= need - 1;
      bool inside;
      int h, w;
      const int off =
          group_at(tid + (bit >> 3) * NT16, inside, h, w) + 2 * (bit & 7);
      const float x = bf(*reinterpret_cast<const __nv_bfloat16*>(src + off));
      *reinterpret_cast<__nv_bfloat16*>(act_s + off) = __float2bfloat16(
          act_f(x, a_s[c + (bit & 7)], b_s[c + (bit & 7)]));
    }
  };
  // weights of step i (chunk i/9, tap i%9): BN rows of 128 bytes into
  // ring stage i % 3, 16-byte groups swizzled by the row
  auto load_w = [&](int i) {
    const unsigned char* src = reinterpret_cast<const unsigned char*>(
        pl.w + ((size_t)i * P.co_pad + n0) * KCH);
    unsigned char* dst = w_s + (i % WSTAGES) * BN * 128;
#pragma unroll
    for (int k = 0; k < BN * 8 / NT16; ++k) {
      const int u = tid + k * NT16, n = u >> 3, gq = u & 7;
      cp_async16(dst + n * 128 + ((gq ^ (n & 7)) << 4), src + u * 16);
    }
  };

  // per-lane A rows: output pixel of row (lane & 15) of each 16-row tile,
  // as a staged pixel index at tap (0, 0); pixels past the plane's edge
  // repeat its last row or column (their outputs are dropped)
  int sp_c[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wm * 32 + mt * 16 + (lane & 15);
    const int h = min(h0 + r / TW, H - 1), w = min(w0 + r % TW, W - 1);
    sp_c[mt] = (h - h0 + 1) * SW + w - w0 + 1;
  }
  const int kg_a = lane >> 4;
  const int kg_b = (lane >> 3) & 1;
  int nb[2];
#pragma unroll
  for (int j = 0; j < 2; ++j)
    nb[j] = wn * 32 + j * 16 + ((lane >> 4) << 3) + (lane & 7);
  const uint32_t in_a0 = smem_u32(in_s), act_a0 = smem_u32(act_s);
  const uint32_t w_a = smem_u32(w_s);

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // step i = 9 cc + tap: issue the copies two steps ahead, then the tap's
  // products from chunk cc's tile (act_s with act)
  const int steps = P.n_cc * 9;
  auto step = [&](int i, int tap, int cc) {
    if (i + 2 < steps) load_w(i + 2);
    if (tap == 0 && cc + 1 < P.n_cc) stage_input(cc + 1);
    cp_async_commit();
    const int dsp = (tap / 3 - 1) * SW + (tap % 3 - 1);
    const uint32_t in_a = ACT ? act_a0 : in_a0 + (cc & 1) * PX * 128;
    const uint32_t ws = w_a + (i % WSTAGES) * BN * 128;
#pragma unroll
    for (int s = 0; s < KCH / 16; ++s) {
      uint32_t a[2][4], bq[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int sp = sp_c[mt] + dsp;
        ldmatrix_x4(a[mt][0], a[mt][1], a[mt][2], a[mt][3],
                    in_a + sp * 128 + (((2 * s + kg_a) ^ (sp & 7)) << 4));
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
        ldmatrix_x4(bq[j][0], bq[j][1], bq[j][2], bq[j][3],
                    ws + nb[j] * 128 + (((2 * s + kg_b) ^ (nb[j] & 7)) << 4));
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_bf16_16816(acc[mt][nt], a[mt], bq[nt / 2][(nt % 2) * 2],
                         bq[nt / 2][(nt % 2) * 2 + 1]);
    }
  };

  // cp.async groups: the prologue commits {chunk 0, w 0} and {w 1}; step
  // i commits {w i+2, and at tap 0 chunk cc+1}, so at step i every group
  // but the newest (w i+1) is complete: w i, and at tap 0 chunk cc.  With
  // act, chunk cc is activated into act_s at its tap 0 between two
  // barriers, before the tap loop.
  stage_input(0);
  load_w(0);
  cp_async_commit();
  if (steps > 1) load_w(1);
  cp_async_commit();
  if (ACT) {   // loaded while the copies above are in flight
    for (int c = tid; c < P.n_cc * KCH; c += NT16) {
      a_s[c] = c < C ? pl.act_a[(size_t)b * C + c] : 0.0f;
      b_s[c] = c < C ? pl.act_b[(size_t)b * C + c] : 0.0f;
    }
  }
  for (int cc = 0; cc < P.n_cc; ++cc) {
    cp_async_wait<1>();
    __syncthreads();   // and every warp is done with the step before
    if (ACT) {
      act_pass(cc);
      __syncthreads();
    }
    step(9 * cc, 0, cc);
    for (int tap = 1; tap < 9; ++tap) {
      cp_async_wait<1>();
      __syncthreads();
      step(9 * cc + tap, tap, cc);
    }
  }

  // epilogue: + bias + rollout border select + skip, one rounding, one
  // write; stats of the rounded outputs per column, reduced in a fixed
  // order (lanes, then warps along M)
  float s1[4][2], s2[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) s1[nt][e] = s2[nt][e] = 0.0f;
  const bool pair = (Co % 2) == 0;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = wm * 32 + mt * 16 + (lane >> 2) + hh * 8;
      const int h = h0 + r / TW, w = w0 + r % TW;
      if (h >= H || w >= W) continue;
      const int ch = h == 0 ? 0 : (h == H - 1 ? 2 : 1);
      const int cw = w == 0 ? 0 : (w == W - 1 ? 2 : 1);
      const size_t o = ((size_t)b * HW + (size_t)h * W + w) * Co;
      const __nv_bfloat16* colp =
          pl.col ? pl.col + (((size_t)b * W + w) * 3 + ch) * Co : nullptr;
      const __nv_bfloat16* rowp =
          pl.row ? pl.row + (((size_t)b * H + h) * 3 + cw) * Co : nullptr;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + wn * 32 + nt * 8 + 2 * (lane & 3);
        if (n >= Co) continue;
        float v[2] = {acc[mt][nt][hh * 2], acc[mt][nt][hh * 2 + 1]};
        const bool two = n + 1 < Co;
        if (pair) {
          if (pl.bias) {
            const float2 bb = *reinterpret_cast<const float2*>(pl.bias + n);
            v[0] += bb.x;
            v[1] += bb.y;
          }
          if (colp) {
            const __nv_bfloat162 q =
                *reinterpret_cast<const __nv_bfloat162*>(colp + n);
            v[0] += __low2float(q);
            v[1] += __high2float(q);
          }
          if (rowp) {
            const __nv_bfloat162 q =
                *reinterpret_cast<const __nv_bfloat162*>(rowp + n);
            v[0] += __low2float(q);
            v[1] += __high2float(q);
          }
          if (pl.skip) {
            const __nv_bfloat162 q =
                *reinterpret_cast<const __nv_bfloat162*>(pl.skip + o + n);
            v[0] += __low2float(q);
            v[1] += __high2float(q);
          }
          const __nv_bfloat162 yr = __floats2bfloat162_rn(v[0], v[1]);
          *reinterpret_cast<__nv_bfloat162*>(pl.y + o + n) = yr;
          v[0] = __low2float(yr);
          v[1] = __high2float(yr);
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (e == 1 && !two) break;
            if (pl.bias) v[e] += pl.bias[n + e];
            if (colp) v[e] += bf(colp[n + e]);
            if (rowp) v[e] += bf(rowp[n + e]);
            if (pl.skip) v[e] += bf(pl.skip[o + n + e]);
            const __nv_bfloat16 yr = __float2bfloat16(v[e]);
            pl.y[o + n + e] = yr;
            v[e] = bf(yr);
          }
        }
        s1[nt][0] += v[0];
        s2[nt][0] += v[0] * v[0];
        if (two) {
          s1[nt][1] += v[1];
          s2[nt][1] += v[1] * v[1];
        }
      }
    }
  if (pl.stats) {  // uniform over the block
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s1[nt][e] += __shfl_xor_sync(0xffffffffu, s1[nt][e], off);
          s2[nt][e] += __shfl_xor_sync(0xffffffffu, s2[nt][e], off);
        }
    if (lane < 4) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int cn = wn * 32 + nt * 8 + 2 * lane + e;
          red[(wm * 2) * BN + cn] = s1[nt][e];
          red[(wm * 2 + 1) * BN + cn] = s2[nt][e];
        }
    }
    __syncthreads();
    if (tid < BN) {   // padding columns write zeros
      float a1 = 0.0f, a2 = 0.0f;
#pragma unroll
      for (int k = 0; k < WM; ++k) {
        a1 += red[(k * 2) * BN + tid];
        a2 += red[(k * 2 + 1) * BN + tid];
      }
      float* out =
          pl.part + (((size_t)b * pl.n_tiles + tile) * 2) * P.co_pad;
      out[n0 + tid] = a1;
      out[P.co_pad + n0 + tid] = a2;
      __threadfence();   // the partial is visible before the count
    }
    // the last block of (plane, item, column block) to finish sums every
    // tile's partial in tile order: no atomics on the values, the same
    // bits every run; the counters are this launch's own
    __shared__ int is_last;
    __syncthreads();
    if (tid == 0)
      is_last = atomicAdd(pl.cnt + b * gridDim.y + blockIdx.y, 1) ==
                pl.n_tiles - 1;
    __syncthreads();
    if (is_last) {  // uniform over the block
      // float4 slots of the [2, BN] partials, NF threads a slot, each
      // summing every NF-th tile in order, then the NF sums in order: the
      // same order, so the same bits, every run
      constexpr int SLOTS = BN / 2, NF = NT16 / SLOTS;
      const int slot = tid % SLOTS, pt = tid / SLOTS;
      const int row = slot / (BN / 4), c4 = (slot % (BN / 4)) * 4;
      const float* pp = pl.part +
                        ((size_t)b * pl.n_tiles * 2 + row) * P.co_pad + n0 +
                        c4;
      float4 t = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int k = pt; k < pl.n_tiles; k += NF) {
        const float4 v = __ldcg(
            reinterpret_cast<const float4*>(pp + (size_t)k * 2 * P.co_pad));
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
      float4* red4 = reinterpret_cast<float4*>(red);
      red4[pt * SLOTS + slot] = t;
      __syncthreads();
      if (tid < SLOTS) {
        float4 u = red4[slot];
#pragma unroll
        for (int k = 1; k < NF; ++k) {
          const float4 v = red4[k * SLOTS + slot];
          u.x += v.x;
          u.y += v.y;
          u.z += v.z;
          u.w += v.w;
        }
        const float q[4] = {u.x, u.y, u.z, u.w};
        float* out = pl.stats + ((size_t)b * 2 + row) * Co + n0 + c4;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (n0 + c4 + e < Co) out[e] = q[e];
      }
    }
  }
}

int bf16_block_n(int Co) { return Co <= 64 ? 64 : 128; }

template <int BN>
int n_tiles(int H, int W, int* tiles_w = nullptr) {
  const int tw = (W + Tile<BN>::TW - 1) / Tile<BN>::TW;
  if (tiles_w) *tiles_w = tw;
  return (H + TH - 1) / TH * tw;
}

template <int BN>
size_t smem_bytes(int n_cc, bool act) {
  return ((n_cc > 1 ? 2 : 1) + (act ? 1 : 0)) * Tile<BN>::PX * 128 +
         WSTAGES * BN * 128 + sizeof(float) * (4 * NT16 + 2 * n_cc * KCH);
}

// Fill the plane table from the pointer and size arrays and launch.
template <int BN>
int launch_bf16(const void* const* ptrs, const int* hw, int n_planes, int B,
                int C, int Co, int* cnt, cudaStream_t st) {
  ConvPlanes P;
  P.n_planes = n_planes;
  P.C = C;
  P.Co = Co;
  P.n_cc = (C + KCH - 1) / KCH;
  P.co_pad = (Co + BN - 1) / BN * BN;
  P.vec_x = C % 8 == 0;
  int blk = 0;
  for (int i = 0; i < n_planes; ++i) {
    ConvPlane& q = P.p[i];
    const void* const* pp = ptrs + 11 * i;
    q.x = static_cast<const __nv_bfloat16*>(pp[0]);
    q.w = static_cast<const __nv_bfloat16*>(pp[1]);
    q.bias = static_cast<const float*>(pp[2]);
    q.col = static_cast<const __nv_bfloat16*>(pp[3]);
    q.row = static_cast<const __nv_bfloat16*>(pp[4]);
    q.act_a = static_cast<const float*>(pp[5]);
    q.act_b = static_cast<const float*>(pp[6]);
    q.skip = static_cast<const __nv_bfloat16*>(pp[7]);
    q.y = static_cast<__nv_bfloat16*>(const_cast<void*>(pp[8]));
    q.stats = static_cast<float*>(const_cast<void*>(pp[9]));
    q.part = static_cast<float*>(const_cast<void*>(pp[10]));
    q.cnt = cnt ? cnt + i * B * (P.co_pad / BN) : nullptr;
    if (q.stats && (!q.part || !cnt)) return (int)cudaErrorInvalidValue;
    if ((uintptr_t)q.x % 16) P.vec_x = 0;
    q.H = hw[2 * i];
    q.W = hw[2 * i + 1];
    if (q.H < 1 || q.W < 1) return (int)cudaErrorInvalidValue;
    q.n_tiles = n_tiles<BN>(q.H, q.W, &q.tiles_w);
    q.blk0 = blk;
    blk += B * q.n_tiles;
  }
  const bool act = P.p[0].act_a != nullptr;
  for (int i = 1; i < n_planes; ++i)
    if ((P.p[i].act_a != nullptr) != act ||
        (P.p[i].stats != nullptr) != (P.p[0].stats != nullptr))
      return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes<BN>(P.n_cc, act);
  const auto kernel =
      act ? conv3x3_bf16_kernel<BN, true> : conv3x3_bf16_kernel<BN, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (P.p[0].stats) {
    err = cudaMemsetAsync(cnt, 0, sizeof(int) * n_planes * B * (P.co_pad / BN),
                          st);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(blk, P.co_pad / BN);
  kernel<<<grid, NT16, smem, st>>>(P);
  return (int)cudaGetLastError();
}

}  // namespace

// bf16: the tiles of an H x W plane (its stats partials per batch item)
// for Co output channels; a block takes bf16_block_n(Co) of them
// (ops/fused_conv.py:block_n).
extern "C" int sin3dm_conv3x3_bf16_tiles(int H, int W, int Co) {
  return bf16_block_n(Co) == 64 ? n_tiles<64>(H, W) : n_tiles<128>(H, W);
}

// bf16: plain C entry point (bound with ctypes), one launch over
// n_planes <= 3 planes with the same B, C, Co.  ptrs holds per plane: x,
// packed w (ceil(C/64) chunks or more), b, col, row, act_a, act_b, skip,
// y, stats, part (each nullable as the fp32 entry point says; stats is
// given for every plane or none, and with it the scratch part [B,
// sin3dm_conv3x3_bf16_tiles(H, W, Co), 2, Co_pad], 16-byte aligned); hw
// holds H, W per plane.  With stats, cnt is the launch's own scratch of
// n_planes * B * Co_pad / block_n(Co) int32 counters, which this zeroes
// on `stream` before the launch.  Launches on `stream`, does not
// synchronise, returns the cudaError_t.
extern "C" int sin3dm_conv3x3_bf16(const void* const* ptrs, const int* hw,
                                   int n_planes, int B, int C, int Co,
                                   int* cnt, void* stream) {
  if (n_planes < 1 || n_planes > 3 || B < 1 || C < 1 || Co < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bf16_block_n(Co) == 64
             ? launch_bf16<64>(ptrs, hw, n_planes, B, C, Co, cnt, st)
             : launch_bf16<128>(ptrs, hw, n_planes, B, C, Co, cnt, st);
}

// fp32: output pixels per block: `stats` holds ceil(H*W / this) partials
// per batch item.
extern "C" int sin3dm_conv3x3_rows_per_block() { return BM; }

// fp32: plain C entry point (bound with ctypes).  b is fp32 [Co] or null;
// col/row null for a plain conv; act_a/act_b fp32 [B, C] or null; skip
// null or [B, H, W, Co]; stats null or fp32 [B, ceil(H*W/64), 2, Co],
// every entry written.  Launches on `stream`, does not synchronise,
// returns the launch's cudaError_t.
extern "C" int sin3dm_conv3x3_rollout(const void* x, const void* w,
                                      const float* b, const void* col,
                                      const void* row, const float* act_a,
                                      const float* act_b, const void* skip,
                                      void* y, float* stats, int B, int H,
                                      int W, int C, int Co, void* stream) {
  return launch<float, SimtF32>(x, w, b, col, row, act_a, act_b, skip, y,
                                stats, B, H, W, C, Co,
                                static_cast<cudaStream_t>(stream));
}
