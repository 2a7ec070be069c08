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
// Design.  The TPU kernel keeps all weights (~0.6 MB) resident in VMEM;
// a Hopper block has 227 KB of shared memory.  bf16 (the decode's
// default): one persistent block per SM walks 128-row tiles.  Two
// consumer warpgroups own 64 rows each and keep their bf16 x tile and
// their [64, 256] activation h in shared memory through the whole head;
// each layer is a chain of wgmma m64n256k16 (m64n8k16 for a last layer of
// at most 8 columns) with A = that shared tile and B = a weight chunk,
// the fp32 sum in registers (128 a thread).  One producer thread streams
// every layer's weights, packed once on the host in the wgmma layout, as
// 64-row chunks (32 KB) through a 4-stage ring of bulk copies guarded by
// mbarriers, so loads overlap the products; a chunk's stage is released
// as soon as the next chunk's products are issued.  The skip layer is two
// K runs, over x then over h: the concat is never built.  Bias and ReLU
// are applied in registers, rounded to bf16 into the warpgroup's own
// rows of h; the last layer's valid columns go to `out` in fp32.  Only x
// is read and only out is written in device memory; every 128-row tile
// re-reads the head's weights from L2 (~0.6 MB).  fp32 (not on the main
// path): a block owns a 64-row tile, weights stream through shared
// memory in 32-row K-chunks, fp32 FMAs, 8x8 outputs per thread.
//
// Bound on the H100: operations.  The towerruins heads (64->256x3,
// 320->256->256->cout) cost ~1.18 MFLOP per grid point for both heads:
// 0.450 ms per x-slab of 8 x 256 x 184 points at 989 TFLOP/s bf16 dense.

#include "hopper.cuh"

namespace {

constexpr int TM = 64;    // fp32: rows per block
constexpr int NTH = 256;  // fp32: threads per block (8 warps)

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

// ------------------------------------------------------------------ bf16
// Weights arrive as a sequence of chunks, each at most 64 K rows of one
// layer and one source (x or h), packed by ops/fused_mlp.py:
// pack_mlp_weights in the wgmma B layout, so one bulk copy moves a chunk.
// Table row (int32 x 8): layer, src (0 x tile, 1 h tile), k0 within the
// source, kc (K rows, a multiple of 16), byte offset / 16 into the
// packed weights, npad (8 or 256 columns), flags (1 first chunk of its
// layer, 2 last chunk, 4 last layer, 8 the last layer that reads x),
// unused.
constexpr int TAB = 8;
constexpr int TM2 = 128;           // rows per tile: 2 warpgroups x 64
constexpr int NH = 256;            // N of every layer but a narrow last one
constexpr int STAGE = 64 * NH * 2; // bytes of one ring stage
constexpr int NTH2 = 384;          // 2 consumer warpgroups + producer
constexpr int MAX_SMEM = 232448;   // opt-in shared memory of an H100 block

// element idx of a warpgroup's 64 x cin fp32 x rows, 4 at a time, as bf16
// into its tile in the core-matrix layout: (r, k) at byte
// ((r/8)(cin/8) + k/8) 128 + (r%8) 16 + (k%8) 2
__device__ __forceinline__ void put_x(unsigned char* xw, int idx, int cin,
                                      float4 v) {
  const int vpr = cin / 4;
  if (idx >= 64 * vpr) return;
  const int r = idx / vpr, k = (idx % vpr) * 4;
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 pk;
  pk.x = *reinterpret_cast<uint32_t*>(&lo);
  pk.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(xw + ((r / 8) * (cin / 8) + k / 8) * 128 +
                            (r % 8) * 16 + (k % 8) * 2) = pk;
}

__global__ void __launch_bounds__(NTH2, 1)
mlp_bf16_kernel(const float* __restrict__ x,
                const unsigned char* __restrict__ wts,
                const float* __restrict__ bias, const int* __restrict__ tab,
                int n_chunks, int n_layers, float* __restrict__ out,
                int n_rows, int cin, int cout, int n_stages) {
  using namespace hopper;
  extern __shared__ __align__(128) unsigned char smem2[];
  const int x_bytes = 64 * cin * 2;          // one warpgroup's x tile
  unsigned char* xs = smem2;                  // [2][64 x cin] bf16
  unsigned char* hs = smem2 + 2 * x_bytes;    // [2][64 x 256] bf16
  float* bs = reinterpret_cast<float*>(hs + 2 * 64 * NH * 2);  // [L][256]
  unsigned char* st = reinterpret_cast<unsigned char*>(bs + n_layers * NH);
  uint64_t* full = reinterpret_cast<uint64_t*>(st + n_stages * STAGE);
  uint64_t* empty = full + n_stages;

  const int tid = threadIdx.x;
  const int n_tiles = (n_rows + TM2 - 1) / TM2;
  // this block's tiles are blockIdx.x + i gridDim.x; chunk g of its
  // sequence is chunk g % n_chunks of tile g / n_chunks, in stage
  // g % n_stages
  const int n_mine = (n_tiles - blockIdx.x + gridDim.x - 1) / gridDim.x;
  const int n_seq = n_mine * n_chunks;
  auto issue = [&](int g) {   // chunk g into its stage
    const int* row = tab + (g % n_chunks) * TAB;
    const uint32_t bytes = (uint32_t)row[3] * row[5] * 2;
    const int s = g % n_stages;
    mbar_arrive_expect_tx(&full[s], bytes);
    bulk_g2s(st + s * STAGE, wts + (size_t)row[4] * 16, bytes, &full[s]);
  };

  for (int i = tid; i < n_layers * NH; i += NTH2) bs[i] = bias[i];
  if (tid == 0) {
    for (int s = 0; s < n_stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);   // one arrival per consumer warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = tid / 128;
  if (wg == 2) {
    // producer: one thread streams the chunk sequence through the ring;
    // the warpgroup's registers go to the consumers
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 256)
      for (int g = 0; g < n_seq; ++g) {
        mbar_wait(&empty[g % n_stages], ((g / n_stages) & 1) ^ 1);
        issue(g);
      }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  // consumers: warpgroup wg owns rows [64 wg, 64 wg + 64) of each tile
  const int wtid = tid % 128, warp = wtid / 32;
  const int lane = tid % 32;
  unsigned char* xw = xs + wg * x_bytes;
  unsigned char* hw = hs + wg * 64 * NH * 2;
  const uint32_t xw_a = smem_u32(xw), hw_a = smem_u32(hw);
  const uint32_t st_a = smem_u32(st);
  const int r0 = warp * 16 + lane / 4;   // this thread's rows r0, r0 + 8
  const int cq = 2 * (lane % 4);         // and columns 8j + cq, + 1
  // byte offset of (r0, 8j + cq) in the h tile (core-matrix layout)
  const int h_off = (r0 / 8) * (NH * 16) + (r0 % 8) * 16 + cq * 2;
  float acc[128], acc8[4];   // N = 256 layers; a last layer of N = 8
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) acc8[i] = 0.0f;

  // chunk g's products are done: its stage may be refilled
  auto release = [&](int g) {
    if (wtid == 0) mbar_arrive(&empty[g % n_stages]);
  };

  // x rows -> bf16 tile (put_x).  At cin <= 64 a thread's share of the
  // next tile's rows (8 float4) is fetched into registers once the skip
  // layer has read this tile's x, so its load overlaps the last layers'
  // products.
  const int vpr = cin / 4;
  float4 xpf[8];
  bool fetched = false;

  int g = 0;  // this block's chunk sequence number
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int row0 = t * TM2 + wg * 64;
    if (cin <= 64) {
      if (!fetched) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = wtid + 128 * i, r = idx / vpr, k = (idx % vpr) * 4;
          xpf[i] = idx < 64 * vpr && row0 + r < n_rows
                       ? __ldg(reinterpret_cast<const float4*>(
                             x + (size_t)(row0 + r) * cin + k))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) put_x(xw, wtid + 128 * i, cin, xpf[i]);
      fetched = false;
    } else {
      for (int idx = wtid; idx < 64 * vpr; idx += 128) {
        const int r = idx / vpr, k = (idx % vpr) * 4;
        put_x(xw, idx, cin,
              row0 + r < n_rows ? __ldg(reinterpret_cast<const float4*>(
                                      x + (size_t)(row0 + r) * cin + k))
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f));
      }
    }
    fence_proxy_async();
    named_bar_sync(1 + wg, 128);

    for (int c = 0; c < n_chunks; ++c, ++g) {
      const int4 ta = __ldg(reinterpret_cast<const int4*>(tab + c * TAB));
      const int4 tb = __ldg(reinterpret_cast<const int4*>(tab + c * TAB + 4));
      const int layer = ta.x, src = ta.y, k0 = ta.z, kc = ta.w;
      const int npad = tb.y, flags = tb.z;
      const int stage = g % n_stages;
      const uint32_t a_base = (src == 0 ? xw_a : hw_a) + (k0 / 8) * 128;
      const uint32_t a_sbo = (src == 0 ? cin : NH) * 16;
      const uint32_t b_base = st_a + stage * STAGE;
      mbar_wait(&full[stage], (g / n_stages) & 1);
      fence_regs<128>(acc);
      fence_regs<4>(acc8);
      wgmma_fence();
      for (int s = 0; s < kc / 16; ++s) {
        const uint64_t da = wgmma_desc(a_base + s * 256, 128, a_sbo);
        const uint64_t db = wgmma_desc(b_base + s * 256, 128, kc * 16);
        const int scale_d = (s == 0 && (flags & 1)) ? 0 : 1;
        if (npad == NH)
          wgmma_m64n256k16(acc, da, db, scale_d);
        else
          wgmma_m64n8k16(acc8, da, db, scale_d);
      }
      wgmma_commit();
      fence_regs<128>(acc);
      fence_regs<4>(acc8);
      if (!(flags & 2)) {
        // chunk g - 1's products are done (g's may still run)
        wgmma_wait<1>();
        if (!(flags & 1)) release(g - 1);
        continue;
      }
      wgmma_wait<0>();
      fence_regs<128>(acc);
      fence_regs<4>(acc8);
      if (!(flags & 1)) release(g - 1);
      release(g);

      if ((flags & 8) && cin <= 64 && t + (int)gridDim.x < n_tiles) {
        const int next0 = row0 + gridDim.x * TM2;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int idx = wtid + 128 * i, r = idx / vpr, k = (idx % vpr) * 4;
          xpf[i] = idx < 64 * vpr && next0 + r < n_rows
                       ? __ldg(reinterpret_cast<const float4*>(
                             x + (size_t)(next0 + r) * cin + k))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
        fetched = true;
      }
      const float* bl = bs + layer * NH;
      if (!(flags & 4)) {
        // hidden layer: + bias, ReLU, bf16 into this warpgroup's h rows
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(bl + 8 * j + cq);
          __nv_bfloat162 top = __floats2bfloat162_rn(
              fmaxf(acc[4 * j] + b.x, 0.0f),
              fmaxf(acc[4 * j + 1] + b.y, 0.0f));
          __nv_bfloat162 bot = __floats2bfloat162_rn(
              fmaxf(acc[4 * j + 2] + b.x, 0.0f),
              fmaxf(acc[4 * j + 3] + b.y, 0.0f));
          *reinterpret_cast<__nv_bfloat162*>(hw + h_off + j * 128) = top;
          *reinterpret_cast<__nv_bfloat162*>(hw + h_off + NH * 16 + j * 128) =
              bot;
        }
        fence_proxy_async();
        named_bar_sync(1 + wg, 128);
      } else {
        // last layer: + bias, fp32 straight to out, valid columns only
        const int ga = row0 + r0, gb = ga + 8;
        if (npad == NH) {
#pragma unroll
          for (int j = 0; j < 32; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int col = 8 * j + cq + e;
              if (col < cout) {
                if (ga < n_rows)
                  out[(size_t)ga * cout + col] = acc[4 * j + e] + bl[col];
                if (gb < n_rows)
                  out[(size_t)gb * cout + col] = acc[4 * j + 2 + e] + bl[col];
              }
            }
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = cq + e;
            if (col < cout) {
              if (ga < n_rows) out[(size_t)ga * cout + col] = acc8[e] + bl[col];
              if (gb < n_rows)
                out[(size_t)gb * cout + col] = acc8[2 + e] + bl[col];
            }
          }
        }
      }
    }
  }
}

// ------------------------------------------------------------------ fp32
__device__ __forceinline__ int round16(int v) { return (v + 15) / 16 * 16; }

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

// fp32: plain C entry point (bound with ctypes).  wts holds every
// layer's [K, N] fp32 weight row-major in layer order (first...,
// second...); bias every layer's [N] fp32 bias.  Launches on `stream`,
// does not synchronise, returns the cudaError_t.
extern "C" int sin3dm_skip_mlp_f32(const float* x, const float* wts,
                                   const float* bias, float* out, int n_rows,
                                   int cin, int hid, int cout, int n_first,
                                   int n_second, void* stream) {
  const int NW = ((hid > cout ? hid : cout) + 15) / 16 * 16;
  const size_t smem = (size_t)(TM * cin + TM * hid + KC_F32 * NW) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  mlp_f32_kernel<<<(n_rows + TM - 1) / TM, NTH, smem,
                   static_cast<cudaStream_t>(stream)>>>(
      x, wts, bias, out, n_rows, cin, hid, cout, n_first, n_second);
  return (int)cudaGetLastError();
}

// Ring stages the bf16 kernel uses for an input width of `cin` and
// `n_layers` layers (0: they do not fit in shared memory).
static int bf16_stages(int cin, int n_layers) {
  const long fixed = 2L * 64 * cin * 2 + 2L * 64 * NH * 2 +
                     (long)n_layers * NH * 4;
  const long n = (MAX_SMEM - 256 - fixed) / STAGE;
  return n < 2 ? 0 : (n > 4 ? 4 : (int)n);
}

// bf16: plain C entry point (bound with ctypes).  wts, bias [n_layers,
// 256] and tab [n_chunks, 8] as ops/fused_mlp.py:pack_mlp_weights makes them;
// x fp32 [n_rows, cin] 16-byte aligned; out fp32 [n_rows, cout].  One
// persistent block per SM (at most one per 128-row tile).  Launches on
// `stream`, does not synchronise, returns the cudaError_t.
extern "C" int sin3dm_skip_mlp_bf16(const float* x, const void* wts,
                                    const float* bias, const int* tab,
                                    int n_chunks, int n_layers, float* out,
                                    int n_rows, int cin, int cout,
                                    void* stream) {
  // the current device's SM count: the wrapper makes the input's card
  // current, and cards of one host may differ
  int dev = 0, n_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_stages = bf16_stages(cin, n_layers);
  if (n_stages == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = 2L * 64 * cin * 2 + 2L * 64 * NH * 2 +
                      (size_t)n_layers * NH * 4 + (size_t)n_stages * STAGE +
                      n_stages * 16;
  err = cudaFuncSetAttribute(
      mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (n_rows + TM2 - 1) / TM2;
  mlp_bf16_kernel<<<n_tiles < n_sm ? n_tiles : n_sm, NTH2, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<const unsigned char*>(wts), bias, tab, n_chunks,
      n_layers, out, n_rows, cin, cout, n_stages);
  return (int)cudaGetLastError();
}
