// First-party geometry kernels for sin3dm_tpu (C++17, no external deps).
//
// Replaces the reference's native dependency stack (SURVEY.md §2.2):
//   PyMCubes            -> mc_* (marching cubes, runtime-generated tables)
//   point_cloud_utils   -> bvh_* (closest point, fast winding number, SDF),
//                          cc_* (connected components)
//   open3d decimation   -> dec_* (quadric edge-collapse)
//   nvdiffrast UV bake  -> raster_uv (CPU barycentric rasterizer)
//
// Exposed as a plain C ABI consumed via ctypes (geometry/__init__.py).
// All buffers are caller-visible malloc'd arrays freed with geo_free().

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <limits>
#include <queue>
#include <unordered_map>
#include <vector>

#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// ---------------------------------------------------------------------------
// Marching cubes with runtime-generated triangulation tables.
//
// Corner layout: 0=(0,0,0) 1=(1,0,0) 2=(1,1,0) 3=(0,1,0)
//                4=(0,0,1) 5=(1,0,1) 6=(1,1,1) 7=(0,1,1)
// Edge layout (12): see kEdges.  A cell config bit c is set iff corner c is
// "inside" (value < iso).  Tables are generated by tracing iso-polygon loops
// on the cube faces with a fixed, neighbor-consistent ambiguity rule
// (pair each inside->outside boundary crossing with the next
// outside->inside crossing walking the face CCW-from-outside), which makes
// the extracted surface watertight by construction.
// ---------------------------------------------------------------------------

const int kCorners[8][3] = {{0, 0, 0}, {1, 0, 0}, {1, 1, 0}, {0, 1, 0},
                            {0, 0, 1}, {1, 0, 1}, {1, 1, 1}, {0, 1, 1}};
const int kEdges[12][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0},
                           {4, 5}, {5, 6}, {6, 7}, {7, 4},
                           {0, 4}, {1, 5}, {2, 6}, {3, 7}};
// Faces as 4 corners, CCW viewed from outside the cube.
const int kFaces[6][4] = {{0, 3, 2, 1},   // z=0
                          {4, 5, 6, 7},   // z=1
                          {0, 1, 5, 4},   // y=0
                          {2, 3, 7, 6},   // y=1
                          {0, 4, 7, 3},   // x=0
                          {1, 2, 6, 5}};  // x=1

struct MCTables {
  // For each of 256 configs: triangle list of edge indices, -1 terminated.
  int tri[256][40];
  int ntri[256];
};

int edge_index(int a, int b) {
  for (int e = 0; e < 12; ++e) {
    if ((kEdges[e][0] == a && kEdges[e][1] == b) ||
        (kEdges[e][0] == b && kEdges[e][1] == a))
      return e;
  }
  return -1;
}

MCTables build_mc_tables() {
  MCTables t;
  for (int config = 0; config < 256; ++config) {
    bool inside[8];
    for (int c = 0; c < 8; ++c) inside[c] = (config >> c) & 1;

    // directed segments between crossing edges: seg_from[e] = next edge
    int seg_next[12];
    for (int e = 0; e < 12; ++e) seg_next[e] = -1;

    for (int f = 0; f < 6; ++f) {
      const int* fc = kFaces[f];
      // boundary crossings in CCW order
      int cross_edge[4], cross_dir[4], ncross = 0;  // dir: 1 = in->out
      for (int i = 0; i < 4; ++i) {
        int a = fc[i], b = fc[(i + 1) % 4];
        if (inside[a] != inside[b]) {
          cross_edge[ncross] = edge_index(a, b);
          cross_dir[ncross] = inside[a] ? 1 : 0;
          ++ncross;
        }
      }
      // pair each in->out with the NEXT out->in (cyclic)
      for (int i = 0; i < ncross; ++i) {
        if (cross_dir[i] != 1) continue;
        for (int j = 1; j <= ncross; ++j) {
          int k = (i + j) % ncross;
          if (cross_dir[k] == 0) {
            seg_next[cross_edge[i]] = cross_edge[k];
            break;
          }
        }
      }
    }

    // trace cycles, fan-triangulate
    int n = 0;
    bool used[12] = {false};
    for (int e0 = 0; e0 < 12; ++e0) {
      if (seg_next[e0] < 0 || used[e0]) continue;
      int loop[12], len = 0;
      int e = e0;
      while (!used[e]) {
        used[e] = true;
        loop[len++] = e;
        e = seg_next[e];
      }
      // fan order flipped so triangle normals point OUTWARD (away from the
      // negative/inside region) — validated by the sphere orientation test
      for (int i = 1; i + 1 < len; ++i) {
        t.tri[config][n++] = loop[0];
        t.tri[config][n++] = loop[i + 1];
        t.tri[config][n++] = loop[i];
      }
    }
    t.tri[config][n] = -1;
    t.ntri[config] = n / 3;
  }
  return t;
}

const MCTables& mc_tables() {
  static MCTables t = build_mc_tables();
  return t;
}

inline int64_t edge_key(int i, int j, int k, int axis, int ny, int nz) {
  // canonical key of the cube edge starting at lattice point (i,j,k) along
  // axis (0=x,1=y,2=z)
  return ((int64_t)((i * (int64_t)ny + j) * nz + k)) * 3 + axis;
}

// Edge->vertex dedup shared by the dense and sparse marching-cubes entry
// points: per-corner (edge key, position) streams in, welded vertex/tri
// arrays out.  Edge keys are dense ints < key_space and arrive in
// near-sorted order, so a direct-mapped array gets one mostly-cache-local
// access per corner — measurably faster than any hash at the ~8M-lookup
// scale of a 256^3 extract.  Falls back to open addressing if the direct
// map would be unreasonably large.
void dedup_edges(const std::vector<std::vector<int64_t>>& keys_t,
                 const std::vector<std::vector<float>>& pos_t,
                 int64_t key_space, float** out_verts, int* out_nv,
                 int** out_tris, int* out_nt) {
  size_t n_corners = 0;
  for (auto& kv : keys_t) n_corners += kv.size();

  std::vector<float> verts;
  std::vector<int> tris;
  verts.reserve(n_corners);  // ~n_corners/3 verts x 3 floats
  tris.reserve(n_corners);

  if (key_space <= (int64_t)1 << 28) {  // <= 1 GiB of int32
    std::vector<int> edge_vert((size_t)key_space, -1);
    for (size_t t = 0; t < keys_t.size(); ++t) {
      const auto& keys = keys_t[t];
      const auto& pos = pos_t[t];
      for (size_t c = 0; c < keys.size(); ++c) {
        int& vi = edge_vert[(size_t)keys[c]];
        if (vi < 0) {
          vi = (int)(verts.size() / 3);
          verts.push_back(pos[3 * c]);
          verts.push_back(pos[3 * c + 1]);
          verts.push_back(pos[3 * c + 2]);
        }
        tris.push_back(vi);
      }
    }
  } else {
    size_t cap = 64;
    while (cap < n_corners * 2) cap <<= 1;
    std::vector<int64_t> hkeys(cap, -1);
    std::vector<int> hvals(cap);
    const size_t hmask = cap - 1;
    auto hash64 = [](uint64_t x) -> uint64_t {  // splitmix64 finalizer
      x += 0x9e3779b97f4a7c15ULL;
      x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ULL;
      x = (x ^ (x >> 27)) * 0x94d049bb133111ebULL;
      return x ^ (x >> 31);
    };
    for (size_t t = 0; t < keys_t.size(); ++t) {
      const auto& keys = keys_t[t];
      const auto& pos = pos_t[t];
      for (size_t c = 0; c < keys.size(); ++c) {
        int64_t key = keys[c];
        size_t slot = hash64((uint64_t)key) & hmask;
        while (hkeys[slot] != -1 && hkeys[slot] != key)
          slot = (slot + 1) & hmask;
        int vi;
        if (hkeys[slot] == -1) {
          vi = (int)(verts.size() / 3);
          hkeys[slot] = key;
          hvals[slot] = vi;
          verts.push_back(pos[3 * c]);
          verts.push_back(pos[3 * c + 1]);
          verts.push_back(pos[3 * c + 2]);
        } else {
          vi = hvals[slot];
        }
        tris.push_back(vi);
      }
    }
  }

  *out_nv = (int)(verts.size() / 3);
  *out_nt = (int)(tris.size() / 3);
  *out_verts = (float*)malloc(verts.size() * sizeof(float));
  *out_tris = (int*)malloc(tris.size() * sizeof(int));
  memcpy(*out_verts, verts.data(), verts.size() * sizeof(float));
  memcpy(*out_tris, tris.data(), tris.size() * sizeof(int));
}

}  // namespace

extern "C" {

void geo_free(void* p) { free(p); }

// grid: [nx, ny, nz] C-order floats. Extract isosurface at `iso`.
// Vertices are in index space (like PyMCubes). Returns 0 on success.
//
// Two phases: (A) OpenMP-parallel over x-slabs — each thread emits, per
// triangle corner, the global edge key + interpolated position (corners
// shared between cells are computed redundantly; that is cheaper than
// synchronizing); (B) serial dedup of edge keys into the final vertex
// array.  Output is deterministic (slab order).
//
// Empty space is skipped with bit-packed sign masks: per lattice row
// (i,j) a bitset of (value < iso) along k; a cell is active iff its 8
// corner bits are not all equal, evaluated 64 cells at a time with
// AND/OR + shift words.  On clamped TSDFs >90% of cells die here without
// ever touching the triangulation tables — this is what makes a 256^3
// extract fast on a single core.
int geo_marching_cubes(const float* grid, int nx, int ny, int nz, float iso,
                       float** out_verts, int* out_nv,
                       int** out_tris, int* out_nt) {
  const MCTables& T = mc_tables();

  auto gval = [&](int i, int j, int k) -> float {
    return grid[((int64_t)i * ny + j) * nz + k];
  };

  const int nw = (nz + 63) / 64;  // sign-mask words per row

  int n_threads = 1;
#if defined(_OPENMP)
  n_threads = std::max(1, omp_get_max_threads());
#endif
  std::vector<std::vector<int64_t>> keys_t(n_threads);
  std::vector<std::vector<float>> pos_t(n_threads);

#pragma omp parallel num_threads(n_threads)
  {
#if defined(_OPENMP)
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    auto& keys = keys_t[tid];
    auto& pos = pos_t[tid];

    // rolling sign masks for lattice planes i and i+1 (ny rows x nw words)
    std::vector<uint64_t> mask_a((size_t)ny * nw), mask_b((size_t)ny * nw);
    auto pack_plane = [&](int i, uint64_t* dst) {
      for (int j = 0; j < ny; ++j) {
        const float* row = grid + ((int64_t)i * ny + j) * nz;
        uint64_t* out = dst + (size_t)j * nw;
        std::memset(out, 0, (size_t)nw * 8);
        for (int k = 0; k < nz; ++k)
          out[k >> 6] |= (uint64_t)(row[k] < iso) << (k & 63);
      }
    };

    int prev_i = -2;  // plane cached in mask_a (as plane index i)

#pragma omp for schedule(static)
    for (int i = 0; i < nx - 1; ++i) {
      if (prev_i == i - 1) {
        mask_a.swap(mask_b);  // previous iteration's i+1 plane is our i
      } else {
        pack_plane(i, mask_a.data());
      }
      pack_plane(i + 1, mask_b.data());
      prev_i = i;

      for (int j = 0; j + 1 < ny; ++j) {
        const uint64_t* r0 = mask_a.data() + (size_t)j * nw;
        const uint64_t* r1 = mask_a.data() + (size_t)(j + 1) * nw;
        const uint64_t* r2 = mask_b.data() + (size_t)j * nw;
        const uint64_t* r3 = mask_b.data() + (size_t)(j + 1) * nw;
        for (int w = 0; w < nw; ++w) {
          uint64_t and4 = r0[w] & r1[w] & r2[w] & r3[w];
          uint64_t or4 = r0[w] | r1[w] | r2[w] | r3[w];
          uint64_t and4n = (w + 1 < nw) ? (r0[w + 1] & r1[w + 1] &
                                           r2[w + 1] & r3[w + 1])
                                        : 0;
          uint64_t or4n = (w + 1 < nw) ? (r0[w + 1] | r1[w + 1] |
                                          r2[w + 1] | r3[w + 1])
                                       : 0;
          // cell k alive iff corners at k,k+1 are neither all-in nor
          // all-out
          uint64_t pair_and = (and4 >> 1) | (and4n << 63);
          uint64_t pair_or = (or4 >> 1) | (or4n << 63);
          uint64_t active = ~(and4 & pair_and) & (or4 | pair_or);
          // clip cells with k+1 >= nz
          int base = w << 6;
          if (base + 64 > nz - 1) {
            int valid = nz - 1 - base;  // may be <= 0
            active = (valid <= 0) ? 0
                     : (valid >= 64) ? active
                                     : active & ((1ULL << valid) - 1);
          }
          while (active) {
            int k = base + __builtin_ctzll(active);
            active &= active - 1;
            float v[8];
            int config = 0;
            for (int c = 0; c < 8; ++c) {
              v[c] = gval(i + kCorners[c][0], j + kCorners[c][1],
                          k + kCorners[c][2]);
              if (v[c] < iso) config |= (1 << c);
            }
            if (config == 0 || config == 255) continue;
            const int* tl = T.tri[config];
          for (int e = 0; tl[e] >= 0; ++e) {
            int edge = tl[e];
            int a = kEdges[edge][0], b = kEdges[edge][1];
            int ax = (kCorners[a][0] != kCorners[b][0]) ? 0
                     : (kCorners[a][1] != kCorners[b][1]) ? 1 : 2;
            int bi = i + std::min(kCorners[a][0], kCorners[b][0]);
            int bj = j + std::min(kCorners[a][1], kCorners[b][1]);
            int bk = k + std::min(kCorners[a][2], kCorners[b][2]);
            keys.push_back(edge_key(bi, bj, bk, ax, ny, nz));
            float va = v[a], vb = v[b];
            float tt = (iso - va) / (vb - va);
            tt = std::max(0.0f, std::min(1.0f, tt));
            pos.push_back(i + kCorners[a][0] +
                          tt * (kCorners[b][0] - kCorners[a][0]));
            pos.push_back(j + kCorners[a][1] +
                          tt * (kCorners[b][1] - kCorners[a][1]));
            pos.push_back(k + kCorners[a][2] +
                          tt * (kCorners[b][2] - kCorners[a][2]));
          }
          }
        }
      }
    }
  }

  dedup_edges(keys_t, pos_t, (int64_t)nx * ny * nz * 3,
              out_verts, out_nv, out_tris, out_nt);
  return 0;
}

// Sparse-wire marching cubes: extracts the iso-0 surface DIRECTLY from the
// near-surface wire format of ops/sparse_grid.py (packed sign bitmap +
// flagged 4^3 int8 blocks), never materializing the dense fp32 grid or the
// one-layer +1.0 pad copy that `sdfgrid_to_mesh` builds for the dense path
// (`src/encoding/utils3d.py:196-213` semantics).  Output is BIT-IDENTICAL
// to geo_marching_cubes on the decoded+padded grid, including vertex and
// triangle order: active cells are collected from flagged-block
// neighborhoods, sorted into the dense sweep's lexicographic (i,j,k)
// order, and fed through the same per-cell emission + edge dedup.
//
// Arguments mirror SparseGrid: signs is np.packbits (MSB-first) of
// (value < 0) over the PADDED grid in C order; block_ids[0..count) are the
// flagged 4^3 block ids ascending; block_vals the int8 block payloads;
// (X,Y,Z) the unpadded grid shape, (PX,PY,PZ) the padded.  Values
// dequantize as (q + 0.5) * dq (bucket centers, sign-exact); dq is the
// float32 of quant/127 computed by the caller so the product matches
// numpy's float32 arithmetic in decode_host bit-for-bit.
// Vertices come back in the VIRTUAL padded index space (pad layer at
// index 0), exactly like the dense call on the padded grid — the Python
// wrapper subtracts 1, as sdfgrid_to_mesh does.
int geo_marching_cubes_sparse(
    const uint8_t* signs, const int32_t* block_ids, const int8_t* block_vals,
    int count, int X, int Y, int Z, int PX, int PY, int PZ, float dq,
    float** out_verts, int* out_nv, int** out_tris, int* out_nt) {
  const MCTables& T = mc_tables();
  const int BLOCK = 4;
  const int bx = PX / BLOCK, by = PY / BLOCK, bz = PZ / BLOCK;

  // block id -> slot in block_vals (-1 = not shipped: sign-only far field)
  std::vector<int32_t> slot_of((size_t)bx * by * bz, -1);
  for (int s = 0; s < count; ++s) slot_of[(size_t)block_ids[s]] = s;

  // sign of unpadded voxel (i,j,k): bit n of the packed bitmap, MSB-first
  auto sgn = [&](int i, int j, int k) -> int {
    size_t n = ((size_t)i * PY + j) * PZ + k;
    return (signs[n >> 3] >> (7 - (n & 7))) & 1;
  };
  // dequantized value of unpadded voxel (matches sparse_grid.decode_host)
  auto val = [&](int i, int j, int k) -> float {
    int b = (i / BLOCK * by + j / BLOCK) * bz + k / BLOCK;
    int s = slot_of[(size_t)b];
    int q = (s >= 0)
                ? block_vals[(size_t)s * 64 + ((i & 3) * BLOCK + (j & 3)) *
                                                  BLOCK + (k & 3)]
                : (sgn(i, j, k) ? -128 : 127);
    return ((float)q + 0.5f) * dq;
  };

  // Virtual (padded-by-one) grid: dims (X+2, Y+2, Z+2), border = +1.0.
  // Cell origins span [0, X] x [0, Y] x [0, Z].
  const int CX = X + 1, CY = Y + 1, CZ = Z + 1;
  auto vsgn = [&](int i, int j, int k) -> int {  // virtual coords
    if (i < 1 || j < 1 || k < 1 || i > X || j > Y || k > Z) return 0;
    return sgn(i - 1, j - 1, k - 1);
  };

  // Collect active cells from flagged-block neighborhoods.  Every
  // triangle-producing cell has a sign-crossing cube edge, both of whose
  // endpoints the encoder flags — so candidates = cells touching a voxel
  // of any flagged block: virtual origins [4b, 4b+4] per axis.
  std::vector<int64_t> active;
  std::vector<uint64_t> visited(((size_t)CX * CY * CZ + 63) / 64, 0);
  for (int s = 0; s < count; ++s) {
    int b = block_ids[s];
    int b0 = b / (by * bz), rem = b % (by * bz);
    int b1 = rem / bz, b2 = rem % bz;
    int i0 = b0 * BLOCK, j0 = b1 * BLOCK, k0 = b2 * BLOCK;
    int i1 = std::min(i0 + BLOCK, CX - 1), j1 = std::min(j0 + BLOCK, CY - 1),
        k1 = std::min(k0 + BLOCK, CZ - 1);
    for (int i = i0; i <= i1; ++i)
      for (int j = j0; j <= j1; ++j)
        for (int k = k0; k <= k1; ++k) {
          size_t cid = ((size_t)i * CY + j) * CZ + k;
          uint64_t& w = visited[cid >> 6];
          uint64_t bit = 1ULL << (cid & 63);
          if (w & bit) continue;
          w |= bit;
          int acc = 0, any = 0;
          for (int c = 0; c < 8; ++c) {
            int sg = vsgn(i + kCorners[c][0], j + kCorners[c][1],
                          k + kCorners[c][2]);
            acc += sg;
            any |= sg;
          }
          if (any && acc != 8) active.push_back((int64_t)cid);
        }
  }
  std::sort(active.begin(), active.end());

  // Process in sorted (dense sweep) order; contiguous chunks per thread
  // keep the concatenated stream identical to the dense path's.
  int n_threads = 1;
#if defined(_OPENMP)
  n_threads = std::max(1, omp_get_max_threads());
#endif
  std::vector<std::vector<int64_t>> keys_t(n_threads);
  std::vector<std::vector<float>> pos_t(n_threads);
  const int nyv = Y + 2, nzv = Z + 2;
  const size_t na = active.size();

#pragma omp parallel num_threads(n_threads)
  {
#if defined(_OPENMP)
    int tid = omp_get_thread_num();
#else
    int tid = 0;
#endif
    auto& keys = keys_t[tid];
    auto& pos = pos_t[tid];
    size_t lo = na * tid / n_threads, hi = na * (tid + 1) / n_threads;
    for (size_t a = lo; a < hi; ++a) {
      int64_t cid = active[a];
      int i = (int)(cid / ((int64_t)CY * CZ));
      int rem = (int)(cid % ((int64_t)CY * CZ));
      int j = rem / CZ, k = rem % CZ;
      float v[8];
      int config = 0;
      for (int c = 0; c < 8; ++c) {
        int vi = i + kCorners[c][0], vj = j + kCorners[c][1],
            vk = k + kCorners[c][2];
        if (vi < 1 || vj < 1 || vk < 1 || vi > X || vj > Y || vk > Z) {
          v[c] = 1.0f;  // +1.0 pad layer, as sdfgrid_to_mesh applies
        } else {
          v[c] = val(vi - 1, vj - 1, vk - 1);
          if (v[c] < 0.0f) config |= (1 << c);
        }
      }
      const int* tl = T.tri[config];
      for (int e = 0; tl[e] >= 0; ++e) {
        int edge = tl[e];
        int a2 = kEdges[edge][0], b2 = kEdges[edge][1];
        int ax = (kCorners[a2][0] != kCorners[b2][0])   ? 0
                 : (kCorners[a2][1] != kCorners[b2][1]) ? 1
                                                        : 2;
        int bi = i + std::min(kCorners[a2][0], kCorners[b2][0]);
        int bj = j + std::min(kCorners[a2][1], kCorners[b2][1]);
        int bk = k + std::min(kCorners[a2][2], kCorners[b2][2]);
        keys.push_back(edge_key(bi, bj, bk, ax, nyv, nzv));
        float va = v[a2], vb = v[b2];
        float tt = (0.0f - va) / (vb - va);
        tt = std::max(0.0f, std::min(1.0f, tt));
        pos.push_back(i + kCorners[a2][0] +
                      tt * (kCorners[b2][0] - kCorners[a2][0]));
        pos.push_back(j + kCorners[a2][1] +
                      tt * (kCorners[b2][1] - kCorners[a2][1]));
        pos.push_back(k + kCorners[a2][2] +
                      tt * (kCorners[b2][2] - kCorners[a2][2]));
      }
    }
  }

  dedup_edges(keys_t, pos_t, (int64_t)(X + 2) * (Y + 2) * (Z + 2) * 3,
              out_verts, out_nv, out_tris, out_nt);
  return 0;
}

// ---------------------------------------------------------------------------
// Connected components (union-find over shared vertices).
// out_face_comp: per-face component id (compacted, 0-based). Returns count.
// ---------------------------------------------------------------------------

int geo_connected_components(const int* tris, int nt, int nv,
                             int* out_face_comp) {
  std::vector<int> parent(nv);
  for (int i = 0; i < nv; ++i) parent[i] = i;
  std::function<int(int)> find = [&](int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  auto unite = [&](int a, int b) {
    a = find(a); b = find(b);
    if (a != b) parent[a] = b;
  };
  for (int f = 0; f < nt; ++f) {
    unite(tris[3 * f], tris[3 * f + 1]);
    unite(tris[3 * f], tris[3 * f + 2]);
  }
  std::unordered_map<int, int> remap;
  for (int f = 0; f < nt; ++f) {
    int r = find(tris[3 * f]);
    auto it = remap.find(r);
    int id;
    if (it == remap.end()) {
      id = (int)remap.size();
      remap.emplace(r, id);
    } else {
      id = it->second;
    }
    out_face_comp[f] = id;
  }
  return (int)remap.size();
}

// ---------------------------------------------------------------------------
// Quadric edge-collapse decimation (Garland-Heckbert style).
// ---------------------------------------------------------------------------

namespace dec {

struct Quadric {
  double m[10];  // symmetric 4x4: xx xy xz xw yy yz yw zz zw ww
  Quadric() { memset(m, 0, sizeof(m)); }
  void add_plane(double a, double b, double c, double d, double w) {
    m[0] += w * a * a; m[1] += w * a * b; m[2] += w * a * c; m[3] += w * a * d;
    m[4] += w * b * b; m[5] += w * b * c; m[6] += w * b * d;
    m[7] += w * c * c; m[8] += w * c * d; m[9] += w * d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; ++i) m[i] += o.m[i];
  }
  double eval(double x, double y, double z) const {
    return m[0] * x * x + 2 * m[1] * x * y + 2 * m[2] * x * z + 2 * m[3] * x +
           m[4] * y * y + 2 * m[5] * y * z + 2 * m[6] * y +
           m[7] * z * z + 2 * m[8] * z + m[9];
  }
  // solve for optimal point; returns false if singular
  bool optimal(double* x, double* y, double* z) const {
    double A[3][3] = {{m[0], m[1], m[2]},
                      {m[1], m[4], m[5]},
                      {m[2], m[5], m[7]}};
    double b[3] = {-m[3], -m[6], -m[8]};
    // Gaussian elimination with partial pivot
    int idx[3] = {0, 1, 2};
    double M[3][4];
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) M[i][j] = A[i][j];
      M[i][3] = b[i];
    }
    for (int col = 0; col < 3; ++col) {
      int piv = col;
      for (int r = col + 1; r < 3; ++r)
        if (std::fabs(M[r][col]) > std::fabs(M[piv][col])) piv = r;
      if (std::fabs(M[piv][col]) < 1e-10) return false;
      std::swap_ranges(M[col], M[col] + 4, M[piv]);
      for (int r = 0; r < 3; ++r) {
        if (r == col) continue;
        double f = M[r][col] / M[col][col];
        for (int c2 = col; c2 < 4; ++c2) M[r][c2] -= f * M[col][c2];
      }
    }
    (void)idx;
    *x = M[0][3] / M[0][0];
    *y = M[1][3] / M[1][1];
    *z = M[2][3] / M[2][2];
    return std::isfinite(*x) && std::isfinite(*y) && std::isfinite(*z);
  }
};

struct HeapEntry {
  double cost;
  int va, vb;
  uint64_t stamp;  // va_version<<32 | vb_version at push time
  bool operator<(const HeapEntry& o) const { return cost > o.cost; }
};

// Flat 4-ary min-heap: ~25% fewer cache lines touched per percolation
// than std::priority_queue's binary heap at the ~400k-entry scale of a
// decimation run (measured 0.19 -> 0.17 s on the collapse loop).
struct QHeap {
  std::vector<HeapEntry> a;
  bool empty() const { return a.empty(); }
  const HeapEntry& top() const { return a[0]; }
  void push(const HeapEntry& e) {
    a.push_back(e);
    size_t i = a.size() - 1;
    while (i) {
      size_t p = (i - 1) >> 2;
      if (a[p].cost <= a[i].cost) break;
      std::swap(a[p], a[i]);
      i = p;
    }
  }
  void pop() {
    a[0] = a.back();
    a.pop_back();
    size_t i = 0, n = a.size();
    for (;;) {
      size_t c0 = 4 * i + 1;
      if (c0 >= n) break;
      size_t m = c0, ce = std::min(c0 + 4, n);
      for (size_t c = c0 + 1; c < ce; ++c)
        if (a[c].cost < a[m].cost) m = c;
      if (a[m].cost >= a[i].cost) break;
      std::swap(a[i], a[m]);
      i = m;
    }
  }
};

}  // namespace dec

// Vertex-clustering pre-pass: weld vertices on a uniform grid sized so the
// output keeps ~`target_tris` x headroom triangles.  O(n), used to take a
// multi-million-triangle marching-cubes mesh down to a size where quadric
// decimation's priority queue is cheap; the quadric pass then handles the
// quality-critical final reduction.
static void cluster_simplify(std::vector<double>& V, std::vector<int>& F,
                             int target_tris) {
  size_t nt = F.size() / 3;
  if ((int)nt <= target_tris) return;
  size_t nv = V.size() / 3;
  double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
  for (size_t i = 0; i < nv; ++i) {
    for (int k = 0; k < 3; ++k) {
      lo[k] = std::min(lo[k], V[3 * i + k]);
      hi[k] = std::max(hi[k], V[3 * i + k]);
    }
  }
  // a closed surface crossing a res^3 grid occupies ~k*res^2 cells
  // (k ~= 2-6); output tris ~ 2 * occupied cells.  Start from that guess
  // and shrink the grid if the result is still too dense.
  double diag = std::max({hi[0] - lo[0], hi[1] - lo[1], hi[2] - lo[2]});
  if (diag <= 0) return;
  int res = std::max((int)std::ceil(std::sqrt(target_tris / 4.0)), 16);

  for (int attempt = 0; attempt < 4; ++attempt) {
    double cell = diag / res;
    std::unordered_map<int64_t, int> cell_rep;
    cell_rep.reserve(nv / 4 + 16);
    std::vector<int> vmap(nv);
    std::vector<double> newV;
    std::vector<int> counts;
    for (size_t i = 0; i < nv; ++i) {
      int64_t cx = (int64_t)((V[3 * i] - lo[0]) / cell);
      int64_t cy = (int64_t)((V[3 * i + 1] - lo[1]) / cell);
      int64_t cz = (int64_t)((V[3 * i + 2] - lo[2]) / cell);
      int64_t key = (cx << 42) ^ (cy << 21) ^ cz;
      auto it = cell_rep.find(key);
      int id;
      if (it == cell_rep.end()) {
        id = (int)(newV.size() / 3);
        cell_rep.emplace(key, id);
        newV.insert(newV.end(), {V[3 * i], V[3 * i + 1], V[3 * i + 2]});
        counts.push_back(1);
      } else {
        id = it->second;
        for (int k = 0; k < 3; ++k)
          newV[3 * id + k] += (V[3 * i + k] - newV[3 * id + k])
                              / (counts[id] + 1);
        counts[id]++;
      }
      vmap[i] = id;
    }
    std::vector<int> newF;
    newF.reserve(nt);
    for (size_t f = 0; f < nt; ++f) {
      int a = vmap[F[3 * f]], b = vmap[F[3 * f + 1]],
          c = vmap[F[3 * f + 2]];
      if (a != b && b != c && c != a) newF.insert(newF.end(), {a, b, c});
    }
    if ((int)(newF.size() / 3) <= 3 * target_tris || attempt == 3) {
      V.swap(newV);
      F.swap(newF);
      return;
    }
    res = (int)(res / 1.6) + 1;  // too dense -> coarser grid, retry
  }
}

int geo_decimate(const float* verts_in, int nv, const int* tris_in, int nt,
                 int target_faces, int prepass_mult, float** out_verts,
                 int* out_nv, int** out_tris, int* out_nt) {
  using namespace dec;
  std::vector<double> V(3 * (size_t)nv);
  for (int i = 0; i < 3 * nv; ++i) V[i] = verts_in[i];
  std::vector<int> F(tris_in, tris_in + 3 * (size_t)nt);

  // pre-pass: clustering when the input is far above the target
  // (> prepass_mult x); keeps quadric quality where it matters, kills
  // the heap cost.  prepass_mult <= 0 disables the pre-pass entirely.
  if (prepass_mult > 0 && nt > prepass_mult * target_faces) {
    cluster_simplify(V, F, std::max(target_faces * prepass_mult, 50000));
  }
  nv = (int)(V.size() / 3);
  nt = (int)(F.size() / 3);

  std::vector<bool> fdead(nt, false);
  std::vector<Quadric> Q(nv);
  std::vector<std::vector<int>> vfaces(nv);
  std::vector<uint32_t> version(nv, 0);

  auto fnormal = [&](int f, double* n, double* d, double* area) {
    int a = F[3 * f], b = F[3 * f + 1], c = F[3 * f + 2];
    double e1[3] = {V[3 * b] - V[3 * a], V[3 * b + 1] - V[3 * a + 1],
                    V[3 * b + 2] - V[3 * a + 2]};
    double e2[3] = {V[3 * c] - V[3 * a], V[3 * c + 1] - V[3 * a + 1],
                    V[3 * c + 2] - V[3 * a + 2]};
    n[0] = e1[1] * e2[2] - e1[2] * e2[1];
    n[1] = e1[2] * e2[0] - e1[0] * e2[2];
    n[2] = e1[0] * e2[1] - e1[1] * e2[0];
    double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    *area = 0.5 * len;
    if (len > 1e-14) {
      n[0] /= len; n[1] /= len; n[2] /= len;
    }
    *d = -(n[0] * V[3 * a] + n[1] * V[3 * a + 1] + n[2] * V[3 * a + 2]);
  };

  for (int f = 0; f < nt; ++f) {
    double n[3], d, area;
    fnormal(f, n, &d, &area);
    for (int k = 0; k < 3; ++k) {
      int v = F[3 * f + k];
      Q[v].add_plane(n[0], n[1], n[2], d, std::max(area, 1e-12));
      vfaces[v].push_back(f);
    }
  }

  QHeap heap;
  auto push_edge = [&](int a, int b) {
    if (a == b) return;
    if (a > b) std::swap(a, b);
    Quadric q = Q[a];
    q.add(Q[b]);
    double x = 0, y = 0, z = 0;
    if (!q.optimal(&x, &y, &z)) {
      // fallback: best of endpoints/midpoint
      double cands[3][3] = {
          {V[3 * a], V[3 * a + 1], V[3 * a + 2]},
          {V[3 * b], V[3 * b + 1], V[3 * b + 2]},
          {(V[3 * a] + V[3 * b]) / 2, (V[3 * a + 1] + V[3 * b + 1]) / 2,
           (V[3 * a + 2] + V[3 * b + 2]) / 2}};
      double best = 1e300;
      for (auto& c : cands) {
        double e = q.eval(c[0], c[1], c[2]);
        if (e < best) { best = e; x = c[0]; y = c[1]; z = c[2]; }
      }
    }
    HeapEntry he;
    he.cost = q.eval(x, y, z);
    he.va = a; he.vb = b;
    he.stamp = ((uint64_t)version[a] << 32) | version[b];
    heap.push(he);
  };

  // initial edges, deduped up front: an edge shared by two faces would
  // otherwise be pushed twice (identical entries) — a sort+unique over
  // packed (min,max) keys halves the initial quadric solves + heap pushes
  {
    std::vector<uint64_t> edges;
    edges.reserve(3 * (size_t)nt);
    for (int f = 0; f < nt; ++f) {
      for (int k = 0; k < 3; ++k) {
        int u = F[3 * f + k], w = F[3 * f + (k + 1) % 3];
        if (u > w) std::swap(u, w);
        edges.push_back(((uint64_t)u << 32) | (uint32_t)w);
      }
    }
    std::sort(edges.begin(), edges.end());
    edges.erase(std::unique(edges.begin(), edges.end()), edges.end());
    for (uint64_t e : edges) push_edge((int)(e >> 32), (int)(uint32_t)e);
  }

  int live_faces = nt;
  std::vector<int> vertex_alias(nv);
  for (int i = 0; i < nv; ++i) vertex_alias[i] = i;
  std::function<int(int)> resolve = [&](int v) {
    while (vertex_alias[v] != v) {
      vertex_alias[v] = vertex_alias[vertex_alias[v]];
      v = vertex_alias[v];
    }
    return v;
  };

  std::vector<int> merged, alive, nbrs;  // reused across collapses
  while (live_faces > target_faces && !heap.empty()) {
    HeapEntry he = heap.top();
    heap.pop();
    int a = resolve(he.va), b = resolve(he.vb);
    if (a == b) continue;
    if (he.va != a || he.vb != b) continue;  // endpoints merged elsewhere
    uint64_t cur = ((uint64_t)version[a] << 32) | version[b];
    if (cur != he.stamp) continue;  // stale

    // new position
    Quadric q = Q[a];
    q.add(Q[b]);
    double x, y, z;
    if (!q.optimal(&x, &y, &z)) {
      x = (V[3 * a] + V[3 * b]) / 2;
      y = (V[3 * a + 1] + V[3 * b + 1]) / 2;
      z = (V[3 * a + 2] + V[3 * b + 2]) / 2;
    }

    // collapse b into a
    V[3 * a] = x; V[3 * a + 1] = y; V[3 * a + 2] = z;
    Q[a] = q;
    vertex_alias[b] = a;
    version[a]++;

    // update faces
    merged.clear();
    merged.reserve(vfaces[a].size() + vfaces[b].size());
    for (int f : vfaces[a]) if (!fdead[f]) merged.push_back(f);
    for (int f : vfaces[b]) if (!fdead[f]) merged.push_back(f);
    std::sort(merged.begin(), merged.end());
    merged.erase(std::unique(merged.begin(), merged.end()), merged.end());
    alive.clear();
    for (int f : merged) {
      int c0 = resolve(F[3 * f]), c1 = resolve(F[3 * f + 1]),
          c2 = resolve(F[3 * f + 2]);
      F[3 * f] = c0; F[3 * f + 1] = c1; F[3 * f + 2] = c2;
      if (c0 == c1 || c1 == c2 || c2 == c0) {
        fdead[f] = true;
        --live_faces;
      } else {
        alive.push_back(f);
      }
    }
    vfaces[a] = alive;
    vfaces[b].clear();

    // re-push edges around a, each once: every incident edge (a,u)
    // appears in two alive faces — collecting unique neighbor vertices
    // halves the re-push quadric solves + heap traffic
    nbrs.clear();
    for (int f : alive) {
      for (int k = 0; k < 3; ++k) {
        int u = F[3 * f + k];
        if (u != a) nbrs.push_back(u);
      }
    }
    std::sort(nbrs.begin(), nbrs.end());
    nbrs.erase(std::unique(nbrs.begin(), nbrs.end()), nbrs.end());
    for (int u : nbrs) push_edge(a, u);
  }

  // compact output
  std::vector<int> vmap(nv, -1);
  std::vector<float> VO;
  std::vector<int> FO;
  for (int f = 0; f < nt; ++f) {
    if (fdead[f]) continue;
    int idx[3];
    for (int k = 0; k < 3; ++k) {
      int v = resolve(F[3 * f + k]);
      if (vmap[v] < 0) {
        vmap[v] = (int)(VO.size() / 3);
        VO.push_back((float)V[3 * v]);
        VO.push_back((float)V[3 * v + 1]);
        VO.push_back((float)V[3 * v + 2]);
      }
      idx[k] = vmap[v];
    }
    FO.push_back(idx[0]); FO.push_back(idx[1]); FO.push_back(idx[2]);
  }
  *out_nv = (int)(VO.size() / 3);
  *out_nt = (int)(FO.size() / 3);
  *out_verts = (float*)malloc(VO.size() * sizeof(float));
  *out_tris = (int*)malloc(FO.size() * sizeof(int));
  memcpy(*out_verts, VO.data(), VO.size() * sizeof(float));
  memcpy(*out_tris, FO.data(), FO.size() * sizeof(int));
  return 0;
}

// ---------------------------------------------------------------------------
// BVH: closest point on mesh + fast winding number (Barill et al. 2018,
// first-order dipole approximation) -> signed distance.
// ---------------------------------------------------------------------------

namespace bvh {

struct Vec3 {
  double x, y, z;
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
};
inline double dot(const Vec3& a, const Vec3& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}
inline Vec3 cross(const Vec3& a, const Vec3& b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
inline double norm(const Vec3& a) { return std::sqrt(dot(a, a)); }

struct Node {
  double bmin[3], bmax[3];
  int left, right;     // children, or -1
  int start, count;    // triangle range for leaves
  // winding-number dipole data
  Vec3 awn;            // area-weighted normal sum
  Vec3 centroid;       // area-weighted centroid
  double radius;       // max distance from centroid to any tri vertex
};

struct BVH {
  std::vector<Vec3> verts;
  std::vector<int> tris;       // 3*nt
  std::vector<int> order;      // triangle permutation
  std::vector<Node> nodes;
  int nt;
};

double tri_area_normal(const BVH& b, int t, Vec3* n_out, Vec3* c_out) {
  const Vec3& a = b.verts[b.tris[3 * t]];
  const Vec3& c = b.verts[b.tris[3 * t + 1]];
  const Vec3& d = b.verts[b.tris[3 * t + 2]];
  Vec3 n = cross(c - a, d - a);
  *n_out = n * 0.5;  // area-weighted normal
  *c_out = (a + c + d) * (1.0 / 3.0);
  return 0.5 * norm(n);
}

int build_node(BVH& b, std::vector<int>& idx, int start, int count) {
  Node node;
  node.bmin[0] = node.bmin[1] = node.bmin[2] = 1e300;
  node.bmax[0] = node.bmax[1] = node.bmax[2] = -1e300;
  node.awn = {0, 0, 0};
  Vec3 wc = {0, 0, 0};
  double wsum = 0;
  for (int i = start; i < start + count; ++i) {
    int t = idx[i];
    for (int k = 0; k < 3; ++k) {
      const Vec3& v = b.verts[b.tris[3 * t + k]];
      node.bmin[0] = std::min(node.bmin[0], v.x);
      node.bmin[1] = std::min(node.bmin[1], v.y);
      node.bmin[2] = std::min(node.bmin[2], v.z);
      node.bmax[0] = std::max(node.bmax[0], v.x);
      node.bmax[1] = std::max(node.bmax[1], v.y);
      node.bmax[2] = std::max(node.bmax[2], v.z);
    }
    Vec3 an, c;
    double area = tri_area_normal(b, t, &an, &c);
    node.awn = node.awn + an;
    wc = wc + c * area;
    wsum += area;
  }
  node.centroid = wsum > 1e-300 ? wc * (1.0 / wsum)
                                : Vec3{(node.bmin[0] + node.bmax[0]) / 2,
                                       (node.bmin[1] + node.bmax[1]) / 2,
                                       (node.bmin[2] + node.bmax[2]) / 2};
  node.radius = 0;
  for (int i = start; i < start + count; ++i) {
    int t = idx[i];
    for (int k = 0; k < 3; ++k) {
      node.radius = std::max(node.radius,
                             norm(b.verts[b.tris[3 * t + k]] - node.centroid));
    }
  }

  int my = (int)b.nodes.size();
  b.nodes.push_back(node);

  if (count <= 4) {
    b.nodes[my].left = b.nodes[my].right = -1;
    b.nodes[my].start = start;
    b.nodes[my].count = count;
    return my;
  }
  // split on longest axis at median
  int axis = 0;
  double ext[3] = {node.bmax[0] - node.bmin[0], node.bmax[1] - node.bmin[1],
                   node.bmax[2] - node.bmin[2]};
  if (ext[1] > ext[axis]) axis = 1;
  if (ext[2] > ext[axis]) axis = 2;
  auto tri_center = [&](int t) {
    const Vec3& a = b.verts[b.tris[3 * t]];
    const Vec3& c = b.verts[b.tris[3 * t + 1]];
    const Vec3& d = b.verts[b.tris[3 * t + 2]];
    double v[3] = {(a.x + c.x + d.x) / 3, (a.y + c.y + d.y) / 3,
                   (a.z + c.z + d.z) / 3};
    return v[axis];
  };
  std::nth_element(idx.begin() + start, idx.begin() + start + count / 2,
                   idx.begin() + start + count,
                   [&](int u, int v) { return tri_center(u) < tri_center(v); });
  int mid = count / 2;
  int l = build_node(b, idx, start, mid);
  int r = build_node(b, idx, start + mid, count - mid);
  b.nodes[my].left = l;
  b.nodes[my].right = r;
  b.nodes[my].start = start;
  b.nodes[my].count = count;
  return my;
}

Vec3 closest_point_triangle(const Vec3& p, const Vec3& a, const Vec3& b,
                            const Vec3& c, double* u, double* v, double* w) {
  // Ericson, Real-Time Collision Detection
  Vec3 ab = b - a, ac = c - a, ap = p - a;
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) { *u = 1; *v = 0; *w = 0; return a; }
  Vec3 bp = p - b;
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) { *u = 0; *v = 1; *w = 0; return b; }
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double t = d1 / (d1 - d3);
    *u = 1 - t; *v = t; *w = 0;
    return a + ab * t;
  }
  Vec3 cp = p - c;
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) { *u = 0; *v = 0; *w = 1; return c; }
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double t = d2 / (d2 - d6);
    *u = 1 - t; *v = 0; *w = t;
    return a + ac * t;
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double t = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    *u = 0; *v = 1 - t; *w = t;
    return b + (c - b) * t;
  }
  double denom = 1.0 / (va + vb + vc);
  double vv = vb * denom, ww = vc * denom;
  *u = 1 - vv - ww; *v = vv; *w = ww;
  return a + ab * vv + ac * ww;
}

inline double box_dist2(const Node& n, const Vec3& p) {
  double d = 0;
  double dx = std::max({n.bmin[0] - p.x, 0.0, p.x - n.bmax[0]});
  double dy = std::max({n.bmin[1] - p.y, 0.0, p.y - n.bmax[1]});
  double dz = std::max({n.bmin[2] - p.z, 0.0, p.z - n.bmax[2]});
  d = dx * dx + dy * dy + dz * dz;
  return d;
}

void closest_query(const BVH& b, int node_id, const Vec3& p, double* best2,
                   int* best_tri, double* bu, double* bv, double* bw) {
  const Node& n = b.nodes[node_id];
  if (n.left < 0) {
    for (int i = n.start; i < n.start + n.count; ++i) {
      int t = b.order[i];
      double u, v, w;
      Vec3 q = closest_point_triangle(p, b.verts[b.tris[3 * t]],
                                      b.verts[b.tris[3 * t + 1]],
                                      b.verts[b.tris[3 * t + 2]], &u, &v, &w);
      double d2 = dot(q - p, q - p);
      if (d2 < *best2) {
        *best2 = d2;
        *best_tri = t;
        *bu = u; *bv = v; *bw = w;
      }
    }
    return;
  }
  double dl = box_dist2(b.nodes[n.left], p);
  double dr = box_dist2(b.nodes[n.right], p);
  int first = n.left, second = n.right;
  if (dr < dl) { std::swap(first, second); std::swap(dl, dr); }
  if (dl < *best2) closest_query(b, first, p, best2, best_tri, bu, bv, bw);
  if (dr < *best2) closest_query(b, second, p, best2, best_tri, bu, bv, bw);
}

double solid_angle(const Vec3& p, const Vec3& a, const Vec3& b,
                   const Vec3& c) {
  // van Oosterom & Strackee
  Vec3 qa = a - p, qb = b - p, qc = c - p;
  double la = norm(qa), lb = norm(qb), lc = norm(qc);
  double num = dot(qa, cross(qb, qc));
  double den = la * lb * lc + dot(qa, qb) * lc + dot(qb, qc) * la +
               dot(qc, qa) * lb;
  return 2.0 * std::atan2(num, den);
}

double winding_query(const BVH& b, int node_id, const Vec3& p, double beta2) {
  const Node& n = b.nodes[node_id];
  Vec3 d = p - n.centroid;
  double dist2 = dot(d, d);
  if (dist2 > beta2 * n.radius * n.radius && n.radius > 0) {
    // dipole approximation: w ~= <awn, (c - p)> / (4 pi |c - p|^3)
    double dist = std::sqrt(dist2);
    Vec3 r = n.centroid - p;
    return dot(n.awn, r) / (4.0 * M_PI * dist2 * dist);
  }
  if (n.left < 0) {
    double w = 0;
    for (int i = n.start; i < n.start + n.count; ++i) {
      int t = b.order[i];
      w += solid_angle(p, b.verts[b.tris[3 * t]], b.verts[b.tris[3 * t + 1]],
                       b.verts[b.tris[3 * t + 2]]) / (4.0 * M_PI);
    }
    return w;
  }
  return winding_query(b, n.left, p, beta2) +
         winding_query(b, n.right, p, beta2);
}

}  // namespace bvh

void* geo_bvh_build(const float* verts, int nv, const int* tris, int nt) {
  auto* b = new bvh::BVH();
  b->verts.resize(nv);
  for (int i = 0; i < nv; ++i)
    b->verts[i] = {verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]};
  b->tris.assign(tris, tris + 3 * (size_t)nt);
  b->nt = nt;
  b->order.resize(nt);
  for (int i = 0; i < nt; ++i) b->order[i] = i;
  b->nodes.reserve(2 * nt);
  if (nt > 0) bvh::build_node(*b, b->order, 0, nt);
  return b;
}

void geo_bvh_destroy(void* h) { delete (bvh::BVH*)h; }

void geo_bvh_closest(void* h, const float* pts, int n, float* out_dist,
                     int* out_face, float* out_bary) {
  auto* b = (bvh::BVH*)h;
#pragma omp parallel for schedule(dynamic, 256)
  for (int i = 0; i < n; ++i) {
    bvh::Vec3 p = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    double best2 = 1e300, u = 0, v = 0, w = 0;
    int bt = -1;
    if (b->nt > 0) bvh::closest_query(*b, 0, p, &best2, &bt, &u, &v, &w);
    out_dist[i] = (float)std::sqrt(best2);
    out_face[i] = bt;
    out_bary[3 * i] = (float)u;
    out_bary[3 * i + 1] = (float)v;
    out_bary[3 * i + 2] = (float)w;
  }
}

void geo_bvh_winding(void* h, const float* pts, int n, float* out_w) {
  auto* b = (bvh::BVH*)h;
  const double beta2 = 2.0 * 2.0;
#pragma omp parallel for schedule(dynamic, 256)
  for (int i = 0; i < n; ++i) {
    bvh::Vec3 p = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    out_w[i] = b->nt > 0 ? (float)bvh::winding_query(*b, 0, p, beta2) : 0.0f;
  }
}

// signed distance: negative inside (winding > 0.5)
void geo_bvh_signed_distance(void* h, const float* pts, int n, float* out_sdf,
                             int* out_face, float* out_bary) {
  auto* b = (bvh::BVH*)h;
  const double beta2 = 2.0 * 2.0;
#pragma omp parallel for schedule(dynamic, 256)
  for (int i = 0; i < n; ++i) {
    bvh::Vec3 p = {pts[3 * i], pts[3 * i + 1], pts[3 * i + 2]};
    double best2 = 1e300, u = 0, v = 0, w = 0;
    int bt = -1;
    if (b->nt > 0) bvh::closest_query(*b, 0, p, &best2, &bt, &u, &v, &w);
    double wind = b->nt > 0 ? bvh::winding_query(*b, 0, p, beta2) : 0.0;
    double d = std::sqrt(best2);
    out_sdf[i] = (float)(wind > 0.5 ? -d : d);
    if (out_face) out_face[i] = bt;
    if (out_bary) {
      out_bary[3 * i] = (float)u;
      out_bary[3 * i + 1] = (float)v;
      out_bary[3 * i + 2] = (float)w;
    }
  }
}

// ---------------------------------------------------------------------------
// UV-space rasterizer (nvdiffrast texture-bake replacement).
// uvs in [0,1]^2; pixel (r, c) covers uv y in [r/res,(r+1)/res) with row 0
// at v=0 (caller flips as needed). Interpolates 3D mesh positions.
// ---------------------------------------------------------------------------

void geo_rasterize_uv(const float* uvs, int nuv, const int* tri_uv,
                      const float* verts, const int* tri_pos, int nt, int res,
                      float* out_pos, unsigned char* out_mask) {
  (void)nuv;
  memset(out_mask, 0, (size_t)res * res);
  memset(out_pos, 0, (size_t)res * res * 3 * sizeof(float));
#pragma omp parallel for schedule(dynamic, 64)
  for (int t = 0; t < nt; ++t) {
    const float* uv0 = uvs + 2 * tri_uv[3 * t];
    const float* uv1 = uvs + 2 * tri_uv[3 * t + 1];
    const float* uv2 = uvs + 2 * tri_uv[3 * t + 2];
    const float* p0 = verts + 3 * tri_pos[3 * t];
    const float* p1 = verts + 3 * tri_pos[3 * t + 1];
    const float* p2 = verts + 3 * tri_pos[3 * t + 2];
    // pixel-space coords: px = u*res - 0.5 (pixel centers at u=(c+0.5)/res)
    double x0 = uv0[0] * res - 0.5, y0 = uv0[1] * res - 0.5;
    double x1 = uv1[0] * res - 0.5, y1 = uv1[1] * res - 0.5;
    double x2 = uv2[0] * res - 0.5, y2 = uv2[1] * res - 0.5;
    int rmin = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
    int rmax = std::min(res - 1, (int)std::ceil(std::max({y0, y1, y2})));
    double cminf = std::max(0.0, std::floor(std::min({x0, x1, x2})));
    double cmaxf = std::min((double)(res - 1),
                            std::ceil(std::max({x0, x1, x2})));
    double Ax = x1 - x0, Ay = y1 - y0, Bx = x2 - x0, By = y2 - y0;
    double denom = Ax * By - Bx * Ay;
    if (std::fabs(denom) < 1e-12) continue;
    double inv = 1.0 / denom;
    // barycentrics are affine in (c, r): wi(c, r) = ai*c + ei*r + fi
    double a1 = By * inv, e1 = -Bx * inv, f1 = (-x0 * By + Bx * y0) * inv;
    double a2 = -Ay * inv, e2 = Ax * inv, f2 = (x0 * Ay - Ax * y0) * inv;
    double a0 = -(a1 + a2), e0 = -(e1 + e2);
    // interpolated position: pos(c, r) = p0 + w1*(p1-p0) + w2*(p2-p0),
    // so the per-column step is a constant vector
    double d10[3] = {(double)p1[0] - p0[0], (double)p1[1] - p0[1],
                     (double)p1[2] - p0[2]};
    double d20[3] = {(double)p2[0] - p0[0], (double)p2[1] - p0[1],
                     (double)p2[2] - p0[2]};
    double stepx = a1 * d10[0] + a2 * d20[0];
    double stepy = a1 * d10[1] + a2 * d20[1];
    double stepz = a1 * d10[2] + a2 * d20[2];
    const double eps = -1e-9;
    for (int r = rmin; r <= rmax; ++r) {
      // exact column span on this row: wi(c) = ai*c + bi >= eps for all i
      double b0 = 1.0 - (f1 + f2) + e0 * r, b1 = f1 + e1 * r,
             b2 = f2 + e2 * r;
      double lo = cminf, hi = cmaxf;
      bool empty = false;
      const double aa[3] = {a0, a1, a2}, bb[3] = {b0, b1, b2};
      for (int k = 0; k < 3; ++k) {
        if (aa[k] > 0) {
          double c = (eps - bb[k]) / aa[k];
          if (c > lo) lo = c;
        } else if (aa[k] < 0) {
          double c = (eps - bb[k]) / aa[k];
          if (c < hi) hi = c;
        } else if (bb[k] < eps) {
          empty = true;
        }
      }
      if (empty) continue;
      int clo = (int)std::ceil(lo), chi = (int)std::floor(hi);
      if (clo > chi) continue;
      double w1 = a1 * clo + b1, w2 = a2 * clo + b2;
      double px = p0[0] + w1 * d10[0] + w2 * d20[0];
      double py = p0[1] + w1 * d10[1] + w2 * d20[1];
      double pz = p0[2] + w1 * d10[2] + w2 * d20[2];
      size_t pix = (size_t)r * res + clo;
      unsigned char* mrow = out_mask + pix;
      float* prow = out_pos + 3 * pix;
      for (int c = clo; c <= chi; ++c) {
        *mrow++ = 1;
        prow[0] = (float)px;
        prow[1] = (float)py;
        prow[2] = (float)pz;
        prow += 3;
        px += stepx;
        py += stepy;
        pz += stepz;
      }
    }
  }
}

// Run-length texel wire: same coverage as geo_rasterize_uv but emits
// per-row SPANS — (start position, per-column step, length) — instead of
// the dense position image.  The interpolated position is affine in the
// column index (see the stepx/stepy/stepz derivation above), so a span
// reproduces every texel position exactly; the accelerator expands spans
// on-device (models/autoencoder.py decode_texels_runs), cutting the
// texture bake's host->device upload from 6 B/texel (u16 wire) to
// ~28 B/run (~1-2 B/texel at production atlas density) AND removing the
// u16 quantization error.  Spans are sorted by (row, col) and trimmed at
// overlaps so the expansion order and count match the row-major masked
// compaction that geo_tex_assemble consumes.  Returns the span count
// (sum of lengths == popcount(out_mask)), or -1 on allocation failure;
// *out_runs = [n_runs, 7] float32 (start xyz, step xyz, len), geo_free().
long long geo_rasterize_uv_runs(const float* uvs, int nuv, const int* tri_uv,
                                const float* verts, const int* tri_pos,
                                int nt, int res, unsigned char* out_mask,
                                float** out_runs) {
  (void)nuv;
  struct TexRun {
    int r, c0, len;
    double px, py, pz, sx, sy, sz;
  };
  memset(out_mask, 0, (size_t)res * res);
#if defined(_OPENMP)
  std::vector<std::vector<TexRun>> tl(omp_get_max_threads());
#else
  std::vector<std::vector<TexRun>> tl(1);
#endif
#pragma omp parallel for schedule(dynamic, 64)
  for (int t = 0; t < nt; ++t) {
#if defined(_OPENMP)
    std::vector<TexRun>& runs = tl[omp_get_thread_num()];
#else
    std::vector<TexRun>& runs = tl[0];
#endif
    const float* uv0 = uvs + 2 * tri_uv[3 * t];
    const float* uv1 = uvs + 2 * tri_uv[3 * t + 1];
    const float* uv2 = uvs + 2 * tri_uv[3 * t + 2];
    const float* p0 = verts + 3 * tri_pos[3 * t];
    const float* p1 = verts + 3 * tri_pos[3 * t + 1];
    const float* p2 = verts + 3 * tri_pos[3 * t + 2];
    double x0 = uv0[0] * res - 0.5, y0 = uv0[1] * res - 0.5;
    double x1 = uv1[0] * res - 0.5, y1 = uv1[1] * res - 0.5;
    double x2 = uv2[0] * res - 0.5, y2 = uv2[1] * res - 0.5;
    int rmin = std::max(0, (int)std::floor(std::min({y0, y1, y2})));
    int rmax = std::min(res - 1, (int)std::ceil(std::max({y0, y1, y2})));
    double cminf = std::max(0.0, std::floor(std::min({x0, x1, x2})));
    double cmaxf = std::min((double)(res - 1),
                            std::ceil(std::max({x0, x1, x2})));
    double Ax = x1 - x0, Ay = y1 - y0, Bx = x2 - x0, By = y2 - y0;
    double denom = Ax * By - Bx * Ay;
    if (std::fabs(denom) < 1e-12) continue;
    double inv = 1.0 / denom;
    double a1 = By * inv, e1 = -Bx * inv, f1 = (-x0 * By + Bx * y0) * inv;
    double a2 = -Ay * inv, e2 = Ax * inv, f2 = (x0 * Ay - Ax * y0) * inv;
    double a0 = -(a1 + a2), e0 = -(e1 + e2);
    double d10[3] = {(double)p1[0] - p0[0], (double)p1[1] - p0[1],
                     (double)p1[2] - p0[2]};
    double d20[3] = {(double)p2[0] - p0[0], (double)p2[1] - p0[1],
                     (double)p2[2] - p0[2]};
    double stepx = a1 * d10[0] + a2 * d20[0];
    double stepy = a1 * d10[1] + a2 * d20[1];
    double stepz = a1 * d10[2] + a2 * d20[2];
    const double eps = -1e-9;
    for (int r = rmin; r <= rmax; ++r) {
      double b0 = 1.0 - (f1 + f2) + e0 * r, b1 = f1 + e1 * r,
             b2 = f2 + e2 * r;
      double lo = cminf, hi = cmaxf;
      bool empty = false;
      const double aa[3] = {a0, a1, a2}, bb[3] = {b0, b1, b2};
      for (int k = 0; k < 3; ++k) {
        if (aa[k] > 0) {
          double c = (eps - bb[k]) / aa[k];
          if (c > lo) lo = c;
        } else if (aa[k] < 0) {
          double c = (eps - bb[k]) / aa[k];
          if (c < hi) hi = c;
        } else if (bb[k] < eps) {
          empty = true;
        }
      }
      if (empty) continue;
      int clo = (int)std::ceil(lo), chi = (int)std::floor(hi);
      if (clo > chi) continue;
      double w1 = a1 * clo + b1, w2 = a2 * clo + b2;
      runs.push_back({r, clo, chi - clo + 1,
                      p0[0] + w1 * d10[0] + w2 * d20[0],
                      p0[1] + w1 * d10[1] + w2 * d20[1],
                      p0[2] + w1 * d10[2] + w2 * d20[2],
                      stepx, stepy, stepz});
      memset(out_mask + (size_t)r * res + clo, 1, (size_t)(chi - clo + 1));
    }
  }
  // merge, order by (row, col), trim overlaps (adjacent triangles of one
  // chart may both cover an edge pixel; the mask byte dedupes it, so the
  // span stream must too — trim the later span's front, positions shifted
  // by its own step so the kept texels stay exact)
  size_t total = 0;
  for (const auto& v : tl) total += v.size();
  std::vector<TexRun> all;
  all.reserve(total);
  for (auto& v : tl) all.insert(all.end(), v.begin(), v.end());
  std::sort(all.begin(), all.end(), [](const TexRun& a, const TexRun& b) {
    return a.r != b.r ? a.r < b.r : a.c0 < b.c0;
  });
  std::vector<TexRun> kept;
  kept.reserve(all.size());
  int cur_r = -1, cur_end = -1;
  for (TexRun run : all) {
    if (run.r != cur_r) {
      cur_r = run.r;
      cur_end = -1;
    }
    if (run.c0 <= cur_end) {
      int k = cur_end - run.c0 + 1;
      run.c0 += k;
      run.len -= k;
      run.px += k * run.sx;
      run.py += k * run.sy;
      run.pz += k * run.sz;
    }
    if (run.len <= 0) continue;
    cur_end = run.c0 + run.len - 1;
    kept.push_back(run);
  }
  float* out =
      (float*)malloc(sizeof(float) * 7 * std::max<size_t>(kept.size(), 1));
  if (!out) return -1;
  for (size_t i = 0; i < kept.size(); ++i) {
    float* o = out + 7 * i;
    o[0] = (float)kept[i].px;
    o[1] = (float)kept[i].py;
    o[2] = (float)kept[i].pz;
    o[3] = (float)kept[i].sx;
    o[4] = (float)kept[i].sy;
    o[5] = (float)kept[i].sz;
    o[6] = (float)kept[i].len;
  }
  *out_runs = out;
  return (long long)kept.size();
}

// Fused texture assembly: scatter decoded texel colors into the texture
// image, fill seam texels by 3x3 dilation, and flip vertically — one
// C++ pass replacing numpy fancy-scatter + cv2.dilate + three masked
// arithmetic passes + a flip view over the 2048^2 image (~6 full-image
// passes with temporaries on the shared host core).
//
// Semantics match the reference bake (`model.py:426-429`) exactly:
//   img[mask] = preds                     (row-major compaction order)
//   out = img           where mask
//   out = dilate3x3(img) where !mask      (max over IN-BOUNDS neighbors:
//       cv2.dilate's default border value is -inf for max filters, so
//       out-of-bounds pixels never contribute)
//   out = out[::-1]                       (texture row 0 = top, v = 1)
// Returns the number of masked texels consumed (== popcount(mask)),
// or -1 on allocation failure.
long long geo_tex_assemble(const unsigned char* preds,
                           const unsigned char* mask, int R, int C,
                           unsigned char* out) {
  size_t n = (size_t)R * R;
  unsigned char* img = (unsigned char*)calloc(n * C, 1);
  if (!img) return -1;
  long long j = 0;
  for (size_t i = 0; i < n; ++i) {
    if (mask[i]) {
      memcpy(img + i * C, preds + (size_t)j * C, C);
      ++j;
    }
  }
  for (int r = 0; r < R; ++r) {
    const unsigned char* mrow = mask + (size_t)r * R;
    unsigned char* orow = out + ((size_t)(R - 1 - r) * R) * C;
    int r0 = r > 0 ? r - 1 : 0, r1 = r < R - 1 ? r + 1 : r;
    for (int c = 0; c < R; ++c) {
      unsigned char* o = orow + (size_t)c * C;
      if (mrow[c]) {
        memcpy(o, img + ((size_t)r * R + c) * C, C);
        continue;
      }
      int c0 = c > 0 ? c - 1 : 0, c1 = c < R - 1 ? c + 1 : c;
      for (int ch = 0; ch < C; ++ch) {
        unsigned char mx = 0;
        for (int rr = r0; rr <= r1; ++rr)
          for (int cc = c0; cc <= c1; ++cc) {
            unsigned char v = img[((size_t)rr * R + cc) * C + ch];
            if (v > mx) mx = v;
          }
        o[ch] = mx;
      }
    }
  }
  free(img);
  return j;
}

// Fused masked compaction + uint16 AABB quantization of rasterized texel
// positions: out[j] = clip(rint((pos[i] - lo) / span * 65535), 0, 65535)
// for the j-th set mask bit (row-major scan order, identical to numpy's
// `pos[mask]`).  Replaces a two-pass numpy boolean gather + quantize that
// cost ~0.6 s per 2048^2 bake on the shared host core (this loop touches
// the 50 MB position buffer once).  Arithmetic is float32 in the same
// operation order as the numpy expression in training/ae.py
// `_dispatch_texels`, and rintf under the default rounding mode matches
// np.rint (round half to even) — the wire is bit-identical.  Returns the
// number of compacted texels (== popcount(mask)).
long long geo_mask_compact_q16(const float* pos, const unsigned char* mask,
                               long long n, const float* lo,
                               const float* span, unsigned short* out) {
  const float lx = lo[0], ly = lo[1], lz = lo[2];
  const float sx = span[0], sy = span[1], sz = span[2];
  long long j = 0;
  for (long long i = 0; i < n; ++i) {
    if (!mask[i]) continue;
    const float* p = pos + 3 * i;
    float qx = rintf((p[0] - lx) / sx * 65535.0f);
    float qy = rintf((p[1] - ly) / sy * 65535.0f);
    float qz = rintf((p[2] - lz) / sz * 65535.0f);
    qx = qx < 0.0f ? 0.0f : (qx > 65535.0f ? 65535.0f : qx);
    qy = qy < 0.0f ? 0.0f : (qy > 65535.0f ? 65535.0f : qy);
    qz = qz < 0.0f ? 0.0f : (qz > 65535.0f ? 65535.0f : qz);
    unsigned short* o = out + 3 * j;
    o[0] = (unsigned short)qx;
    o[1] = (unsigned short)qy;
    o[2] = (unsigned short)qz;
    ++j;
  }
  return j;
}

// ---------------------------------------------------------------------------
// UV atlas helpers: normal-axis chart segmentation (union-find over shared
// edges within a 6-way normal bin) and minimal-area oriented bounding-rect
// angles (batched monotone-chain hull + rotating calipers).  These mirror
// the Python reference implementations in geometry/uvatlas.py bit-for-bit
// (same union order, same candidate-angle set) — moved here because at
// 1000+ charts the Python loops dominated decode wall-clock.
// ---------------------------------------------------------------------------

void geo_charts_by_axis(const float* verts, const int* tris, int nt,
                        int* out_root, int* out_bin) {
  // normal bin: argmax over [+x,-x,+y,-y,+z,-z] of the face normal (first
  // max wins, like numpy argmax; normalization cannot change the argmax)
  for (int t = 0; t < nt; ++t) {
    const float* p0 = verts + 3 * tris[3 * t];
    const float* p1 = verts + 3 * tris[3 * t + 1];
    const float* p2 = verts + 3 * tris[3 * t + 2];
    float e1x = p1[0] - p0[0], e1y = p1[1] - p0[1], e1z = p1[2] - p0[2];
    float e2x = p2[0] - p0[0], e2y = p2[1] - p0[1], e2z = p2[2] - p0[2];
    float n[3] = {e1y * e2z - e1z * e2y, e1z * e2x - e1x * e2z,
                  e1x * e2y - e1y * e2x};
    double cand[6] = {n[0], -n[0], n[1], -n[1], n[2], -n[2]};
    int best = 0;
    for (int k = 1; k < 6; ++k)
      if (cand[k] > cand[best]) best = k;
    out_bin[t] = best;
  }

  // edge -> incident faces, in first-insertion order (faces scanned in
  // order, edges as (min,max) vertex pairs)
  std::unordered_map<uint64_t, int> edge_slot;
  edge_slot.reserve((size_t)nt * 2);
  std::vector<std::vector<int>> lists;
  lists.reserve((size_t)nt * 3 / 2);
  for (int t = 0; t < nt; ++t) {
    for (int k = 0; k < 3; ++k) {
      uint32_t a = (uint32_t)tris[3 * t + k];
      uint32_t b = (uint32_t)tris[3 * t + (k + 1) % 3];
      if (a > b) std::swap(a, b);
      uint64_t key = ((uint64_t)a << 32) | b;
      auto it = edge_slot.find(key);
      if (it == edge_slot.end()) {
        edge_slot.emplace(key, (int)lists.size());
        lists.emplace_back();
        lists.back().push_back(t);
      } else {
        lists[it->second].push_back(t);
      }
    }
  }

  std::vector<int> parent(nt);
  for (int i = 0; i < nt; ++i) parent[i] = i;
  auto find = [&](int x) {
    while (parent[x] != x) {
      parent[x] = parent[parent[x]];
      x = parent[x];
    }
    return x;
  };
  for (auto& faces : lists) {
    for (size_t i = 1; i < faces.size(); ++i) {
      int a = faces[0], b = faces[i];
      if (out_bin[a] != out_bin[b]) continue;
      int ra = find(a), rb = find(b);
      if (ra != rb) parent[ra] = rb;
    }
  }
  for (int i = 0; i < nt; ++i) out_root[i] = find(i);
}

void geo_oriented_rect_angles(const double* uv, const long long* offsets,
                              int n_charts, double* out_angle) {
  const double HALF_PI = 1.5707963267948966;
#pragma omp parallel for schedule(dynamic, 8)
  for (int c = 0; c < n_charts; ++c) {
    long long s = offsets[c], e = offsets[c + 1];
    long long n = e - s;
    out_angle[c] = 0.0;
    if (n < 3) continue;
    // polygon whose edge directions are the caliper candidates: the
    // convex hull for large charts, the raw point cycle for <= 8 points
    std::vector<std::array<double, 2>> poly;
    if (n <= 8) {
      poly.reserve(n);
      for (long long i = s; i < e; ++i)
        poly.push_back({uv[2 * i], uv[2 * i + 1]});
    } else {
      std::vector<std::array<double, 2>> pts;
      pts.reserve(n);
      for (long long i = s; i < e; ++i)
        pts.push_back({uv[2 * i], uv[2 * i + 1]});
      std::sort(pts.begin(), pts.end());
      pts.erase(std::unique(pts.begin(), pts.end()), pts.end());
      if ((long long)pts.size() < 3) {
        continue;  // degenerate: all points collinear on <3 distinct
      }
      auto cross = [](const std::array<double, 2>& o,
                      const std::array<double, 2>& a,
                      const std::array<double, 2>& b) {
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]);
      };
      std::vector<std::array<double, 2>> hull(2 * pts.size());
      size_t k = 0;
      for (size_t i = 0; i < pts.size(); ++i) {  // lower
        while (k >= 2 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
        hull[k++] = pts[i];
      }
      for (size_t i = pts.size() - 1, t0 = k + 1; i-- > 0;) {  // upper
        while (k >= t0 && cross(hull[k - 2], hull[k - 1], pts[i]) <= 0) --k;
        hull[k++] = pts[i];
      }
      hull.resize(k > 1 ? k - 1 : k);
      poly = std::move(hull);
      if (poly.size() < 3) continue;
    }
    // candidate angles: edge directions mod pi/2, sorted + deduped
    std::vector<double> angles;
    angles.reserve(poly.size());
    size_t np_ = poly.size();
    for (size_t i = 0; i < np_; ++i) {
      size_t j = (i + 1) % np_;
      double a = std::fmod(
          std::atan2(poly[j][1] - poly[i][1], poly[j][0] - poly[i][0]),
          HALF_PI);
      if (a < 0) a += HALF_PI;
      angles.push_back(a);
    }
    std::sort(angles.begin(), angles.end());
    angles.erase(std::unique(angles.begin(), angles.end()), angles.end());
    double best_a = 0.0, best_area = std::numeric_limits<double>::infinity();
    for (double a : angles) {
      double ca = std::cos(a), sa = std::sin(a);
      double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
      for (auto& p : poly) {
        double x = p[0] * ca + p[1] * sa;
        double y = -p[0] * sa + p[1] * ca;
        xmin = std::min(xmin, x);
        xmax = std::max(xmax, x);
        ymin = std::min(ymin, y);
        ymax = std::max(ymax, y);
      }
      double area = (xmax - xmin) * (ymax - ymin);
      if (area < best_area) {
        best_area = area;
        best_a = a;
      }
    }
    out_angle[c] = best_a;
  }
}

// ---------------------------------------------------------------------------
// Z-buffered perspective rasterization for the software multi-view renderer
// (rendering/softraster.py).  Mirrors the vectorized numpy reference
// (render_view) operation-for-operation in float64 so the Python fallback
// and this kernel agree to rounding: per-pixel barycentrics evaluated
// directly (not incrementally), the same skip rules (any z <= 1e-6,
// |det| < 1e-12), cover = all w >= 0, depth = 1/max(sum wi/zi, 1e-12),
// strict `depth < zbuf` test, and perspective-correct UV.  Texture lookup
// and shading stay in Python (vectorized gathers over the face-id map).
//
// px/py/z: projected pixel coords + camera depth per vertex (float64, nv).
// faces: nt x 3 vertex ids.  order: the nt face indices in paint order
// (the Python path sorts near-to-far; with a z-buffer order only breaks
// exact-depth ties, but matching it keeps parity exact).  face_uvs:
// nt x 3 x 2 float32.  Outputs (res x res, caller-allocated): zbuf
// (float64, init +inf), face_id (int32, init -1), u/v (float32, init 0).
void geo_render_view(const double* px, const double* py, const double* z,
                     int nv, const int* faces, const int* order, int nt,
                     const float* face_uvs, int res, double* zbuf,
                     int* face_id, float* out_u, float* out_v) {
  (void)nv;
  for (int oi = 0; oi < nt; ++oi) {
    int fi = order ? order[oi] : oi;
    int i0 = faces[3 * fi], i1 = faces[3 * fi + 1], i2 = faces[3 * fi + 2];
    double z0 = z[i0], z1 = z[i1], z2 = z[i2];
    if (z0 <= 1e-6 || z1 <= 1e-6 || z2 <= 1e-6) continue;
    double x0 = px[i0], x1 = px[i1], x2 = px[i2];
    double y0 = py[i0], y1 = py[i1], y2 = py[i2];
    // clamp in double BEFORE the int cast: a vertex just above the
    // z<=1e-6 near-clip can project to coords far outside int range,
    // and double->int overflow is UB (cf. geo_rasterize_uv above)
    int xmin = (int)std::min(std::max(std::floor(std::min({x0, x1, x2})),
                                      0.0), (double)res);
    int xmax = (int)std::max(std::min(std::ceil(std::max({x0, x1, x2})),
                                      (double)(res - 1)), -1.0);
    int ymin = (int)std::min(std::max(std::floor(std::min({y0, y1, y2})),
                                      0.0), (double)res);
    int ymax = (int)std::max(std::min(std::ceil(std::max({y0, y1, y2})),
                                      (double)(res - 1)), -1.0);
    if (xmin > xmax || ymin > ymax) continue;
    double d = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0);
    if (std::fabs(d) < 1e-12) continue;
    double inv_z0 = 1.0 / z0, inv_z1 = 1.0 / z1, inv_z2 = 1.0 / z2;
    const float* uv0 = face_uvs + 6 * fi;
    const float* uv1 = uv0 + 2;
    const float* uv2 = uv0 + 4;
    for (int gy = ymin; gy <= ymax; ++gy) {
      size_t rowbase = (size_t)gy * res;
      for (int gx = xmin; gx <= xmax; ++gx) {
        double w1 = ((gx - x0) * (y2 - y0) - (x2 - x0) * (gy - y0)) / d;
        double w2 = ((x1 - x0) * (gy - y0) - (gx - x0) * (y1 - y0)) / d;
        double w0 = 1.0 - w1 - w2;
        if (w0 < 0.0 || w1 < 0.0 || w2 < 0.0) continue;
        double q0 = w0 * inv_z0, q1 = w1 * inv_z1, q2 = w2 * inv_z2;
        double invz = q0 + q1 + q2;
        double depth = 1.0 / std::max(invz, 1e-12);
        size_t pix = rowbase + gx;
        if (!(depth < zbuf[pix])) continue;
        zbuf[pix] = depth;
        face_id[pix] = fi;
        out_u[pix] =
            (float)((uv0[0] * q0 + uv1[0] * q1 + uv2[0] * q2) * depth);
        out_v[pix] =
            (float)((uv0[1] * q0 + uv1[1] * q1 + uv2[1] * q2) * depth);
      }
    }
  }
}

}  // extern "C"
