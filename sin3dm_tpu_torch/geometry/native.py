"""ctypes bindings of the port's C++ geometry library (`cpp/geometry.cpp`,
a copy of the JAX package's source, byte for byte).

The library is compiled by `g++` at first use, with the flags of the JAX
package's Makefile, into `build/sin3dm_tpu_torch/` at the root of the
checkout, under a name hashed from the source, the flags and the host;
each build goes to a temporary file moved into place, so concurrent
processes may build at once.  Without `g++` it raises.  Where `g++`
cannot link OpenMP (no libgomp development files: the H100 machine's
toolchain), the same source builds without `-fopenmp` and runs its loops
on one thread: every parallel loop of the source writes per-index or
per-thread results that it merges in a fixed order, so the outputs are
the same, bit for bit (tested against the JAX package's OpenMP build).
The library is loaded once per process.  Every function takes
contiguous float32/int32 numpy arrays; the C calls release the
interpreter lock (ctypes).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Tuple

import numpy as np

from ..ops._build import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "cpp" / "geometry.cpp"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-fopenmp",
             "-Wall", "-Wextra", "-Wno-unused-parameter", "-shared"]

_lib = None
_lock = threading.Lock()

c_float_p = ctypes.POINTER(ctypes.c_float)
c_int_p = ctypes.POINTER(ctypes.c_int)
c_ubyte_p = ctypes.POINTER(ctypes.c_ubyte)
c_double_p = ctypes.POINTER(ctypes.c_double)
c_ll_p = ctypes.POINTER(ctypes.c_longlong)


def _cxx() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the port's geometry library "
                           "builds only where a C++ compiler is installed")
    return cxx


def _tmp(path: Path) -> Path:
    return path.with_name(
        f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")


@functools.lru_cache(maxsize=None)
def build_flags() -> tuple:
    """CXX_FLAGS where the compiler links OpenMP, else CXX_FLAGS without
    `-fopenmp` (probed once per process by linking an empty library)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    probe = _tmp(BUILD_DIR / "openmp-probe.so")
    proc = subprocess.run([_cxx(), "-fopenmp", "-fPIC", "-shared", "-x",
                           "c++", "-", "-o", str(probe)],
                          input="int sin3dm_probe() { return 0; }\n",
                          capture_output=True, text=True)
    probe.unlink(missing_ok=True)
    if proc.returncode == 0:
        return tuple(CXX_FLAGS)
    return tuple(f for f in CXX_FLAGS if f != "-fopenmp")


def target() -> Path:
    """Where the library goes: a hash of the source, the flags and the
    host (`-march=native` builds for this host's CPU alone, so a build
    directory copied to another host builds anew)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(build_flags()).encode())
    h.update(" ".join((os.uname().nodename, os.uname().machine)).encode())
    return BUILD_DIR / f"geometry-{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the library if it is missing; {"path", "seconds",
    "flags"}."""
    so, flags = target(), list(build_flags())
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "flags": flags}
    cxx = _cxx()
    tmp = _tmp(so)
    t0 = time.perf_counter()
    proc = subprocess.run([cxx, *flags, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, so)
    return {"path": str(so), "seconds": time.perf_counter() - t0,
            "flags": flags}


def _declare(L: ctypes.CDLL) -> None:
    L.geo_free.argtypes = [ctypes.c_void_p]
    L.geo_free.restype = None
    L.geo_marching_cubes.argtypes = [
        c_float_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(c_float_p), c_int_p, ctypes.POINTER(c_int_p), c_int_p]
    L.geo_marching_cubes.restype = ctypes.c_int
    L.geo_marching_cubes_sparse.argtypes = [
        c_ubyte_p, c_int_p, ctypes.POINTER(ctypes.c_byte),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
        ctypes.POINTER(c_float_p), c_int_p, ctypes.POINTER(c_int_p), c_int_p]
    L.geo_marching_cubes_sparse.restype = ctypes.c_int
    L.geo_connected_components.argtypes = [c_int_p, ctypes.c_int,
                                           ctypes.c_int, c_int_p]
    L.geo_connected_components.restype = ctypes.c_int
    L.geo_decimate.argtypes = [
        c_float_p, ctypes.c_int, c_int_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int,
        ctypes.POINTER(c_float_p), c_int_p, ctypes.POINTER(c_int_p), c_int_p]
    L.geo_decimate.restype = ctypes.c_int
    L.geo_rasterize_uv.argtypes = [c_float_p, ctypes.c_int, c_int_p,
                                   c_float_p, c_int_p, ctypes.c_int,
                                   ctypes.c_int, c_float_p, c_ubyte_p]
    L.geo_rasterize_uv.restype = None
    L.geo_rasterize_uv_runs.argtypes = [c_float_p, ctypes.c_int, c_int_p,
                                        c_float_p, c_int_p, ctypes.c_int,
                                        ctypes.c_int, c_ubyte_p,
                                        ctypes.POINTER(c_float_p)]
    L.geo_rasterize_uv_runs.restype = ctypes.c_longlong
    L.geo_mask_compact_q16.argtypes = [
        c_float_p, c_ubyte_p, ctypes.c_longlong, c_float_p, c_float_p,
        ctypes.POINTER(ctypes.c_ushort)]
    L.geo_mask_compact_q16.restype = ctypes.c_longlong
    L.geo_tex_assemble.argtypes = [c_ubyte_p, c_ubyte_p, ctypes.c_int,
                                   ctypes.c_int, c_ubyte_p]
    L.geo_tex_assemble.restype = ctypes.c_longlong
    L.geo_charts_by_axis.argtypes = [c_float_p, c_int_p, ctypes.c_int,
                                     c_int_p, c_int_p]
    L.geo_charts_by_axis.restype = None
    L.geo_oriented_rect_angles.argtypes = [c_double_p, c_ll_p, ctypes.c_int,
                                           c_double_p]
    L.geo_oriented_rect_angles.restype = None
    L.geo_bvh_build.argtypes = [c_float_p, ctypes.c_int, c_int_p,
                                ctypes.c_int]
    L.geo_bvh_build.restype = ctypes.c_void_p
    L.geo_bvh_destroy.argtypes = [ctypes.c_void_p]
    L.geo_bvh_destroy.restype = None
    L.geo_bvh_closest.argtypes = [ctypes.c_void_p, c_float_p, ctypes.c_int,
                                  c_float_p, c_int_p, c_float_p]
    L.geo_bvh_closest.restype = None
    L.geo_bvh_winding.argtypes = [ctypes.c_void_p, c_float_p, ctypes.c_int,
                                  c_float_p]
    L.geo_bvh_winding.restype = None
    L.geo_bvh_signed_distance.argtypes = [ctypes.c_void_p, c_float_p,
                                          ctypes.c_int, c_float_p, c_int_p,
                                          c_float_p]
    L.geo_bvh_signed_distance.restype = None
    L.geo_render_view.argtypes = [
        c_double_p, c_double_p, c_double_p, ctypes.c_int, c_int_p, c_int_p,
        ctypes.c_int, c_float_p, ctypes.c_int, c_double_p, c_int_p,
        c_float_p, c_float_p]
    L.geo_render_view.restype = None


def lib() -> ctypes.CDLL:
    """The loaded library, built first if missing (once per process)."""
    global _lib
    with _lock:
        if _lib is None:
            L = ctypes.CDLL(build()["path"])
            _declare(L)
            _lib = L
        return _lib


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32)


def _i32(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int32)


def _take(ptr, n: int) -> np.ndarray:
    """Copy n values out of a library buffer and free it."""
    arr = np.ctypeslib.as_array(ptr, shape=(n,)).copy() if n else \
        np.zeros(0, np.dtype(ptr._type_))
    lib().geo_free(ctypes.cast(ptr, ctypes.c_void_p))
    return arr


def _mesh_out(call) -> Tuple[np.ndarray, np.ndarray]:
    """Run a library call that returns a malloc'd mesh; (v float64 [n, 3],
    f int64 [m, 3])."""
    vp, tp = c_float_p(), c_int_p()
    nv, nt = ctypes.c_int(), ctypes.c_int()
    if call(ctypes.byref(vp), ctypes.byref(nv), ctypes.byref(tp),
            ctypes.byref(nt)) != 0:
        raise RuntimeError("geometry library call failed")
    v = _take(vp, nv.value * 3).reshape(-1, 3).astype(np.float64)
    f = _take(tp, nt.value * 3).reshape(-1, 3).astype(np.int64)
    return v, f


def marching_cubes(grid: np.ndarray,
                   iso: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Isosurface of a `[nx, ny, nz]` grid; vertices in index space."""
    g = _f32(grid)
    nx, ny, nz = g.shape
    return _mesh_out(lambda *out: lib().geo_marching_cubes(
        g.ctypes.data_as(c_float_p), nx, ny, nz, iso, *out))


def marching_cubes_sparse(signs: np.ndarray, block_ids: np.ndarray,
                          block_vals: np.ndarray, count: int,
                          shape: Tuple[int, int, int],
                          padded: Tuple[int, int, int],
                          quant: float) -> Tuple[np.ndarray, np.ndarray]:
    """The iso-0 surface straight from the sparse wire
    (`ops/sparse_grid.SparseGrid`): the same vertices and faces, in the
    same order, as `marching_cubes` of the decoded grid padded by one
    layer of +1.0; vertices in that padded index space."""
    ids = _i32(block_ids).reshape(-1)
    if int(count) > len(ids):
        raise ValueError(f"sparse grid overflow: {int(count)} flagged "
                         f"blocks > capacity {len(ids)}")
    s = np.ascontiguousarray(signs, dtype=np.uint8)
    vals = np.ascontiguousarray(block_vals, dtype=np.int8)
    X, Y, Z = (int(x) for x in shape)
    PX, PY, PZ = (int(x) for x in padded)
    # float32(quant / 127): the C side's (q + 0.5) * dq then equals
    # decode_host's numpy float32 product
    dq = np.float32(float(quant) / 127.0)
    return _mesh_out(lambda *out: lib().geo_marching_cubes_sparse(
        s.ctypes.data_as(c_ubyte_p), ids.ctypes.data_as(c_int_p),
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_byte)), int(count),
        X, Y, Z, PX, PY, PZ, float(dq), *out))


def face_components(faces: np.ndarray, n_verts: int
                    ) -> Tuple[np.ndarray, int]:
    """(component id per face, number of components) over shared
    vertices."""
    f = _i32(faces).reshape(-1)
    out = np.empty(len(f) // 3, dtype=np.int32)
    n = lib().geo_connected_components(
        f.ctypes.data_as(c_int_p), len(f) // 3, n_verts,
        out.ctypes.data_as(c_int_p))
    return out, int(n)


def decimate(verts: np.ndarray, faces: np.ndarray, target_faces: int,
             prepass_mult: int = 8) -> Tuple[np.ndarray, np.ndarray]:
    """Quadric edge collapse to about `target_faces`, after a
    vertex-clustering pre-pass that keeps about prepass_mult x target
    faces (<= 0 skips it)."""
    v = _f32(verts).reshape(-1)
    f = _i32(faces).reshape(-1)
    return _mesh_out(lambda *out: lib().geo_decimate(
        v.ctypes.data_as(c_float_p), len(v) // 3,
        f.ctypes.data_as(c_int_p), len(f) // 3, int(target_faces),
        int(prepass_mult), *out))


def _uv_args(uvs, tri_uv, verts, tri_pos):
    u = _f32(uvs).reshape(-1, 2)
    tu = _i32(tri_uv).reshape(-1)
    v = _f32(verts).reshape(-1)
    tpv = _i32(tri_pos).reshape(-1)
    return (u, tu, v, tpv), (u.ctypes.data_as(c_float_p), len(u),
                             tu.ctypes.data_as(c_int_p),
                             v.ctypes.data_as(c_float_p),
                             tpv.ctypes.data_as(c_int_p), len(tu) // 3)


def rasterize_uv(uvs: np.ndarray, tri_uv: np.ndarray, verts: np.ndarray,
                 tri_pos: np.ndarray, res: int):
    """Rasterize triangles in UV space -> (pos `[res, res, 3]` float32,
    mask `[res, res]` bool); row r covers v = (r + 0.5) / res."""
    keep, args = _uv_args(uvs, tri_uv, verts, tri_pos)
    pos = np.zeros((res, res, 3), np.float32)
    mask = np.zeros((res, res), np.uint8)
    lib().geo_rasterize_uv(*args, res, pos.ctypes.data_as(c_float_p),
                           mask.ctypes.data_as(c_ubyte_p))
    del keep
    return pos, mask.astype(bool)


def rasterize_uv_runs(uvs: np.ndarray, tri_uv: np.ndarray,
                      verts: np.ndarray, tri_pos: np.ndarray, res: int):
    """`rasterize_uv`'s coverage, with positions as per-row spans: (mask
    `[res, res]` bool, runs `[R, 7]` float32 of start xyz, per-column step
    xyz, length), ordered so that expanding them gives the row-major
    masked texel stream."""
    keep, args = _uv_args(uvs, tri_uv, verts, tri_pos)
    mask = np.zeros((res, res), np.uint8)
    out_runs = c_float_p()
    n = lib().geo_rasterize_uv_runs(*args, res,
                                    mask.ctypes.data_as(c_ubyte_p),
                                    ctypes.byref(out_runs))
    del keep
    if n < 0:
        raise MemoryError("geo_rasterize_uv_runs: allocation failed")
    return mask.astype(bool), _take(out_runs, int(n) * 7).reshape(-1, 7)


def mask_compact_q16(pos: np.ndarray, mask: np.ndarray, lo: np.ndarray,
                     span: np.ndarray) -> np.ndarray:
    """`np.clip(np.rint((pos[mask] - lo) / span * 65535), 0, 65535)` as
    uint16 `[count, 3]`, in one pass (float32 in the same order)."""
    p = _f32(pos).reshape(-1, 3)
    m = np.ascontiguousarray(mask, np.uint8).reshape(-1)
    if p.shape[0] != m.shape[0]:
        raise ValueError(f"mask_compact_q16: {p.shape[0]} positions, "
                         f"{m.shape[0]} mask values")
    lo = _f32(lo).reshape(3)
    span = _f32(span).reshape(3)
    out = np.empty((int(m.sum()), 3), np.uint16)
    lib().geo_mask_compact_q16(
        p.ctypes.data_as(c_float_p), m.ctypes.data_as(c_ubyte_p),
        p.shape[0], lo.ctypes.data_as(c_float_p),
        span.ctypes.data_as(c_float_p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ushort)))
    return out


def tex_assemble(preds: np.ndarray, mask: np.ndarray, reso: int
                 ) -> np.ndarray:
    """Scatter texel colours `[N, C]` uint8 into the `[R, R]` mask, fill
    unmasked texels with the 3x3 max of their neighbours (seam dilation)
    and flip vertically: `[R, R, C]` uint8, row 0 at v = 1."""
    preds = np.ascontiguousarray(preds, np.uint8)
    m = np.ascontiguousarray(mask, np.uint8).reshape(-1)
    if m.shape[0] != reso * reso or int(m.sum()) != preds.shape[0]:
        raise ValueError(f"tex_assemble: {preds.shape[0]} colours for a "
                         f"mask of {int(m.sum())} texels in {m.shape[0]}")
    C = preds.shape[-1]
    out = np.empty((reso, reso, C), np.uint8)
    lib().geo_tex_assemble(
        preds.ctypes.data_as(c_ubyte_p), m.ctypes.data_as(c_ubyte_p),
        reso, C, out.ctypes.data_as(c_ubyte_p))
    return out


def charts_by_axis(verts: np.ndarray, tris: np.ndarray):
    """(union-find root per face within the 6 normal-axis bins over shared
    edges, bin per face)."""
    v = _f32(verts).reshape(-1)
    f = _i32(tris).reshape(-1)
    nt = len(f) // 3
    root = np.empty(nt, np.int32)
    bins = np.empty(nt, np.int32)
    lib().geo_charts_by_axis(
        v.ctypes.data_as(c_float_p), f.ctypes.data_as(c_int_p), nt,
        root.ctypes.data_as(c_int_p), bins.ctypes.data_as(c_int_p))
    return root, bins


def oriented_rect_angles(uv_list) -> np.ndarray:
    """One rotation angle in [0, pi/2) per 2-D point set: the one that
    minimises its bounding rectangle's area."""
    n = len(uv_list)
    if n == 0:
        return np.zeros(0, np.float64)
    offsets = np.zeros(n + 1, np.int64)
    for i, uv in enumerate(uv_list):
        offsets[i + 1] = offsets[i] + len(uv)
    cat = (np.concatenate([np.asarray(u, np.float64).reshape(-1, 2)
                           for u in uv_list], axis=0)
           if offsets[-1] else np.zeros((0, 2)))
    cat = np.ascontiguousarray(cat, np.float64)
    out = np.empty(n, np.float64)
    lib().geo_oriented_rect_angles(
        cat.ctypes.data_as(c_double_p), offsets.ctypes.data_as(c_ll_p), n,
        out.ctypes.data_as(c_double_p))
    return out


def _query_threads() -> int:
    """Threads over which `MeshBVH` splits a query: 1 where the library
    runs its own OpenMP loop, else the cores this process may use."""
    if "-fopenmp" in build_flags():
        return 1
    return len(os.sched_getaffinity(0))


class MeshBVH:
    """Closest-point and fast-winding-number queries on a triangle mesh
    (the library's BVH over float32 vertices and int32 faces).

    Every query point is answered on its own, so where the library was
    built without OpenMP the points are split into contiguous chunks that
    threads hand to the library at once (ctypes releases the interpreter
    lock): the same outputs, bit for bit, as one call."""

    _MIN_CHUNK = 16384

    def __init__(self, verts: np.ndarray, faces: np.ndarray):
        self._v = _f32(verts).reshape(-1, 3)
        self._f = _i32(faces).reshape(-1, 3)
        L = lib()
        self._h = L.geo_bvh_build(
            self._v.ctypes.data_as(c_float_p), len(self._v),
            self._f.ctypes.data_as(c_int_p), len(self._f))
        if not self._h:
            raise MemoryError("geo_bvh_build returned no tree")
        # the finalizer holds the library's function, so the tree is freed
        # before the library can be unloaded, at collection or at exit
        weakref.finalize(self, L.geo_bvh_destroy, self._h)

    def _run(self, fn, pts: np.ndarray, outs) -> None:
        """`fn(handle, points, n, *outs)` over `pts` `[N, 3]`, in chunks
        over threads where the library is serial; each output `[N, ...]`
        is written in place."""
        n = len(pts)
        threads = min(_query_threads(), max(1, n // self._MIN_CHUNK))

        def call(lo: int, hi: int) -> None:
            fn(self._h, pts[lo:hi].ctypes.data_as(c_float_p), hi - lo,
               *(o[lo:hi].ctypes.data_as(
                   c_int_p if o.dtype == np.int32 else c_float_p)
                 for o in outs))

        if threads <= 1:
            call(0, n)
            return
        bounds = np.linspace(0, n, threads * 4 + 1).astype(np.int64)
        with ThreadPoolExecutor(threads) as pool:
            for fut in [pool.submit(call, int(lo), int(hi))
                        for lo, hi in zip(bounds[:-1], bounds[1:])
                        if hi > lo]:
                fut.result()

    def closest(self, pts: np.ndarray):
        """-> (distance [N], face [N], barycentric [N, 3]), float32/int32."""
        p = _f32(pts).reshape(-1, 3)
        n = len(p)
        out = (np.empty(n, np.float32), np.empty(n, np.int32),
               np.empty((n, 3), np.float32))
        self._run(lib().geo_bvh_closest, p, out)
        return out

    def winding(self, pts: np.ndarray) -> np.ndarray:
        """Generalised winding number [N] float32 (1 inside, 0 outside)."""
        p = _f32(pts).reshape(-1, 3)
        w = np.empty(len(p), np.float32)
        self._run(lib().geo_bvh_winding, p, (w,))
        return w

    def signed_distance(self, pts: np.ndarray):
        """-> (sdf [N], negative where the winding number exceeds 0.5,
        face [N], barycentric [N, 3])."""
        p = _f32(pts).reshape(-1, 3)
        n = len(p)
        out = (np.empty(n, np.float32), np.empty(n, np.int32),
               np.empty((n, 3), np.float32))
        self._run(lib().geo_bvh_signed_distance, p, out)
        return out


def render_view_raster(px: np.ndarray, py: np.ndarray, z: np.ndarray,
                       faces: np.ndarray, order: np.ndarray,
                       face_uvs: np.ndarray, res: int):
    """Z-buffered perspective rasterization of projected vertices in paint
    order: per-pixel (zbuf float64, face id int32 (-1 where empty), u, v
    float32) maps `[res, res]`."""
    pxa = np.ascontiguousarray(px, np.float64)
    pya = np.ascontiguousarray(py, np.float64)
    za = np.ascontiguousarray(z, np.float64)
    f = _i32(faces).reshape(-1)
    o = _i32(order).reshape(-1)
    uv = _f32(face_uvs).reshape(-1)
    nt = len(f) // 3
    if len(o) != nt or len(uv) != nt * 6:
        raise ValueError(f"render_view_raster: {nt} faces, {len(o)} in the "
                         f"paint order, {len(uv)} uv values")
    zbuf = np.full((res, res), np.inf, np.float64)
    face_id = np.full((res, res), -1, np.int32)
    u = np.zeros((res, res), np.float32)
    v = np.zeros((res, res), np.float32)
    lib().geo_render_view(
        pxa.ctypes.data_as(c_double_p), pya.ctypes.data_as(c_double_p),
        za.ctypes.data_as(c_double_p), len(pxa), f.ctypes.data_as(c_int_p),
        o.ctypes.data_as(c_int_p), nt, uv.ctypes.data_as(c_float_p), res,
        zbuf.ctypes.data_as(c_double_p), face_id.ctypes.data_as(c_int_p),
        u.ctypes.data_as(c_float_p), v.ctypes.data_as(c_float_p))
    return zbuf, face_id, u, v
