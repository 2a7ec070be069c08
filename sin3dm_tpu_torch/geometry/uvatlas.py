"""UV atlas of the mesh path (counterpart of
`sin3dm_tpu/geometry/uvatlas.py`, the same charts, packing and output).

Normal-axis chart segmentation (6 directional bins), orthographic
projection of each chart along its axis, each chart rotated to its
minimal-area bounding rectangle, and the best of four packers into the
unit square (FFDH shelves, skyline bottom-left, MaxRects-BSSF, and
height profiles that let round charts nest).  While the estimated texel
use stays below a target, the largest chart is split and the atlas
repacked.  Projection along the dominant normal bounds distortion and
disjoint placements rule out overlaps.  numpy only, over the native
library.

Returns (uvs [N,2], mesh_tex_idx [F,3]) like xatlas.parametrize.
`SIN3DM_UV_TARGET` and `SIN3DM_UV_MAX_SPLITS` set the split loop's
defaults, `SIN3DM_UV_DEBUG` prints each packing round, and `seam_stats`
measures the seams an atlas cut, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
from numpy.lib.stride_tricks import sliding_window_view

from . import native


_AXES = np.array([
    [1, 0, 0], [-1, 0, 0],
    [0, 1, 0], [0, -1, 0],
    [0, 0, 1], [0, 0, -1],
], np.float64)

# (u_axis, v_axis) for each bin; u flipped on negative bins so charts are
# not mirrored
_PROJ = [
    ((0, -1, 0), (0, 0, 1)),   # +x: u=-y, v=z
    ((0, 1, 0), (0, 0, 1)),    # -x: u=+y, v=z
    ((1, 0, 0), (0, 0, 1)),    # +y: u=x, v=z
    ((-1, 0, 0), (0, 0, 1)),   # -y
    ((1, 0, 0), (0, 1, 0)),    # +z: u=x, v=y
    ((-1, 0, 0), (0, 1, 0)),   # -z
]


def _charts_by_axis(v: np.ndarray, f: np.ndarray) -> np.ndarray:
    """Per-face chart id: connected components within each normal bin
    (native union-find — the Python edge map dominated decode time at
    50k faces)."""
    if len(f) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    roots, bins = native.charts_by_axis(v, f)
    _, chart = np.unique(roots, return_inverse=True)
    return chart, bins.astype(np.int64)


def seam_stats(v: np.ndarray, f: np.ndarray, tex_idx: np.ndarray) -> dict:
    """Seams of a parametrized mesh: an interior edge is a seam where its
    two faces give it different uv index pairs (chart boundaries and
    split cuts).  {"seam_length", "edge_length" (of the interior edges),
    "seam_ratio"}; boundary edges count in neither."""
    edges = {}
    seam_len = 0.0
    total_len = 0.0
    for fi in range(len(f)):
        for k in range(3):
            a, b = int(f[fi, k]), int(f[fi, (k + 1) % 3])
            ta, tb = int(tex_idx[fi, k]), int(tex_idx[fi, (k + 1) % 3])
            key = (min(a, b), max(a, b))
            length = float(np.linalg.norm(v[a] - v[b]))
            uvkey = (min(ta, tb), max(ta, tb))
            if key in edges:
                total_len += length
                if edges[key] != uvkey:
                    seam_len += length
            else:
                edges[key] = uvkey
    ratio = seam_len / total_len if total_len > 0 else 0.0
    return {"seam_length": seam_len, "edge_length": total_len,
            "seam_ratio": ratio}


def _pack_once(v: np.ndarray, f: np.ndarray, chart: np.ndarray,
               bins: np.ndarray, padding: float, effort: int = 1,
               profiles: dict = None):
    """Project each chart, pick the best of four packers, and return
    (scale, pos, rot, chart_rects, chart_vert_uv, mat_area) where
    mat_area is the total 2D chart material area (for the utilization
    estimate that drives the split-and-repack loop in parametrize).
    `profiles` caches chart silhouette profiles by the chart's face ids
    across the calls of one `parametrize` (split rounds re-project the
    untouched charts)."""
    if profiles is None:
        profiles = {}
    n_charts = chart.max() + 1 if len(f) else 0

    # project each chart; duplicate vertices per (chart, vertex).
    # chart_vert_uv rows are (faces_c, vids, uv): vids is the SORTED unique
    # vertex-id array of the chart, so local indices are
    # np.searchsorted(vids, <vertex ids>).
    order_f = np.argsort(chart, kind="stable")
    bounds = np.searchsorted(chart[order_f], np.arange(n_charts + 1))
    per_chart = []
    for c in range(n_charts):
        faces_c = order_f[bounds[c]:bounds[c + 1]]
        bin_id = bins[faces_c[0]]
        u_ax = np.array(_PROJ[bin_id][0], np.float64)
        v_ax = np.array(_PROJ[bin_id][1], np.float64)
        vids = np.unique(f[faces_c].reshape(-1))
        uv = np.stack([v[vids] @ u_ax, v[vids] @ v_ax], axis=-1)
        per_chart.append((faces_c, vids, uv))
    angles = native.oriented_rect_angles([p[2] for p in per_chart])

    chart_rects = []          # (w, h) of each chart in world units
    chart_vert_uv = []        # list of (faces_c, vids, uv)
    mat_area = 0.0
    for c, (faces_c, vids, uv) in enumerate(per_chart):
        # rotate to the minimal-area oriented bounding rect, then make the
        # rect wider than tall (90-deg rotation) for shelf packing
        a = angles[c]
        ca, sa = np.cos(a), np.sin(a)
        uv = uv @ np.array([[ca, -sa], [sa, ca]])
        uv -= uv.min(axis=0)
        w, h = uv.max(axis=0) if len(uv) else (0.0, 0.0)
        if h > w:
            uv = np.stack([uv[:, 1], w - uv[:, 0]], axis=-1)
            w, h = h, w
        chart_rects.append((max(w, 1e-9), max(h, 1e-9)))
        chart_vert_uv.append((faces_c, vids, uv))
        p = uv[np.searchsorted(vids, f[faces_c])]
        e1 = p[:, 1] - p[:, 0]
        e2 = p[:, 2] - p[:, 0]
        mat_area += float(0.5 * np.abs(
            e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]).sum())

    # rect packers: FFDH shelves (near-optimal when chart heights
    # cluster), skyline bottom-left (wins on mixed sizes) and MaxRects.
    # The global scale is binary-searched per packer for the largest
    # layout that fits [0,1]^2 and the best scale is kept.
    order = sorted(range(n_charts),
                   key=lambda c: -chart_rects[c][1])  # by height desc
    by_area = sorted(range(n_charts),
                     key=lambda c: -chart_rects[c][0] * chart_rects[c][1])
    orient_full = set(by_area[:48])

    def pack_shelf(scale):
        pos = {}
        shelves = []  # [y, height, x_used]
        y_top = 0.0
        for c in order:
            w = chart_rects[c][0] * scale + 2 * padding
            h = chart_rects[c][1] * scale + 2 * padding
            if w > 1.0 or h > 1.0:
                return None
            placed = False
            for sh in shelves:
                if h <= sh[1] and sh[2] + w <= 1.0:
                    pos[c] = (sh[2] + padding, sh[0] + padding)
                    sh[2] += w
                    placed = True
                    break
            if not placed:
                if y_top + h > 1.0:
                    return None
                shelves.append([y_top, h, w])
                pos[c] = (padding, y_top + padding)
                y_top += h
        return pos, {}

    def pack_skyline(scale):
        pos = {}
        # skyline: sorted list of (x, y, width) segments spanning [0,1]
        sky = [(0.0, 0.0, 1.0)]
        for c in order:
            w = chart_rects[c][0] * scale + 2 * padding
            h = chart_rects[c][1] * scale + 2 * padding
            if w > 1.0 or h > 1.0:
                return None
            # best (lowest resting y, then leftmost) left-edge position:
            # try each segment start
            best = None  # (y, x, i)
            for i, (sx, sy, sw) in enumerate(sky):
                if sx + w > 1.0 + 1e-12:
                    break  # segments are sorted by x; no fit further right
                # resting height = max skyline over [sx, sx + w)
                y = sy
                x_end = sx + w
                j = i
                while j < len(sky) and sky[j][0] < x_end - 1e-12:
                    y = max(y, sky[j][1])
                    j += 1
                if y + h <= 1.0 + 1e-12 and (best is None
                                             or (y, sx) < (best[0], best[1])):
                    best = (y, sx, i)
            if best is None:
                return None
            y, x, i = best
            pos[c] = (x + padding, y + padding)
            # update skyline: segment [x, x+w) at height y+h
            x_end = x + w
            new_sky = []
            for (sx, sy, sw) in sky:
                se = sx + sw
                if se <= x + 1e-12 or sx >= x_end - 1e-12:
                    new_sky.append((sx, sy, sw))
                    continue
                if sx < x - 1e-12:           # left remainder
                    new_sky.append((sx, sy, x - sx))
                if se > x_end + 1e-12:       # right remainder
                    new_sky.append((x_end, sy, se - x_end))
            new_sky.append((x, y + h, w))
            new_sky.sort(key=lambda s: s[0])
            # merge adjacent equal-height segments
            merged = [new_sky[0]]
            for s in new_sky[1:]:
                px, py, pw = merged[-1]
                if abs(s[1] - py) < 1e-12 and abs(px + pw - s[0]) < 1e-9:
                    merged[-1] = (px, py, pw + s[2])
                else:
                    merged.append(s)
            sky = merged
        return pos, {}

    def pack_maxrects(scale):
        # MaxRects-BSSF (Jylanki): keep the set of maximal free
        # rectangles; place each chart (height-desc) into the free rect
        # minimizing the leftover short side, allowing a 90-deg rotation;
        # split/prune intersecting free rects.  Reaches ~0.85-0.9 rect
        # density where shelves/skyline plateau near ~0.76-0.8.
        pos = {}
        rot = {}
        free = [(0.0, 0.0, 1.0, 1.0)]  # (x, y, w, h)
        eps = 1e-12
        for c in order:
            w = chart_rects[c][0] * scale + 2 * padding
            h = chart_rects[c][1] * scale + 2 * padding
            best = None  # (short_fit, long_fit, x, y, rotated)
            for (fx, fy, fw, fh) in free:
                for (cw, ch, r) in ((w, h, False), (h, w, True)):
                    if cw <= fw + eps and ch <= fh + eps:
                        dw, dh = fw - cw, fh - ch
                        key = (min(dw, dh), max(dw, dh))
                        if best is None or key < best[0]:
                            best = (key, fx, fy, r)
            if best is None:
                return None
            _, px, py, r = best
            cw, ch = (h, w) if r else (w, h)
            pos[c] = (px + padding, py + padding)
            rot[c] = r
            # split every intersecting free rect into up to 4 maximal
            # remainders, then prune rects contained in another
            nx, ny = px + cw, py + ch
            new_free = []
            for (fx, fy, fw, fh) in free:
                fex, fey = fx + fw, fy + fh
                if px >= fex - eps or nx <= fx + eps \
                        or py >= fey - eps or ny <= fy + eps:
                    new_free.append((fx, fy, fw, fh))
                    continue
                if px > fx + eps:
                    new_free.append((fx, fy, px - fx, fh))
                if nx < fex - eps:
                    new_free.append((nx, fy, fex - nx, fh))
                if py > fy + eps:
                    new_free.append((fx, fy, fw, py - fy))
                if ny < fey - eps:
                    new_free.append((fx, ny, fw, fey - ny))
            new_free.sort(key=lambda r_: -r_[2] * r_[3])
            pruned = []
            for (fx, fy, fw, fh) in new_free:
                contained = any(
                    fx >= gx - eps and fy >= gy - eps
                    and fx + fw <= gx + gw + eps
                    and fy + fh <= gy + gh + eps
                    for (gx, gy, gw, gh) in pruned)
                if not contained:
                    pruned.append((fx, fy, fw, fh))
            free = pruned
        return pos, rot

    # ---- profile packer: charts as column-wise (bottom, top) height
    # profiles instead of rects, so round lobes nest into each other's
    # curves (what xatlas's bitmap packer does).  Six near-equal rounded
    # lobes — the typical axis-binned decomposition of a blobby shape —
    # cap any RECT packer at ~0.79 density; profiles recover the corner
    # waste.  Profiles are rasterized once per chart at 256 cells and
    # conservatively resampled per candidate scale.
    _PROF_RES = 512

    def _chart_profile(c, full=True):
        """Column-wise (bottom, top) height profiles of chart `c` in all
        four 90-deg orientations, chart units, conservative by one raster
        cell on every side (the rasterizer samples texel centers, so the
        true silhouette can stick out by up to one cell).

        With full=False (small charts outside the top-48 by area) the
        silhouette raster is skipped and the profile is just the
        bounding rect — their nesting gain is nil but their raster cost
        dominates pack time at 1000+ charts."""
        if not full:
            w, h = chart_rects[c]
            z2 = np.zeros(2)
            return {0: (z2, np.full(2, h), w, h)}, max(w, 1e-9) / 2
        faces_c, vids, uv = chart_vert_uv[c]
        w, h = chart_rects[c]
        m = max(w, h)
        t2 = np.searchsorted(vids, f[faces_c]).astype(np.int32)
        uvn = uv / m
        uv3 = np.column_stack([uvn, np.zeros(len(uvn))]).astype(np.float32)
        _, mask = native.rasterize_uv(uvn.astype(np.float32), t2,
                                      uv3, t2, _PROF_RES)
        cell = m / _PROF_RES
        nbw = int(np.ceil(w / cell)) + 1
        nbh = int(np.ceil(h / cell)) + 1
        R = _PROF_RES
        cols = mask.any(axis=0)
        first = np.argmax(mask, axis=0)
        last = R - 1 - np.argmax(mask[::-1], axis=0)
        bot0 = np.where(cols, (first - 1) * cell, np.inf)[:nbw]
        top0 = np.where(cols, (last + 2) * cell, -np.inf)[:nbw]
        rows = mask.any(axis=1)
        lef = np.where(rows, (np.argmax(mask, axis=1) - 1) * cell,
                       np.inf)[:nbh]
        rig = np.where(rows,
                       (R + 1 - np.argmax(mask[:, ::-1], axis=1)) * cell,
                       -np.inf)[:nbh]
        # orientation r = number of 90-deg rotations (pure rotations,
        # handedness kept): r1 (u,v)->(v,w-u), r2 ->(w-u,h-v), r3 ->(h-v,u)
        return {
            0: (bot0, top0, w, h),
            1: (w - rig, w - lef, h, w),
            2: ((h - top0)[::-1], (h - bot0)[::-1], w, h),
            3: (lef[::-1], rig[::-1], h, w),
        }, cell

    def pack_profile(scale, B=512):
        """Bottom-left skyline packing with per-chart height profiles,
        trying all four orientations per placement (rows of dome-shaped
        charts interlock up/down).  Packs into an open-top strip; returns
        (pos, rot, max_height)."""
        sky = np.zeros(B, np.float32)
        pos = {}
        rot = {}
        inv_b = 1.0 / B
        pb = max(1, int(np.ceil(padding * B)))  # horizontal pad, bins
        top_h = 0.0
        for c in order:
            full = c in orient_full
            key = (chart_vert_uv[c][0].tobytes(), full)
            hit = profiles.get(key)
            if hit is None:
                hit = profiles[key] = _chart_profile(c, full)
            variants, cell = hit
            best = None  # (chart_top_y, r, i0, y0, top_arr, wbp)
            rs = (variants.items() if c in orient_full
                  else ((0, variants[0]),))
            for r, (bot_u, top_u, wext, hext) in rs:
                wb = int(np.ceil(wext * scale * B)) + 1
                if wb + 2 * pb >= B:
                    continue
                # conservative resample chart-unit profiles -> atlas
                # bins: bin i covers chart-u [i, i+1) * inv_b / scale
                src = np.arange(wb + 1) * inv_b / scale / cell
                j0 = np.clip(src[:-1].astype(int), 0, len(bot_u) - 1)
                j1m = np.minimum(np.clip(np.ceil(src[1:]).astype(int),
                                         1, len(bot_u)) - 1,
                                 len(bot_u) - 1)
                bot = (np.minimum(np.minimum.reduceat(bot_u, j0),
                                  bot_u[j1m]) * scale
                       - padding).astype(np.float32)
                top = (np.maximum(np.maximum.reduceat(top_u, j0),
                                  top_u[j1m]) * scale
                       + padding).astype(np.float32)
                # horizontal padding: widen by pb bins each side (edge-
                # replicated profile = dilation for these 1-2 bin margins)
                bot = np.concatenate([bot[:1].repeat(pb), bot,
                                      bot[-1:].repeat(pb)])
                top = np.concatenate([top[:1].repeat(pb), top,
                                      top[-1:].repeat(pb)])
                wbp = wb + 2 * pb
                windows = sliding_window_view(sky, wbp)  # [B-wbp+1, wbp]
                # wide charts: test every 2nd position, then refine
                # around the winner (placement granularity stays 1 bin)
                step = 2 if wbp > 96 else 1
                oy_s = (windows[::step] - bot[None, :]).max(axis=1)
                i0 = int(np.argmin(oy_s)) * step
                y0 = float(oy_s[i0 // step])
                for ir in (i0 - 1, i0 + 1):
                    if step > 1 and 0 <= ir < len(windows):
                        yr = float((windows[ir] - bot).max())
                        if yr < y0 - 1e-12:
                            i0, y0 = ir, yr
                score = y0 + hext * scale
                if best is None or score < best[0] - 1e-12:
                    best = (score, r, i0, y0, top, wbp)
            if best is None:
                return None
            _, r, i0, y0, top, wbp = best
            # padding clearance is already inside bot/top — y0 IS the
            # chart origin (material bottom lands at y0+bot+padding)
            pos[c] = ((i0 + pb) * inv_b, y0)
            rot[c] = r
            np.maximum(sky[i0:i0 + wbp], y0 + top, out=sky[i0:i0 + wbp])
            ftop = top[np.isfinite(top)]
            if len(ftop):
                top_h = max(top_h, y0 + float(ftop.max()))
        return pos, rot, top_h

    def search_profile():
        """Find the largest scale whose packing fits the unit square:
        one strip pack at the theoretical-perfect scale brackets the
        answer (the height/scale relation is discontinuous, so a pure
        rescale by achieved height badly over/undershoots), then bisect
        on the fits/doesn't boundary."""
        if n_charts == 0:
            return 0.0, None
        best = (0.0, None)
        packed = pack_profile(hi0)
        if packed is None:
            return best
        if packed[2] <= 1.0 + 1e-9:
            return hi0, packed[:2]
        hi = hi0                       # known failing
        lo = hi0 / packed[2] * 0.98    # likely-fitting start
        for _ in range(12 if effort else 7):
            p = pack_profile(lo)
            if p is not None and p[2] <= 1.0 + 1e-9:
                if lo > best[0]:
                    best = (lo, p[:2])
                lo = 0.5 * (lo + hi)
            else:
                lo, hi = lo - 0.5 * (hi - lo), lo
            if best[1] is not None and hi - lo < 1e-4 * hi0:
                break
        return best

    total_area = sum(w * h for w, h in chart_rects)
    hi0 = 1.0 / np.sqrt(total_area) if total_area > 0 else 1.0

    def search(try_pack, iters=16):
        hi = hi0
        lo = hi * 1e-3
        packed = try_pack(lo)
        if packed is None:
            return 0.0, None
        for _ in range(iters):
            mid = 0.5 * (lo + hi)
            p = try_pack(mid)
            if p is not None:
                lo, packed = mid, p
            else:
                hi = mid
        return lo, packed

    # effort 0 (split-loop exploration): coarser bisections — the scale
    # estimate only steers which chart to split next.  The O(n^2)-ish
    # packers only run at low chart counts (they never win there anyway,
    # but are cheap safety nets); at 1000+ charts they cost seconds.
    if not effort:
        # split-loop exploration: the scale estimate only steers which
        # chart to split next — profile alone is accurate enough
        cand = {"profile": search_profile()}
        if cand["profile"][1] is None:   # degenerate input: rect fallback
            cand["shelf"] = search(pack_shelf, iters=9)
    else:
        cand = {"shelf": search(pack_shelf)}
        if n_charts <= 256:
            cand["profile"] = search_profile()
            # profile's bin quantization (+1 bin per chart side) eats
            # the nesting gain once most charts are a few bins wide,
            # and the O(n^2)-ish packers cost seconds — at 1000+ charts
            # plain FFDH shelves win on both counts; conversely profile
            # dominates at low counts, where these are safety nets
            cand["skyline"] = search(pack_skyline)
            # maxrects: fewer bisection steps (precision ~hi0 * 2^-22)
            cand["maxrects"] = search(pack_maxrects, iters=14)
    if os.environ.get("SIN3DM_UV_DEBUG"):
        print({k: round(float(v[0]), 6) for k, v in cand.items()})
    scale, packed = max(cand.values(), key=lambda sp: sp[0])
    if packed is None:
        raise RuntimeError("uv packing failed even at minimal scale")
    pos, rot = packed
    return scale, pos, rot, chart_rects, chart_vert_uv, mat_area


def _split_chart(f: np.ndarray, chart: np.ndarray, c: int,
                 chart_vert_uv, chart_rects) -> bool:
    """Split chart `c` in two along its longer oriented axis at the
    median face centroid (in place on `chart`).  Returns False when the
    chart cannot be split (fewer than 2 faces or degenerate spread)."""
    faces_c, vids, uv = chart_vert_uv[c]
    if len(faces_c) < 2:
        return False
    w, h = chart_rects[c]
    axis = 0 if w >= h else 1
    idx = np.searchsorted(vids, f[faces_c])
    cent = uv[idx][..., axis].mean(axis=1)
    cut = np.median(cent)
    upper = cent > cut
    if not upper.any() or upper.all():
        return False
    chart[faces_c[upper]] = chart.max() + 1
    return True


def parametrize(v: np.ndarray, f: np.ndarray, padding: float = 0.004,
                target_util: float = None, max_splits: int = None
                ) -> Tuple[np.ndarray, np.ndarray]:
    """-> (uvs [N,2] in [0,1], mesh_tex_idx [F,3] indices into uvs).

    Each chart is rotated to its minimal-area oriented bounding rect (a
    pure rotation — texel density and orientation handedness preserved)
    and laid out by the best of four packers: FFDH shelves, skyline
    bottom-left, MaxRects-BSSF (90-deg rotations), and a profile packer
    (charts as column-wise height profiles in 4 orientations, so round
    lobes nest into each other's curves — what xatlas's bitmap packing
    does).  When the estimated texel utilization still lands below
    `target_util` (default 0.65, env SIN3DM_UV_TARGET), the largest chart
    is split along its longer axis and the atlas is repacked, up to
    `max_splits` (default 6, env SIN3DM_UV_MAX_SPLITS) times — a few
    equal-size lobes otherwise force a rigid grid layout with a dead
    side strip."""
    if target_util is None:
        target_util = float(os.environ.get("SIN3DM_UV_TARGET", "0.65"))
    if max_splits is None:
        max_splits = int(os.environ.get("SIN3DM_UV_MAX_SPLITS", "6"))
    chart, bins = _charts_by_axis(v, f)
    chart = np.asarray(chart).copy()
    profiles: dict = {}

    if (chart.max() + 1 if len(f) else 0) > 96:
        # many mixed-size charts pack fine as rects; the split loop is
        # for the few-big-lobes regime, and exploration rounds are not
        # free at 1000+ charts
        scale, pos, rot, chart_rects, chart_vert_uv, _ = _pack_once(
            v, f, chart, bins, padding, effort=1, profiles=profiles)
        return _emit(f, scale, pos, rot, chart_rects, chart_vert_uv)

    best = None          # (scale, chart ids) of the best explore round
    splits = 0
    while True:
        result = _pack_once(v, f, chart, bins, padding, effort=0,
                            profiles=profiles)
        if best is None or result[0] > best[0]:
            best = (result[0], chart.copy())
        util_est = result[5] * result[0] ** 2
        if os.environ.get("SIN3DM_UV_DEBUG"):
            print(f"  util_est {util_est:.4f} (charts "
                  f"{chart.max() + 1 if len(f) else 0})")
        if util_est >= target_util or splits >= max_splits:
            break
        scale, pos, rot, chart_rects, chart_vert_uv, _ = result
        c_big = max(range(len(chart_rects)),
                    key=lambda c: chart_rects[c][0] * chart_rects[c][1])
        if not _split_chart(f, chart, c_big, chart_vert_uv, chart_rects):
            break
        splits += 1

    # full-precision pack of the winning chart decomposition
    scale, pos, rot, chart_rects, chart_vert_uv, _ = _pack_once(
        v, f, best[1], bins, padding, effort=1, profiles=profiles)
    return _emit(f, scale, pos, rot, chart_rects, chart_vert_uv)


def _emit(f, scale, pos, rot, chart_rects, chart_vert_uv):
    tex_idx = np.zeros_like(f)
    uv_parts = []
    base = 0
    for c in range(len(chart_rects)):
        faces_c, vids, uv = chart_vert_uv[c]
        ox, oy = pos[c]
        r = int(rot.get(c, 0))
        w, h = chart_rects[c]
        # r = number of 90-deg rotations applied at placement: all pure
        # rotations (det +1 — texel density and handedness kept)
        if r == 1:
            uv_p = np.stack([uv[:, 1], w - uv[:, 0]], axis=-1)
        elif r == 2:
            uv_p = np.stack([w - uv[:, 0], h - uv[:, 1]], axis=-1)
        elif r == 3:
            uv_p = np.stack([h - uv[:, 1], uv[:, 0]], axis=-1)
        else:
            uv_p = uv
        uv_parts.append(uv_p * scale + np.array([ox, oy]))
        tex_idx[faces_c] = base + np.searchsorted(vids, f[faces_c])
        base += len(vids)

    uvs_out = (np.concatenate(uv_parts, axis=0) if uv_parts
               else np.zeros((0, 2)))
    return uvs_out.astype(np.float64), tex_idx.astype(np.int64)


def uv_unwrap_and_rasterize(v: np.ndarray, f: np.ndarray, resolution: int):
    """Full xatlas_uvmap replacement (`utils3d.py:228-251`): parametrize,
    rasterize the UV charts at `resolution`, return
    (uvs, mesh_tex_idx, gb_pos [R,R,3], mask [R,R]).

    Padding is resolution-aware (2 texels between charts): with hundreds
    of charts, fixed padding eats most of the atlas and starves texel
    density."""
    uvs, tex_idx = parametrize(v, f, padding=max(2.0 / resolution, 5e-4))
    gb_pos, mask = native.rasterize_uv(
        uvs.astype(np.float32), tex_idx.astype(np.int32),
        v.astype(np.float32), f.astype(np.int32), resolution)
    return uvs, tex_idx, gb_pos, mask


def uv_unwrap_and_rasterize_runs(v: np.ndarray, f: np.ndarray,
                                 resolution: int):
    """`uv_unwrap_and_rasterize` with the RUN-LENGTH position wire: no
    dense [R,R,3] position image is ever built — texel positions come
    back as per-row spans for on-device expansion (the texture bake's
    compact host->device wire, `training/ae.py _dispatch_texels_runs`).

    Returns (uvs, mesh_tex_idx, mask [R,R], runs [n,7] float32)."""
    uvs, tex_idx = parametrize(v, f, padding=max(2.0 / resolution, 5e-4))
    mask, runs = native.rasterize_uv_runs(
        uvs.astype(np.float32), tex_idx.astype(np.int32),
        v.astype(np.float32), f.astype(np.int32), resolution)
    n_tex = int(mask.sum())
    n_runs = int(runs[:, 6].sum()) if len(runs) else 0
    assert n_runs == n_tex, (
        f"texel-run stream ({n_runs}) disagrees with the coverage mask "
        f"({n_tex}) — rasterizer invariant broken")
    return uvs, tex_idx, mask, runs
