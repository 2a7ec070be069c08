"""Mesh and texture export (counterpart of `sin3dm_tpu/geometry/meshio.py`):
OBJ+MTL+PNG, the PBR set under `textures/`, and a glTF 2.0 binary (GLB)
writer.  The OBJ and MTL text is the JAX package's byte for byte.  PNG is
written and read with the standard library (`encode_png`, `decode_png`),
as the machines the port runs on need carry neither OpenCV nor PIL: a
written file may differ from theirs, its pixels do not, and a read gives
PIL's bytes.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Optional

import numpy as np

from ..core import profiling


def read_material_params_from_mtl(path: str) -> str:
    """The scalar params of the first material, up to its first map."""
    with open(path) as f:
        lines = f.readlines()
    s = ""
    started = False
    for line in lines:
        stripped = line.lstrip()
        if not started and stripped[:6] == "newmtl":
            started = True
            continue
        if stripped[:4] == "map_" or stripped[:6] == "newmtl":
            break
        if started:
            s += line
    return s


def encode_png(img: np.ndarray) -> bytes:
    """An 8-bit PNG of `img` (`[H, W]` grey, `[H, W, 2]` grey+alpha,
    `[H, W, 3]` RGB or `[H, W, 4]` RGBA uint8), written with the standard
    library: filter-0 scanlines, zlib level 1 with run-length matching (a
    fast encoder; the texture export is on the generation path), and the
    IHDR/IDAT/IEND chunks with their CRCs."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    color_type = {1: 0, 2: 4, 3: 2, 4: 6}[C]
    raw = np.zeros((H, 1 + W * C), np.uint8)     # column 0: filter type 0
    raw[:, 1:] = img.reshape(H, W * C)
    z = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_RLE)
    idat = z.compress(raw.tobytes()) + z.flush()

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color_type,
                                         0, 0, 0))
            + chunk(b"IDAT", idat) + chunk(b"IEND", b""))


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples per pixel, for the 8-bit depth read here
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter_average(line: bytes, prior: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        left = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((left + prior[i]) >> 1)) & 0xFF
    return bytes(cur)


def _unfilter_paeth(line: bytes, prior: bytes, bpp: int) -> bytes:
    cur = bytearray(line)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return bytes(cur)


def _unfilter(rows: np.ndarray, bpp: int, name: str) -> np.ndarray:
    """Undo the PNG scanline filters (types 0-4) of `rows` `[H, 1 + S]`;
    Sub and Up are vectorised, Average and Paeth run byte by byte."""
    H, S = rows.shape[0], rows.shape[1] - 1
    out = np.empty((H, S), np.uint8)
    prior = np.zeros(S, np.uint8)
    for y in range(H):
        kind, line = int(rows[y, 0]), rows[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif kind == 2:
            cur = line + prior
        elif kind == 3:
            cur = np.frombuffer(_unfilter_average(
                line.tobytes(), prior.tobytes(), bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_unfilter_paeth(
                line.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"{name}: PNG row {y} has filter type {kind}")
        out[y] = cur
        prior = out[y]
    return out


def decode_png(src, mode: Optional[str] = None) -> np.ndarray:
    """The pixels of an 8-bit, non-interlaced PNG (a path or the file's
    bytes) as uint8, read with the standard library, equal to PIL's:

    - `mode=None`: `np.asarray(Image.open(src))`: `[H, W]` grey or palette
      indices, `[H, W, 2]` grey+alpha, `[H, W, 3]` RGB, `[H, W, 4]` RGBA;
    - `mode="RGB"` / `"RGBA"`: `Image.open(src).convert(mode)`: grey
      repeated, the palette looked up, a tRNS chunk turned into alpha
      (RGBA only), alpha 255 where there is none.

    Anything else (JPEG or another format, a bit depth other than 8, an
    interlaced PNG) raises ValueError naming the file and what it is."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data, name = bytes(src), "<png bytes>"
    else:
        name = os.fspath(src)
        with open(name, "rb") as fh:
            data = fh.read()
    if mode not in (None, "RGB", "RGBA"):
        raise ValueError(f"decode_png: mode {mode!r} is not None, 'RGB' or "
                         "'RGBA'")
    if not data.startswith(_PNG_SIGNATURE):
        kind = ("a JPEG file" if data[:3] == b"\xff\xd8\xff"
                else "not a PNG file")
        raise ValueError(f"{name}: {kind}; without PIL the port reads only "
                         "8-bit non-interlaced PNG")
    ihdr, plte, trns, idat = None, None, None, []
    pos = len(_PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated PNG chunk {tag!r}")
        pos += 12 + length
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = body
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    W, H, depth, ctype, compression, filtering, interlace = ihdr
    C = _PNG_CHANNELS.get(ctype)
    if depth != 8 or C is None:
        raise ValueError(f"{name}: PNG of bit depth {depth}, colour type "
                         f"{ctype}; without PIL the port reads only 8-bit "
                         "grey, grey+alpha, RGB, RGBA and palette PNG")
    if interlace != 0 or compression != 0 or filtering != 0:
        raise ValueError(f"{name}: interlaced or non-standard PNG "
                         f"(interlace {interlace}); without PIL the port "
                         "reads only non-interlaced PNG")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: palette PNG without a PLTE chunk")
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < H * (1 + W * C):
        raise ValueError(f"{name}: {len(raw)} bytes of scanlines for "
                         f"{H} rows of {W * C}")
    rows = np.frombuffer(raw, np.uint8, H * (1 + W * C)).reshape(H, -1)
    img = _unfilter(rows, C, name).reshape(H, W, C)
    if mode is None:
        return img[..., 0] if C == 1 else img
    if ctype == 3:
        pal = np.zeros((256, 4), np.uint8)
        pal[:, 3] = 255
        pal[:len(plte), :3] = plte
        if trns is not None:
            alpha = np.frombuffer(trns, np.uint8)[:256]
            pal[:len(alpha), 3] = alpha
        rgba = pal[img[..., 0]]
    else:
        rgb = img[..., :3] if C >= 3 else np.repeat(img[..., :1], 3, -1)
        if C in (2, 4):
            alpha = img[..., -1]
        else:
            alpha = np.full((H, W), 255, np.uint8)
            if trns is not None:
                key = np.frombuffer(trns, ">u2")[:C]
                alpha[(img == key).all(axis=-1)] = 0
        rgba = np.concatenate([rgb, alpha[..., None]], axis=-1)
    return np.ascontiguousarray(rgba[..., :len(mode)])


def _save_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as fh:
        fh.write(encode_png(img))


def _fmt_rows(template: str, arr: np.ndarray) -> str:
    """Batch-format rows with one C-level `%` pass — ~2x faster than a
    per-row f-string loop at 10k-face scale (export is on the generation
    hot path).  Output is byte-identical to per-row `%f`/`%d` writes."""
    if len(arr) == 0:
        return ""
    return (template * len(arr)) % tuple(np.asarray(arr).ravel())


def _fmt_face_rows(faces: np.ndarray, face_tex: np.ndarray) -> str:
    fi = np.empty((len(faces), 6), np.int64)
    fi[:, 0::2] = np.asarray(faces) + 1
    fi[:, 1::2] = np.asarray(face_tex) + 1
    return _fmt_rows("f %d/%d %d/%d %d/%d\n", fi)


def save_mesh_vf(path: str, v: np.ndarray, f: np.ndarray) -> None:
    with open(path, "w") as fh:
        fh.write(_fmt_rows("v %f %f %f\n", v))
        fh.write(_fmt_rows("f %d %d %d\n", np.asarray(f, np.int64) + 1))


def save_colored_pointcloud_obj(path: str, pts: np.ndarray,
                                colors: np.ndarray) -> None:
    with open(path, "w") as fh:
        for p, c in zip(pts, colors):
            fh.write(f"v {p[0]:f} {p[1]:f} {p[2]:f} "
                     f"{c[0]:f} {c[1]:f} {c[2]:f}\n")


def save_mesh_with_tex(path: str, verts: np.ndarray, uvs: np.ndarray,
                       faces: np.ndarray, face_tex: np.ndarray,
                       tex_img: np.ndarray, mtl_str: Optional[str] = None,
                       Kd=(1, 1, 1), Ka=(0, 0, 0), Ks=(0.4, 0.4, 0.4),
                       Ns=10, illum=2) -> None:
    assert path.endswith(".obj")
    name = os.path.basename(path)[:-4]

    with open(path.replace(".obj", ".mtl"), "w") as fh:
        fh.write("newmtl material_0\n")
        if mtl_str is not None:
            fh.write(mtl_str)
        else:
            fh.write(f"Kd {Kd[0]} {Kd[1]} {Kd[2]}\n")
            fh.write(f"Ka {Ka[0]} {Ka[1]} {Ka[2]}\n")
            fh.write(f"Ks {Ks[0]} {Ks[1]} {Ks[2]}\n")
            fh.write(f"Ns {Ns}\n")
            fh.write(f"illum {illum}\n")
        fh.write(f"map_Kd {name}.png\n")

    _save_png(path.replace(".obj", ".png"), tex_img)

    with open(path, "w") as fh:
        fh.write(f"mtllib {name}.mtl\n")
        fh.write(_fmt_rows("v %f %f %f\n", verts))
        fh.write(_fmt_rows("vt %f %f\n", uvs))
        fh.write("usemtl material_0\n")
        fh.write(_fmt_face_rows(faces, face_tex))


def save_mesh_with_pbr(path: str, verts: np.ndarray, uvs: np.ndarray,
                       faces: np.ndarray, face_tex: np.ndarray,
                       albedo_img, metallic_img, roughness_img, normal_img,
                       Ks=(0.5, 0.5, 0.5), Ke=(0, 0, 0), Ns=250, Ni=1.5,
                       d=1.0, illum=2, Ps=0.0, Pc=0.0, Pcr=0.03,
                       aniso=0.0, anisor=0.0) -> None:
    """PBR OBJ with 4 texture maps under textures/; each map's PNG write
    is an `export.png` span (`core.profiling`), attr `map`."""
    assert path.endswith(".obj")
    name = os.path.basename(path)[:-4]
    tex_dir = os.path.join(os.path.dirname(path), "textures")
    os.makedirs(tex_dir, exist_ok=True)

    with open(path.replace(".obj", ".mtl"), "w") as fh:
        fh.write("newmtl material_0\n")
        fh.write(f"Ns {Ns}\n")
        fh.write(f"Ks {Ks[0]} {Ks[1]} {Ks[2]}\n")
        fh.write(f"Ke {Ke[0]} {Ke[1]} {Ke[2]}\n")
        fh.write(f"Ni {Ni}\n")
        fh.write(f"d {d}\n")
        fh.write(f"illum {illum}\n")
        fh.write(f"Ps {Ps}\n")
        fh.write(f"Pc {Pc}\n")
        fh.write(f"Pcr {Pcr}\n")
        fh.write(f"aniso {aniso}\n")
        fh.write(f"anisor {anisor}\n")
        fh.write("map_Kd textures/albedo.png\n")
        fh.write("map_Pm textures/metallic.png\n")
        fh.write("map_Pr textures/roughness.png\n")
        fh.write("map_Bump -bm 1.000000 textures/normal.png\n")

    for key, img in (("albedo", albedo_img), ("metallic", metallic_img),
                     ("roughness", roughness_img), ("normal", normal_img)):
        with profiling.span("export.png", map=key):
            _save_png(os.path.join(tex_dir, f"{key}.png"), img)

    with open(path, "w") as fh:
        fh.write(f"mtllib {name}.mtl\n")
        fh.write(_fmt_rows("v %f %f %f\n", verts))
        fh.write(_fmt_rows("vt %f %f\n", uvs))
        fh.write("usemtl material_0\n")
        fh.write(_fmt_face_rows(faces, face_tex))


# ---------------------------------------------------------------------------
# GLB (glTF 2.0 binary) writer
# ---------------------------------------------------------------------------

def _align4(b: bytes, pad: bytes) -> bytes:
    return b + pad * ((4 - len(b) % 4) % 4)


def save_mesh_with_tex_to_glb(path: str, verts: np.ndarray, uvs: np.ndarray,
                              faces: np.ndarray, face_tex: np.ndarray,
                              tex_img: np.ndarray) -> None:
    """GLB with one textured mesh.  Splits vertices per (position, uv) pair
    like the reference; material pinned to
    baseColorFactor 1, metallic 0, roughness 1, doubleSided."""
    assert path.endswith(".glb")

    # re-index: one glTF vertex per unique (pos_idx, uv_idx)
    pair_to_new = {}
    v_new, vt_new, f_new = [], [], []
    for tri_pos, tri_uv in zip(faces, face_tex):
        tri_out = []
        for vp, vt in zip(tri_pos, tri_uv):
            key = (int(vp), int(vt))
            if key not in pair_to_new:
                pair_to_new[key] = len(v_new)
                v_new.append(verts[vp])
                vt_new.append(uvs[vt])
            tri_out.append(pair_to_new[key])
        f_new.append(tri_out)
    pos = np.asarray(v_new, np.float32)
    uv = np.asarray(vt_new, np.float32).copy()
    uv[:, 1] = 1.0 - uv[:, 1]  # glTF v origin is top-left
    idx = np.asarray(f_new, np.uint32).reshape(-1)

    png_bytes = encode_png(tex_img)

    pos_b = pos.tobytes()
    uv_b = uv.tobytes()
    idx_b = idx.tobytes()
    img_b = _align4(png_bytes, b"\x00")

    offsets = []
    bin_parts = []
    off = 0
    for b in (pos_b, uv_b, idx_b, img_b):
        offsets.append(off)
        b = _align4(b, b"\x00")
        bin_parts.append(b)
        off += len(b)
    bin_blob = b"".join(bin_parts)

    gltf = {
        "asset": {"version": "2.0", "generator": "sin3dm_tpu"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0, "TEXCOORD_0": 1},
            "indices": 2, "material": 0}]}],
        "materials": [{
            "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "baseColorFactor": [1.0, 1.0, 1.0, 1.0],
                "metallicFactor": 0.0,
                "roughnessFactor": 1.0,
            },
            "doubleSided": True,
        }],
        "textures": [{"source": 0, "sampler": 0}],
        "samplers": [{"magFilter": 9729, "minFilter": 9987,
                      "wrapS": 10497, "wrapT": 10497}],
        "images": [{"bufferView": 3, "mimeType": "image/png"}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": len(pos),
             "type": "VEC3",
             "min": pos.min(axis=0).tolist(),
             "max": pos.max(axis=0).tolist()},
            {"bufferView": 1, "componentType": 5126, "count": len(uv),
             "type": "VEC2"},
            {"bufferView": 2, "componentType": 5125, "count": len(idx),
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": offsets[0], "byteLength": len(pos_b)},
            {"buffer": 0, "byteOffset": offsets[1], "byteLength": len(uv_b)},
            {"buffer": 0, "byteOffset": offsets[2], "byteLength": len(idx_b)},
            {"buffer": 0, "byteOffset": offsets[3],
             "byteLength": len(png_bytes)},
        ],
        "buffers": [{"byteLength": len(bin_blob)}],
    }

    json_b = _align4(json.dumps(gltf).encode(), b" ")
    total = 12 + 8 + len(json_b) + 8 + len(bin_blob)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", 0x46546C67, 2, total))   # glTF magic
        fh.write(struct.pack("<II", len(json_b), 0x4E4F534A))  # JSON chunk
        fh.write(json_b)
        fh.write(struct.pack("<II", len(bin_blob), 0x004E4942))  # BIN chunk
        fh.write(bin_blob)
