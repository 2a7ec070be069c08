"""The port's PNG reader (`geometry/meshio.py:decode_png`) against PIL,
which the port's machines do not carry: every 8-bit colour type, every
scanline filter, tRNS transparency, in PIL's native mode and converted
to RGB and RGBA, bit for bit; JPEG, 16-bit and interlaced files
refused."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from sin3dm_tpu_torch.geometry.meshio import decode_png, encode_png

MODES = {"L": 0, "LA": 4, "RGB": 2, "RGBA": 6, "P": 3}


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_rows(img: np.ndarray) -> bytes:
    """Scanlines of `img` `[H, W, C]` uint8, row y under filter y % 5."""
    H, W, C = img.shape
    prior = [0] * (W * C)
    out = bytearray()
    for y in range(H):
        x = [int(v) for v in img[y].reshape(-1)]
        kind = y % 5
        out.append(kind)
        for i in range(len(x)):
            a = x[i - C] if i >= C else 0
            b = prior[i]
            c = prior[i - C] if i >= C else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, c))[kind]
            out.append((x[i] - pred) & 0xFF)
        prior = x
    return bytes(out)


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _png(img: np.ndarray, ctype: int, depth: int = 8, interlace: int = 0,
         plte: bytes = b"", trns: bytes = b"") -> bytes:
    H, W = img.shape[:2]
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0,
                                       0, interlace))
    if plte:
        body += _chunk(b"PLTE", plte)
    if trns:
        body += _chunk(b"tRNS", trns)
    return (b"\x89PNG\r\n\x1a\n" + body
            + _chunk(b"IDAT", zlib.compress(_filter_rows(img.reshape(
                H, W, -1))))
            + _chunk(b"IEND", b""))


def _image(mode: str, seed: int = 0, H: int = 13, W: int = 17):
    rng = np.random.default_rng(seed)
    C = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4, "P": 1}[mode]
    # a ramp plus noise: every filter's predictor matters
    img = (rng.integers(0, 90, (H, W, C))
           + np.arange(W)[None, :, None] * 9).astype(np.uint8)
    if mode == "P":
        img = img % 37
    return img


def _pil(data: bytes, mode):
    im = Image.open(io.BytesIO(data))
    return np.asarray(im if mode is None else im.convert(mode))


def _check(data: bytes):
    for mode in (None, "RGB", "RGBA"):
        want = _pil(data, mode)
        got = decode_png(data, mode)
        assert got.dtype == want.dtype and got.shape == want.shape, mode
        np.testing.assert_array_equal(got, want, err_msg=str(mode))


@pytest.mark.parametrize("mode", list(MODES))
def test_every_filter_and_colour_type_equals_pil(mode):
    img = _image(mode)
    plte = (bytes(np.random.default_rng(1).integers(0, 256, 37 * 3,
                                                    dtype=np.uint8))
            if mode == "P" else b"")
    _check(_png(img, MODES[mode], plte=plte))


@pytest.mark.parametrize("mode", list(MODES))
def test_pil_written_files_equal_pil(mode):
    img = _image(mode, seed=2, H=40, W=50)
    im = Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img,
                         "L" if mode == "P" else mode)
    if mode == "P":
        im = Image.fromarray(np.random.default_rng(3).integers(
            0, 255, (40, 50, 3), dtype=np.uint8)).quantize(30)
    for kw in ({}, {"optimize": True}):
        buf = io.BytesIO()
        im.save(buf, format="PNG", **kw)
        _check(buf.getvalue())


@pytest.mark.parametrize("mode", ["L", "RGB", "P"])
def test_transparency_chunk_equals_pil(mode):
    img = _image(mode) % 4
    if mode == "P":
        trns = bytes([0, 128, 255, 7])[:3]
        data = _png(img, 3, plte=bytes(range(12)), trns=trns)
    else:
        key = struct.pack(">" + "H" * img.shape[-1], *([2] * img.shape[-1]))
        data = _png(img, MODES[mode], trns=key)
    _check(data)


def test_encode_png_round_trip():
    rng = np.random.default_rng(4)
    for shape in ((9, 11), (9, 11, 2), (9, 11, 3), (9, 11, 4)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        np.testing.assert_array_equal(decode_png(encode_png(img)), img)


def test_files_it_cannot_read_are_refused(tmp_path):
    rgb = np.random.default_rng(5).integers(0, 256, (8, 8, 3),
                                            dtype=np.uint8)
    jpg = tmp_path / "tex.jpg"
    Image.fromarray(rgb).save(jpg, format="JPEG")
    with pytest.raises(ValueError, match=r"tex\.jpg.*JPEG"):
        decode_png(jpg)
    deep = tmp_path / "deep.png"
    Image.fromarray(rgb[..., 0].astype(np.uint16) * 257).save(deep)
    with pytest.raises(ValueError, match=r"deep\.png.*bit depth 16"):
        decode_png(deep)
    with pytest.raises(ValueError, match="interlaced"):
        decode_png(_png(rgb, 2, interlace=1))
    with pytest.raises(ValueError, match="bit depth 4"):
        decode_png(_png(rgb[..., :1], 0, depth=4))
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + bytes(20))
