"""Image files without OpenCV: the port's counterpart of ``cv2.imread`` and
``cv2.imwrite`` for PNG, the format of Cityscapes' ``leftImg8bit`` images,
and for baseline JPEG, the format of VOC-style datasets (the Diverse
Weather Dataset).

``imread`` returns what ``cv2.imread(path, cv2.IMREAD_COLOR)`` returns: an
(H, W, 3) uint8 BGR array; a gray image is replicated into the three
channels and an alpha channel is dropped. The PNG decoder takes 8-bit gray,
RGB and RGBA PNGs without interlacing and raises on anything else. It
inflates with ``zlib`` and undoes the row filters in the port's host library
(``utils/host_kernels.py``), whose call releases the interpreter lock;
``png_unfilter_numpy`` is its plain twin. JPEG goes to ``utils/jpeg.py``
(``decode_jpeg``: baseline Huffman, 4:2:0, 4:2:2 or 4:4:4, bit-equal to
``cv2.imdecode``; the entropy stage in the host library), which raises a
``ValueError`` naming the file on a progressive, arithmetic-coded, lossless
or 12-bit one. Any other format raises too: there is no other decoder.

``encode_png`` / ``imwrite`` write 8-bit PNGs (filter None or Sub, ``zlib``)
and ``encode_jpeg`` baseline 4:2:0 JPEGs (``imwrite`` to a ``.jpg`` path),
so that tests and the card's smoke run can make datasets without OpenCV.
"""
from __future__ import annotations

import struct
import zlib
from typing import Tuple

import numpy as np

from ...utils.jpeg import JPEG_SOI, decode_jpeg, encode_jpeg

__all__ = ["imread", "imwrite", "image_size", "decode_png", "encode_png", "decode_jpeg",
           "encode_jpeg", "png_scanlines", "png_unfilter_numpy"]

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # PNG colour type -> samples a pixel
_COLOUR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 12 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        (crc,) = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])
        if len(body) != length or zlib.crc32(kind + body) != crc:
            raise ValueError(f"PNG chunk {kind!r} is truncated or fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends before its IEND chunk")


def png_scanlines(data: bytes) -> Tuple[np.ndarray, int, int, int]:
    """The filtered scanlines of an 8-bit gray, RGB or RGBA PNG without
    interlacing -> ((H, 1 + W * channels) uint8, H, W, channels)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or compression or filtering or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {colour}, "
                         f"interlace {interlace}: the port decodes 8-bit gray, RGB "
                         "and RGBA without interlacing only")
    c = _CHANNELS[colour]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (1 + w * c):
        raise ValueError(f"PNG image data holds {len(raw)} bytes, not "
                         f"{h * (1 + w * c)} for {h}x{w}x{c}")
    return np.frombuffer(raw, np.uint8).reshape(h, 1 + w * c), h, w, c


def png_unfilter_numpy(filtered: np.ndarray, bpp: int) -> np.ndarray:
    """The plain twin of ``native.png_unfilter``: (H, 1 + stride) filtered
    scanlines -> (H, stride) bytes. Average and Paeth read the reconstructed
    pixel to the left, so the pixels are reconstructed one anti-diagonal at
    a time (left, above and above-left all lie on earlier ones), every row's
    filter evaluated at once: H + W - 1 numpy steps."""
    types = filtered[:, 0]
    if (types > 4).any():
        row = int(np.argmax(types > 4))
        raise ValueError(f"PNG row {row} has filter type {types[row]}, not one of 0-4")
    h = filtered.shape[0]
    w = (filtered.shape[1] - 1) // bpp
    f = filtered[:, 1:].reshape(h, w, bpp).astype(np.int32)
    r = np.zeros((h + 1, w + 1, bpp), np.int32)   # a zero row above, a zero column left
    for d in range(h + w - 1):
        y = np.arange(max(0, d - w + 1), min(h, d + 1))
        x = d - y
        a, b, c = r[y + 1, x], r[y, x + 1], r[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = types[y][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        r[y + 1, x + 1] = (f[y, x] + pred) & 255
    return r[1:, 1:].astype(np.uint8).reshape(h, w * bpp)


def decode_png(data: bytes, native: bool = True) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 BGR, as ``cv2.IMREAD_COLOR`` decodes."""
    filtered, h, w, c = png_scanlines(data)
    if native:
        from ...utils.host_kernels import png_unfilter
        pixels = png_unfilter(filtered, c)
    else:
        pixels = png_unfilter_numpy(filtered, c)
    pixels = pixels.reshape(h, w, c)
    if c == 1:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[..., 2::-1])


def imread(path, flag: str = "color") -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_COLOR)``: (H, W, 3) uint8 BGR of a PNG
    or a baseline JPEG. Any other file raises ``ValueError`` naming it; a
    missing file raises ``FileNotFoundError``."""
    if flag != "color":
        raise ValueError(f"imread flag {flag!r}: the port reads 'color' images only")
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        return decode_png(data)
    if data[:2] == JPEG_SOI:
        return decode_jpeg(data, name=str(path))
    raise ValueError(f"{path} is neither a PNG nor a JPEG: the port decodes "
                     "those two formats only")


def image_size(path) -> Tuple[int, int]:
    """(width, height) of a PNG or JPEG file from its header (IHDR, or the
    JPEG frame header), without decoding it."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == PNG_SIGNATURE:
        w, h = struct.unpack(">II", data[16:24])
        return int(w), int(h)
    pos = 2
    while data[:2] == JPEG_SOI and pos + 4 <= len(data) and data[pos] == 0xFF:
        marker = data[pos + 1]
        if marker == 0xFF:
            pos += 1
            continue
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            h, w = struct.unpack(">HH", data[pos + 5:pos + 9])
            return int(w), int(h)
        pos += 2 + length
    raise ValueError(f"{path}: no PNG or JPEG header with the image size")


def encode_png(img: np.ndarray, filter_type: int = 1) -> bytes:
    """(H, W) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8 -> PNG bytes, as
    ``cv2.imwrite`` stores them (RGB order in the file), every row with
    filter ``filter_type`` (0 None, 1 Sub), compressed at zlib's level 6."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOUR_TYPE:
        raise ValueError(f"encode_png takes 1, 3 or 4 channels, not {c}")
    if c >= 3:
        img = img[..., [2, 1, 0, 3][:c]]
    rows = np.ascontiguousarray(img).reshape(h, w * c)
    if filter_type == 1:
        rows = rows.copy()
        rows[:, c:] -= rows[:, :-c].copy()          # uint8: wraps modulo 256
    elif filter_type != 0:
        raise ValueError(f"encode_png writes filter 0 or 1, not {filter_type}")
    lines = np.empty((h, 1 + w * c), np.uint8)
    lines[:, 0] = filter_type
    lines[:, 1:] = rows

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    header = struct.pack(">IIBBBBB", w, h, 8, _COLOUR_TYPE[c], 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(lines.tobytes(), 6))
            + chunk(b"IEND", b""))


def imwrite(path, img: np.ndarray, **kwargs) -> None:
    """Write ``img`` as a JPEG file for a ``.jpg`` / ``.jpeg`` path
    (``encode_jpeg``'s arguments), else as a PNG file (``encode_png``'s)."""
    jpeg = str(path).lower().endswith((".jpg", ".jpeg"))
    data = encode_jpeg(img, **kwargs) if jpeg else encode_png(img, **kwargs)
    with open(path, "wb") as f:
        f.write(data)
