"""Baseline JPEG without OpenCV, as libjpeg-turbo codes it.

The port's counterpart of ``cv2.imdecode(..., IMREAD_COLOR)`` and
``cv2.imencode('.jpg', ...)`` for the images of VOC-style datasets (the
Diverse Weather Dataset's ``JPEGImages``). Every lossy step is libjpeg-turbo's
integer arithmetic, so decoding equals ``cv2.imdecode`` bit for bit:

- colour: the fixed-point YCbCr tables of ``jccolor.c`` / ``jdcolor.c``;
- sampling: 4:2:0 (the encoder's 2x2 average with the 1, 2 column bias; the
  decoder's h2v2 "fancy" triangle filter), 4:2:2 (h2v1 fancy) and 4:4:4;
- the islow forward and inverse DCT (``jfdctint.c``, ``jidctint.c``) with the
  SIMD IDCT's saturating range limit, quantization by the encoder's
  reciprocals (``jcdctmgr.c``).

Entropy coding is Huffman, baseline sequential (SOF0 / SOF1, 8-bit samples,
1 or 3 components, interleaved or not, restart intervals). Decoding a scan
runs in the port's host library (``utils/host_kernels.py``,
``jpeg_decode_scan``), whose call releases the interpreter lock;
``decode_scan_numpy`` is its plain twin. Progressive, lossless, arithmetic-
coded, hierarchical and 12-bit files raise a ``ValueError`` naming the mode:
nothing is handed to another decoder.

``encode_jpeg`` writes baseline 4:2:0 with the standard Huffman tables
(ITU T.81 Annex K.3) and the quality-scaled standard quantization tables, as
``cv2.imencode`` does without its options; ``jpeg_roundtrip`` is its lossy
steps without the file, the JPEG corruption of ``ops/corruptions.py``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["decode_jpeg", "encode_jpeg", "jpeg_roundtrip", "decode_scan_numpy",
           "JPEG_SOI"]

JPEG_SOI = b"\xff\xd8"

STD_LUMA = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64).reshape(8, 8)
STD_CHROMA = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99],
    np.int64).reshape(8, 8)
_FIX = dict(c0_298=2446, c0_390=3196, c0_541=4433, c0_765=6270, c0_899=7373,
            c1_175=9633, c1_501=12299, c1_847=15137, c1_961=16069, c2_053=16819,
            c2_562=20995, c3_072=25172)

# natural (row-major) index of the k-th coefficient in zigzag order
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)


def _ac_values(head: Sequence[int]) -> List[int]:
    """An Annex K AC table's symbols: its irregular head, then every other
    symbol (EOB, ZRL, run 0-15 x size 1-10) in increasing order."""
    every = {0x00, 0xF0} | {r << 4 | s for r in range(16) for s in range(1, 11)}
    return list(head) + sorted(every - set(head))


# (BITS, HUFFVAL) of ITU T.81 Annex K.3, as libjpeg's jstdhuff.c
STD_HUFFMAN = {
    "dc_luma": ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0), list(range(12))),
    "dc_chroma": ((0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0), list(range(12))),
    "ac_luma": ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D), _ac_values([
        0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
        0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
        0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
        0x82, 0x09, 0x0A])),
    "ac_chroma": ((0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77), _ac_values([
        0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
        0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
        0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
        0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1])),
}


# --------------------------------------------------- lossy arithmetic ----

def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """``jpeg_set_quality``: the standard table scaled, clamped to 1..255."""
    q = min(max(int(quality), 1), 100)
    scale = 5000 // q if q < 50 else 200 - 2 * q
    return np.clip((base * scale + 50) // 100, 1, 255)


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _fdct_1d(d, pass1: bool):
    """One pass of libjpeg's islow forward DCT along the last axis."""
    c, pb = 13, 2
    t0, t7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    t1, t6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    t2, t5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    t3, t4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    out = [None] * 8
    if pass1:
        out[0], out[4] = (t10 + t11) << pb, (t10 - t11) << pb
        sh = c - pb
    else:
        out[0], out[4] = _descale(t10 + t11, pb), _descale(t10 - t11, pb)
        sh = c + pb
    z1 = (t12 + t13) * _FIX["c0_541"]
    out[2] = _descale(z1 + t13 * _FIX["c0_765"], sh)
    out[6] = _descale(z1 - t12 * _FIX["c1_847"], sh)
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * _FIX["c1_175"]
    t4, t5 = t4 * _FIX["c0_298"], t5 * _FIX["c2_053"]
    t6, t7 = t6 * _FIX["c3_072"], t7 * _FIX["c1_501"]
    z1, z2 = z1 * -_FIX["c0_899"], z2 * -_FIX["c2_562"]
    z3, z4 = z3 * -_FIX["c1_961"] + z5, z4 * -_FIX["c0_390"] + z5
    out[7] = _descale(t4 + z1 + z3, sh)
    out[5] = _descale(t5 + z2 + z4, sh)
    out[3] = _descale(t6 + z2 + z3, sh)
    out[1] = _descale(t7 + z1 + z4, sh)
    return np.stack(out, -1)


def _idct_1d(d, final: bool):
    """One pass of libjpeg's islow inverse DCT along the last axis."""
    c, pb = 13, 2
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * _FIX["c0_541"]
    t2 = z1 - z3 * _FIX["c1_847"]
    t3 = z1 + z2 * _FIX["c0_765"]
    t0 = (d[..., 0] + d[..., 4]) << c
    t1 = (d[..., 0] - d[..., 4]) << c
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    t0, t1, t2, t3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * _FIX["c1_175"]
    t0, t1 = t0 * _FIX["c0_298"], t1 * _FIX["c2_053"]
    t2, t3 = t2 * _FIX["c3_072"], t3 * _FIX["c1_501"]
    z1, z2 = z1 * -_FIX["c0_899"], z2 * -_FIX["c2_562"]
    z3, z4 = z3 * -_FIX["c1_961"] + z5, z4 * -_FIX["c0_390"] + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    sh = c + pb + 3 if final else c - pb
    return np.stack([_descale(t10 + t3, sh), _descale(t11 + t2, sh),
                     _descale(t12 + t1, sh), _descale(t13 + t0, sh),
                     _descale(t13 - t0, sh), _descale(t12 - t1, sh),
                     _descale(t11 - t2, sh), _descale(t10 - t3, sh)], -1)


def _quantize(coef: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantization by reciprocal (``compute_reciprocal``
    with 16-bit ``DCTELEM``): ``((|x| + corr) * recip) >> shift``, signed."""
    div = (qtab << 3).astype(np.int64)
    recip = np.zeros_like(div)
    corr = np.zeros_like(div)
    shift = np.zeros_like(div)
    for idx, dv in np.ndenumerate(div):
        dv = int(dv)
        b = dv.bit_length() - 1
        r = 16 + b
        fq, fr = divmod(1 << r, dv)
        cc = dv // 2
        if fr == 0:
            fq >>= 1
            r -= 1
        elif fr <= dv // 2:
            cc += 1
        else:
            fq += 1
        recip[idx], corr[idx], shift[idx] = fq, cc, r
    a = np.abs(coef)
    q = ((a + corr) * recip) >> shift
    return np.where(coef < 0, -q, q)


def _blocks(plane: np.ndarray) -> np.ndarray:
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _unblocks(b: np.ndarray) -> np.ndarray:
    n, m = b.shape[:2]
    return b.transpose(0, 2, 1, 3).reshape(n * 8, m * 8)


def forward_plane(plane: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """A padded sample plane (multiple of 8 in both axes) -> its quantized
    coefficients (H/8, W/8, 8, 8) int64: level shift, islow DCT, quantize."""
    b = _blocks(plane.astype(np.int64) - 128)
    f = _fdct_1d(b, True)
    f = _fdct_1d(f.swapaxes(-1, -2), False).swapaxes(-1, -2)
    return _quantize(f, qtab)


def inverse_plane(coefs: np.ndarray, qtab: np.ndarray) -> np.ndarray:
    """Quantized coefficients (nby, nbx, 8, 8) -> the uint8 sample plane:
    dequantize, islow IDCT, the SIMD IDCT's saturating range limit."""
    deq = coefs.astype(np.int64) * qtab
    s = _idct_1d(deq.swapaxes(-1, -2), False).swapaxes(-1, -2)
    s = _idct_1d(s, True)
    return _unblocks(np.clip(s + 128, 0, 255)).astype(np.uint8)


def _pad_edge(x: np.ndarray, h: int, w: int) -> np.ndarray:
    return np.pad(x, ((0, h - x.shape[0]), (0, w - x.shape[1])), mode="edge")


def _fancy_h2(rows: np.ndarray, w: int, bias: Tuple[int, int], shift: int):
    """The horizontal half of libjpeg's fancy upsampling: each column's
    3/4 itself + 1/4 its left / right neighbour, edges replicated."""
    left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
    right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
    out = np.empty((rows.shape[0], 2 * rows.shape[1]), np.int32)
    out[:, 0::2] = (3 * rows + left + bias[0]) >> shift
    out[:, 1::2] = (3 * rows + right + bias[1]) >> shift
    return out[:, :w]


def fancy_h2v2(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libjpeg's h2v2 fancy upsampling of a (ceil(h/2), ceil(w/2)) plane:
    3/4 nearer + 1/4 further row, then columns, with the 8 / 7 biases."""
    c = c.astype(np.int32)
    up = np.concatenate([c[:1], c[:-1]], 0)
    down = np.concatenate([c[1:], c[-1:]], 0)
    rows = np.empty((2 * c.shape[0], c.shape[1]), np.int32)
    rows[0::2] = 3 * c + up
    rows[1::2] = 3 * c + down
    return _fancy_h2(rows, w, (8, 7), 4)[:h]


def fancy_h2v1(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libjpeg's h2v1 fancy upsampling of an (h, ceil(w/2)) plane: 3/4
    itself + 1/4 its neighbour, with the 1 / 2 biases."""
    return _fancy_h2(c.astype(np.int32), w, (1, 2), 2)[:h]


_ONE_HALF = 1 << 15


def _fix(v: float) -> int:
    return int(v * 65536 + 0.5)


def bgr_to_ycc(img: np.ndarray):
    """``jccolor.c``'s RGB -> YCbCr of an (H, W, 3) uint8 BGR image: three
    int64 planes."""
    b, g, r = (img[..., i].astype(np.int64) for i in range(3))
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + _ONE_HALF) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + (128 << 16) + _ONE_HALF - 1) >> 16
    return y, cb, cr


def ycc_to_bgr(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """``jdcolor.c``'s YCbCr -> RGB by its tables, as (H, W, 3) uint8 BGR."""
    x = np.arange(256) - 128
    cr_r = (_fix(1.402) * x + _ONE_HALF) >> 16
    cb_b = (_fix(1.772) * x + _ONE_HALF) >> 16
    cr_g = -_fix(0.71414) * x
    cb_g = -_fix(0.34414) * x + _ONE_HALF
    y = y.astype(np.int64)
    rr = y + cr_r[cr]
    gg = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    bb = y + cb_b[cb]
    return np.clip(np.stack([bb, gg, rr], -1), 0, 255).astype(np.uint8)


def _downsample_h2v2(comp: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """``jcsample.c`` h2v2: the plane edge-padded to (2 out_h, 2 out_w)
    read as 2x2 sums with the alternating 1, 2 bias, >> 2."""
    full = _pad_edge(comp, 2 * out_h, 2 * out_w)
    bias = np.tile(np.array([1, 2]), out_w // 2 + 1)[:out_w]
    return (full[0::2, 0::2] + full[0::2, 1::2] + full[1::2, 0::2]
            + full[1::2, 1::2] + bias[None, :]) >> 2


def _forward_420(img: np.ndarray, quality: int):
    """The quantized coefficients of a 4:2:0 image on its MCU grid: Y
    (2 my, 2 mx, 8, 8), Cb and Cr (my, mx, 8, 8), and the two tables."""
    h, w = img.shape[:2]
    my, mx = -(-h // 16), -(-w // 16)
    y, cb, cr = bgr_to_ycc(img)
    qy, qc = quant_table(STD_LUMA, quality), quant_table(STD_CHROMA, quality)
    ch, cw = -(-h // 2), -(-w // 2)
    out = [forward_plane(_pad_edge(y, 16 * my, 16 * mx), qy)]
    for comp in (cb, cr):
        s = _downsample_h2v2(comp, ch, 8 * mx)
        out.append(forward_plane(_pad_edge(s, 8 * my, 8 * mx), qc))
    return out, qy, qc


def jpeg_roundtrip(img: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode('.jpg', img, [IMWRITE_JPEG_QUALITY,
    quality]))`` of an (H, W, 3) uint8 BGR image: baseline 4:2:0 JPEG as
    libjpeg-turbo codes it, less the lossless entropy stage."""
    h, w = img.shape[:2]
    (cy, cb, cr), qy, qc = _forward_420(img, quality)
    y = inverse_plane(cy, qy)[:h, :w]
    ch, cw = -(-h // 2), -(-w // 2)
    up = [fancy_h2v2(inverse_plane(c, qc)[:ch, :cw], h, w) for c in (cb, cr)]
    return ycc_to_bgr(y, *up)


# ------------------------------------------------------------ encoder ----

def _canonical_codes(bits: Sequence[int], vals: Sequence[int]):
    """Canonical Huffman codes (T.81 Annex C): code and length per symbol."""
    codes = np.zeros(256, np.int64)
    lens = np.zeros(256, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            codes[vals[k]], lens[vals[k]] = code, length
            code, k = code + 1, k + 1
        code <<= 1
    return codes, lens


def _magnitude(v: np.ndarray):
    """The size category of each value and its extra bits (one's
    complement of negatives, T.81 F.1.2.1)."""
    size = np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)
    extra = np.where(v < 0, v + (1 << size) - 1, v)
    return size, extra


def _entropy_code(blocks: np.ndarray, comp: np.ndarray, tables) -> bytes:
    """Huffman-code one scan: ``blocks`` (N, 64) quantized coefficients in
    natural order and scan order, ``comp`` (N,) each block's component,
    ``tables[c]`` its ((dc codes, lens), (ac codes, lens)). Returns the
    byte-stuffed entropy-coded segment, padded with 1 bits."""
    n = blocks.shape[0]
    zz = blocks[:, ZIGZAG]
    diff = np.zeros(n, np.int64)
    for c in np.unique(comp):
        idx = np.flatnonzero(comp == c)
        dc = zz[idx, 0]
        diff[idx] = dc - np.concatenate([[0], dc[:-1]])
    keys, values, lengths = [], [], []

    def emit(key, sym, size, extra, which):
        code = np.zeros(len(key), np.int64)
        clen = np.zeros(len(key), np.int64)
        for c in np.unique(comp):
            sel = comp[key // 256] == c
            codes, lens = tables[c][which]
            code[sel], clen[sel] = codes[sym[sel]], lens[sym[sel]]
        keys.append(key)
        values.append((code << size) | extra)
        lengths.append(clen + size)

    block = np.arange(n)
    size, extra = _magnitude(diff)
    emit(block * 256, size, size, extra, 0)
    bi, k = np.nonzero(zz[:, 1:])
    k = k + 1
    first = np.r_[True, bi[1:] != bi[:-1]] if len(bi) else np.zeros(0, bool)
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    size, extra = _magnitude(zz[bi, k])
    emit(bi * 256 + 4 * k + 3, (run % 16) << 4 | size, size, extra, 1)
    nzrl = run // 16
    zi = np.repeat(np.arange(len(bi)), nzrl)
    j = np.arange(len(zi)) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
    zero = np.zeros(len(zi), np.int64)
    emit(bi[zi] * 256 + 4 * k[zi] + j, zero + 0xF0, zero, zero, 1)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)
    eob = np.flatnonzero(last < 63)
    zero = np.zeros(len(eob), np.int64)
    emit(eob * 256 + 255, zero, zero, zero, 1)

    order = np.argsort(np.concatenate(keys), kind="stable")
    values = np.concatenate(values)[order]
    lengths = np.concatenate(lengths)[order]
    starts = np.cumsum(lengths) - lengths
    total = int(lengths.sum())
    item = np.repeat(np.arange(len(lengths)), lengths)
    pos = np.arange(total) - starts[item]
    bits = ((values[item] >> (lengths[item] - 1 - pos)) & 1).astype(np.uint8)
    bits = np.concatenate([bits, np.ones((-total) % 8, np.uint8)])
    data = np.packbits(bits)
    data = np.insert(data, np.flatnonzero(data == 0xFF) + 1, 0)
    return data.tobytes()


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR -> baseline JPEG bytes: JFIF, 4:2:0, the
    quality-scaled standard quantization tables and the standard Huffman
    tables, one interleaved scan; what ``cv2.imencode('.jpg', img,
    [IMWRITE_JPEG_QUALITY, quality])`` stores (its lossy steps are
    ``jpeg_roundtrip``'s)."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"encode_jpeg takes (H, W, 3) uint8 BGR images, not "
                         f"{img.shape} {img.dtype}")
    h, w = img.shape[:2]
    if not (0 < h < 65536 and 0 < w < 65536):
        raise ValueError(f"a baseline JPEG holds at most 65535x65535, not {h}x{w}")
    (cy, cb, cr), qy, qc = _forward_420(img, quality)
    my, mx = cb.shape[:2]
    # MCU order: 4 Y blocks (2x2), Cb, Cr
    ys = cy.reshape(my, 2, mx, 2, 64).transpose(0, 2, 1, 3, 4).reshape(my, mx, 4, 64)
    blocks = np.concatenate([ys, cb.reshape(my, mx, 1, 64), cr.reshape(my, mx, 1, 64)],
                            2).reshape(-1, 64)
    comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), my * mx)
    std = {k: _canonical_codes(*v) for k, v in STD_HUFFMAN.items()}
    luma = (std["dc_luma"], std["ac_luma"])
    chroma = (std["dc_chroma"], std["ac_chroma"])
    scan = _entropy_code(blocks, comp, {0: luma, 1: chroma, 2: chroma})

    def dht(tc_th, name):
        bits, vals = STD_HUFFMAN[name]
        return bytes([tc_th, *bits, *vals])

    return b"".join([
        JPEG_SOI,
        _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00"),
        _segment(0xDB, bytes([0, *qy.reshape(-1)[ZIGZAG].tolist()])
                 + bytes([1, *qc.reshape(-1)[ZIGZAG].tolist()])),
        _segment(0xC0, bytes([8]) + h.to_bytes(2, "big") + w.to_bytes(2, "big")
                 + bytes([3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])),
        _segment(0xC4, dht(0x00, "dc_luma") + dht(0x10, "ac_luma")
                 + dht(0x01, "dc_chroma") + dht(0x11, "ac_chroma")),
        _segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])),
        scan,
        b"\xff\xd9",
    ])


# ------------------------------------------------------------ decoder ----

_SOF_MODES = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential",
    0xC6: "differential progressive", 0xC7: "differential lossless",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless", 0xCD: "arithmetic-coded differential "
    "sequential", 0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless",
}
_HUFF_TABLE_BYTES = 16 + 256          # BITS, then HUFFVAL padded to 256

SCAN_ERRORS = {
    1: "an invalid Huffman code",
    2: "entropy-coded data that ends early",
    3: "a missing or out-of-order restart marker",
    4: "a run of AC coefficients past the 64th",
    5: "a Huffman table that is not defined",
}


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq
        self.coefs: Optional[np.ndarray] = None
        self.qtab: Optional[np.ndarray] = None


def _find_scan_end(data: bytes, pos: int) -> int:
    """The offset of the first marker after ``pos`` that is not a restart
    marker (a 0xFF not followed by 0x00 or 0xD0-0xD7)."""
    d = np.frombuffer(data, np.uint8, offset=pos)
    if len(d) < 2:
        return len(data)
    nxt = d[1:]
    hit = np.flatnonzero((d[:-1] == 0xFF) & (nxt != 0x00) & ((nxt < 0xD0) | (nxt > 0xD7)))
    return pos + int(hit[0]) if len(hit) else len(data)


def _huff_lookup(table: np.ndarray) -> Optional[List[int]]:
    """A 16-bit-peek lookup of one packed table: entry = length << 8 |
    symbol, 0 for an invalid code; None for a table with no code or whose
    counts overflow a code length."""
    bits, vals = table[:16], table[16:]
    look = np.zeros(1 << 16, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(int(bits[length - 1])):
            if code >= 1 << length or k >= 256:
                return None
            lo = code << (16 - length)
            look[lo:lo + (1 << (16 - length))] = length << 8 | int(vals[k])
            code, k = code + 1, k + 1
        code <<= 1
    return look.tolist() if k else None


def decode_scan_numpy(data: bytes, comps: np.ndarray, tables: np.ndarray,
                      mcus_x: int, mcus_y: int, restart_interval: int,
                      coefs: Sequence[np.ndarray]) -> int:
    """The plain twin of the host library's ``jpeg_decode_scan``: decode
    one baseline Huffman scan into ``coefs``.

    Args:
        data: the scan's entropy-coded bytes, restart markers included.
        comps: (n, 5) int32 per scan component: blocks across and down an
            MCU, DC and AC table slot, and the component's blocks a row.
        tables: (8, 272) uint8: DC slots 0-3, AC slots 4-7, each BITS then
            HUFFVAL; a slot with no code is undefined.
        coefs: per scan component an (rows, blocks a row, 64) int16 array,
            natural order, written in place.

    Returns 0, or the code of ``SCAN_ERRORS``.
    """
    d = np.frombuffer(data, np.uint8)
    nxt = np.r_[d[1:], 0]
    ff = d == 0xFF
    rst = np.flatnonzero(ff & (nxt >= 0xD0) & (nxt <= 0xD7))
    bounds = np.r_[0, rst, len(d)]
    looks: Dict[int, List[int]] = {}

    def lookup(slot):
        if slot not in looks:
            looks[slot] = _huff_lookup(tables[slot])
        return looks[slot]

    units = []
    for c in comps:
        dc, ac = lookup(int(c[2])), lookup(int(c[3]) + 4)
        if dc is None or ac is None:
            return 5
        units.append((int(c[0]), int(c[1]), dc, ac, int(c[4])))
    zigzag = ZIGZAG.tolist()
    total = mcus_x * mcus_y
    per = restart_interval or total
    for seg_i, mcu0 in enumerate(range(0, total, per)):
        if seg_i >= len(bounds) - 1:
            return 2
        lo = bounds[seg_i] + (2 if seg_i else 0)
        if seg_i and d[bounds[seg_i] + 1] != 0xD0 + (seg_i - 1) % 8:
            return 3
        seg = d[lo:bounds[seg_i + 1]]
        seg = np.delete(seg, np.flatnonzero((seg[:-1] == 0xFF) & (seg[1:] == 0)) + 1)
        nbits = 8 * len(seg)
        # room for a block's worth of reads past the end (caught below)
        padded = np.concatenate([seg, np.zeros(256, np.uint8)]).astype(np.int64)
        win = ((padded[:-3] << 24) | (padded[1:-2] << 16) | (padded[2:-1] << 8)
               | padded[3:]).tolist()
        pos = 0
        pred = [0] * len(units)
        for mcu in range(mcu0, min(mcu0 + per, total)):
            my, mx = divmod(mcu, mcus_x)
            for ui, (bh, bv, dc_look, ac_look, row) in enumerate(units):
                out = coefs[ui]
                for yy in range(bv):
                    for xx in range(bh):
                        blk = out[my * bv + yy, mx * bh + xx]
                        e = dc_look[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                        if not e:
                            return 1
                        pos += e >> 8
                        s = e & 0xFF
                        v = 0
                        if s:
                            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if v < 1 << (s - 1):
                                v -= (1 << s) - 1
                        pred[ui] += v
                        blk[0] = pred[ui]
                        k = 1
                        while k < 64:
                            e = ac_look[(win[pos >> 3] >> (16 - (pos & 7))) & 0xFFFF]
                            if not e:
                                return 1
                            pos += e >> 8
                            rs = e & 0xFF
                            r, s = rs >> 4, rs & 15
                            if s == 0:
                                if r != 15:
                                    break
                                k += 16
                                continue
                            k += r
                            if k > 63:
                                return 4
                            v = (win[pos >> 3] >> (32 - (pos & 7) - s)) & ((1 << s) - 1)
                            pos += s
                            if v < 1 << (s - 1):
                                v -= (1 << s) - 1
                            blk[zigzag[k]] = v
                            k += 1
                        if pos > nbits:
                            return 2
    return 0


def _decode_scan(data: bytes, comps, tables, mcus_x, mcus_y, restart,
                 coefs, native: bool) -> int:
    comps = np.ascontiguousarray(comps, np.int32)
    for (bh, bv, _, _, row), a in zip(comps, coefs):
        if (a.dtype != np.int16 or not a.flags.c_contiguous or a.shape[1] != row
                or a.shape[0] < mcus_y * bv or row < mcus_x * bh or a.shape[2] != 64):
            raise ValueError("a coefficient array does not hold the scan's blocks")
    if native:
        from .host_kernels import jpeg_decode_scan
        return jpeg_decode_scan(data, comps, tables, mcus_x, mcus_y, restart, coefs)
    return decode_scan_numpy(data, comps, tables, mcus_x, mcus_y, restart, coefs)


def _color_space(comps: List[_Component], adobe: Optional[int], jfif: bool) -> str:
    """libjpeg's ``default_decompress_parms`` for 3 components: YCbCr
    unless an Adobe marker says transform 0 or, without JFIF and Adobe
    markers, the component ids spell R, G, B."""
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if [c.id for c in comps] == [82, 71, 66] else "ycc"


def decode_jpeg(data: bytes, native: bool = True, name: str = "JPEG data") -> np.ndarray:
    """Baseline JPEG bytes -> (H, W, 3) uint8 BGR, what ``cv2.imdecode(data,
    cv2.IMREAD_COLOR)`` returns (a gray image replicated into the three
    channels). ``native=False`` decodes the entropy-coded scans with the
    numpy twin. Raises ``ValueError`` naming ``name`` for anything else
    (progressive, arithmetic-coded, lossless, 12-bit, other sampling)."""
    def fail(msg):
        raise ValueError(f"{name}: {msg}")

    if data[:2] != JPEG_SOI:
        fail("not a JPEG file (no SOI marker)")
    qtabs: Dict[int, np.ndarray] = {}
    tables = np.zeros((8, _HUFF_TABLE_BYTES), np.uint8)
    comps: List[_Component] = []
    h = w = 0
    restart = 0
    adobe, jfif, scans = None, False, 0
    pos = 2
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) \
                and data[pos + 1] == 0xFF:
            pos += 1                                   # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            fail(f"a marker is missing at byte {pos}")
        marker = data[pos + 1]
        pos += 2
        if marker == 0xD9:                             # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue
        if pos + 2 > len(data):
            fail("truncated marker segment")
        length = int.from_bytes(data[pos:pos + 2], "big")
        body = data[pos + 2:pos + length]
        if len(body) != length - 2:
            fail(f"marker 0x{marker:02X}'s segment is truncated")
        pos += length
        if marker in _SOF_MODES:
            fail(f"a {_SOF_MODES[marker]} JPEG: the port decodes baseline "
                 "sequential Huffman JPEG only")
        if marker in (0xC0, 0xC1):
            precision = body[0]
            if precision != 8:
                fail(f"a {precision}-bit JPEG: the port decodes 8-bit samples only")
            h, w = int.from_bytes(body[1:3], "big"), int.from_bytes(body[3:5], "big")
            n = body[5]
            comps = [_Component(body[6 + 3 * i], body[7 + 3 * i] >> 4,
                                body[7 + 3 * i] & 15, body[8 + 3 * i])
                     for i in range(n)]
            if n not in (1, 3) or h == 0 or w == 0:
                fail(f"a JPEG of {n} components and {h}x{w} pixels: the port "
                     "decodes 1 or 3 components with the height in the frame")
            if not all(1 <= c.h <= 4 and 1 <= c.v <= 4 and c.tq <= 3 for c in comps):
                fail("a frame header with sampling factors outside 1-4 or a "
                     "quantization table slot above 3")
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                if pq > 1 or tq > 3:
                    fail(f"a quantization table of precision {pq} and slot {tq}")
                size = 128 if pq else 64
                raw = np.frombuffer(body[i + 1:i + 1 + size], ">u2" if pq else np.uint8)
                tab = np.zeros(64, np.int64)
                tab[ZIGZAG] = raw
                qtabs[tq] = tab.reshape(8, 8)
                i += 1 + size
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                if tc > 1 or th > 3:
                    fail(f"a Huffman table of class {tc} and slot {th}")
                bits = np.frombuffer(body[i + 1:i + 17], np.uint8)
                n = int(bits.sum())
                slot = (4 if tc else 0) + th
                tables[slot] = 0
                tables[slot, :16] = bits
                tables[slot, 16:16 + n] = np.frombuffer(body[i + 17:i + 17 + n], np.uint8)
                i += 17 + n
        elif marker == 0xDD:
            restart = int.from_bytes(body[:2], "big")
        elif marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif marker == 0xDA:
            if not comps:
                fail("a scan before the frame header")
            pos = _read_scan(data, pos, body, comps, qtabs, tables, h, w, restart,
                             native, fail)
            scans += 1
    if not scans:
        fail("no scan")
    return _to_bgr(comps, h, w, _color_space(comps, adobe, jfif) if len(comps) == 3
                   else "gray", fail)


def _read_scan(data, pos, body, comps, qtabs, tables, h, w, restart, native, fail):
    """Decode the scan whose header is ``body``; returns the offset after
    its entropy-coded data."""
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    ns = body[0]
    by_id = {c.id: c for c in comps}
    members = []
    for i in range(ns):
        c = by_id.get(body[1 + 2 * i])
        if c is None:
            fail(f"a scan names component {body[1 + 2 * i]}, not in the frame")
        members.append((c, body[2 + 2 * i] >> 4, body[2 + 2 * i] & 15))
    ss, se, ahal = body[1 + 2 * ns:4 + 2 * ns]
    if (ss, se, ahal) != (0, 63, 0):
        fail(f"a scan of spectral range {ss}-{se} and approximation {ahal}: the "
             "port decodes baseline sequential scans only")
    mcus_x, mcus_y = -(-w // (8 * hmax)), -(-h // (8 * vmax))
    rows = []
    for c, td, ta in members:
        if c.coefs is None:
            if c.tq not in qtabs:
                fail(f"component {c.id} uses quantization table {c.tq}, not defined")
            c.qtab = qtabs[c.tq]
            c.coefs = np.zeros((mcus_y * c.v, mcus_x * c.h, 64), np.int16)
        if ns == 1:     # one block an MCU, over the component's own blocks
            bw = -(-(-(-w * c.h // hmax)) // 8)
            bh = -(-(-(-h * c.v // vmax)) // 8)
            rows.append((1, 1, td, ta, c.coefs.shape[1]))
        else:
            rows.append((c.h, c.v, td, ta, c.coefs.shape[1]))
    if ns == 1:
        sx, sy = bw, bh
    else:
        sx, sy = mcus_x, mcus_y
    end = _find_scan_end(data, pos)
    err = _decode_scan(data[pos:end], np.asarray(rows, np.int32), tables, sx, sy,
                       restart, [c.coefs for c, _, _ in members], native)
    if err:
        fail(f"scan decode failed: {SCAN_ERRORS.get(err, f'error {err}')}")
    return end


def _to_bgr(comps: List[_Component], h: int, w: int, space: str, fail) -> np.ndarray:
    hmax = max(c.h for c in comps)
    vmax = max(c.v for c in comps)
    planes = []
    for c in comps:
        if c.coefs is None:
            fail(f"component {c.id} has no scan")
        ch, cw = -(-h * c.v // vmax), -(-w * c.h // hmax)
        nby, nbx = c.coefs.shape[:2]
        planes.append(inverse_plane(c.coefs.reshape(nby, nbx, 8, 8), c.qtab)[:ch, :cw])
    if len(comps) == 1:
        return np.repeat(planes[0][..., None], 3, axis=2)
    sampling = tuple((c.h, c.v) for c in comps)
    if sampling[1:] != ((1, 1), (1, 1)) or sampling[0] not in ((1, 1), (2, 2), (2, 1)):
        fail(f"sampling factors {sampling}: the port decodes 4:4:4, 4:2:2 and "
             "4:2:0 only")
    up = {(1, 1): lambda p: p, (2, 2): lambda p: fancy_h2v2(p, h, w),
          (2, 1): lambda p: fancy_h2v1(p, h, w)}[sampling[0]]
    y, cb, cr = planes[0], up(planes[1]), up(planes[2])
    if space == "rgb":
        return np.ascontiguousarray(np.stack([cr, cb, y], -1).astype(np.uint8))
    return ycc_to_bgr(y, cb.astype(np.int64), cr.astype(np.int64))
