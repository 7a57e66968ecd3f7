"""The port's JPEG codec (``oadg_tpu_torch/utils/jpeg.py``, the scan decoder
of ``utils/csrc/host_kernels.cpp``) against OpenCV, on the CPU.

``decode_jpeg`` equals ``cv2.imdecode(..., IMREAD_COLOR)`` bit for bit on
``cv2.imencode`` outputs: qualities 30, 75 and 95, sampling 4:2:0, 4:2:2
and 4:4:4, odd sizes, restart intervals, optimized Huffman tables, a gray
image, an RGB-coded (Adobe) file, through the host library and through its
numpy twin.
``cv2.imdecode(encode_jpeg(img, q))`` equals ``jpeg_roundtrip(img, q)``,
the corruption suite's JPEG; the encoder's Huffman tables are those cv2
writes. ``imread`` reads a JPEG with ``cv2`` unimportable; progressive,
arithmetic-coded, 12-bit and truncated files raise a ``ValueError`` naming
the file and what it is.
"""
import sys

import numpy as np
import pytest

from oadg_tpu_torch.data.pipelines import image_io
from oadg_tpu_torch.utils import jpeg

SIZES = [(37, 53), (64, 96), (1, 1), (17, 8), (9, 130)]
SAMPLING = {"420": "IMWRITE_JPEG_SAMPLING_FACTOR_420",
            "422": "IMWRITE_JPEG_SAMPLING_FACTOR_422",
            "444": "IMWRITE_JPEG_SAMPLING_FACTOR_444"}


@pytest.fixture(scope="module")
def cv2():
    return pytest.importorskip("cv2")


def _image(h, w, seed=0):
    """A smooth texture with noise and a saturated block (colour
    conversion clips there)."""
    rng = np.random.RandomState(seed + h * 1000 + w)
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([np.sin(xx / 7.0 + c) * 60 + np.cos(yy / 5.0) * 40 + 128
                     for c in range(3)], -1)
    img = base + rng.randint(-40, 40, (h, w, 3))
    img[: h // 3, : w // 4] = [255, 0, 255]
    return np.clip(img, 0, 255).astype(np.uint8)


def _encode(cv2, img, *params):
    ok, enc = cv2.imencode(".jpg", img, list(params))
    assert ok
    return enc.tobytes()


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("restart", [0, 3])
@pytest.mark.parametrize("sampling", sorted(SAMPLING))
@pytest.mark.parametrize("quality", [30, 75, 95])
def test_decode_equals_cv2(cv2, quality, sampling, restart, native):
    for h, w in SIZES:
        params = [cv2.IMWRITE_JPEG_QUALITY, quality,
                  cv2.IMWRITE_JPEG_SAMPLING_FACTOR, getattr(cv2, SAMPLING[sampling])]
        if restart:
            params += [cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
        data = _encode(cv2, _image(h, w), *params)
        if restart:
            assert b"\xff\xdd" in data and (h * w < 300 or b"\xff\xd0" in data)
        want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        got = jpeg.decode_jpeg(data, native=native)
        assert got.dtype == np.uint8 and got.shape == (h, w, 3)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("kind", ["gray", "optimized tables"])
def test_decode_gray_and_optimized_tables_equal_cv2(cv2, kind, native):
    img = _image(37, 53)
    data = (_encode(cv2, img[..., 1]) if kind == "gray"
            else _encode(cv2, img, cv2.IMWRITE_JPEG_OPTIMIZE, 1))
    want = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(jpeg.decode_jpeg(data, native=native), want)


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
def test_decode_rgb_coded_file_equals_cv2(cv2, native):
    """A 3-component file without JFIF whose Adobe marker says transform 0
    holds RGB, not YCbCr (libjpeg's ``default_decompress_parms``)."""
    data = _encode(cv2, _image(37, 53), cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                   cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444)
    length = int.from_bytes(data[4:6], "big")
    assert data[2:4] == b"\xff\xe0" and data[6:11] == b"JFIF\x00"
    adobe = b"\xff\xee\x00\x0eAdobe\x00\x64\x00\x00\x00\x00\x00"
    rgb = data[:2] + adobe + data[4 + length:]
    want = cv2.imdecode(np.frombuffer(rgb, np.uint8), cv2.IMREAD_COLOR)
    got = jpeg.decode_jpeg(rgb, native=native)
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, jpeg.decode_jpeg(data, native=native))


@pytest.mark.parametrize("quality", [7, 30, 75, 95, 100])
def test_encode_decodes_in_cv2_to_the_roundtrip(cv2, quality):
    for h, w in SIZES:
        img = _image(h, w, seed=1)
        data = jpeg.encode_jpeg(img, quality)
        want = jpeg.jpeg_roundtrip(img, quality)
        got = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
        np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w}")
        np.testing.assert_array_equal(jpeg.decode_jpeg(data), want)


def test_encoder_tables_are_the_ones_cv2_writes(cv2):
    """The DQT and DHT segments of ``encode_jpeg`` equal those of
    ``cv2.imencode`` at the same quality."""
    img = _image(37, 53)

    def segments(data, marker):
        out, pos = [], 2
        while data[pos + 1] != 0xDA:
            length = int.from_bytes(data[pos + 2:pos + 4], "big")
            if data[pos + 1] == marker:
                out.append(data[pos + 4:pos + 2 + length])
            pos += 2 + length
        return b"".join(out)

    for q in (30, 95):
        mine, theirs = jpeg.encode_jpeg(img, q), _encode(cv2, img, cv2.IMWRITE_JPEG_QUALITY, q)
        assert segments(mine, 0xDB) == segments(theirs, 0xDB)
        assert segments(mine, 0xC4) == segments(theirs, 0xC4)


def test_imread_decodes_jpeg_without_cv2(tmp_path, monkeypatch):
    img = _image(40, 60)
    path = tmp_path / "x.jpg"
    image_io.imwrite(str(path), img, quality=90)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = image_io.imread(str(path))
    np.testing.assert_array_equal(got, jpeg.jpeg_roundtrip(img, 90))
    assert image_io.image_size(str(path)) == (60, 40)
    image_io.imwrite(str(tmp_path / "x.png"), img)
    assert image_io.image_size(str(tmp_path / "x.png")) == (60, 40)
    (tmp_path / "x.gif").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="x.gif"):
        image_io.imread(str(tmp_path / "x.gif"))


def _patched(data, marker, offset, value):
    """``data`` with the byte at ``offset`` into the segment of ``marker``
    set to ``value`` (offset 0 is the marker byte itself)."""
    pos = data.index(bytes([0xFF, marker]))
    return data[:pos + 1 + offset] + bytes([value]) + data[pos + 2 + offset:]


@pytest.mark.parametrize("mode", ["progressive", "arithmetic", "12-bit", "truncated",
                                  "lossless"])
def test_unsupported_or_broken_files_raise(cv2, tmp_path, mode):
    img = _image(37, 53)
    base = _encode(cv2, img)
    data = {
        "progressive": lambda: _encode(cv2, img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "arithmetic": lambda: _patched(base, 0xC0, 0, 0xC9),
        "lossless": lambda: _patched(base, 0xC0, 0, 0xC3),
        "12-bit": lambda: _patched(base, 0xC0, 3, 12),
        "truncated": lambda: base[:len(base) // 2] + b"\xff\xd9",
    }[mode]()
    path = tmp_path / f"{mode}.jpg"
    path.write_bytes(data)
    words = {"progressive": "progressive", "arithmetic": "arithmetic-coded",
             "lossless": "lossless", "12-bit": "12-bit", "truncated": "ends early"}
    for native in (True, False):
        with pytest.raises(ValueError, match=f"{mode}.jpg.*{words[mode]}"):
            if native:
                image_io.imread(str(path))
            else:
                jpeg.decode_jpeg(data, native=False, name=str(path))


def test_native_and_numpy_scan_decoders_agree_on_coefficients(cv2):
    """The two scan decoders fill the same coefficient arrays and return
    the same code, on a whole scan and on a corrupted one."""
    data = _encode(cv2, _image(64, 96), cv2.IMWRITE_JPEG_RST_INTERVAL, 2)
    sos = data.index(b"\xff\xda")
    start = sos + 2 + int.from_bytes(data[sos + 2:sos + 4], "big")
    end = jpeg._find_scan_end(data, start)
    tables = np.zeros((8, 272), np.uint8)
    pos = 2
    while pos < sos:
        length = int.from_bytes(data[pos + 2:pos + 4], "big")
        if data[pos + 1] == 0xC4:
            body, i = data[pos + 4:pos + 2 + length], 0
            while i < len(body):
                n = sum(body[i + 1:i + 17])
                slot = (4 if body[i] >> 4 else 0) + (body[i] & 15)
                tables[slot, :16] = list(body[i + 1:i + 17])
                tables[slot, 16:16 + n] = list(body[i + 17:i + 17 + n])
                i += 17 + n
        pos += 2 + length
    comps = np.array([[2, 2, 0, 0, 12], [1, 1, 1, 1, 6], [1, 1, 1, 1, 6]], np.int32)
    scan = data[start:end]
    broken = scan[:40] + bytes([scan[40] ^ 0x5A]) + scan[41:]
    for segment in (scan, broken, scan[: len(scan) // 3]):
        out = []
        for native in (True, False):
            coefs = [np.zeros((8, 12, 64), np.int16), np.zeros((4, 6, 64), np.int16),
                     np.zeros((4, 6, 64), np.int16)]
            code = jpeg._decode_scan(segment, comps, tables, 6, 4, 2, coefs, native)
            out.append((code, coefs))
        assert out[0][0] == out[1][0]
        if out[0][0] == 0:
            for a, b in zip(out[0][1], out[1][1]):
                np.testing.assert_array_equal(a, b)
    assert jpeg._decode_scan(scan, comps, tables, 6, 4, 2, [
        np.zeros((8, 12, 64), np.int16), np.zeros((4, 6, 64), np.int16),
        np.zeros((4, 6, 64), np.int16)], True) == 0
