"""The port's corruption suite (oadg_tpu_torch/ops/corruptions.py) against the
JAX package's, and its OpenCV stand-ins (oadg_tpu_torch/ops/cv_host.py)
against OpenCV itself, on the CPU (cv2 is imported here, never in the port).

Every corruption at severities 1-5 runs on the JAX test's 64x96 image and on
a 61x93 one (JPEG's partial MCUs, INTER_AREA's fractional scales, a width
that is not a multiple of 16): the port with ``rng=RandomState(s)``, JAX
after ``np.random.seed(s)``. They are bit-equal but where ``TOLERANCE``
says otherwise: at most 1 level apart on at most the stated share of
values, measured on these very cases, for a reason named there.
"""
import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from oadg_tpu.ops import corruptions as jax_corruptions
from oadg_tpu_torch.ops import corruptions, cv_host

SIZES = [(64, 96), (61, 93)]

# name -> (largest share of values 1 level apart, share measured on these
# cases, reason). Where cv2 sums in float32 or by DFT and the port in
# float64, a value that lands on a uint8 boundary can round the other way;
# on the textured 80x160 to 120x200 PNGs of torch_data_cases the shares
# reach 1.6e-4 (snow) and 4.4e-5 (frost, defocus_blur, elastic_transform).
TOLERANCE = {
    "snow": (2e-4, 5.9e-5, "its snow layer goes through filter2D, which cv2 computes by a "
                           "float DFT for kernels of 25x25 and the port in float64 "
                           "(1 value of 17019, at 61x93 severity 5)"),
    "defocus_blur": (2e-4, 0.0, "filter2D by DFT, and GaussianBlur of the disk kernel"),
    "motion_blur": (2e-4, 0.0, "filter2D by DFT for its 21x21 to 41x41 kernels"),
    "frost": (2e-4, 0.0, "GaussianBlur summed in float32 by cv2, and OpenCV 5's cubic "
                         "coefficients (test_resize_cubic_within_ulps_of_cv2)"),
    "spatter": (2e-4, 0.0, "the chamfer distance a unit in the last place apart "
                           "(test_canny_distance_and_box_blur_equal_cv2)"),
    "elastic_transform": (2e-4, 0.0, "cv2's warpAffine takes the last (width mod 16) "
                                     "columns through a scalar loop whose coordinate "
                                     "rounding the port does not follow (1.2e-4 at "
                                     "61x93 with other seeds)"),
}


def _image(h, w):
    return np.random.RandomState(3).randint(0, 256, (h, w, 3)).astype(np.uint8)


@pytest.mark.parametrize("name", list(jax_corruptions.CORRUPTIONS))
def test_corruption_equals_jax_at_every_severity(name):
    limit = TOLERANCE.get(name, (0.0,))[0]
    for h, w in SIZES:
        img = _image(h, w)
        for sev in range(1, 6):
            np.random.seed(100 * sev + h)
            want = jax_corruptions.corrupt_numpy(img, name, sev)
            got = corruptions.corrupt_numpy(img, name, sev,
                                            rng=np.random.RandomState(100 * sev + h))
            assert got.dtype == np.uint8 and got.shape == want.shape == img.shape
            diff = np.abs(got.astype(int) - want.astype(int))
            assert diff.max() <= (1 if limit else 0), (name, h, w, sev, diff.max())
            assert (diff > 0).mean() <= limit, (name, h, w, sev, (diff > 0).mean())


def test_suite_lists_equal_jax():
    assert list(corruptions.CORRUPTIONS) == list(jax_corruptions.CORRUPTIONS)
    assert corruptions.BENCHMARK_CORRUPTIONS == jax_corruptions.BENCHMARK_CORRUPTIONS
    assert corruptions.HOLDOUT_CORRUPTIONS == jax_corruptions.HOLDOUT_CORRUPTIONS
    assert len(corruptions.BENCHMARK_CORRUPTIONS) == 15


def test_severity_zero_returns_the_image_itself():
    img = _image(32, 32)
    assert corruptions.corrupt_numpy(img, "gaussian_noise", 0) is img
    with pytest.raises(ValueError, match="unknown corruption"):
        corruptions.corrupt_numpy(img, "rain", 1)


def test_global_generator_by_default_and_every_draw_through_rng():
    """``rng=None`` draws from ``np.random`` as JAX does; with an ``rng``
    the global generator is not touched (frost's texture seed and the fog's
    fractal included)."""
    img = _image(64, 96)
    for name in ("frost", "fog", "glass_blur", "elastic_transform"):
        np.random.seed(7)
        a = corruptions.corrupt_numpy(img, name, 2)
        np.random.seed(7)
        assert np.array_equal(a, jax_corruptions.corrupt_numpy(img, name, 2)), name
        np.random.seed(9)
        state = np.random.get_state()[1].copy()
        b = corruptions.corrupt_numpy(img, name, 2, rng=np.random.RandomState(7))
        assert np.array_equal(np.random.get_state()[1], state), name
        assert np.array_equal(a, b), name


# ----------------------------------------------- cv_host against OpenCV ----

def _rng():
    return np.random.RandomState(0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("zoom", [1.01, 1.1, 1.3])
@pytest.mark.parametrize("size", SIZES)
def test_resize_linear_float_equals_cv2(size, zoom, dtype):
    h, w = size
    x = _rng().rand(h, w, 3).astype(dtype) if dtype == np.float32 else _rng().normal(size=(h, w))
    ch, cw = int(np.ceil(h / zoom)), int(np.ceil(w / zoom))
    crop = x[(h - ch) // 2:(h - ch) // 2 + ch, (w - cw) // 2:(w - cw) // 2 + cw]
    got = cv_host.resize(crop, (w, h), cv_host.INTER_LINEAR)
    want = cv2.resize(crop, (w, h), interpolation=cv2.INTER_LINEAR)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("c", [0.6, 0.5, 0.4, 0.3, 0.25])
@pytest.mark.parametrize("size", SIZES)
def test_resize_area_and_nearest_equal_cv2(size, c):
    h, w = size
    u = _rng().randint(0, 256, (h, w, 3)).astype(np.uint8)
    small = cv2.resize(u, (int(w * c), int(h * c)), interpolation=cv2.INTER_AREA)
    assert np.array_equal(cv_host.resize(u, (int(w * c), int(h * c)), cv_host.INTER_AREA), small)
    assert np.array_equal(cv_host.resize(small, (w, h), cv_host.INTER_NEAREST),
                          cv2.resize(small, (w, h), interpolation=cv2.INTER_NEAREST))


def test_resize_cubic_within_ulps_of_cv2():
    """OpenCV 5 computes the cubic taps' coefficients in an order the port
    does not follow: values agree to 2e-6 (relative to the grid's range)."""
    for h, w in SIZES:
        for s in (16, 32, 64):
            g = _rng().rand(h // s + 2, w // s + 2).astype(np.float32)
            got = cv_host.resize(g, (w, h), cv_host.INTER_CUBIC)
            want = cv2.resize(g, (w, h), interpolation=cv2.INTER_CUBIC)
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)


@pytest.mark.parametrize("shape", [(64, 96, 3), (61, 93, 3), (200, 300, 3)])
def test_colour_conversions_equal_cv2(shape):
    rng = _rng()
    u = rng.randint(0, 256, shape).astype(np.uint8)
    assert np.array_equal(cv_host.bgr2gray(u), cv2.cvtColor(u, cv2.COLOR_BGR2GRAY))
    assert np.array_equal(cv_host.bgr2hsv(u), cv2.cvtColor(u, cv2.COLOR_BGR2HSV))
    hsv = rng.randint(0, 256, shape).astype(np.uint8)
    hsv[..., 0] %= 180
    hsv[:2, :, 1] = 0                       # gray pixels
    assert np.array_equal(cv_host.hsv2bgr(hsv), cv2.cvtColor(hsv, cv2.COLOR_HSV2BGR))


def _affine_points(rng, h, w, jitter):
    center = np.float32((h, w)) // 2
    sq = min(h, w) // 3
    pts1 = np.float32([center + sq, [center[0] + sq, center[1] - sq], center - sq])
    return pts1, pts1 + rng.uniform(-jitter, jitter, size=pts1.shape).astype(np.float32)


def test_get_affine_transform_equals_cv2():
    rng = _rng()
    for _ in range(100):
        h, w = rng.randint(40, 1100), rng.randint(40, 2100)
        pts1, pts2 = _affine_points(rng, h, w, min(h, w) * 0.1)
        assert np.array_equal(cv_host.get_affine_transform(pts1, pts2),
                              cv2.getAffineTransform(pts1, pts2))


@pytest.mark.parametrize("size", [(64, 96), (123, 256), (61, 93)])
def test_warp_affine_and_remap_equal_cv2(size):
    """Bit-equal but for the last (width mod 16) columns of warpAffine (see
    ``TOLERANCE``): there, within 1e-4 of cv2's values."""
    h, w = size
    rng = _rng()
    img = rng.rand(h, w, 3).astype(np.float32)
    pts1, pts2 = _affine_points(rng, h, w, min(h, w) * 0.1)
    m = cv2.getAffineTransform(pts1, pts2)
    got = cv_host.warp_affine(img, m, (w, h))
    want = cv2.warpAffine(img, m, (w, h), borderMode=cv2.BORDER_REFLECT_101)
    full = w // 16 * 16
    assert np.array_equal(got[:, :full], want[:, :full])
    np.testing.assert_allclose(got[:, full:], want[:, full:], rtol=0, atol=1e-4)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    mx = np.float32(xx + rng.normal(0, 3, (h, w)))
    my = np.float32(yy + rng.normal(0, 3, (h, w)))
    assert np.array_equal(cv_host.remap(img, mx, my),
                          cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR,
                                    borderMode=cv2.BORDER_REFLECT_101))


def _liquid(rng, h, w, sigma):
    import scipy.ndimage as ndi
    liq = ndi.gaussian_filter(rng.normal(size=(h, w), loc=0.65, scale=0.3), sigma=sigma)
    liq[liq < 0.68] = 0
    return (np.clip(liq, 0, 1) * 255).astype(np.uint8)


@pytest.mark.parametrize("size", [(64, 96), (61, 93), (256, 512)])
def test_canny_distance_and_box_blur_equal_cv2(size):
    """Canny and the 3x3 box blur bit for bit; the chamfer distance with at
    most 1 unit in the last place on at most 1% of pixels: the port's
    in-row pass adds the run of 1s to a value once, cv2's float32 loop one
    at a time (measured: up to 0.16% of pixels on these cases)."""
    h, w = size
    rng = _rng()
    for sigma in (4, 2):
        lu = _liquid(rng, h, w, sigma)
        edges = cv2.Canny(lu, 50, 150)
        assert np.array_equal(cv_host.canny(lu, 50, 150), edges)
        d = 255 - edges
        got, want = cv_host.distance_transform(d), cv2.distanceTransform(d, cv2.DIST_L2, 5)
        ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32))
        assert ulp.max() <= 1 and (ulp > 0).mean() <= 1e-2
        assert np.array_equal(cv_host.box_blur(want, (3, 3)), cv2.blur(want, (3, 3)))
    noise = rng.randint(0, 256, (h, w)).astype(np.uint8)
    assert np.array_equal(cv_host.canny(noise, 50, 150), cv2.Canny(noise, 50, 150))


def test_gaussian_blur_and_filter2d_close_to_cv2():
    """cv2 sums these in float32 (``filter2D`` by DFT for large kernels),
    the port in float64 once rounded: within a few float32 units."""
    rng = _rng()
    for h, w in SIZES:
        x = rng.rand(h, w).astype(np.float32)
        np.testing.assert_allclose(cv_host.gaussian_blur(x, (0, 0), 1.5),
                                   cv2.GaussianBlur(x, (0, 0), 1.5), rtol=0, atol=3e-7)
        k = rng.rand(17, 17).astype(np.float32)
        for ks, s in (((3, 3), 0.1), ((5, 5), 0.5)):
            np.testing.assert_allclose(cv_host.gaussian_blur(k, ks, s),
                                       cv2.GaussianBlur(k, ks, s), rtol=0, atol=3e-7)
        x3 = rng.rand(h, w, 3).astype(np.float32)
        kern = rng.rand(21, 21).astype(np.float32)
        kern /= kern.sum()
        np.testing.assert_allclose(cv_host.filter2d(x3, kern), cv2.filter2D(x3, -1, kern),
                                   rtol=0, atol=3e-6)
        x64 = rng.rand(h, w)
        np.testing.assert_allclose(cv_host.filter2d(x64, kern), cv2.filter2D(x64, -1, kern),
                                   rtol=0, atol=1e-14)


@pytest.mark.parametrize("quality", [25, 18, 15, 10, 7])
def test_jpeg_roundtrip_equals_cv2(quality):
    rng = _rng()
    for h, w in SIZES + [(17, 33)]:
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([np.sin(xx / 7.) * 60 + 128, np.cos(yy / 5.) * 60 + 128,
                         (xx + yy) % 256], -1)
        u = np.clip(base + rng.normal(0, 20, (h, w, 3)), 0, 255).astype(np.uint8)
        ok, enc = cv2.imencode(".jpg", u, [int(cv2.IMWRITE_JPEG_QUALITY), quality])
        assert ok
        assert np.array_equal(cv_host.jpeg_roundtrip(u, quality),
                              cv2.imdecode(enc, cv2.IMREAD_COLOR)), (h, w)
