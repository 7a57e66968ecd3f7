"""The port's data layer of the test path against OpenCV and the JAX package,
on the CPU.

- PNG decoding (``image_io``) equals ``cv2.imread(path, IMREAD_COLOR)``
  exactly on files written by ``cv2.imwrite`` (adaptive filters and each
  filter alone) and by PIL, in gray, RGB and RGBA; the C++ unfilter equals
  its numpy twin; the port's encoder round-trips through OpenCV.
- ``resize_bilinear`` equals ``cv2.resize(INTER_LINEAR)`` bit for bit on a
  grid of sizes (up, down, exactly half, odd sizes, 1 to 4 channels).
- The test pipeline's sample (``img``, ``img_metas``) and the loader's
  batches equal the JAX package's exactly, key by key and in order, on the
  dataset of ``torch_data_cases.py``.
"""
import io
import os
import sys
import threading
import time

import cv2
import numpy as np
import pytest
from PIL import Image

import torch_data_cases as cases
from oadg_tpu_torch.config import DictAction, load_config
from oadg_tpu_torch.utils import host_kernels as native
from oadg_tpu_torch.data.pipelines import image_io
from oadg_tpu_torch.data.pipelines.transforms import resize_bilinear

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PNG_FILTERS = {"all": cv2.IMWRITE_PNG_ALL_FILTERS, "none": cv2.IMWRITE_PNG_FILTER_NONE,
               "sub": cv2.IMWRITE_PNG_FILTER_SUB, "up": cv2.IMWRITE_PNG_FILTER_UP,
               "avg": cv2.IMWRITE_PNG_FILTER_AVG, "paeth": cv2.IMWRITE_PNG_FILTER_PAETH}


def _image(channels, h=37, w=53, seed=0):
    img = cases.textured_image(np.random.RandomState(seed), h, w)
    if channels == 1:
        return img[..., 0].copy()
    if channels == 4:
        alpha = np.random.RandomState(seed + 1).randint(0, 256, (h, w, 1), np.uint8)
        return np.concatenate([img, alpha], -1)
    return img


def _pil_png(img):
    arr = img if img.ndim == 2 else img[..., [2, 1, 0, 3][:img.shape[2]]]
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(arr)).save(buf, "PNG")
    return buf.getvalue()


@pytest.mark.parametrize("writer", ["cv2-" + k for k in PNG_FILTERS] + ["pil"])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_decoder_equals_cv2_imread(tmp_path, writer, channels):
    img = _image(channels)
    path = str(tmp_path / "x.png")
    if writer == "pil":
        with open(path, "wb") as f:
            f.write(_pil_png(img))
    else:
        cv2.imwrite(path, img, [cv2.IMWRITE_PNG_FILTER, PNG_FILTERS[writer[4:]]])
    want = cv2.imread(path, cv2.IMREAD_COLOR)
    got = image_io.imread(path)
    assert got.dtype == np.uint8 and got.flags["C_CONTIGUOUS"]
    np.testing.assert_array_equal(got, want)
    with open(path, "rb") as f:
        data = f.read()
    np.testing.assert_array_equal(image_io.decode_png(data, native=False), want)


def test_every_png_filter_type_occurs_and_the_unfilters_agree():
    """Across the files the decoder test reads, rows of all five filter
    types occur; the C++ unfilter equals the numpy twin on each, and on
    random filter bytes with random filter types."""
    seen = np.zeros(5, int)
    for channels in (1, 3, 4):
        img = _image(channels)
        blobs = [cv2.imencode(".png", img, [cv2.IMWRITE_PNG_FILTER, f])[1].tobytes()
                 for f in PNG_FILTERS.values()] + [_pil_png(img)]
        for data in blobs:
            lines, h, w, c = image_io.png_scanlines(data)
            seen += np.bincount(lines[:, 0], minlength=5)
            np.testing.assert_array_equal(native.png_unfilter(lines, c),
                                          image_io.png_unfilter_numpy(lines, c))
    assert (seen > 0).all(), seen
    rng = np.random.RandomState(3)
    for bpp in (1, 3, 4):
        lines = rng.randint(0, 256, (23, 1 + 31 * bpp)).astype(np.uint8)
        lines[:, 0] = rng.randint(0, 5, 23)
        np.testing.assert_array_equal(native.png_unfilter(lines, bpp),
                                      image_io.png_unfilter_numpy(lines, bpp))


@pytest.mark.parametrize("filter_type", [0, 1])
@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_encoder_round_trips(tmp_path, channels, filter_type):
    img = _image(channels, seed=5)
    path = str(tmp_path / "y.png")
    image_io.imwrite(path, img, filter_type=filter_type)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), img)
    np.testing.assert_array_equal(image_io.imread(path), cv2.imread(path, cv2.IMREAD_COLOR))


def test_png_decoder_refuses_what_it_does_not_decode(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.arange(64, dtype=np.uint8).reshape(8, 8)).convert("P").save(buf, "PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        image_io.decode_png(buf.getvalue())
    wide = cv2.imencode(".png", np.arange(64, dtype=np.uint16).reshape(8, 8) * 999)[1]
    with pytest.raises(ValueError, match="bit depth 16"):
        image_io.decode_png(wide.tobytes())
    data = bytearray(image_io.encode_png(_image(3)))
    data[40] ^= 0xFF                                     # inside the IDAT chunk
    with pytest.raises(ValueError, match="CRC"):
        image_io.decode_png(bytes(data))
    lines = np.zeros((3, 7), np.uint8)
    lines[1, 0] = 5
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        native.png_unfilter(lines, 3)
    with pytest.raises(ValueError, match="row 1 has filter type 5"):
        image_io.png_unfilter_numpy(lines, 3)
    with pytest.raises(FileNotFoundError):
        image_io.imread(str(tmp_path / "missing.png"))


def test_jpeg_goes_to_cv2_and_raises_without_it(tmp_path, monkeypatch):
    """A JPEG no longer goes to cv2: the port decodes it itself, equal to
    ``cv2.imread`` with or without cv2 importable; a file that is neither
    PNG nor JPEG raises, naming it."""
    img = _image(3)
    path = str(tmp_path / "frame.jpg")
    cv2.imwrite(path, img)
    want = cv2.imread(path)
    np.testing.assert_array_equal(image_io.imread(path), want)
    monkeypatch.setitem(sys.modules, "cv2", None)       # import cv2 raises ImportError
    np.testing.assert_array_equal(image_io.imread(path), want)
    other = tmp_path / "frame.bmp"
    other.write_bytes(b"BM" + bytes(60))
    with pytest.raises(ValueError, match="frame.bmp"):
        image_io.imread(str(other))


RESIZE_GRID = [
    ((120, 200), (160, 96), 3), ((100, 150), (144, 96), 3),   # the test scale's
    ((96, 160), (160, 96), 3),                                 # same size: a copy
    ((64, 64), (32, 32), 3), ((64, 66), (33, 32), 1),          # exactly half
    ((65, 63), (31, 32), 3), ((50, 70), (140, 100), 3),        # odd, up
    ((37, 53), (29, 61), 1), ((17, 300), (11, 40), 2), ((1, 1), (7, 5), 3),
    ((5, 1), (9, 1), 1), ((300, 17), (34, 600), 4), ((256, 512), (600, 300), 3),
    ((1024, 2048), (1600, 800), 3), ((1024, 2048), (2048, 1024), 3),
]


@pytest.mark.parametrize("src,size,channels", RESIZE_GRID,
                         ids=[f"{s[0]}x{s[1]}-to-{d[1]}x{d[0]}-c{c}" for s, d, c in RESIZE_GRID])
def test_resize_equals_cv2_bit_for_bit(src, size, channels):
    rng = np.random.RandomState(src[0] * 7 + size[0])
    img = rng.randint(0, 256, src + ((channels,) if channels > 1 else ()), np.uint8)
    want = cv2.resize(img, size, interpolation=cv2.INTER_LINEAR)
    got = resize_bilinear(img, size)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_resize_equals_cv2_on_random_sizes():
    rng = np.random.RandomState(11)
    for _ in range(60):
        sh, sw, dh, dw = (int(v) for v in rng.randint(1, 140, 4))
        c = int(rng.randint(1, 5))
        img = rng.randint(0, 256, (sh, sw, c), np.uint8)
        np.testing.assert_array_equal(
            resize_bilinear(img, (dw, dh)),
            cv2.resize(img, (dw, dh), interpolation=cv2.INTER_LINEAR),
            err_msg=f"{sh}x{sw}x{c} -> {dh}x{dw}")


def test_cfg_options_merge_as_the_jax_config(tmp_path):
    import argparse

    from oadg_tpu.config import Config, DictAction as JaxDictAction
    argv = ["model.backbone.depth=18", "data.workers_per_gpu=4",
            "evaluation.metric=bbox,mAP", "x.flag=true", "data.test.img_prefix=/x/"]
    options = []
    for action in (DictAction, JaxDictAction):
        p = argparse.ArgumentParser()
        p.add_argument("--cfg-options", nargs="+", action=action)
        options.append(p.parse_args(["--cfg-options", *argv]).cfg_options)
    assert options[0] == options[1]
    want = Config.fromfile(os.path.join(ROOT, cases.FLAGSHIP), import_custom_modules=False)
    want.merge_from_dict(options[1])
    got = load_config(os.path.join(ROOT, cases.FLAGSHIP))
    got.merge_from_dict(options[0])
    assert got.evaluation.metric == ("bbox", "mAP") and got.x.flag is True
    cases.assert_equal_nested(_plain(got), want.to_dict())


def test_cfg_options_index_lists_as_mmcv_does():
    """A digit key indexes a list (mmcv's ``_merge_a_into_b``). The JAX
    package's ``merge_dict`` replaces the list with a dict of the override
    instead (a reference-side fault, recorded in ROADMAP C)."""
    from oadg_tpu.config import Config
    option = {"data.test.pipeline.1.img_scale": (160, 96)}
    got = load_config(os.path.join(ROOT, cases.FLAGSHIP))
    before = _plain(got.data.test.pipeline)
    got.merge_from_dict(option)
    after = _plain(got.data.test.pipeline)
    assert after[1].pop("img_scale") == (160, 96) and before[1].pop("img_scale") == (2048, 1024)
    assert after == before
    with pytest.raises(KeyError, match="index 7"):
        got.merge_from_dict({"data.test.pipeline.7.type": "Pad"})
    ref = Config.fromfile(os.path.join(ROOT, cases.FLAGSHIP), import_custom_modules=False)
    ref.merge_from_dict(option)
    assert ref.to_dict()["data"]["test"]["pipeline"] == {"1": {"img_scale": (160, 96)}}


def _plain(o):
    if isinstance(o, dict):
        return {k: _plain(v) for k, v in o.items()}
    if isinstance(o, (list, tuple)):
        return type(o)(_plain(v) for v in o)
    return o


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """(port dataset, JAX dataset, port cfg, JAX cfg) on the 4-image set."""
    from oadg_tpu.config import Config
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.data import build_dataset
    ann_file, img_prefix = cases.write_dataset(str(tmp_path_factory.mktemp("city")))
    options = cases.cfg_options(ann_file, img_prefix)
    cfg = load_config(os.path.join(ROOT, cases.FLAGSHIP))
    cfg.merge_from_dict(options)
    jcfg = Config.fromfile(os.path.join(ROOT, cases.FLAGSHIP), import_custom_modules=False)
    jcfg.merge_from_dict({"data.test": _plain(cfg.data.test)})
    test = dict(cfg.data.test, test_mode=True)
    return (build_dataset(test), jax_build_dataset(dict(jcfg.data.test, test_mode=True)),
            cfg, jcfg)


def test_test_pipeline_sample_equals_jax(datasets):
    ds, jds, _, _ = datasets
    assert len(ds) == len(jds) == 4
    for i in range(4):
        got, want = ds[i], jds[i]
        cases.assert_equal_nested(got, want)
    shapes = [ds[i]["img"].shape for i in range(4)]
    assert shapes == [(96, 160, 3), (96, 160, 3), (96, 160, 3), (96, 160, 3)]
    factors = [float(ds[i]["img_metas"]["scale_factor"][0]) for i in range(4)]
    assert factors == [np.float32(0.8), 1.0, 1.0, np.float32(0.96)]


def test_annotations_and_filters_equal_jax(datasets):
    """``get_ann_info`` (crowd boxes to ``bboxes_ignore``; ignored, tiny and
    foreign-class boxes dropped) and the training-mode image filter."""
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.data import build_dataset
    ds, jds, cfg, jcfg = datasets
    for i in range(4):
        got = ds.get_ann_info(i)
        masks = got.pop("masks")     # the port keeps each box's segmentation; JAX drops it
        cases.assert_equal_nested(got, jds.get_ann_info(i))
        assert len(masks) == len(got["bboxes"])
    assert sum(len(ds.get_ann_info(i)["bboxes_ignore"]) for i in range(4)) == 4
    train = [dict(c.data.test, filter_empty_gt=True, pipeline=[]) for c in (cfg, jcfg)]
    port, jax_ds = build_dataset(train[0]), jax_build_dataset(train[1])
    assert [d["id"] for d in port.data_infos] == [d["id"] for d in jax_ds.data_infos]
    np.testing.assert_array_equal(port.flag, jax_ds.flag)


def test_repeat_and_concat_datasets_equal_jax(datasets):
    """``RepeatDataset`` and ``ConcatDataset`` built from configs: lengths,
    group flags and samples across the seams."""
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.data import build_dataset
    _, _, cfg, _ = datasets
    train = dict(_plain(cfg.data.test), filter_empty_gt=False)
    for wrapper in (dict(type="RepeatDataset", times=3, dataset=train),
                    dict(type="ConcatDataset", datasets=[train, dict(train)])):
        got, want = build_dataset(wrapper), jax_build_dataset(wrapper)
        assert len(got) == len(want) == (12 if wrapper["type"] == "RepeatDataset" else 8)
        np.testing.assert_array_equal(got.flag, want.flag)
        assert got.CLASSES == want.CLASSES
        for i in (0, 3, 4, 7):
            cases.assert_equal_nested(got[i], want[i])


def _jax_loader(jds, **kw):
    from oadg_tpu.data import build_dataloader
    return build_dataloader(jds, rank=0, world_size=1, **kw)


@pytest.mark.parametrize("workers", [1, 3])
def test_test_loader_batches_equal_jax(datasets, workers):
    from oadg_tpu_torch.apis import build_test_loader
    from oadg_tpu_torch.data import build_dataloader
    ds, jds, cfg, _ = datasets
    want = list(_jax_loader(jds, samples_per_gpu=1, workers_per_gpu=workers,
                            shuffle=False, static_hw=(96, 160)))
    got = list(build_dataloader(ds, 1, workers_per_gpu=workers, shuffle=False,
                                static_hw=(96, 160)))
    cases.assert_equal_nested(got, want)
    _, loader = build_test_loader(cfg)
    assert loader.batcher.static_hw == (96, 160)
    assert loader.num_workers == cfg.data.workers_per_gpu == 4
    cases.assert_equal_nested(list(loader), want)
    two = list(build_dataloader(ds, 2, workers_per_gpu=workers, shuffle=False))
    cases.assert_equal_nested(two, list(_jax_loader(jds, samples_per_gpu=2,
                                                    workers_per_gpu=workers,
                                                    shuffle=False)))


def test_shuffled_training_batches_with_boxes_equal_jax(datasets):
    """A training-mode dataset (aspect-ratio groups, ground truth padded to
    ``max_gt``), shuffled from one seed, two images a batch."""
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.data import build_dataloader, build_dataset
    _, _, cfg, _ = datasets
    pipeline = [dict(type="LoadImageFromFile"), dict(type="LoadAnnotations", with_bbox=True),
                dict(type="Resize", img_scale=cases.TEST_SCALE, keep_ratio=True),
                dict(type="RandomFlip"), dict(type="Normalize", **cfg.img_norm_cfg),
                dict(type="Pad", size_divisor=32), dict(type="DefaultFormatBundle"),
                dict(type="Collect", keys=["img", "gt_bboxes", "gt_labels"])]
    train = dict(cfg.data.test, pipeline=pipeline, filter_empty_gt=False)
    ds, jds = build_dataset(train), jax_build_dataset(_plain(train))
    for seed in (0, 3):
        want = list(_jax_loader(jds, samples_per_gpu=2, workers_per_gpu=2,
                                shuffle=True, seed=seed, max_gt=6))
        got = list(build_dataloader(ds, 2, workers_per_gpu=2, shuffle=True, seed=seed,
                                    max_gt=6))
        assert len(got) == 2 and got[0]["gt_valid"].sum() > 0
        cases.assert_equal_nested(got, want)


def test_loader_keeps_batch_order_with_slow_workers():
    """``tests/test_data.py:146`` on the port's loader: batches come out in
    dataset order whatever order the workers finish them in."""
    from oadg_tpu_torch.data import PrefetchLoader

    class SlowDataset:
        flag = np.zeros(16, np.uint8)

        def __len__(self):
            return 16

        def __getitem__(self, i):
            time.sleep(0.05 if i % 4 == 0 else 0.0)
            return {"idx": np.array([i])}

    loader = PrefetchLoader(SlowDataset(), samples_per_gpu=2, num_workers=4,
                            shuffle=False)
    loader.batcher = lambda samples: {"idx": np.concatenate([s["idx"] for s in samples])}
    for _ in range(3):
        seen = np.concatenate([b["idx"] for b in loader])
        np.testing.assert_array_equal(seen, np.arange(16))


def test_loader_raises_a_worker_failure_and_stops_its_threads():
    from oadg_tpu_torch.data import PrefetchLoader

    class Broken:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise OSError("unreadable image 5")
            return {"idx": np.array([i])}

    before = set(threading.enumerate())
    loader = PrefetchLoader(Broken(), samples_per_gpu=1, num_workers=3, shuffle=False)
    loader.batcher = lambda samples: samples[0]
    seen = []
    with pytest.raises(OSError, match="unreadable image 5"):
        for b in loader:
            seen.append(int(b["idx"][0]))
    assert seen == [0, 1, 2, 3, 4]
    deadline = time.time() + 5
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.01)
    assert not set(threading.enumerate()) - before


def test_multi_view_test_time_augmentation_is_refused(datasets):
    """A ``MultiScaleFlipAug`` with two scales and ``flip=True``: the
    port's loader collates each sample's four views as the JAX package's
    ``StaticBatcher`` does (``__tta_views__`` batch by batch bit for bit,
    ``__tta_metas__``, the first view's ``metas``), on the test loader's
    static canvas and without one."""
    from oadg_tpu.config import Config
    from oadg_tpu.data import build_dataloader as jax_build_dataloader
    from oadg_tpu.data import build_dataset as jax_build_dataset
    from oadg_tpu_torch.data import build_dataloader, build_dataset
    ds, _, cfg, _ = datasets
    test = dict(cfg.data.test, test_mode=True)
    test["pipeline"] = [dict(p) for p in test["pipeline"]]
    test["pipeline"][1]["flip"] = True
    test["pipeline"][1]["img_scale"] = [(160, 96), (128, 80)]
    tta = build_dataset(test)
    assert tta[0]["__tta__"]
    jcfg = Config.fromfile(os.path.join(ROOT, cases.FLAGSHIP), import_custom_modules=False)
    jcfg.merge_from_dict({"data.test": test})
    jtta = jax_build_dataset(dict(jcfg.data.test))
    for static in ((96, 160), None):
        got = list(build_dataloader(tta, 2, shuffle=False, static_hw=static))
        want = list(jax_build_dataloader(jtta, 2, shuffle=False, static_hw=static))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            assert g["__tta_metas__"] == w["__tta_metas__"] == (
                (False, "horizontal"), (True, "horizontal")) * 2
            assert len(g["metas"]) == 2 and not g["metas"][0]["flip"]
            assert [m["filename"] for m in g["metas"]] == [m["filename"] for m in w["metas"]]
            for gv, wv in zip(g["__tta_views__"], w["__tta_views__"]):
                assert sorted(gv) == sorted(wv)
                for k in ("img", "img_shape", "scale_factor"):
                    assert gv[k].dtype == wv[k].dtype
                    np.testing.assert_array_equal(gv[k], wv[k], err_msg=k)


def test_pinned_canvas_holds_the_same_batch(datasets, monkeypatch):
    """With ``pin_memory`` the image stack comes from ``torch.empty(...,
    pin_memory=True)``; the batch is the same. (Pinning needs a card, so on
    the CPU the allocation is observed, not made.)"""
    import torch

    from oadg_tpu_torch.data import build_dataloader
    ds, _, _, _ = datasets
    calls = []
    real_empty = torch.empty

    def empty(*shape, pin_memory=False, **kw):
        calls.append(pin_memory)
        return real_empty(*shape, **kw)

    monkeypatch.setattr(torch, "empty", empty)
    got = list(build_dataloader(ds, 1, shuffle=False, static_hw=(96, 160),
                                pin_memory=True))
    assert calls == [True] * 4
    monkeypatch.undo()
    want = list(build_dataloader(ds, 1, shuffle=False, static_hw=(96, 160)))
    cases.assert_equal_nested(got, want)
