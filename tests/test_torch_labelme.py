"""PyTorch port: the labelme → training-pair converter (``twinvoice_tpu_torch/data/
labelme.py``) and the pure helpers of ``data/synthetic.py`` against the JAX
package's.

Tolerance: none. ``fill_polygon`` and ``rasterize_labelme`` return JAX's
masks on random polygons (concave, self-crossing, degenerate, off the
frame); ``build_dataset_from_labelme`` on a directory of labelme JSON and
images writes the same ``.npy`` masks and the same JPEG bytes as JAX's (both
written by OpenCV from equal arrays: the port's resizes are
``ops.host_image``'s), and returns the same ``done`` and ``missing`` lists.
"""

import json
import os

import cv2
import numpy as np
import pytest

from twinvoice_tpu.data import labelme as jlabelme
from twinvoice_tpu.data import synthetic as jsynthetic
from twinvoice_tpu_torch.data import labelme as tlabelme
from twinvoice_tpu_torch.data import synthetic as tsynthetic


def _polygons(rng, n):
    for t in range(n):
        k = int(rng.integers(0, 9))
        h, w = (int(v) for v in rng.integers(1, 60, 2))
        pts = rng.uniform(-10, max(h, w) + 10, (k, 2))
        if t % 4 == 0:
            pts = np.round(pts)  # vertices on pixel edges and centres
        if t % 9 == 0 and k:
            pts[:, 1] = pts[0, 1]  # all edges horizontal
        yield pts.tolist(), h, w


def test_fill_polygon_equals_jax():
    for pts, h, w in _polygons(np.random.default_rng(0), 300):
        np.testing.assert_array_equal(tlabelme.fill_polygon(pts, h, w),
                                      jlabelme.fill_polygon(pts, h, w))


def test_rasterize_labelme_equals_jax():
    rng = np.random.default_rng(1)
    labels = ["invoice_no", "date", "total_amount", "other", None]
    for _ in range(40):
        h, w = (int(v) for v in rng.integers(8, 80, 2))
        shapes = [{"label": labels[int(rng.integers(0, 5))], "points": pts}
                  for pts, _, _ in _polygons(rng, int(rng.integers(0, 6)))]
        scale = tuple(float(v) for v in rng.uniform(0.3, 2.5, 2))
        np.testing.assert_array_equal(tlabelme.rasterize_labelme(shapes, (h, w), scale),
                                      jlabelme.rasterize_labelme(shapes, (h, w), scale))


def test_synthetic_helpers_equal_jax():
    for date in ("2025-09-09", "2011-01-31", "1912-12-01"):
        assert tsynthetic.iso_to_roc(date) == jsynthetic.iso_to_roc(date)
        assert (tsynthetic.header_qr_payload("AB12345678", date, 4580)
                == jsynthetic.header_qr_payload("AB12345678", date, 4580))
    items = [{"name": "紅茶", "qty": 2, "price": 30}, {"name": "синt", "qty": 1, "price": 5}]
    assert tsynthetic.items_qr_payload(items) == jsynthetic.items_qr_payload(items)
    boxes = {"invoice_no": (1, 2, 30, 40), "date": (5, 6, 7, 8)}
    assert tsynthetic.labelme_shapes(boxes) == jsynthetic.labelme_shapes(boxes)


@pytest.fixture(scope="module")
def labelme_dir(tmp_path_factory):
    """Labelme JSON and images: pages at odd sizes, JSON nominal sizes other
    than the image's, every image extension ``_find_image`` looks for, and one
    JSON without an image."""
    root = tmp_path_factory.mktemp("labelme")
    jd, imd = root / "json", root / "images"
    jd.mkdir()
    imd.mkdir()
    rng = np.random.default_rng(2)
    for i, (ext, (h, w)) in enumerate(zip((".jpg", ".png", ".jpeg", ".JPG"),
                                          ((211, 97), (640, 440), (300, 523), (64, 64)))):
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        img[h // 4:h // 2, w // 5:w // 2] = 240
        assert cv2.imwrite(str(imd / f"inv{i}{ext}"), img)
        nominal = (int(w * (1 + i / 2)), int(h * (1 + i / 3)))
        shapes = jsynthetic.labelme_shapes({"invoice_no": (3, 4, nominal[0] // 2, nominal[1] // 3),
                                            "date": (nominal[0] // 3, 9, nominal[0] - 2, 30)})
        shapes.append({"label": "total_amount",
                       "points": rng.uniform(0, min(nominal), (5, 2)).tolist()})
        with open(jd / f"inv{i}.json", "w", encoding="utf-8") as f:
            json.dump({"imageWidth": nominal[0], "imageHeight": nominal[1], "shapes": shapes}, f)
    with open(jd / "orphan.json", "w", encoding="utf-8") as f:
        json.dump({"imageWidth": 10, "imageHeight": 10, "shapes": []}, f)
    return root


def _build(pkg, root, out, size):
    logs = []
    done, missing = pkg.build_dataset_from_labelme(
        json_dir=str(root / "json"), images_dir=str(root / "images"),
        out_img_dir=str(out / "fixed_images"), out_mask_dir=str(out / "fixed_masks"),
        train_size=size, log=logs.append)
    return done, missing, logs


@pytest.mark.parametrize("size", [(512, 512), (97, 211), (128, 64)])
def test_build_dataset_equals_jax(labelme_dir, tmp_path, size):
    """Same lists and log lines; each ``.npy`` mask equal; each JPEG equal
    byte for byte."""
    jout, tout = tmp_path / "jax", tmp_path / "port"
    jres = _build(jlabelme, labelme_dir, jout, size)
    tres = _build(tlabelme, labelme_dir, tout, size)
    assert tres == jres
    done, missing, _ = tres
    assert done == ["inv0", "inv1", "inv2", "inv3"] and missing == ["orphan"]
    for base in done:
        jm = np.load(jout / "fixed_masks" / f"{base}.npy")
        tm = np.load(tout / "fixed_masks" / f"{base}.npy")
        assert tm.shape == (size[1], size[0], 3) and tm.dtype == np.uint8
        np.testing.assert_array_equal(tm, jm)
        assert (tout / "fixed_images" / f"{base}.jpg").read_bytes() == (
            jout / "fixed_images" / f"{base}.jpg").read_bytes()
    assert sorted(os.listdir(tout / "fixed_images")) == sorted(os.listdir(jout / "fixed_images"))


def test_build_one_raises_on_a_missing_image(tmp_path):
    (tmp_path / "a.json").write_text(json.dumps({"imageWidth": 4, "imageHeight": 4,
                                                 "shapes": []}))
    with pytest.raises(FileNotFoundError):
        tlabelme.build_one(str(tmp_path / "a.json"), str(tmp_path / "a.jpg"),
                           str(tmp_path / "i"), str(tmp_path / "m"))
