"""PyTorch port: what the card's machine lacks is never imported (the
recognition stack, bulk extraction, training, the QR locator, the CLI, the
training renderers and the invoice renderer run end to end without it; the
renderers load neither FreeType nor HarfBuzz; an Orbax checkpoint is read
without orbax, TensorStore or zstandard),
and the kernel build finds nvcc, hashes its sources and reports failures."""

import os
import stat
import subprocess
import sys

import pytest

from twinvoice_tpu_torch import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# what the card's machine lacks: JAX and the JAX package, the imaging
# libraries, the app's and the network engines' libraries, and Orbax's
# storage stack
BLOCKED = ("jax", "jaxlib", "twinvoice_tpu", "PIL", "cv2", "pandas", "plotly", "streamlit",
           "requests", "supabase", "easyocr", "orbax", "tensorstore", "zstandard")

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
for name in {BLOCKED!r}:
    sys.modules[name] = None  # any import of it now raises ImportError
import twinvoice_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(twinvoice_tpu_torch.__path__,
                                              "twinvoice_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
from twinvoice_tpu_torch.ops.nhwc_conv import (pad_nhwc, qconv3x3_nhwc_dma,
    qconv3x3_nhwc_requant, qconv3x3_pair_dma)
from twinvoice_tpu_torch.ops.qconv import qconv3x3_requant_dma
from twinvoice_tpu_torch.ocr.torchocr import TorchOcrEngine
from twinvoice_tpu_torch.ocr.torchocr.detector import detect_lines, read_page
from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
from twinvoice_tpu_torch.qr.detect import QrPipeline
from twinvoice_tpu_torch.data.dataset import ArrayDataset, load_invoice_dataset, synthetic_dataset
from twinvoice_tpu_torch.data.labelme import build_dataset_from_labelme, build_one
from twinvoice_tpu_torch.train import checkpoint, losses, metrics, schedule, visualize
from twinvoice_tpu_torch.train.trainer import fit, make_train_step
from twinvoice_tpu_torch.ocr.fonts import (coverage, draw_text, glyph_strokes, has_glyph,
    render_char, render_text)
from twinvoice_tpu_torch.ocr.fonts.latin_glyphs import GLYPHS, LatinStyle, sample_style
from twinvoice_tpu_torch.qr.locate import locate_qr_boxes, locate_qr_quads, set_rng_seed
from twinvoice_tpu_torch.ocr.torchocr.charset import cjk_charset
from twinvoice_tpu_torch.ocr.torchocr.data import encode_labels, random_field_text
from twinvoice_tpu_torch.ocr.torchocr.lm import CharNgramLM
from twinvoice_tpu_torch.ocr.torchocr.model import crnn_params_to_jax, init_crnn
from twinvoice_tpu_torch.ocr.torchocr.train import ctc_loss, save_weights, train
from twinvoice_tpu_torch.ocr.torchocr.textness import init_textness, save_textness
from twinvoice_tpu_torch.core.collectives import copy_to, gather_from, sum_over
from twinvoice_tpu_torch.core.mesh import make_mesh, param_shardings, shard_batch
from twinvoice_tpu_torch.core.precision import Policy
from twinvoice_tpu_torch.parallel import conv3x3_spatial, halo_exchange_h, spatial_shard_apply
from twinvoice_tpu_torch.parallel.pipeline import pipeline_apply, stack_stage_params
from twinvoice_tpu_torch.parallel.spatial import spatial_unet_forward
from twinvoice_tpu_torch.train.trainer import gather_train_state, shard_train_state
from twinvoice_tpu_torch.infer import Segmenter, masks_and_boxes
from twinvoice_tpu_torch.port import load_pth, port_state_dict, export_state_dict
from twinvoice_tpu_torch.eval import run_segmenter_gauntlet, run_e2e_gauntlet
from twinvoice_tpu_torch.eval import perturb_cases
from twinvoice_tpu_torch.data.augment import (AugmentedDataset, PerturbSpec, apply_spec,
    boxes_from_mask, perturb, sample_spec)
from twinvoice_tpu_torch.ops.host_warp import (get_perspective_transform, invert_3x3,
    rotation_matrix_2d, warp_affine_f32, warp_perspective_u8)
from twinvoice_tpu_torch.ops.host_filter import (filter2d_f32, gaussian_blur_f32,
    gaussian_blur_u8, resize_cubic_f32)
from twinvoice_tpu_torch.ops.host_draw import fill_rect_u8, line_u8
from twinvoice_tpu_torch.ops.host_jpeg import decode_jpeg, encode_jpeg, jpeg_roundtrip_u8
from twinvoice_tpu_torch.ops.host_png import decode_png
from twinvoice_tpu_torch.ops.host_imageio import (apply_orientation, build_codec, codec,
    exif_orientation, imread_rgb, imwrite_jpeg)
from twinvoice_tpu_torch.ocr import OcrEngine, FakeOcrEngine
from twinvoice_tpu_torch.compat import load_model, preprocess, run_unet
from twinvoice_tpu_torch.ops import resize_nearest, conv3x3
from twinvoice_tpu_torch.models import UNetConfig, init_unet
from twinvoice_tpu_torch.utils import StageTimer, trace_span
from twinvoice_tpu_torch.train import invoice_loss
from twinvoice_tpu_torch.train.checkpoint import restore_params, save_params
from twinvoice_tpu_torch.data import ArrayDataset
from twinvoice_tpu_torch.core import Policy, make_mesh
from twinvoice_tpu_torch.models.pretrained import SEGMENTER_SYNTH_CFG, SEGMENTER_SYNTH_W16
from twinvoice_tpu_torch.store import InvoiceStore, MemoryStore
from twinvoice_tpu_torch.store.supabase_store import SupabaseStore
from twinvoice_tpu_torch.app import prepare_frames, monthly_totals, category_totals, year_summary
from twinvoice_tpu_torch.app.main import capture_tab, dashboard_tab, main
from twinvoice_tpu_torch.app.camera_component import camera, data_url_to_image, declare
from twinvoice_tpu_torch.ocr import enhance_for_ocr, grayscale_for_ocr
from twinvoice_tpu_torch.ocr.ocrspace import OcrSpaceEngine
from twinvoice_tpu_torch.ocr.easyocr_engine import EasyOcrEngine
from twinvoice_tpu_torch.ocr.fonts.truetype import FreeTypeFont
from twinvoice_tpu_torch.ops.host_pildraw import Draw, Image
from twinvoice_tpu_torch.ocr.torchocr.data import dot_matrix, make_batch, make_lines, render_line
from twinvoice_tpu_torch.ocr.torchocr.textness import render_textpage
from twinvoice_tpu_torch.data.synthetic import train_fonts
from twinvoice_tpu_torch.ops.host_image import dilate2x2, resize_area_f32, resize_linear_f32
from twinvoice_tpu_torch.ops.host_warp import remap_linear_f32, warp_affine_u8
from twinvoice_tpu_torch.ops.host_filter import resize_cubic_f32, soft_exp
from twinvoice_tpu_torch.data.synthetic import heldout_fonts, render_invoice
from twinvoice_tpu_torch.eval import make_base_cases
from twinvoice_tpu_torch.train import ocdbt, orbax
from twinvoice_tpu_torch.train.checkpoint import optimizer_state_from_optax, restore
from twinvoice_tpu_torch.ops.host_zstd import decompress
from twinvoice_tpu_torch.ops.host_filter import dft_filter2d
assert orbax.read("tests/data/torch_smoke_orbax/w8_state")["meta"]["epoch"] == 2
import runpy
runpy.run_path("scripts/eval_torch_gauntlet.py", run_name="not_main")
import chip_smoke
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print(len(mods))
"""


def test_port_and_chip_smoke_import_without_jax_pil_cv2():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 85  # every module was imported


_RENDER_WITHOUT_PIL = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
from twinvoice_tpu_torch.data.synthetic import train_fonts
from twinvoice_tpu_torch.ocr.fonts.truetype import FreeTypeFont
from twinvoice_tpu_torch.ocr.torchocr.charset import cjk_charset
from twinvoice_tpu_torch.ocr.torchocr.data import make_batch
from twinvoice_tpu_torch.ocr.torchocr.textness import make_batch as page_batch
fonts = train_fonts()
assert len(fonts) >= 13, fonts
for path in fonts:
    mask, _ = FreeTypeFont(path, 17).getmask2("AB-12/3")
    assert mask.max() > 0, path
from twinvoice_tpu_torch.ocr.fonts import strokefont
assert strokefont.render_text("Total: NT$1,250 統一").min() < 128  # Pillow's default font
rng = np.random.default_rng(0)
make_batch(4, rng, cjk_charset(), dot_frac=0.5, synth_frac=0.3, mixed_frac=0.3)
page_batch(1, rng)
with open("/proc/self/maps") as f:
    maps = f.read()
assert "libfreetype" not in maps and "libharfbuzz" not in maps
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("rendered")
"""


def test_renderers_run_without_pil_freetype_cv2():
    """Every training font, Pillow's default font (the stroke font's ASCII),
    the recognizer's lines (CJK, dot, synthetic typefaces) and a textness
    page render with JAX, the JAX package, Pillow and OpenCV blocked, and
    neither FreeType nor HarfBuzz loaded, as on the card's machine."""
    out = subprocess.run([sys.executable, "-c", _RENDER_WITHOUT_PIL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "rendered"


_INVOICE_WITHOUT_PIL = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
from twinvoice_tpu_torch.data.synthetic import heldout_fonts, render_invoice
from twinvoice_tpu_torch.eval import make_base_cases, perturb_cases
fonts = heldout_fonts()
assert len(fonts) >= 6, fonts
for i, path in enumerate(fonts):
    img, boxes = render_invoice(font_path=path, font_size=18 + i, seed=i, stylize=0.5)
    assert img.array.shape == (640, 440, 3) and len(boxes) == 3, path
img, _ = render_invoice(dot_print=True)
for kw in ({{}}, {{"use_heldout_fonts": True}}, {{"dot_print": True}}):
    (case,) = make_base_cases(1, **kw)
    assert case.mask.any()
perturb_cases([case], "crumple", seed=7)
with open("/proc/self/maps") as f:
    maps = f.read()
assert "libfreetype" not in maps and "libharfbuzz" not in maps
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("invoices")
"""


def test_invoices_render_without_pil_freetype_cv2():
    """Invoices on every held-out face, stylised and dot-matrix, and the
    gauntlet's three base sets render, and a tier perturbs, with JAX, the
    JAX package, Pillow and OpenCV blocked and neither FreeType nor HarfBuzz
    loaded, as on the card's machine."""
    out = subprocess.run([sys.executable, "-c", _INVOICE_WITHOUT_PIL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "invoices"


_READ_WITHOUT_CV2 = f"""
import sys
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
from twinvoice_tpu_torch.ocr.torchocr.detector import detect_lines, read_page
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
rng = np.random.default_rng(0)
page = np.full((200, 300), 235, np.uint8)
for y in (20, 90, 150):  # three dark "text lines" of blobs
    for x in range(20, 260, 14):
        page[y:y + 14, x:x + 9] = rng.integers(0, 60)
eng = TorchOcrEngine(device="cpu")
assert eng.available()
rgb = np.repeat(page[..., None], 3, axis=-1)
for mode in ("text", "amount", "invoice", "date"):
    for decode in ("greedy", "beam_lm", "cascade"):
        eng.decode = decode
        out = eng.read_batch([page, rgb, page[10:40]], modes=[mode] * 3)
        assert len(out) == 3
for method in ("classical", "learned", "hybrid"):
    assert len(detect_lines(page, method=method, device="cpu")) >= 2
read_page(rgb, eng)
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("read")
"""


def test_recognition_stack_runs_without_jax_pil_cv2():
    """Every host step of the engine and the detector (split, prepare, the
    amount variants, the rescue variants, the three decoders, all map
    methods) runs with JAX, the JAX package, Pillow and OpenCV blocked, as on
    the card's machine."""
    out = subprocess.run([sys.executable, "-c", _READ_WITHOUT_CV2], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "read"


_EXTRACT_WITHOUT_CV2 = f"""
import sys, warnings
for name in {BLOCKED!r}:
    sys.modules[name] = None
import torch
import chip_smoke
from twinvoice_tpu_torch.config import FusionConfig
from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
from twinvoice_tpu_torch.models.pretrained import load_pretrained_segmenter
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
from twinvoice_tpu_torch.qr.detect import QrPipeline, passes
fix = chip_smoke.fusion_fixture()
seg = load_pretrained_segmenter(torch.float32, device="cpu")
ex = InvoiceExtractor(seg, QrPipeline(), [TorchOcrEngine(device="cpu")], cfg=FusionConfig())
with warnings.catch_warnings():
    warnings.simplefilter("error")  # no OpenCV step was needed, so none skipped
    out = ex.extract_batch(list(fix["pages"]))
assert [chip_smoke.fusion_record(*r) for r in out] == fix["jax_batch"]
assert dict(passes) == {{"gray_0.75": len(out)}}, dict(passes)
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("extracted")
"""


def test_extract_batch_runs_without_jax_pil_cv2():
    """The bulk extraction route end to end (the QR library's build and
    scan, the segmenter's numpy prep, the crops, the recognizer, the merge)
    with JAX, the JAX package, Pillow and OpenCV blocked, as on the card's
    machine, giving the JAX extractor's fields on the fixture pages."""
    out = subprocess.run([sys.executable, "-c", _EXTRACT_WITHOUT_CV2], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "extracted"


_FIT_WITHOUT_CV2 = f"""
import os, sys, tempfile
for name in {BLOCKED!r}:
    sys.modules[name] = None
from twinvoice_tpu_torch.config import Config, TrainConfig, UNetConfig
from twinvoice_tpu_torch.data.dataset import synthetic_dataset
from twinvoice_tpu_torch.train import checkpoint
from twinvoice_tpu_torch.train.trainer import fit
d = tempfile.mkdtemp()
cfg = Config(model=UNetConfig(base_width=4), train=TrainConfig(
    epochs=2, checkpoint_dir=os.path.join(d, "c"), visualize_dir=os.path.join(d, "v"),
    val_fraction=0.25))
state, history = fit(synthetic_dataset(n=8, size=32), cfg, device="cpu", log=lambda m: None)
checkpoint.save_params_npz(os.path.join(d, "w.npz"), state.params, state.bn_state)
checkpoint.load_params_npz(os.path.join(d, "w.npz"))
assert len(os.listdir(os.path.join(d, "v"))) == 6, os.listdir(os.path.join(d, "v"))
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("trained")
"""


def test_fit_runs_without_jax_pil_cv2():
    """Training end to end (the split, the steps with prefetch, the visual
    dumps' PNGs, the checkpoints, the npz weights both ways) with JAX, the
    JAX package, Pillow and OpenCV blocked, as on the card's machine."""
    out = subprocess.run([sys.executable, "-c", _FIT_WITHOUT_CV2], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "trained"


_OCR_TRAIN_WITHOUT_CV2 = f"""
import os, sys, tempfile
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
import torch
torch.set_num_threads(1)  # small ops: no thread pool to oversubscribe the cores
from twinvoice_tpu_torch.ocr.torchocr import textness, train
from twinvoice_tpu_torch.ocr.torchocr.charset import DEFAULT, cjk_charset
from twinvoice_tpu_torch.ocr.torchocr.data import encode_labels, random_field_text
from twinvoice_tpu_torch.ocr.torchocr.engine import TorchOcrEngine
from twinvoice_tpu_torch.ocr.torchocr.lm import CharNgramLM
from twinvoice_tpu_torch.ocr.torchocr.model import init_crnn
d = tempfile.mkdtemp()
rng = np.random.default_rng(0)
assert cjk_charset().num_classes == 420
CharNgramLM.build(cjk_charset(), n_samples=200).save(os.path.join(d, "lm.json.gz"))
p, s = init_crnn(torch.Generator().manual_seed(0), num_classes=DEFAULT.num_classes,
                 channels=(8, 16, 16, 16), context=32)
train.save_weights(os.path.join(d, "start.npz"), p, s, DEFAULT, arch="t32")
labels, pad, texts = encode_labels([random_field_text(rng) for _ in range(16)])
lines = rng.integers(0, 256, (16, 32, 256), dtype=np.uint8)
train.train(os.path.join(d, "w.npz"), steps=101, batch_size=8, batches=(lines, labels, pad),
            eval_batches=[(lines, texts)], arch="t32", resume_from=os.path.join(d, "start.npz"),
            device="cpu", log=lambda m: None)
eng = TorchOcrEngine(weights_dir=os.path.join(d, "w.npz"), device="cpu")
assert eng.available() and eng.arch == "t32"
eng.read_batch([lines[0]], modes=["text"])
pages = rng.integers(200, 256, (4, 64, 64), dtype=np.uint8)
masks = np.zeros((4, 64, 64), np.uint8)
masks[:, 8:20, 4:60] = 255
textness.train(steps=2, bs=4, pages=pages, masks=masks, device="cpu",
               out_path=os.path.join(d, "t.npz"), log=lambda m: None)
assert textness.load_textness(os.path.join(d, "t.npz")) is not None
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("trained")
"""


def test_ocr_training_runs_without_jax_pil_cv2():
    """The recognizer's and the textness head's training end to end (the CJK
    charset, an LM build and save, ``train`` from a saved file, its weights
    read by the engine, ``textness.train`` and its file) with JAX, the JAX
    package, Pillow and OpenCV blocked, as on the card's machine."""
    out = subprocess.run([sys.executable, "-c", _OCR_TRAIN_WITHOUT_CV2], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "trained"


_GAUNTLET_WITHOUT_PIL = f"""
import os, sys, tempfile
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
import torch
import chip_smoke
from twinvoice_tpu_torch import compat
from twinvoice_tpu_torch.config import FusionConfig
from twinvoice_tpu_torch.eval import run_e2e_gauntlet, run_segmenter_gauntlet
from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
from twinvoice_tpu_torch.models.pretrained import variant_path
from twinvoice_tpu_torch.ocr import FakeOcrEngine
from twinvoice_tpu_torch.port import export_state_dict
from twinvoice_tpu_torch.weights import load_npz
fix = chip_smoke.gauntlet_fixture()
seg = chip_smoke.gauntlet_segmenter("w16_fp32", fix, device="cpu")
res = run_segmenter_gauntlet(seg, fix["cases"][:2])
assert res["iou"] == fix["w16_fp32_iou"][:2].mean(0).tolist(), res
ex = InvoiceExtractor(seg, None, [FakeOcrEngine(lambda im, mode: "2029-06-02")],
                      cfg=FusionConfig(use_qr=False, auto_rotate=False))
assert run_e2e_gauntlet(ex, fix["cases"][:1])["date_acc"] == 1.0
d = tempfile.mkdtemp()
sd = export_state_dict(*load_npz(variant_path("w16")))
torch.save({{k: torch.from_numpy(v) for k, v in sd.items()}}, os.path.join(d, "w16.pth"))
compat.UNetConfig = lambda: chip_smoke.VARIANTS["w16"][1]
m = compat.load_model(os.path.join(d, "w16.pth"), device="cpu")
assert m is compat.load_model(os.path.join(d, "w16.pth"), device="cpu")
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("scored")
"""


def test_gauntlet_and_serving_edges_run_without_jax_pil_cv2():
    """The gauntlet's case file, its segmenter and e2e scoring, a ``.pth``
    export and ``compat.load_model`` run with JAX, the JAX package, Pillow
    and OpenCV blocked, as on the card's machine (``compat.run_unet`` and
    ``preprocess`` need Pillow only to be handed a PIL image)."""
    out = subprocess.run([sys.executable, "-c", _GAUNTLET_WITHOUT_PIL], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "scored"


_QR_CLI_WITHOUT_CV2 = f"""
import sys, warnings
for name in {BLOCKED!r}:
    sys.modules[name] = None
import numpy as np
import chip_smoke
from twinvoice_tpu_torch import __main__ as cli
from twinvoice_tpu_torch.fusion.extract import auto_rotate_by_qr
from twinvoice_tpu_torch.qr import detect, locate
fix = chip_smoke.qr_fixture()
i = fix["names"].index("s0_x0.45")
detect.passes.clear()
locate.set_rng_seed(0)
with warnings.catch_warnings():
    warnings.simplefilter("error")  # the decoders skip nothing
    got = detect.QrPipeline().scan(fix["pages"][i])
assert got == fix["jax_native"][i] and len(got) == 1, got
assert detect.passes["regions"] == 1 and detect.passes["enhanced"] == 1, dict(detect.passes)
j = fix["names"].index("s0_rot90")
page = fix["pages"][j]
assert np.array_equal(auto_rotate_by_qr(page), np.rot90(page, int(fix["jax_turn"][j])))
parser = cli.build_parser()
for argv in (["build-dataset"], ["train", "--device", "cpu"],
             ["train-ocr", "--pool", "p.npz", "--out", "w.npz"]):
    assert parser.parse_args(argv).cmd == argv[0]
loaded = [m for m, v in sys.modules.items()
          if v is not None and m.split(".")[0] in {BLOCKED!r}]
assert not loaded, loaded
print("located")
"""


def test_qr_locator_autorotate_and_cli_run_without_jax_pil_cv2():
    """The QR scan's region pass and enhanced retries (the host C++ locator,
    ``equalizeHist`` and the cubic upscale), auto-rotate of a landscape page
    and every CLI subcommand's parser run with JAX, the JAX package, Pillow
    and OpenCV blocked, as on the card's machine."""
    out = subprocess.run([sys.executable, "-c", _QR_CLI_WITHOUT_CV2], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-1] == "located"


def test_find_nvcc_names_every_place_it_looked(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr(_build.os.path, "isfile", lambda p: False)
    with pytest.raises(FileNotFoundError) as e:
        _build.find_nvcc()
    msg = str(e.value)
    for place in ("PATH", str(tmp_path / "bin" / "nvcc"), "$CUDA_PATH (unset)",
                  "/usr/local/cuda/bin/nvcc"):
        assert place in msg


def _fake_nvcc(tmp_path, exit_code=0):
    """A stand-in nvcc that records its arguments and writes its -o file."""
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text(
        "#!/bin/sh\n"
        f'echo "$@" >> "{tmp_path}/calls"\n'
        f"[ {exit_code} -ne 0 ] && echo 'error: bad kernel' && exit {exit_code}\n"
        'while [ $# -gt 0 ]; do [ "$1" = -o ] && touch "$2"; shift; done\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    return nvcc


def test_build_compiles_each_source_once_for_sm90a(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("TWINVOICE_TORCH_BUILD_DIR", str(tmp_path / "out"))
    _fake_nvcc(tmp_path)
    built = _build.build()
    assert set(built) == set(_build.sources()) >= {
        "bbox_postprocess", "head_rowcol_max", "qconv3x3", "qconv3x3_pair",
        "qupsample2x2", "qconv3x3_nhwc_requant", "qconv3x3_nhwc_dma",
        "qconv3x3_pair_dma", "qconv3x3_requant_dma"}
    for name, path in built.items():
        assert path.exists() and path.parent == tmp_path / "out"
        assert path.name.startswith(name + "-") and path.suffix == ".so"
    calls = (tmp_path / "calls").read_text().splitlines()
    assert len(calls) == len(built)
    assert all("arch=compute_90a,code=sm_90a" in c and "-shared" in c for c in calls)
    _build.build()  # unchanged sources: nothing is compiled again
    assert len((tmp_path / "calls").read_text().splitlines()) == len(built)


def test_build_failure_raises_with_compiler_output(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("TWINVOICE_TORCH_BUILD_DIR", str(tmp_path / "out"))
    _fake_nvcc(tmp_path, exit_code=2)
    with pytest.raises(RuntimeError, match="bad kernel"):
        _build.build(["bbox_postprocess"])
    assert not list((tmp_path / "out").glob("*.so"))


def test_an_edited_shared_header_rebuilds_every_kernel(monkeypatch, tmp_path):
    """The headers K3a, K3b, K4b and K7a include (``csrc/*.cuh``) are hashed
    with the sources: editing one gives every library a new path, so nothing
    stale is loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in _build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    assert {"int8_conv_common.cuh", "int8_tma_conv.cuh"} <= {
        p.name for p in csrc.glob("*.cuh")}
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.sources()}
    header = csrc / "int8_conv_common.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.sources()}
    assert all(before[n] != after[n] for n in before)
