"""PyTorch port: the Streamlit app (``app/main.py``) and the CLI's ``app``
against the JAX package's, and the extractor's hand-off to the engines.

- ``capture_tab`` and ``dashboard_tab`` of both packages driven by the same
  recording fake ``st`` (scripted uploads, buttons and selections), with a
  fake ``plotly.express`` in ``sys.modules``: the recorded calls equal,
  frames by their columns, dtypes and values (the index aside: the port's
  tables are built from rows, and every table is shown without its index),
  images by their pixels;
- ``_build_engine``'s choice of segmenter and engines under each of the
  JAX package's environment variables, the model loads replaced by
  recorders; ``_build_store`` with and without Supabase credentials;
- the extractor's hand-off (``fusion/extract.py``): on pages through a
  random base-width-8 U-Net at 64² in both packages, each engine receives
  a crop whose Pillow luma, OpenCV luma and enhanced bytes are JAX's;
- ``python -m twinvoice_tpu_torch app`` runs Streamlit on the port's
  ``app/main.py`` as JAX's CLI does on its own.

Tolerance: none.
"""

import inspect
import io
import os
import subprocess
import sys
import types

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from tests.torch_port_cases import random_unet
from twinvoice_tpu.app import main as japp
from twinvoice_tpu.config import FusionConfig as JFusionConfig
from twinvoice_tpu.config import InferConfig as JInferConfig
from twinvoice_tpu.fusion.extract import InvoiceExtractor as JExtractor
from twinvoice_tpu.infer.pipeline import Segmenter as JSegmenter
from twinvoice_tpu.ocr import enhance as jenhance
from twinvoice_tpu.ocr.base import OcrResult as JOcrResult
from twinvoice_tpu.store.memory import MemoryStore as JMemoryStore
from twinvoice_tpu_torch import __main__ as cli
from twinvoice_tpu_torch.app import main as tapp
from twinvoice_tpu_torch.config import FusionConfig, InferConfig, UNetConfig
from twinvoice_tpu_torch.fusion.extract import InvoiceExtractor
from twinvoice_tpu_torch.infer.pipeline import Segmenter
from twinvoice_tpu_torch.ocr import enhance as tenhance
from twinvoice_tpu_torch.ocr.base import OcrResult
from twinvoice_tpu_torch.store.memory import MemoryStore
from twinvoice_tpu_torch.weights import from_jax_params


def norm(v):
    """A call argument as comparable data."""
    import pandas as pd

    if isinstance(v, pd.DataFrame):
        return ("frame", list(v.columns), [str(t) for t in v.dtypes],
                chip_smoke.plain(v.to_dict("records")))
    if isinstance(v, Image.Image):
        return ("image", v.mode, v.size, np.asarray(v).tobytes())
    if isinstance(v, FakeFig):
        return ("fig", v.kind, norm(v.frame), norm(v.kw), norm(v.layout))
    if isinstance(v, dict):
        return {k: norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [norm(x) for x in v]
    return chip_smoke.plain(v)


class FakeFig:
    def __init__(self, kind, frame, kw):
        self.kind, self.frame, self.kw, self.layout = kind, frame, kw, None

    def update_layout(self, **kw):
        self.layout = kw


@pytest.fixture
def fake_px(monkeypatch):
    px = types.ModuleType("plotly.express")
    px.bar = lambda frame, **kw: FakeFig("bar", frame, kw)
    px.pie = lambda frame, **kw: FakeFig("pie", frame, kw)
    plotly = types.ModuleType("plotly")
    plotly.express = px
    monkeypatch.setitem(sys.modules, "plotly", plotly)
    monkeypatch.setitem(sys.modules, "plotly.express", px)


class Upload:
    def __init__(self, data):
        self.data = data

    def getvalue(self):
        return self.data


class FakeSt:
    """Records every Streamlit call; ``script`` answers uploads, buttons
    (by label and key) and select boxes (by label; default the first
    option)."""

    def __init__(self, script=None):
        self.calls, self.script, self.session_state = [], dict(script or {}), {}

    def __getattr__(self, name):
        def call(*args, **kw):
            self.calls.append((name, norm(list(args)), norm(kw)))
            return self._answer(name, args, kw)
        return call

    def _answer(self, name, args, kw):
        if name in ("spinner", "expander"):
            return _Ctx()
        if name in ("columns", "tabs"):
            n = args[0] if isinstance(args[0], int) else len(args[0])
            return [_Ctx() for _ in range(n)]
        if name in ("file_uploader", "camera_input"):
            return self.script.get(name)
        if name == "button":
            return self.script.get((args[0], kw.get("key")), False)
        if name == "selectbox":
            opts = list(args[1])
            return self.script.get(args[0], opts[kw.get("index", 0)] if opts else None)
        return None


class _Ctx:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


class FixedExtractor:
    def __init__(self, meta, items):
        self.result, self.calls = (meta, items, []), []

    def extract(self, image):
        self.calls.append(np.asarray(image).copy())
        return dict(self.result[0]), list(self.result[1]), []


META = {"invoice_no": "AB12345678", "date": "2025-03-07", "total_amount": "250",
        "source": "QR", "date_source": "QR", "amount_source": "merged_ocr", "qr_raw": ["x"],
        "failures": []}
ITEMS = [{"name": "咖啡", "qty": 2, "price": 100, "amount": 200},
         {"name": "鬆餅", "qty": 1, "price": 50, "amount": 50}]


def _png(seed):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (30, 20, 3), dtype=np.uint8)).save(buf, "PNG")
    return buf.getvalue()


CAPTURE_SCRIPTS = {
    "nothing": {},
    "upload_only": {"file_uploader": Upload(_png(1))},
    "recognize_and_save": {"file_uploader": Upload(_png(2)), ("開始辨識", None): True,
                           ("儲存發票", None): True},
    "camera_no_items": {"camera_input": Upload(_png(3)), ("開始辨識", None): True,
                        "選擇消費類別": "交通"},
}


@pytest.mark.parametrize("case", sorted(CAPTURE_SCRIPTS))
def test_capture_tab_calls_equal_jax(case):
    items = [] if case == "camera_no_items" else ITEMS
    runs = []
    for app, store in ((japp, JMemoryStore()), (tapp, MemoryStore())):
        st = FakeSt(CAPTURE_SCRIPTS[case])
        ex = FixedExtractor(META, items)
        app.capture_tab(st, ex, store)
        runs.append((st.calls, norm(st.session_state), [c.tobytes() for c in ex.calls],
                     store.list_invoices(), store.list_items()))
    assert runs[1] == runs[0]
    if case == "recognize_and_save":
        assert runs[1][3][0]["category"] == "餐飲"  # classify_invoice's pick was stored


def _dashboard_store(cls):
    s = cls()
    rows = [("AB11111111", "2025-01-15", "100", "餐飲"), ("AB22222222", "2025-01-20", "50", "交通"),
            ("AB33333333", "2025-02-05", "200", "餐飲"), ("AB44444444", "2024-12-31", "999", "購物"),
            ("AB55555555", None, "77", "生活"), ("AB66666666", "2025-01-20", "5", "交通")]
    for i, (no, date, amt, cat) in enumerate(rows):
        s.save_invoice({"invoice_no": no, "date": date, "total_amount": amt, "category": cat,
                        "source": "QR", "qr_raw": []}, ITEMS[:i % 3])
    return s


DASH_SCRIPTS = {
    "empty": None,
    "first_year_all_months": {},
    "a_month": {"選擇月份": "2025-01"},
    "the_older_year": {"選擇年度": "2024"},
    "delete_one": {("刪除", "del_2"): True},
}


@pytest.mark.parametrize("case", sorted(DASH_SCRIPTS))
def test_dashboard_tab_calls_equal_jax(case, fake_px):
    runs = []
    for app, cls in ((japp, JMemoryStore), (tapp, MemoryStore)):
        store = cls() if DASH_SCRIPTS[case] is None else _dashboard_store(cls)
        st = FakeSt(DASH_SCRIPTS[case])
        app.dashboard_tab(st, store)
        runs.append((st.calls, norm(st.session_state), store.list_invoices()))
    assert runs[1] == runs[0]
    names = [c[0] for c in runs[1][0]]
    if case != "empty":
        assert names.count("plotly_chart") == 2 and "expander" in names
    if case == "delete_one":
        assert "rerun" in names and 2 not in [r["id"] for r in runs[1][2]]


def test_main_calls_equal_jax(monkeypatch, fake_px):
    runs = []
    for app, cls in ((japp, JMemoryStore), (tapp, MemoryStore)):
        st = FakeSt()
        monkeypatch.setitem(sys.modules, "streamlit", st)
        monkeypatch.setattr(app, "_build_engine", lambda: FixedExtractor(META, ITEMS))
        monkeypatch.setattr(app, "_build_store", lambda: _dashboard_store(cls))
        app.main()
        runs.append(st.calls)
    assert runs[1] == runs[0]
    assert [c[0] for c in runs[1][:3]] == ["set_page_config", "spinner", "tabs"]


class LoadRecorder:
    """Stands for the segmenter loads and the local engine in both
    packages: records which load ran and with what."""

    def __init__(self, log):
        self.log = log

    def seg(self, how):
        def load(*args, **kw):
            dtype = kw["dtype"]
            dtype = getattr(dtype, "__name__", str(dtype)).replace("torch.", "")
            path = args[0] if how != "bundled" else None
            cfg = kw.get("infer_cfg", args[2] if len(args) > 2 else None)
            self.log.append((how, path, dtype, cfg.img_size))
            return "segmenter"
        return load


class FakeLocal:
    name = "local"

    def __init__(self, *a, **kw):
        pass

    def available(self):
        return True


ENV_CASES = {
    "none": {},
    "pth": {"TWINVOICE_PTH": "/w/model.pth"},
    "ckpt": {"TWINVOICE_CKPT": "/w/ckpt"},
    "pth_wins": {"TWINVOICE_PTH": "/w/model.pth", "TWINVOICE_CKPT": "/w/ckpt"},
    "ocr_space_key": {"OCR_SPACE_API_KEY": "k"},
}


@pytest.mark.parametrize("case", sorted(ENV_CASES))
def test_build_engine_choice_equals_jax(case, monkeypatch):
    from twinvoice_tpu.infer import pipeline as jpipe
    from twinvoice_tpu.models import pretrained as jpre
    from twinvoice_tpu.ocr.jaxocr import engine as jeng
    from twinvoice_tpu_torch.infer import pipeline as tpipe
    from twinvoice_tpu_torch.models import pretrained as tpre
    from twinvoice_tpu_torch.ocr.torchocr import engine as teng

    for k in chip_smoke.APP_ENV:
        monkeypatch.delenv(k, raising=False)
    for k, v in ENV_CASES[case].items():
        monkeypatch.setenv(k, v)
    out = []
    for pipe, pre, eng, mod, build in ((jpipe, jpre, jeng, "JaxOcrEngine", japp._build_engine),
                                       (tpipe, tpre, teng, "TorchOcrEngine",
                                        lambda: tapp._build_engine("cpu"))):
        log = []
        rec = LoadRecorder(log)
        fake_seg = type("Seg", (), {"from_pth": staticmethod(rec.seg("pth")),
                                    "from_checkpoint": staticmethod(rec.seg("ckpt"))})
        monkeypatch.setattr(pipe, "Segmenter", fake_seg)
        monkeypatch.setattr(pre, "load_pretrained_segmenter",
                            lambda infer_cfg, device=None, _r=rec: _r.seg("bundled")(
                                infer_cfg=infer_cfg, dtype="default"))
        monkeypatch.setattr(eng, mod, FakeLocal)
        ex = build()
        out.append((log, [e.name for e in ex.engines], ex.segmenter,
                    type(ex.qr).__name__, vars(ex.cfg)))
    assert out[1] == out[0]
    assert out[1][1] == (["ocr.space", "local"] if case == "ocr_space_key" else ["local"])



def test_bundled_load_defaults_to_bf16_in_both():
    """``_build_engine`` loads the bundled segmenter at its loader's default
    dtype: bf16 in both (JAX's ``dtype or jnp.bfloat16``)."""
    from twinvoice_tpu.models import pretrained as jpre
    from twinvoice_tpu_torch.models import pretrained as tpre

    assert inspect.signature(tpre.load_pretrained_segmenter).parameters["dtype"].default \
        is torch.bfloat16
    assert "dtype or jnp.bfloat16" in inspect.getsource(jpre.load_pretrained_segmenter)


def test_build_engine_defaults_to_the_card(monkeypatch):
    from twinvoice_tpu_torch.models import pretrained as tpre

    for k in chip_smoke.APP_ENV:
        monkeypatch.delenv(k, raising=False)
    seen = []
    monkeypatch.setattr(tpre, "load_pretrained_segmenter",
                        lambda infer_cfg, device=None: seen.append(device))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapp._build_engine()
        assert seen == [None]  # the bundled load got the default; the engine refused


def test_build_store_equals_jax(monkeypatch):
    for k in chip_smoke.APP_ENV:
        monkeypatch.delenv(k, raising=False)
    assert type(tapp._build_store()).__name__ == type(japp._build_store()).__name__ == \
        "MemoryStore"
    monkeypatch.setenv("SUPABASE_URL", "http://localhost:1")
    monkeypatch.setenv("SUPABASE_KEY", "k")
    assert type(tapp._build_store()).__name__ == "MemoryStore"  # no supabase package
    fake = types.ModuleType("supabase")
    fake.create_client = lambda url, key: chip_smoke.FakeSupabaseClient()
    monkeypatch.setitem(sys.modules, "supabase", fake)
    stores = [japp._build_store(), tapp._build_store()]
    assert [type(s).__name__ for s in stores] == ["SupabaseStore"] * 2
    assert [s.save_invoice(chip_smoke.STORE_META, chip_smoke.STORE_ITEMS) for s in stores] == [1, 1]


# -- the extractor hands each engine what JAX's hands its counterpart ---------


class GrayRecorder:
    """An engine that reads a crop as each kind of engine does: Pillow's
    luma (``convert("L")``, the recognizer), OpenCV's luma of
    ``convert("RGB")`` (EasyOCR) and the enhanced bytes (OCR.space)."""

    def __init__(self, result_cls, enhance):
        self.result_cls, self.enhance, self.seen = result_cls, enhance, []
        self.name = "recorder"

    def read(self, image, mode="text"):
        pil = np.asarray(image.convert("L") if hasattr(image, "convert") else image)
        self.seen.append((mode, pil.tobytes(), self.enhance.grayscale_for_ocr(image).tobytes(),
                          self.enhance.enhance_for_ocr(image, mode=mode).tobytes()))
        return self.result_cls("", self.name)


def _pages(seed, sizes):
    rng = np.random.default_rng(seed)
    out = []
    for w, h in sizes:
        page = rng.integers(200, 256, (h, w, 3), dtype=np.uint8)
        for _ in range(6):
            y, x = rng.integers(0, h - 8), rng.integers(0, w - 16)
            page[y:y + rng.integers(3, 8), x:x + rng.integers(8, 16)] = rng.integers(
                0, 90, 3, dtype=np.uint8)
        out.append(page)
    return out


def test_engines_get_jax_crops_from_the_extractor():
    """Both extractors on the same random w8 U-Net (64²): every crop an
    engine receives gives JAX's Pillow luma, OpenCV luma and enhanced bytes,
    through ``extract`` and ``extract_batch``; the Pillow and OpenCV lumas
    differ on these crops, so handing the wrong one shows."""
    was = cv2.ipp.useIPP()
    cv2.ipp.setUseIPP(False)
    try:
        jcfg, params, state = random_unet(3)
        jseg = JSegmenter(params, state, jcfg, JInferConfig(img_size=64), dtype=jnp.float32)
        tp, ts = from_jax_params(params, state)
        tseg = Segmenter(tp, ts, UNetConfig(base_width=8), InferConfig(img_size=64),
                         dtype=torch.float32, device="cpu")
        pages = _pages(30, [(90, 120), (64, 64), (150, 70), (75, 75)])
        cfg = dict(use_qr=False, auto_rotate=False, full_page_fallback=False)
        jrec, trec = GrayRecorder(JOcrResult, jenhance), GrayRecorder(OcrResult, tenhance)
        jex = JExtractor(jseg, None, [jrec], cfg=JFusionConfig(**cfg))
        tex = InvoiceExtractor(tseg, None, [trec], cfg=FusionConfig(**cfg))
        for p in pages:
            assert tex.extract(p)[0]["failures"] == jex.extract(Image.fromarray(p))[0]["failures"]
        jex.clear_cache()
        tex.clear_cache()
        tex.extract_batch(pages)
        jex.extract_batch([Image.fromarray(p) for p in pages])
    finally:
        cv2.ipp.setUseIPP(was)
    assert len(trec.seen) == len(jrec.seen) >= 4
    assert trec.seen == jrec.seen
    assert any(pil != cv for _, pil, cv, _ in trec.seen)


def test_cli_app_runs_streamlit_on_the_ports_app(monkeypatch):
    calls = []
    monkeypatch.setattr(subprocess, "run", lambda cmd, **kw: calls.append((cmd, kw)))
    cli.main(["app"])
    from twinvoice_tpu import __main__ as jcli

    jcli.main(["app"])
    (tcmd, tkw), (jcmd, jkw) = calls
    assert tcmd[:4] == jcmd[:4] == [sys.executable, "-m", "streamlit", "run"]
    assert tkw == jkw == {"check": True}
    assert os.path.samefile(tcmd[4], os.path.join(os.path.dirname(tapp.__file__), "main.py"))
    assert os.path.samefile(jcmd[4], japp.__file__)
    assert chip_smoke.cli_app_check() == tcmd
    assert cli.build_parser().parse_args(["app"]).cmd == "app"
