"""Recognizer training data: the port of ``twinvoice_tpu/ocr/jaxocr/data.py``,
without Pillow, FreeType or OpenCV.

- the text samplers (``random_field_text``, ``random_hard_text``,
  ``random_mixed_text``, ``random_cjk_text``), copied so that one
  ``np.random.Generator`` gives the JAX package's strings and is left in
  the same state;
- the line renderer (``render_line``, ``dot_matrix``) and ``make_batch``:
  JAX's code with the same draws from the generator in the same order,
  drawing with ``ops/host_pildraw`` (Pillow's drawing), the TrueType engine
  of ``ocr/fonts/truetype`` and the OpenCV steps of ``ops/host_image``,
  ``host_warp`` and ``host_filter``. The lines equal JAX's byte for byte
  on the training fonts (the DejaVu faces through the bytecode interpreter,
  Atkinson and Minecraft through the auto-hinter) where OpenCV runs its own
  code
  (``cv2.ipp.setUseIPP(False)``: with IPP, OpenCV's float resizes differ
  in the last bits);
- ``encode_labels``: texts → the CTC labels and paddings ``make_batch``
  builds;
- ``lines_to_tensor`` and ``read_line_npz``: uint8 lines → the float32
  batches the recognizer trains on.
"""

from __future__ import annotations

from functools import lru_cache
from typing import List, Optional

import numpy as np
import torch

from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET, DEFAULT, Charset
from twinvoice_tpu_torch.ocr.torchocr.model import IMG_H, IMG_W

MAX_LABEL = 24


def _font_paths():
    """Training typefaces: ``data.synthetic.train_fonts`` (JAX's registry),
    never the held-out families."""
    from twinvoice_tpu_torch.data.synthetic import train_fonts

    return train_fonts()


_FONT_PATHS = _font_paths()


@lru_cache(maxsize=512)  # every (face, size) the line and page renderers draw
def _font(path, size):
    from twinvoice_tpu_torch.ocr.fonts.truetype import FreeTypeFont

    return FreeTypeFont(path, size)

# Realistic TW receipt item names / labels, drawn from the classifier keyword
# vocabulary (fusion/classify.py) and common e-invoice text — all covered by
# the in-repo stroke font. Random glyph combos are mixed in so the model
# can't memorize this list.
_CJK_NAMES = (
    "珍珠奶茶 紅茶拿鐵 火腿吐司 雞排 鍋燒麵 咖啡 拿鐵 漢堡 壽司 炸雞 "
    "便當 飲料 餐飲 加油 停車費 捷運 高鐵 火車 公車 計程車 水費 電費 "
    "瓦斯 管理費 醫院 藥局 全家 蝦皮 商城 家樂福 發票 號碼 日期 總計 "
    "金額 統一編號 品名 數量 單價 合計 測試品項 電子發票證明聯 未分類 "
    "購物 生活 交通 美式咖啡 燒餅 油條 豆漿 麵包 餅乾 奶茶 紅豆餅"
).split()


def _cjk_pool(charset: Charset):
    return [c for c in charset.chars if ord(c) > 0x2E00]


def random_cjk_text(rng: np.random.Generator, charset: Charset) -> str:
    """Item-name-shaped CJK (optionally mixed with qty/price digits)."""
    kind = rng.integers(0, 4)
    if kind <= 1:  # realistic vocabulary name
        name = _CJK_NAMES[int(rng.integers(0, len(_CJK_NAMES)))]
        name = "".join(c for c in name if c in charset._to_id) or "品項"
    else:  # random combo — forces per-glyph recognition
        pool = _cjk_pool(charset)
        name = "".join(rng.choice(pool, int(rng.integers(2, 5))))
    if kind == 3 and rng.random() < 0.7:  # "name qty price"-ish line
        return f"{name} {rng.integers(1, 9)} {rng.integers(10, 999)}"
    return name


def random_hard_text(rng: np.random.Generator, charset: Charset = DEFAULT) -> str:
    """Training-only hard-case sampler: O/0/I/1 confusions in format-free
    strings, space handling next to symbols, CTC doubled-character runs, and
    random CJK glyph combos mixed with digits."""
    has_cjk = len(charset.chars) > len(CHARSET)
    kind = rng.integers(0, 4 if has_cjk else 3)
    if kind == 0:  # O/0/I/1/S/5-dense format-free string
        pool = list("O0I1S5B8Z2Q") + list("O0O0I1")  # double-weight O/0/I/1
        n = int(rng.integers(4, 12))
        s = "".join(rng.choice(pool, n))
        if rng.random() < 0.4:  # sprinkle separators the confusions ride on
            i = int(rng.integers(1, max(2, n - 1)))
            s = s[:i] + str(rng.choice([".", ",", ":", "-", ")"])) + s[i:]
        return s
    if kind == 1:  # space-dense line with symbols at the boundaries
        words = []
        for _ in range(int(rng.integers(2, 4))):
            n = int(rng.integers(1, 6))
            words.append("".join(rng.choice(list(CHARSET.strip()), n)))
        return " ".join(words)[:MAX_LABEL - 1]
    if kind == 2:  # doubled-character runs (CTC must emit blanks)
        letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
        ch = str(rng.choice(list(letters + "0123456789")))
        tail = "".join(rng.choice(list("0123456789"), int(rng.integers(4, 9))))
        if rng.random() < 0.5:
            return ch * 2 + "-" + tail
        return ch * 2 + tail
    # random CJK combo + qty/price (the mixed-line failure mode)
    pool = _cjk_pool(charset)
    name = "".join(rng.choice(pool, int(rng.integers(2, 5))))
    return f"{name} {rng.integers(1, 9)} {rng.integers(10, 999)}"


def random_mixed_text(rng: np.random.Generator, charset: Charset = DEFAULT) -> str:
    """Training-only mixed-script line sampler: CJK name ↔ digit qty/price
    transitions, ASCII words inside CJK labels, unit suffixes."""
    pool = _cjk_pool(charset)
    if not pool:
        return random_field_text(rng, charset)
    kind = rng.integers(0, 5)
    if kind == 0:  # vocabulary name + qty + price (the canonical item line)
        name = _CJK_NAMES[int(rng.integers(0, len(_CJK_NAMES)))]
        name = "".join(c for c in name if c in charset._to_id) or "品項"
        return f"{name} {rng.integers(1, 99)} {rng.integers(10, 9999)}"
    if kind == 1:  # random glyph combo + digits, no separators (dense boundary)
        name = "".join(rng.choice(pool, int(rng.integers(2, 5))))
        return f"{name}{rng.integers(10, 999)}"
    if kind == 2:  # ASCII token inside a CJK label ("全家COFFEE拿鐵")
        a = "".join(rng.choice(pool, int(rng.integers(1, 3))))
        word = "".join(rng.choice(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"),
                                  int(rng.integers(2, 6))))
        b = "".join(rng.choice(pool, int(rng.integers(1, 3))))
        return f"{a}{word}{b}"
    if kind == 3:  # label: value ("金額: 1,250" / "數量:3")
        label = "".join(rng.choice(pool, int(rng.integers(2, 4))))
        amount = int(10 ** rng.uniform(0.5, 4))
        s = f"{amount:,}" if rng.random() < 0.3 else str(amount)
        sep = str(rng.choice([": ", ":", " "]))
        return f"{label}{sep}{s}"
    # name x qty ("珍珠奶茶 X2" / "咖啡*3")
    name = "".join(rng.choice(pool, int(rng.integers(2, 5))))
    return f"{name} {rng.choice(['X', '*', 'x'])}{rng.integers(1, 9)}"


def random_field_text(rng: np.random.Generator, charset: Charset = DEFAULT) -> str:
    """Sample a string shaped like one of the three invoice fields (or, when
    the charset covers CJK, like an item-name line ~35% of the time)."""
    if len(charset.chars) > len(CHARSET) and rng.random() < 0.35:
        return random_cjk_text(rng, charset)
    kind = rng.integers(0, 6)
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    if kind in (0, 5):  # invoice number, possibly hyphenated (oversampled)
        # confusion-pair-weighted sampling: O/0, S/5/6, B/8/V, I/1/J/L and
        # doubled digits (CTC must emit a blank between repeats)
        if rng.random() < 0.45:
            hard = "OSBIJLVQDGUZ"
            pre = "".join(rng.choice(list(hard), 2))
        else:
            pre = "".join(rng.choice(list(letters), 2))
        digits = list(rng.choice(list("0123456789"), 8))
        if rng.random() < 0.35:  # force a doubled digit pair
            i = int(rng.integers(0, 7))
            digits[i + 1] = digits[i]
        if rng.random() < 0.3:  # bias toward the confusable digits
            for i in range(8):
                if rng.random() < 0.4:
                    digits[i] = str(rng.choice(list("0156889")))
        no = pre + "".join(digits)
        return no if rng.random() < 0.5 else no[:2] + "-" + no[2:]
    if kind == 1:  # western date
        sep = rng.choice(["-", "/", "."])
        return f"{rng.integers(2018, 2031)}{sep}{rng.integers(1, 13):02d}{sep}{rng.integers(1, 29):02d}"
    if kind == 2:  # ROC-style date digits
        return f"{rng.integers(100, 130)}/{rng.integers(1, 13):02d}/{rng.integers(1, 29):02d}"
    if kind == 3:  # amount
        amount = int(10 ** rng.uniform(0.5, 5))
        s = f"{amount:,}" if rng.random() < 0.4 else str(amount)
        prefix = rng.choice(["", "$", "NT$", "TX ", "TOTAL "])
        return f"{prefix}{s}"
    n = int(rng.integers(3, 14))  # generic alphanumeric
    return "".join(rng.choice(list(CHARSET.strip() + "  "), n)).strip() or "X"


def dot_matrix(img: np.ndarray, rng: np.random.Generator,
               pitch: Optional[int] = None) -> np.ndarray:
    """Re-print a rendered line through a simulated dot-matrix/thermal
    printhead: ink is grid-sampled at ``pitch`` px and re-drawn as discrete
    dots with per-dot intensity jitter and row banding (JAX's, verbatim)."""
    H, W = img.shape
    pitch = int(rng.integers(2, 4)) if pitch is None else int(pitch)
    ink = 255.0 - img
    gh, gw = H // pitch, W // pitch
    cells = ink[: gh * pitch, : gw * pitch].reshape(
        gh, pitch, gw, pitch).mean(axis=(1, 3))
    dots = cells > float(rng.uniform(40, 80))
    yy, xx = np.mgrid[0:pitch, 0:pitch].astype(np.float32)
    c = (pitch - 1) / 2.0
    kern = (((yy - c) ** 2 + (xx - c) ** 2)
            <= (pitch / 2.0 + 0.15) ** 2).astype(np.float32)
    amp = dots * rng.uniform(0.55, 1.0, dots.shape)
    amp *= (1.0 - 0.25 * (rng.random(gh) < 0.2))[:, None]
    printed = np.kron(amp, kern) * float(rng.uniform(190, 255))
    out = np.full((H, W), 255.0, np.float32)
    out[: gh * pitch, : gw * pitch] -= printed
    return np.clip(out, 0, 255)


def render_line(text: str, rng: np.random.Generator,
                sev: float = 1.0, dot: bool = False,
                synth_style=None, dot_hard: bool = False) -> np.ndarray:
    """Render text → uint8 grayscale (IMG_H, IMG_W), dark text on light bg:
    JAX's ``render_line`` with the same generator draws (see the module
    docstring)."""
    from twinvoice_tpu_torch.ocr import fonts
    from twinvoice_tpu_torch.ocr.fonts import latin_glyphs
    from twinvoice_tpu_torch.ops import host_filter, host_image, host_warp
    from twinvoice_tpu_torch.ops.host_pildraw import Draw, Image

    size = int(rng.integers(18, 30))
    font = _font(_FONT_PATHS[int(rng.integers(0, len(_FONT_PATHS)))], size)
    pad = 8
    canvas = Image.new("L", (IMG_W * 2 + 64 * len(text), IMG_H * 2), 255)
    draw = Draw(canvas)
    fill = int(rng.integers(0, 80))
    if any(ord(c) > 0x2E00 for c in text):
        fonts.draw_text(
            draw, (pad, pad), text, size, fill=fill, ascii_font=font,
            weight=float(rng.uniform(5.0, 8.0)),
            style_rng=rng if rng.random() < 0.7 else None,
            jitter=float(rng.uniform(0.015, 0.05)),
        )
    elif synth_style is not None:
        latin_glyphs.draw_text(draw, (pad, pad), text, size, fill=fill,
                               style=synth_style)
    elif rng.random() < 0.5:
        x = float(pad)
        for ch in text:
            dy = float(rng.normal(0, 1.0)) * size / 24.0
            draw.text((x, pad + dy), ch, fill=fill, font=font)
            adv = draw.textlength(ch, font=font)
            x += adv * float(rng.uniform(0.92, 1.18))
    else:
        draw.text((pad, pad), text, fill=fill, font=font)
    arr = canvas.array
    ys, xs = np.where(arr < 250)
    if len(xs) == 0:
        return np.full((IMG_H, IMG_W), 255, np.uint8)
    x0, x1 = xs.min(), xs.max() + 1
    y0, y1 = ys.min(), ys.max() + 1
    crop = Image.fromarray(arr[y0:y1, x0:x1])

    if rng.random() < min(0.85, 0.4 * sev):
        crop = crop.rotate(float(rng.uniform(-4.0 * sev, 4.0 * sev)),
                           expand=True, fillcolor=255)

    if rng.random() < 0.5:
        t = crop.array
        r = rng.random()
        if r < 0.3:
            t = host_image.erode2x2(t)
        elif r < 0.5:
            t = host_image.dilate2x2(t)
        shear = float(rng.uniform(-0.25, 0.25))
        h0, w0 = t.shape
        m = np.array([[1.0, shear, abs(shear) * h0], [0.0, 1.0, 0.0]],
                     np.float32)
        t = host_warp.warp_affine_u8(t, m, (int(w0 + abs(shear) * h0 + 2), h0), 255)
        crop = Image.fromarray(t)

    w, h = crop.size
    scale = min((IMG_H - 4) / h, (IMG_W - 4) / w)
    stretch = float(rng.uniform(0.85, 1.15))
    new_w = max(1, min(IMG_W - 4, int(w * scale * stretch)))
    crop = crop.resize((new_w, max(1, int(h * scale))))
    out = Image.new("L", (IMG_W, IMG_H), 255)
    max_x = IMG_W - crop.size[0]
    ox = int(rng.integers(0, max(1, max_x // 3)))
    oy = (IMG_H - crop.size[1]) // 2
    out.paste(crop, (ox, oy))
    img = np.asarray(out.array, np.float32)

    if dot:
        pitch = int(rng.integers(2, 4))
        if dot_hard:
            dpg = float(rng.uniform(6.5, 9.5))
            s = min(1.0, dpg * pitch / 28.0)
        else:
            s = float(rng.uniform(min(1.0, 6.5 * pitch / 28.0), 1.0))
        if s < 0.97:
            sw, sh = max(8, int(IMG_W * s)), max(8, int(IMG_H * s))
            small = host_image.resize_area_f32(img, sw, sh)
            img = host_image.resize_linear_f32(
                dot_matrix(small, rng, pitch=pitch).astype(np.float32), IMG_W, IMG_H)
        else:
            img = dot_matrix(img, rng, pitch=pitch)

    if rng.random() < min(0.85, 0.4 * sev):
        amp = float(rng.uniform(0.5, max(0.51, 1.3 * sev)))
        gx = host_filter.resize_cubic_f32(
            rng.normal(0, amp, (4, 16)).astype(np.float32), IMG_W, IMG_H)
        gy = host_filter.resize_cubic_f32(
            rng.normal(0, 0.8 * amp, (4, 16)).astype(np.float32), IMG_W, IMG_H)
        xs, ys = np.meshgrid(np.arange(IMG_W, dtype=np.float32),
                             np.arange(IMG_H, dtype=np.float32))
        img = host_warp.remap_linear_f32(np.asarray(img, np.float32), xs + gx, ys + gy)

    img = img * float(rng.uniform(max(0.45, 1.0 - 0.3 * sev), 1.0)) \
        + float(rng.uniform(0, 60 * sev))
    if rng.random() < min(0.85, 0.5 * sev):
        img = img + rng.normal(0, rng.uniform(2, 12 * sev), img.shape)
    if rng.random() < 0.5:
        img = img - rng.integers(0, 9, img.shape)
    if rng.random() < min(0.7, 0.3 * sev):
        img = (img + np.roll(img, 1, 0) + np.roll(img, 1, 1) + np.roll(np.roll(img, 1, 0), 1, 1)) / 4
    return np.clip(img, 0, 255).astype(np.uint8)


def make_lines(batch_size: int, rng: np.random.Generator,
               charset: Charset = DEFAULT, hard_frac: float = 0.0,
               sev_frac: float = 0.0, sev_hi: float = 1.8,
               dot_frac: float = 0.0, mixed_frac: float = 0.0,
               synth_frac: float = 0.0, dot_hard_frac: float = 0.0):
    """:func:`make_batch`'s draws with the lines kept as uint8: → (lines
    (B, IMG_H, IMG_W) uint8, labels, label_pad, texts)."""
    from twinvoice_tpu_torch.ocr.fonts import latin_glyphs

    lines = np.zeros((batch_size, IMG_H, IMG_W), np.uint8)
    labels = np.zeros((batch_size, MAX_LABEL), np.int32)
    pad = np.ones((batch_size, MAX_LABEL), np.float32)
    texts: List[str] = []
    for i in range(batch_size):
        if hard_frac > 0.0 and rng.random() < hard_frac:
            text = random_hard_text(rng, charset)
        elif mixed_frac > 0.0 and rng.random() < mixed_frac:
            text = random_mixed_text(rng, charset)
        else:
            text = random_field_text(rng, charset)
        ids = charset.encode_text(text)[:MAX_LABEL]
        text = "".join(
            c for c in text.upper() if charset.encode_text(c)
        )[: len(ids)]  # keep label/text consistent
        sev = 1.0
        if sev_frac > 0.0 and rng.random() < sev_frac:
            sev = float(rng.uniform(1.2, sev_hi))
        dot = dot_frac > 0.0 and rng.random() < dot_frac
        dhard = dot and dot_hard_frac > 0.0 and rng.random() < dot_hard_frac
        style = None
        if (synth_frac > 0.0 and rng.random() < synth_frac
                and not any(ord(c) > 0x2E00 for c in text)):
            style = latin_glyphs.sample_style(rng)
        lines[i] = render_line(text, rng, sev=sev, dot=dot,
                               synth_style=style, dot_hard=dhard)
        labels[i, : len(ids)] = ids
        pad[i, : len(ids)] = 0.0
        texts.append(text)
    return lines, labels, pad, texts


def make_batch(batch_size: int, rng: np.random.Generator,
               charset: Charset = DEFAULT, hard_frac: float = 0.0,
               sev_frac: float = 0.0, sev_hi: float = 1.8,
               dot_frac: float = 0.0, mixed_frac: float = 0.0,
               synth_frac: float = 0.0, dot_hard_frac: float = 0.0):
    """→ (images (B,H,W,1) float[0,1], labels (B,MAX) int32, label_pad
    (B,MAX) f32, texts): JAX's ``make_batch``, drawn by :func:`render_line`."""
    lines, labels, pad, texts = make_lines(
        batch_size, rng, charset, hard_frac=hard_frac, sev_frac=sev_frac, sev_hi=sev_hi,
        dot_frac=dot_frac, mixed_frac=mixed_frac, synth_frac=synth_frac,
        dot_hard_frac=dot_hard_frac)
    imgs = (lines.astype(np.float32) / 255.0)[..., None]
    return imgs, labels, pad, texts


def encode_labels(texts, charset: Charset = DEFAULT):
    """Texts → ``(labels (B, MAX_LABEL) int32, label_pad (B, MAX_LABEL)
    float32, texts)`` as ``make_batch`` builds them: each text's ids
    (unknown characters dropped) cut to ``MAX_LABEL``, padded with 0 and
    pad 1.0; each text upper-cased, its unknown characters dropped and cut
    to its labels' length."""
    labels = np.zeros((len(texts), MAX_LABEL), np.int32)
    pad = np.ones((len(texts), MAX_LABEL), np.float32)
    out = []
    for i, text in enumerate(texts):
        ids = charset.encode_text(text)[:MAX_LABEL]
        out.append("".join(c for c in text.upper() if charset.encode_text(c))[:len(ids)])
        labels[i, :len(ids)] = ids
        pad[i, :len(ids)] = 0.0
    return labels, pad, out


def lines_to_tensor(lines_u8, device) -> torch.Tensor:
    """uint8 lines (B, 32, 256), a numpy array or a tensor on any device →
    float32 (B, 1, 32, 256) on ``device``, ``u8 / 255.0``: bit-equal to
    ``make_batch``'s ``astype(float32) / 255.0`` (one correctly rounded
    division either way). NCHW-contiguous, so that BatchNorm's sums over
    (N, H, W) run pairwise on the CPU."""
    if not isinstance(lines_u8, torch.Tensor):
        lines_u8 = torch.from_numpy(np.ascontiguousarray(lines_u8, dtype=np.uint8))
    return (lines_u8.to(device)[:, None].to(torch.float32) / 255.0).contiguous()


def read_line_npz(path, prefix=""):
    """A file of pre-rendered lines → ``(lines uint8 (N, 32, 256), labels
    (N, MAX_LABEL) int32, label_pad (N, MAX_LABEL) float32, texts)``, from
    its keys ``<prefix>lines``, ``<prefix>labels``, ``<prefix>label_pad``
    and ``<prefix>texts``."""
    with np.load(path) as z:
        return (np.asarray(z[prefix + "lines"], np.uint8),
                np.asarray(z[prefix + "labels"], np.int32),
                np.asarray(z[prefix + "label_pad"], np.float32),
                [str(t) for t in z[prefix + "texts"]])
