"""Recognizer training data: the port of the host half of
``twinvoice_tpu/ocr/jaxocr/data.py`` that needs neither Pillow nor OpenCV.

- the text samplers (``random_field_text``, ``random_hard_text``,
  ``random_mixed_text``, ``random_cjk_text``), copied so that one
  ``np.random.Generator`` gives the JAX package's strings and is left in
  the same state;
- ``encode_labels``: texts → the CTC labels and paddings ``make_batch``
  builds;
- ``lines_to_tensor`` and ``read_line_npz``: pre-rendered uint8 lines → the
  float32 batches the recognizer trains on.

The line renderer (``render_line``, ``dot_matrix``) and ``make_batch`` draw
with Pillow, TrueType fonts and OpenCV, which the card's machine lacks: they
stay in the JAX package, and their lines reach the port as uint8 arrays in
an npz (``scripts/make_torch_smoke_ocrtrain.py`` writes one).
"""

from __future__ import annotations

import numpy as np
import torch

from twinvoice_tpu_torch.ocr.torchocr.charset import CHARSET, DEFAULT, Charset

MAX_LABEL = 24

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
