"""Character n-gram language model over the invoice text domain: the port's
own copy of the reader half of ``twinvoice_tpu/ocr/jaxocr/lm.py``.

TW e-invoice text is rigidly structured, so a tiny char 4-gram captures most
of the prior. Fused into CTC prefix beam search
(:func:`.charset.beam_ctc_decode`) it disambiguates pure-vision ties (0↔O in
a digit slot, spurious/dropped spaces). The bundled model,
``twinvoice_tpu/ocr/jaxocr/lm4.json.gz``, is read where it lies as a data
file. ``CharNgramLM.build`` makes it from the port's copy of the training
text sampler (:func:`.data.random_field_text`) with a fixed seed, so the
port rebuilds the bundled asset exactly. ``^``/``$`` mark string start/end.
"""

from __future__ import annotations

import gzip
import json
import math
import os
from collections import Counter, defaultdict

import numpy as np

MAX_ORDER = 4  # contexts of length 0..3
DEFAULT_LM_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))),
    "twinvoice_tpu", "ocr", "jaxocr", "lm4.json.gz",
)


class CharNgramLM:
    """Interpolated-backoff char n-gram: P(c|ctx) mixes orders 1..4.

    ``logp(ctx, c)``: ``ctx`` is the full emitted prefix prefixed with
    ``"^"``; only the last ``MAX_ORDER-1`` chars are used. ``c`` may be
    ``"$"`` for end-of-string.
    """

    def __init__(self, grams, vocab_size: int):
        # grams[k]: dict ctx(len k) -> (total, dict char -> count)
        self.grams = grams
        self.V = vocab_size
        self.order = MAX_ORDER  # context length consumers may truncate to
        self._interp = 0.65
        self._smooth = 0.1
        self._cache: dict = {}  # (ctx[-3:], c) -> logp; contexts repeat
        # heavily across beam prefixes and frames (~5x decode speedup)

    def logp(self, ctx: str, c: str) -> float:
        ctx = ctx[-(MAX_ORDER - 1):]
        key = (ctx, c)
        v = self._cache.get(key)
        if v is not None:
            return v
        p = 1.0 / self.V
        w, s, V = self._interp, self._smooth, self.V
        for k in range(MAX_ORDER):
            cc = ctx[len(ctx) - k:] if k else ""
            e = self.grams[k].get(cc)
            if e is not None:
                tot, d = e
                p = (1.0 - w) * p + w * (d.get(c, 0) + s) / (tot + s * V)
        v = math.log(p)
        if len(self._cache) < 2_000_000:
            self._cache[key] = v
        return v

    # ------------------------------------------------------------- build
    @classmethod
    def build(cls, charset=None, n_samples: int = 120000, seed: int = 1):
        """Build from the training text generator (NOT from any eval set:
        eval seeds are 7/4242/99+; the LM uses seed 1 samples only)."""
        from twinvoice_tpu_torch.ocr.torchocr import data as D
        from twinvoice_tpu_torch.ocr.torchocr.charset import DEFAULT

        charset = charset or DEFAULT
        rng = np.random.default_rng(seed)
        raw = [defaultdict(Counter) for _ in range(MAX_ORDER)]
        for _ in range(n_samples):
            t = "^" + D.random_field_text(rng, charset) + "$"
            for j in range(1, len(t)):
                for k in range(MAX_ORDER):
                    if j - k >= 0:
                        raw[k][t[j - k:j]][t[j]] += 1
        grams = [{ctx: (sum(d.values()), dict(d)) for ctx, d in g.items()}
                 for g in raw]
        return cls(grams, charset.num_classes + 2)

    # --------------------------------------------------------- save/load
    def save(self, path: str):
        obj = {"V": self.V,
               "grams": [{ctx: [tot, d] for ctx, (tot, d) in g.items()}
                         for g in self.grams]}
        with gzip.open(path, "wt", encoding="utf-8") as f:
            json.dump(obj, f, ensure_ascii=False, separators=(",", ":"))

    @classmethod
    def load(cls, path: str = DEFAULT_LM_PATH):
        with gzip.open(path, "rt", encoding="utf-8") as f:
            obj = json.load(f)
        grams = [{ctx: (tot_d[0], tot_d[1]) for ctx, tot_d in g.items()}
                 for g in obj["grams"]]
        return cls(grams, obj["V"])


_default = None


def default_lm() -> CharNgramLM:
    """The bundled domain LM (loaded once per process). Without the asset it
    is built from ``cjk_charset()`` at the defaults, which give the bundled
    file's counts; the build is not written into the JAX package's
    directory."""
    global _default
    if _default is None:
        if os.path.exists(DEFAULT_LM_PATH):
            _default = CharNgramLM.load(DEFAULT_LM_PATH)
        else:
            from twinvoice_tpu_torch.ocr.torchocr.charset import cjk_charset

            _default = CharNgramLM.build(cjk_charset())
    return _default
