"""Recognizer charsets, CTC decoders and field patterns: the port's own copy
of ``twinvoice_tpu/ocr/jaxocr/charset.py``.

The default covers the symbols on TW invoice *fields* (invoice numbers
[A-Z]{2}\\d{8}, western/ROC dates, integer amounts). Weights files embed
their charset string, so a loaded model always decodes with the alphabet it
was trained on; the bundled recognizer carries a CJK charset that way. The
decoders are host code, copied unchanged so the port decodes the same top-K
arrays to the same strings. ``cjk_charset`` reads the port's copy of the
stroke font (``twinvoice_tpu_torch.ocr.fonts``).
"""

from __future__ import annotations

import math
from typing import List

BLANK = 0
CHARSET = " 0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZ-./:,$#*()"  # index 1..len


class Charset:
    """Bidirectional char↔id table with CTC blank at id 0."""

    def __init__(self, chars: str = CHARSET):
        self.chars = chars
        self.num_classes = len(chars) + 1  # + blank
        self._to_id = {c: i + 1 for i, c in enumerate(chars)}
        self._to_char = {i + 1: c for i, c in enumerate(chars)}

    def encode_text(self, text: str) -> List[int]:
        """Text → label ids; unknown chars are dropped (not mapped to blank)."""
        return [self._to_id[c] for c in text.upper() if c in self._to_id]

    def decode_ids(self, ids) -> str:
        """CTC-collapsed ids → text (ids must already be collapsed/deduped)."""
        return "".join(self._to_char.get(int(i), "") for i in ids if int(i) != BLANK)

    def greedy_ctc_decode(self, class_ids) -> str:
        """Raw per-timestep argmax ids → text (collapse repeats, drop blanks)."""
        out = []
        prev = -1
        for i in class_ids:
            i = int(i)
            if i != prev and i != BLANK:
                out.append(i)
            prev = i
        return self.decode_ids(out)


DEFAULT = Charset(CHARSET)
NUM_CLASSES = DEFAULT.num_classes


# ------------------------------------------------------------------ patterns
#
# Format-constrained CTC decoding. TW invoice fields have rigid
# formats — [A-Z]{2}\d{8} invoice numbers, numeric dates, integer amounts
# — so instead of greedy argmax + regex repair, the decoder can run a
# Viterbi pass over the field's pattern automaton: every frame's
# probability mass is kept, and a frame where '0' narrowly beats 'O' in a
# letter slot still decodes to 'O'. This is the principled version of
# EasyOCR's `allowlist` (reference app_camera.py:824-833 relies on the
# pretrained model + post-regex instead).
#
# A pattern is a list of slots (allowed_chars, optional). Helpers below
# unroll (chars, min, max) repeat specs into optional-slot runs.

_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
_DIGITS = "0123456789"


def unroll_pattern(spec):
    """[(chars, min_rep, max_rep), ...] → [(chars, optional), ...]."""
    slots = []
    for chars, lo, hi in spec:
        slots += [(chars, False)] * lo + [(chars, True)] * (hi - lo)
    return slots


INVOICE_PATTERN = unroll_pattern(
    [(_LETTERS, 2, 2), ("-", 0, 1), (_DIGITS, 8, 8)]
)
DATE_PATTERN = unroll_pattern(
    # 20xx years only: a '2' misread as '1' in the year slot then still
    # decodes to '2' (fusion's date cleaner requires 20\d{2} anyway)
    [("2", 1, 1), ("0", 1, 1), (_DIGITS, 2, 2), ("-/.", 1, 1),
     (_DIGITS, 2, 2), ("-/.", 1, 1), (_DIGITS, 1, 2)]
)
# no leading zero/comma (amounts are positive integers in the domain)
AMOUNT_PATTERN = unroll_pattern(
    [("123456789", 1, 1), (_DIGITS + ",", 0, 8)]
)

FIELD_PATTERNS = {
    "invoice": INVOICE_PATTERN,
    "date": DATE_PATTERN,
    "amount": AMOUNT_PATTERN,
}


def cjk_charset() -> Charset:
    """ASCII field charset + every glyph the stroke font covers."""
    from twinvoice_tpu_torch.ocr.fonts import strokefont

    cjk = "".join(sorted(strokefont.coverage()))
    return Charset(CHARSET + cjk)


def _epsilon_targets(slots, s):
    """Emission positions reachable from slot s via optional-slot skips."""
    out = [s]
    j = s
    while j < len(slots) and slots[j][1]:
        j += 1
        out.append(j)
    return out


def _accepts(slots, s):
    """Can the automaton finish from slot position s (rest all optional)?"""
    return all(opt for _, opt in slots[s:])


def constrained_ctc_decode(charset: Charset, topk_ids, topk_logp, blank_logp,
                           slots, beam: int = 64):
    """Viterbi/beam decode of CTC frame posteriors against a slot pattern.

    ``topk_ids``/``topk_logp``: (T, K) per-frame top-K class ids and log
    probabilities; ``blank_logp``: (T,) exact blank log-prob per frame
    (blank may fall outside the top-K); ``slots``: [(allowed_chars,
    optional)] from :func:`unroll_pattern`.

    Returns ``(text, path_logp)`` for the best frame path whose emitted
    string matches the pattern, or ``(None, -inf)`` when no top-K path
    does. CTC semantics: repeats collapse unless separated by blank.
    """
    L = len(slots)
    allowed = [set(ch) for ch, _ in slots]
    # state: (slot_pos, last_emitted_id) -> (score, text)
    states = {(0, 0): (0.0, "")}
    T = len(topk_ids)
    for t in range(T):
        nxt = {}

        def push(key, sc, tx):
            cur = nxt.get(key)
            if cur is None or sc > cur[0]:
                nxt[key] = (sc, tx)

        b_lp = float(blank_logp[t])
        cands = [(int(i), float(lp))
                 for i, lp in zip(topk_ids[t], topk_logp[t])]
        for (s, last), (sc, tx) in states.items():
            push((s, 0), sc + b_lp, tx)  # blank frame
            for cid, lp in cands:
                if cid == 0:
                    continue  # blank handled exactly above
                if cid == last:
                    push((s, last), sc + lp, tx)  # repeat-collapse
                    continue
                ch = charset._to_char.get(cid)
                if ch is None:
                    continue
                for s2 in _epsilon_targets(slots, s):
                    if s2 < L and ch in allowed[s2]:
                        push((s2 + 1, cid), sc + lp, tx + ch)
        if len(nxt) > beam:
            nxt = dict(sorted(nxt.items(), key=lambda kv: -kv[1][0])[:beam])
        states = nxt
        if not states:
            return None, float("-inf")
    best, best_sc = None, float("-inf")
    for (s, _), (sc, tx) in states.items():
        if _accepts(slots, s) and sc > best_sc:
            best, best_sc = tx, sc
    return best, best_sc


def beam_ctc_decode(charset: Charset, topk_ids, topk_logp, blank_logp,
                    width: int = 8, lm=None, alpha: float = 0.4,
                    beta: float = 0.3, prune: float = 12.0,
                    alpha_cjk: float = 0.1):
    """CTC prefix beam search over per-frame top-K posteriors, optionally
    fused with a character language model.

    Unlike greedy argmax (one frame path), this sums probability over ALL
    frame paths that collapse to the same string, so a character whose
    mass is split across two frames — or a space competing with blank —
    is scored by its total evidence. Standard prefix beam search
    (Hannun et al. 2014). With ``lm`` (an object with
    ``logp(context_str, char) -> float``, see :mod:`.lm`) the beam adds
    shallow fusion: ``alpha * logp_lm`` per emitted char plus a length
    bonus ``beta`` — the domain's rigid field formats then disambiguate
    pure-vision ties like 0↔O. This is the principled version of what the
    reference gets from EasyOCR's pretrained implicit LM
    (app_camera.py:817-833).

    ``topk_ids``/``topk_logp``: (T, K) per-frame top-K class ids / log
    probs; ``blank_logp``: (T,) exact blank log prob (blank may fall
    outside the top-K). Returns ``(text, logp)`` of the best prefix
    (logp includes the LM term when fused).

    ``alpha_cjk``: the LM weight applied to CJK-character extensions
    (``ord(ch) > 0x2E00``) instead of ``alpha``. The 4-gram's value lives
    in the RIGID ASCII field formats (dates, ``[A-Z]{2}\\d{8}``, amounts);
    over CJK its mass concentrates on the vocabulary item names, so full-
    weight fusion pulls an uncertain but correctly-read random glyph
    toward a vocabulary glyph — measured on an earlier CJK model as
    mixed-tier beam 0.845 UNDER greedy 0.866 at ``alpha_cjk=alpha``. Down-weighting CJK fusion
    keeps the ASCII gains and removes the CJK penalty.

    ``prune``: per-frame candidates more than this many nats below the
    frame's best option are dropped, and frames whose best non-blank
    candidate trails blank by more than ``prune`` nats take a fast path
    that only advances the blank transition (the contribution such paths
    could make is ≤ e^-prune of a surviving beam — far below the width
    cutoff). Serving-path optimization (beam must be
    cheap enough to be the read_batch default); ~6× fewer dict ops on
    typical lines, where most frames are confident blanks.
    """
    NEG = float("-inf")

    def _lae(a, b):  # scalar logaddexp; ~10x faster than np.logaddexp here
        if a == NEG:
            return b
        if b == NEG:
            return a
        m = a if a > b else b
        return m + math.log1p(math.exp(-abs(a - b)))

    import numpy as np

    T = len(topk_ids)
    to_char = charset._to_char
    ids_a = np.asarray(topk_ids)
    lp_a = np.asarray(topk_logp, dtype=np.float64)
    blank_l = [float(b) for b in blank_logp]
    # beam value: [logp ending in blank, ending in char, lm score, lm ctx]
    beams = {(): [0.0, NEG, 0.0, "^"]}
    ctx_keep = (4 - 1) if lm is None else (getattr(lm, "order", 4) - 1)
    for t in range(T):
        b_lp = blank_l[t]
        row_lp = lp_a[t]
        best_lp_t = max(float(row_lp[0]), b_lp)
        floor = best_lp_t - prune
        cands = []
        for cid, lp in zip(ids_a[t], row_lp):
            lp = float(lp)
            if lp < floor:
                break  # top-K rows are sorted descending
            cid = int(cid)
            if cid != 0:
                ch = to_char.get(cid)
                if ch is not None:
                    cands.append((cid, lp, ch))
        if not cands:
            # pure-blank frame: every prefix keeps itself; scores shift by
            # b_lp and all mass moves to the blank-ended slot. No new
            # prefixes can appear, so update the dict in place.
            for e in beams.values():
                e[0] = _lae(e[0], e[1]) + b_lp
                e[1] = NEG
            continue
        nxt = {}

        def acc(prefix, slot, lp, lms, ctx):
            e = nxt.get(prefix)
            if e is None:
                nxt[prefix] = e = [NEG, NEG, lms, ctx]
            e[slot] = _lae(e[slot], lp)

        for prefix, (pb, pnb, lms, ctx) in beams.items():
            tot = _lae(pb, pnb)
            acc(prefix, 0, tot + b_lp, lms, ctx)  # blank keeps the prefix
            last = prefix[-1] if prefix else 0
            for cid, lp, ch in cands:
                ext_lms = lms
                if lm is not None and (cid != last or pb > NEG):
                    a = alpha_cjk if ord(ch) > 0x2E00 else alpha
                    ext_lms = lms + a * lm.logp(ctx, ch) + beta
                ext_ctx = (ctx + ch)[-ctx_keep:]
                if cid == last:
                    # same char again w/o blank collapses (stay on prefix);
                    # extending needs a blank-ended path
                    acc(prefix, 1, pnb + lp, lms, ctx)
                    if pb > NEG:
                        acc(prefix + (cid,), 1, pb + lp, ext_lms, ext_ctx)
                else:
                    acc(prefix + (cid,), 1, tot + lp, ext_lms, ext_ctx)
        if len(nxt) > width:
            beams = dict(sorted(
                nxt.items(),
                key=lambda kv: -(_lae(kv[1][0], kv[1][1]) + kv[1][2])
            )[:width])
        else:
            beams = nxt
    best, best_lp = (), NEG
    for prefix, (pb, pnb, lms, ctx) in beams.items():
        lp = _lae(pb, pnb) + lms
        if lm is not None:  # end-of-string LM term
            lp += alpha * lm.logp(ctx, "$")
        if lp > best_lp:
            best, best_lp = prefix, lp
    return charset.decode_ids(best), best_lp


# module-level functions kept for existing callers (default charset)
def encode_text(text: str) -> List[int]:
    return DEFAULT.encode_text(text)


def decode_ids(ids) -> str:
    return DEFAULT.decode_ids(ids)


def greedy_ctc_decode(class_ids) -> str:
    return DEFAULT.greedy_ctc_decode(class_ids)
