"""QR locator in numpy: one bounding box per QR code in a gray frame.

The port's counterpart of the part of ``cv2.QRCodeDetector`` that the JAX
scan uses (``detectMulti``, then ``detect``): a uint8 gray frame in, boxes
``(x1, y1, x2, y2)`` out, each the box of a code's four outer corners (the
quiet zone left out), cast to int and clipped to the frame, as the JAX
``_detect_gray`` takes them of cv2's quads.

It follows the finder search of the in-repo decoder (``native/qrdecode.cpp``)
on the whole frame at once:

1. binarize against a local mean over an integral image (``binarize``,
   uneven photo light);
2. run-length encode every row and keep each window of five runs,
   dark-light-dark-light-dark, in the ratio 1:1:3:1:1 (``ratio_ok``);
3. cross-check each such centre on the column through it (``cross_check``)
   and on the diagonal (``cross_check_diag``), through the run lengths of
   the whole frame's columns and of a stretch of each diagonal;
4. cluster the checked centres into finders, each with a module size and a
   vote count (``find_finders``);
5. group finders three by three into codes with ``decode_pass``'s geometry
   prefilter (module sizes within 1.6×, legs within ~1.5×, a corner near
   90°, legs of at least 10 modules) and a read of both timing patterns
   (three finders of two codes side by side pass the prefilter now and
   then), each finder in at most one code, the codes taken greedily by
   votes;
6. make each box: the version is read off the legs (17 + 4v modules), and
   each corner goes 3.5 modules out of its finder centre along the code's
   axes (the fourth centre is ``tr + bl − tl``).

Coordinates are continuous: pixel ``(y, x)`` covers ``[x, x+1) × [y, y+1)``.
"""

from __future__ import annotations

import itertools
from typing import List, NamedTuple, Tuple

import numpy as np

Box = Tuple[int, int, int, int]

_RATIO_TOL = 0.65       # ratio_ok's tolerance, in modules
_MERGE_POS = 3.0        # a centre joins a finder within 3 modules of it ...
_MERGE_MODULE = 0.35    # ... whose module size is within 35% of its own
_MAX_FINDERS = 24       # the best-voted finders grouped into codes


class Finder(NamedTuple):
    x: float
    y: float
    module: float
    votes: int


def binarize(gray: np.ndarray) -> np.ndarray:
    """uint8 (H, W) → bool (H, W), True where dark: ``pixel < 0.85·mean +
    8`` against the mean of a ``max(15, min(H, W)/16)``-pixel window (odd),
    clipped at the frame, as the native decoder's unsmoothed pass."""
    h, w = gray.shape
    win = max(15, min(h, w) // 16) | 1
    r = win // 2
    g = gray.astype(np.int32)
    y0, y1 = np.clip(np.arange(h) - r, 0, h), np.clip(np.arange(h) + r + 1, 0, h)
    x0, x1 = np.clip(np.arange(w) - r, 0, w), np.clip(np.arange(w) + r + 1, 0, w)
    cum = np.zeros((h + 1, w), np.int32)
    np.cumsum(g, axis=0, out=cum[1:])
    cols = cum[y1] - cum[y0]  # each pixel's window column sums
    cum = np.zeros((h, w + 1), np.int32)
    np.cumsum(cols, axis=1, out=cum[:, 1:])
    area = (y1 - y0)[:, None] * (x1 - x0)[None, :]
    mean = (cum[:, x1] - cum[:, x0]) // area
    return g * 20 < mean * 17 + 160


class _Runs(NamedTuple):
    line: np.ndarray    # the row (or column) of each run
    start: np.ndarray   # its first pixel along the line
    length: np.ndarray
    dark: np.ndarray    # bool
    first: np.ndarray   # (lines, L): True where a run starts

    def index(self, line, pos):
        """The run that holds pixel ``pos`` of ``line``."""
        at = np.cumsum(self.first.ravel()) - 1
        return at[line * self.first.shape[1] + pos]


def _runs(bits: np.ndarray) -> _Runs:
    """Every line's runs of equal bits, numbered in line order."""
    n, length = bits.shape
    first = np.ones((n, length), bool)
    first[:, 1:] = bits[:, 1:] != bits[:, :-1]
    line, start = np.nonzero(first)
    end = np.empty_like(start)
    end[:-1] = start[1:]
    end[-1] = length
    last = np.ones(len(start), bool)
    last[:-1] = line[1:] != line[:-1]
    end[last] = length
    return _Runs(line, start, end - start, bits[line, start], first)


def _ratio_ok(r: np.ndarray) -> np.ndarray:
    """(n, 5) run lengths → bool (n,): 1:1:3:1:1 within 0.65 of a module
    (``qrdecode.cpp:ratio_ok``)."""
    total = r.sum(axis=1)
    m = total / 7.0
    tol = m * _RATIO_TOL
    ok = total >= 7
    for k, w in enumerate((1, 1, 3, 1, 1)):
        ok &= np.abs(r[:, k] - w * m) < w * tol
    return ok


def _windows(runs: _Runs, i: np.ndarray):
    """Five runs centred on each run index in ``i`` (i−2 … i+2) on the same
    line, dark in the middle → (valid mask, (n, 5) lengths)."""
    n = len(runs.start)
    lo, hi = i - 2, i + 2
    ok = (lo >= 0) & (hi < n)
    lo_c, hi_c = np.clip(lo, 0, n - 1), np.clip(hi, 0, n - 1)
    ok &= (runs.line[lo_c] == runs.line[i]) & (runs.line[hi_c] == runs.line[i])
    ok &= runs.dark[i]
    idx = np.clip(i[:, None] + np.arange(-2, 3)[None, :], 0, n - 1)
    return ok, runs.length[idx]


def finder_candidates(bits: np.ndarray) -> np.ndarray:
    """Centres that pass the 1:1:3:1:1 test along their row and along the
    column through them → (n, 3) float: x, y, module (the smaller of the two
    cuts' estimates)."""
    rows = _runs(bits)
    core = np.nonzero(rows.dark)[0]
    ok, r = _windows(rows, core)
    core, r = core[ok], r[ok]
    keep = _ratio_ok(r)
    core, r = core[keep], r[keep]
    if not len(core):
        return np.zeros((0, 3))
    cx = rows.start[core] + rows.length[core] / 2.0
    y = rows.line[core]
    mod_h = r.sum(axis=1) / 7.0
    cols = _runs(np.ascontiguousarray(bits.T))
    ci = cols.index(np.minimum(cx.astype(np.int64), bits.shape[1] - 1), y)
    ok, rv = _windows(cols, ci)
    ok &= _ratio_ok(rv)
    if not ok.any():
        return np.zeros((0, 3))
    ci, rv, cx, mod_h = ci[ok], rv[ok], cx[ok], mod_h[ok]
    cy = cols.start[ci] + cols.length[ci] / 2.0
    mod = np.minimum(mod_h, rv.sum(axis=1) / 7.0)
    ok, mod_d = _diagonal_check(bits, cx.astype(np.int64), np.floor(cy).astype(np.int64), mod)
    mod = np.minimum(mod, mod_d)
    return np.stack([cx, cy, mod], axis=1)[ok]


def _diagonal_check(bits: np.ndarray, x: np.ndarray, y: np.ndarray, module: np.ndarray):
    """The 1:1:3:1:1 test on the down-right diagonal through each pixel
    ``(y, x)`` (``cross_check_diag``: a finder's concentric squares show the
    ratio on every cut through the centre, data modules seldom on all three),
    on a stretch of ±6 modules of it → (ok, module: the diagonal's length
    over 7, times √2)."""
    h, w = bits.shape
    reach = int(np.ceil(6 * module.max())) + 2
    t = np.arange(-reach, reach + 1)
    yy, xx = y[:, None] + t[None, :], x[:, None] + t[None, :]
    inside = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
    seg = bits[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)] & inside
    diag = _runs(seg)
    ok, r = _windows(diag, diag.index(np.arange(len(x)), reach))
    ok &= _ratio_ok(r)
    return ok, r.sum(axis=1) * np.sqrt(2.0) / 7.0


def find_finders(bits: np.ndarray) -> List[Finder]:
    """Cluster the checked centres: a centre joins the first finder within
    3 modules of it in x and y whose module size is within 35%, which takes
    the running mean of its members (``qrdecode.cpp:find_finders``)."""
    acc: List[list] = []  # [sum x, sum y, sum module, votes]
    for cx, cy, m in finder_candidates(bits):
        for f in acc:
            n = f[3]
            fx, fy, fm = f[0] / n, f[1] / n, f[2] / n
            if abs(fx - cx) < _MERGE_POS * m and abs(fy - cy) < _MERGE_POS * m and (
                    abs(fm - m) < _MERGE_MODULE * m):
                f[0] += cx
                f[1] += cy
                f[2] += m
                f[3] += 1
                break
        else:
            acc.append([cx, cy, m, 1])
    return [Finder(sx / n, sy / n, sm / n, n) for sx, sy, sm, n in acc]


def _triple_ok(a: Finder, b: Finder, c: Finder) -> bool:
    """``decode_pass``'s geometry prefilter of three finder centres."""
    mods = (a.module, b.module, c.module)
    if max(mods) > 1.6 * min(mods):
        return False
    d2 = sorted(((p.x - q.x) ** 2 + (p.y - q.y) ** 2) for p, q in ((a, b), (a, c), (b, c)))
    l2, l1, hyp = d2
    if l2 < 1e-9 or l1 > 2.2 * l2:
        return False  # legs within ~1.5×
    if hyp < 0.6 * (l1 + l2) or hyp > 1.5 * (l1 + l2):
        return False  # corner angle far from 90°
    m = sum(mods) / 3.0
    return l2 >= (10.0 * m) ** 2  # closer than any legal version allows


def _orient(a: Finder, b: Finder, c: Finder):
    """→ (tl, tr, bl): tl faces the longest side; tr and bl by the sign of
    the cross product, as ``decode_triple``."""
    pts = (a, b, c)
    d = [((pts[i].x - pts[j].x) ** 2 + (pts[i].y - pts[j].y) ** 2, k)
         for k, (i, j) in enumerate(((1, 2), (0, 2), (0, 1)))]
    tl = pts[max(d)[1]]
    p, q = [f for f in pts if f is not tl]
    cross = (p.x - tl.x) * (q.y - tl.y) - (p.y - tl.y) * (q.x - tl.x)
    return (tl, p, q) if cross > 0 else (tl, q, p)


def code_side(tl: Finder, tr: Finder, bl: Finder) -> int:
    """The code's side in modules, 17 + 4v, read off its mean leg: the
    finder centres sit 3.5 modules in from the corners."""
    legs = (np.hypot(tr.x - tl.x, tr.y - tl.y) + np.hypot(bl.x - tl.x, bl.y - tl.y)) / 2
    m = (tl.module + tr.module + bl.module) / 3.0
    return 17 + 4 * int(np.clip(round((legs / m + 7 - 17) / 4.0), 1, 40))


def _module_point(tl: Finder, tr: Finder, bl: Finder, side: int, u, v):
    """Module coordinates (u along tl→tr, v along tl→bl; a finder centre is
    3.5 modules in) → pixel coordinates, on the parallelogram of the three
    centres."""
    k = side - 7.0
    return (tl.x + (u - 3.5) / k * (tr.x - tl.x) + (v - 3.5) / k * (bl.x - tl.x),
            tl.y + (u - 3.5) / k * (tr.y - tl.y) + (v - 3.5) / k * (bl.y - tl.y))


def _timing_ok(bits: np.ndarray, tl: Finder, tr: Finder, bl: Finder, side: int) -> bool:
    """Both timing patterns (row 6 and column 6, modules 8 … side − 9,
    dark on even modules) read back at 3/4 of their module centres or more:
    three finders of two different codes pass the geometry prefilter now
    and then, their timing lines almost never."""
    h, w = bits.shape
    t = np.arange(8, side - 8) + 0.5
    want = (np.arange(8, side - 8) % 2) == 0
    for u, v in ((t, np.full_like(t, 6.5)), (np.full_like(t, 6.5), t)):
        x, y = _module_point(tl, tr, bl, side, u, v)
        x, y = np.floor(x).astype(np.int64), np.floor(y).astype(np.int64)
        inside = (x >= 0) & (x < w) & (y >= 0) & (y < h)
        got = bits[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)] & inside
        if np.mean(got == want) < 0.75:
            return False
    return True


def code_corners(tl: Finder, tr: Finder, bl: Finder, side: int) -> np.ndarray:
    """The four outer corners (4, 2) of the code whose finder centres these
    are: each 3.5 modules out of its finder centre along the code's axes
    (the fourth centre is ``tr + bl − tl``)."""
    return np.array([_module_point(tl, tr, bl, side, u, v)
                     for u, v in ((0, 0), (side, 0), (0, side), (side, side))])


def group_codes(bits: np.ndarray, finders: List[Finder]):
    """Finders → codes (tl, tr, bl, side): the finders of two or more votes
    (all of them when fewer than three have two), the best-voted 24 of them,
    every triple that passes the prefilter and whose timing patterns read
    back, taken by total votes with each finder in at most one code."""
    fs = [f for f in finders if f.votes >= 2]
    if len(fs) < 3:
        fs = list(finders)
    fs = sorted(fs, key=lambda f: -f.votes)[:_MAX_FINDERS]
    triples = [t for t in itertools.combinations(range(len(fs)), 3)
               if _triple_ok(*(fs[i] for i in t))]
    triples.sort(key=lambda t: -sum(fs[i].votes for i in t))
    used, codes = set(), []
    for t in triples:
        if not used.isdisjoint(t):
            continue
        tl, tr, bl = _orient(*(fs[i] for i in t))
        side = code_side(tl, tr, bl)
        if _timing_ok(bits, tl, tr, bl, side):
            used.update(t)
            codes.append((tl, tr, bl, side))
    return codes


def locate_qr_boxes(gray: np.ndarray) -> List[Box]:
    """uint8 (H, W) → one box ``(x1, y1, x2, y2)`` per QR code found: the
    bounding box of its four outer corners, each coordinate cast to int and
    clipped to the frame; boxes with no area are dropped."""
    h, w = gray.shape
    if h < 21 or w < 21:
        return []
    boxes = []
    bits = binarize(gray)
    for tl, tr, bl, side in group_codes(bits, find_finders(bits)):
        c = code_corners(tl, tr, bl, side)
        x1, y1 = (int(min(max(v, 0), lim)) for v, lim in zip(c.min(axis=0), (w, h)))
        x2, y2 = (int(min(max(v, 0), lim)) for v, lim in zip(c.max(axis=0), (w, h)))
        if x2 > x1 and y2 > y1:
            boxes.append((x1, y1, x2, y2))
    return boxes
