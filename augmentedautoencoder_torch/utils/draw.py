"""OpenCV-free drawing and labelling on the host (numpy, scipy).

The JAX package draws its overlays and finds its detector's blobs with
OpenCV; the port's machines need not have it. Each function here gives
OpenCV 5.0's pixels for uint8 images of 1 or 3 channels:

  * `line(img, p0, p1, color, thickness)` -- `cv2.line` (LINE_8): the
    Bresenham walk of `cv::LineIterator` for thickness 1; for thickness >= 2
    the segment clipped to the image grown by the thickness, then the 16.16
    fixed-point quadrilateral of `ThickLine`, its edges (`Line2`), its scan
    fill (`FillConvexPoly`) and the filled end circles (`Circle`);
  * `rectangle(img, p0, p1, color, thickness)` -- `cv2.rectangle`, the
    closed polyline of its 4 corners;
  * `morph_open3x3(mask)` -- `cv2.morphologyEx(mask, MORPH_OPEN, 3x3)`,
    whose border never erodes or dilates (a min then a max filter over the
    edge-replicated image);
  * `connected_components(mask)` and `connected_components_stats(mask)` --
    the labels and the stats of `cv2.connectedComponentsWithStats(mask, 8)`,
    components numbered in OpenCV's order: by each component's first pixel
    in a scan over two-row strips, key (row // 2, column, row % 2);
  * `text_size(text, scale, thickness)` -- `cv2.getTextSize` for
    FONT_HERSHEY_SIMPLEX, which OpenCV 5 renders in its built-in Rubik
    TrueType font (weight 400 for thickness <= 1, else 600): the size in
    pixels round(scale * 1000 / 37), each glyph's advance floored to whole
    font units, scaled by size / 935 (the ascender), rounded to 1/64 px and
    floored to pixels; width = sum + 1, height = size, baseline = the
    largest of the glyphs' baselines, tabulated from OpenCV up to 320 px
    (scale 11.8), above that the deepest descender rounded up;
  * `put_text(img, text, org, scale, color, thickness)` -- draws the same
    glyphs from OpenCV's own 27 px rendering of that font (`utils/_glyphs.py`,
    made by `scripts/make_text_glyphs.py`) resampled to the size, hard-edged
    where OpenCV antialiases, so its pixels differ from `cv2.putText`'s;
    every pixel it sets lies inside the box `text_size` gives at `org`.

Colors are a scalar or a tuple whose first channels are used, as in cv2.
Drawing functions modify `img` in place and return it.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence, Tuple

import numpy as np

XY_SHIFT = 16
XY_ONE = 1 << XY_SHIFT
_HALF = XY_ONE >> 1


def _cdiv(a: int, b: int) -> int:
    """C integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return q if (a >= 0) == (b >= 0) else -q


def _color_of(img: np.ndarray, color) -> np.ndarray:
    channels = 1 if img.ndim == 2 else img.shape[2]
    c = np.atleast_1d(np.asarray(color, dtype=np.float64))
    c = np.concatenate([c, np.zeros(max(0, channels - c.size))])[:channels]
    return np.clip(np.round(c), 0, 255).astype(np.uint8)


def _check_image(img: np.ndarray) -> None:
    if not isinstance(img, np.ndarray) or img.dtype != np.uint8:
        raise TypeError("draw takes uint8 numpy images")
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] in (1, 3))):
        raise ValueError(f"draw takes (H, W), (H, W, 1) or (H, W, 3) images, got {img.shape}")


def _paint(img: np.ndarray, mask: np.ndarray, color) -> np.ndarray:
    c = _color_of(img, color)
    img[mask] = c if img.ndim == 3 else c[0]
    return img


def clip_line(width: int, height: int, x1: int, y1: int, x2: int, y2: int):
    """`cv::clipLine` on 64-bit points: the clipped segment, or None when it
    misses the [0, width) x [0, height) rectangle."""
    if width <= 0 or height <= 0:
        return None
    right, bottom = width - 1, height - 1
    c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8
    c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8
    if (c1 & c2) == 0 and (c1 | c2) != 0:
        if c1 & 12:
            a = 0 if c1 < 8 else bottom
            x1 += int(float(a - y1) * float(x2 - x1) / float(y2 - y1))
            y1 = a
            c1 = (x1 < 0) + (x1 > right) * 2
        if c2 & 12:
            a = 0 if c2 < 8 else bottom
            x2 += int(float(a - y2) * float(x2 - x1) / float(y2 - y1))
            y2 = a
            c2 = (x2 < 0) + (x2 > right) * 2
        if (c1 & c2) == 0 and (c1 | c2) != 0:
            if c1:
                a = 0 if c1 == 1 else right
                y1 += int(float(a - x1) * float(y2 - y1) / float(x2 - x1))
                x1 = a
                c1 = 0
            if c2:
                a = 0 if c2 == 1 else right
                y2 += int(float(a - x2) * float(y2 - y1) / float(x2 - x1))
                x2 = a
                c2 = 0
    if c1 | c2:
        return None
    return x1, y1, x2, y2


def _line8(mask: np.ndarray, x1: int, y1: int, x2: int, y2: int) -> None:
    """`cv::LineIterator(img, p1, p2, 8, leftToRight=true)` over the mask."""
    h, w = mask.shape
    if not (0 <= x1 < w and 0 <= x2 < w and 0 <= y1 < h and 0 <= y2 < h):
        clipped = clip_line(w, h, x1, y1, x2, y2)
        if clipped is None:
            return
        x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if dx < 0:  # left to right
        dx, dy = -dx, -dy
        x1, y1 = x2, y2
    step_y = 1
    if dy < 0:
        dy, step_y = -dy, -1
    vert = dy > dx
    if vert:
        dx, dy = dy, dx
    n = dx + 1
    # err_k before step k: dx - 2dy - 2dy*k + 2dx*(#minor steps so far)
    major = np.arange(n)
    minor = np.zeros(n, np.int64)
    err = dx - 2 * dy
    m = 0
    for k in range(1, n):
        if err < 0:
            err += 2 * dx
            m += 1
        err -= 2 * dy
        minor[k] = m
    if vert:
        mask[y1 + step_y * major, x1 + minor] = True
    else:
        mask[y1 + step_y * minor, x1 + major] = True


def _line2(mask: np.ndarray, p1: Tuple[int, int], p2: Tuple[int, int]) -> None:
    """OpenCV's `Line2`: the Bresenham walk of a 16.16 fixed-point segment
    (the outline of `FillConvexPoly`)."""
    h, w = mask.shape
    clipped = clip_line(w << XY_SHIFT, h << XY_SHIFT, p1[0], p1[1], p2[0], p2[1])
    if clipped is None:
        return
    x1, y1, x2, y2 = clipped
    dx, dy = x2 - x1, y2 - y1
    if abs(dx) > abs(dy):
        if dx < 0:
            dy = -dy
            x1, y1, x2, y2 = x2, y2, x1, y1
        y_step = _cdiv(dy << XY_SHIFT, abs(dx) | 1)
        k = np.arange(((x2 - x1) >> XY_SHIFT) + 1, dtype=np.int64)
        xs = ((x1 + _HALF) >> XY_SHIFT) + k
        ys = (y1 + _HALF + k * y_step) >> XY_SHIFT
    else:
        if dy < 0:
            dx = -dx
            x1, y1, x2, y2 = x2, y2, x1, y1
        x_step = _cdiv(dx << XY_SHIFT, abs(dy) | 1)
        k = np.arange(((y2 - y1) >> XY_SHIFT) + 1, dtype=np.int64)
        xs = (x1 + _HALF + k * x_step) >> XY_SHIFT
        ys = ((y1 + _HALF) >> XY_SHIFT) + k
    xs = np.append(xs, (x2 + _HALF) >> XY_SHIFT)
    ys = np.append(ys, (y2 + _HALF) >> XY_SHIFT)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    mask[ys[keep], xs[keep]] = True


def _hline(mask: np.ndarray, y: int, xl: int, xr: int) -> None:
    mask[y, xl:xr + 1] = True


def _fill_convex_poly(mask: np.ndarray, v: Sequence[Tuple[int, int]]) -> None:
    """OpenCV's `FillConvexPoly` for 16.16 points (shift XY_SHIFT, LINE_8):
    the outline by `Line2`, then the scanline fill."""
    h, w = mask.shape
    npts = len(v)
    delta = _HALF
    p0 = v[npts - 1]
    xmin = xmax = v[0][0]
    ymin = ymax = v[0][1]
    imin = 0
    for i in range(npts):
        p = v[i]
        if p[1] < ymin:
            ymin = p[1]
            imin = i
        ymax = max(ymax, p[1])
        xmax = max(xmax, p[0])
        xmin = min(xmin, p[0])
        _line2(mask, p0, p)
        p0 = p
    xmin = (xmin + delta) >> XY_SHIFT
    xmax = (xmax + delta) >> XY_SHIFT
    ymin = (ymin + delta) >> XY_SHIFT
    ymax = (ymax + delta) >> XY_SHIFT
    if npts < 3 or xmax < 0 or ymax < 0 or xmin >= w or ymin >= h:
        return
    ymax = min(ymax, h - 1)
    edges = npts
    e_idx = [imin, imin]
    e_di = [1, npts - 1]
    e_x = [-XY_ONE, -XY_ONE]
    e_dx = [0, 0]
    e_ye = [ymin, ymin]
    y = ymin
    while True:
        for i in range(2):
            if y >= e_ye[i]:
                idx0 = e_idx[i]
                di = e_di[i]
                idx = idx0 + di
                if idx >= npts:
                    idx -= npts
                while True:
                    edges -= 1
                    if edges < 0:
                        break
                    ty = (v[idx][1] + delta) >> XY_SHIFT
                    if ty > y:
                        xs = v[idx0][0]
                        xe = v[idx][0]
                        e_ye[i] = ty
                        e_dx[i] = _cdiv((xe - xs) * 2 + (ty - y), 2 * (ty - y))
                        e_x[i] = xs
                        e_idx[i] = idx
                        break
                    idx0 = idx
                    idx += di
                    if idx >= npts:
                        idx -= npts
        if edges < 0:
            break
        if y >= 0:
            left, right = (1, 0) if e_x[0] > e_x[1] else (0, 1)
            xx1 = (e_x[left] + _HALF) >> XY_SHIFT
            xx2 = (e_x[right] + _HALF) >> XY_SHIFT
            if xx2 >= 0 and xx1 < w:
                _hline(mask, y, max(xx1, 0), min(xx2, w - 1))
        e_x[0] += e_dx[0]
        e_x[1] += e_dx[1]
        y += 1
        if y > ymax:
            break


def _fill_circle(mask: np.ndarray, cx: int, cy: int, radius: int) -> None:
    """OpenCV's `Circle(..., fill=1)`: the union of its horizontal spans."""
    h, w = mask.shape
    err, dx, dy, plus, minus = 0, radius, 0, 1, (radius << 1) - 1
    while dx >= dy:
        for yy, xl, xr in ((cy - dy, cx - dx, cx + dx), (cy + dy, cx - dx, cx + dx),
                           (cy - dx, cx - dy, cx + dy), (cy + dx, cx - dy, cx + dy)):
            if 0 <= yy < h and xl < w and xr >= 0:
                _hline(mask, yy, max(xl, 0), min(xr, w - 1))
        dy += 1
        err += plus
        plus += 2
        m = -1 if err > 0 else 0  # (err <= 0) - 1
        err -= minus & m
        dx += m
        minus -= m & 2


def _thick_line(mask: np.ndarray, p0: Tuple[int, int], p1: Tuple[int, int], thickness: int,
                flags: int) -> None:
    """OpenCV's `ThickLine` for integer end points (shift 0), LINE_8."""
    x0, y0 = p0[0] << XY_SHIFT, p0[1] << XY_SHIFT
    x1, y1 = p1[0] << XY_SHIFT, p1[1] << XY_SHIFT
    if thickness <= 1:
        _line8(mask, (x0 + _HALF) >> XY_SHIFT, (y0 + _HALF) >> XY_SHIFT,
               (x1 + _HALF) >> XY_SHIFT, (y1 + _HALF) >> XY_SHIFT)
        return
    dx = (x0 - x1) / XY_ONE
    dy = (y1 - y0) / XY_ONE
    r = dx * dx + dy * dy
    odd = thickness & 1
    thickness <<= XY_SHIFT - 1
    if abs(r) > np.finfo(np.float64).eps:
        r = (thickness + odd * XY_ONE * 0.5) / math.sqrt(r)
        dpx = round(dy * r)
        dpy = round(dx * r)
        _fill_convex_poly(mask, [(x0 + dpx, y0 + dpy), (x0 - dpx, y0 - dpy),
                                 (x1 - dpx, y1 - dpy), (x1 + dpx, y1 + dpy)])
    radius = (thickness + _HALF) >> XY_SHIFT
    for i, (x, y) in enumerate(((x0, y0), (x1, y1))):
        if flags & (i + 1):
            _fill_circle(mask, (x + _HALF) >> XY_SHIFT, (y + _HALF) >> XY_SHIFT, radius)


def _int_point(p) -> Tuple[int, int]:
    return int(p[0]), int(p[1])


def line(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """`cv2.line(img, p0, p1, color, thickness)` (LINE_8, shift 0)."""
    _check_image(img)
    if not 0 < thickness <= 32767:
        raise ValueError(f"line thickness must be in 1..32767, got {thickness}")
    mask = np.zeros(img.shape[:2], bool)
    (x0, y0), (x1, y1) = _int_point(p0), _int_point(p1)
    if thickness > 1:
        # OpenCV 5 first clips a thick segment to the image grown by the
        # thickness on every side (`cv::clipLine`), caps included
        t = int(thickness)
        h, w = mask.shape
        clipped = clip_line(w + 2 * t, h + 2 * t, x0 + t, y0 + t, x1 + t, y1 + t)
        if clipped is None:
            return img
        x0, y0, x1, y1 = (v - t for v in clipped)
    _thick_line(mask, (x0, y0), (x1, y1), int(thickness), 3)
    return _paint(img, mask, color)


def rectangle(img: np.ndarray, p0, p1, color, thickness: int = 1) -> np.ndarray:
    """`cv2.rectangle(img, p0, p1, color, thickness)` (LINE_8, thickness >= 1)."""
    _check_image(img)
    if not 0 < thickness <= 32767:
        raise ValueError(f"rectangle thickness must be in 1..32767, got {thickness}")
    (x0, y0), (x1, y1) = _int_point(p0), _int_point(p1)
    corners = [(x0, y0), (x1, y0), (x1, y1), (x0, y1)]
    mask = np.zeros(img.shape[:2], bool)
    prev = corners[3]
    for p in corners:  # PolyLine, closed: a round cap at each segment's end
        _thick_line(mask, prev, p, int(thickness), 2)
        prev = p
    return _paint(img, mask, color)


def morph_open3x3(mask: np.ndarray) -> np.ndarray:
    """`cv2.morphologyEx(mask, cv2.MORPH_OPEN, np.ones((3, 3), np.uint8))`:
    erosion then dilation by the 3x3 square, the border replicated (OpenCV's
    default morphology border leaves edge pixels to their in-image
    neighbours)."""
    from scipy import ndimage

    m = np.asarray(mask)
    return ndimage.maximum_filter(ndimage.minimum_filter(m, size=3, mode="nearest"), size=3, mode="nearest")


def _components_in_cv2_order(mask: np.ndarray):
    """scipy's 8-connected labels of mask != 0 (raw, 1..n_fg), each raw
    component's box (`find_objects`, label k at k - 1) and the raw labels
    less one in OpenCV's order: by each component's first pixel in a scan
    over two-row strips, key (row // 2, column, row % 2), which lies in the
    strip of the component's top row."""
    from scipy import ndimage

    fg = np.asarray(mask) != 0
    if fg.ndim != 2:
        raise ValueError(f"connected components take a 2-D mask, got {fg.shape}")
    w = fg.shape[1]
    raw, n_fg = ndimage.label(fg, structure=np.ones((3, 3), bool))
    raw_boxes = ndimage.find_objects(raw)
    first = np.zeros(n_fg, np.int64)
    for k, (ys, xs) in enumerate(raw_boxes):
        top = ys.start - ys.start % 2
        r, c = np.nonzero(raw[top:top + 2, xs] == k + 1)
        first[k] = (top // 2) * (2 * w) + int((2 * (c + xs.start) + r).min())
    return fg, raw, raw_boxes, np.argsort(first, kind="stable")


def connected_components(mask: np.ndarray):
    """`cv2.connectedComponents(mask, connectivity=8)` -> (n, labels int32),
    label 0 the background, components numbered in OpenCV's order."""
    _, raw, _, order = _components_in_cv2_order(mask)
    n = len(order) + 1
    new_of_raw = np.zeros(n, np.int32)
    new_of_raw[1 + order] = np.arange(1, n, dtype=np.int32)
    return n, new_of_raw[raw]


def connected_components_stats(mask: np.ndarray) -> np.ndarray:
    """The `stats` of `cv2.connectedComponentsWithStats(mask, 8)`: int32
    (n, 5) rows of x, y, w, h, area, row 0 the background, then the
    components in OpenCV's order (the labels of `connected_components`)."""
    fg, raw, raw_boxes, order = _components_in_cv2_order(mask)
    area = np.bincount(raw.ravel(), minlength=len(order) + 1)
    stats = np.zeros((len(order) + 1, 5), np.int32)
    if area[0]:
        rows, cols = np.nonzero((~fg).any(axis=1))[0], np.nonzero((~fg).any(axis=0))[0]
        stats[0] = (cols[0], rows[0], cols[-1] + 1 - cols[0], rows[-1] + 1 - rows[0], area[0])
    else:
        stats[0] = (-1, np.iinfo(np.int32).max, 0, 0, 0)  # OpenCV's row for an empty background
    for k, raw_k in enumerate(order, start=1):
        ys, xs = raw_boxes[raw_k]
        stats[k] = (xs.start, ys.start, xs.stop - xs.start, ys.stop - ys.start, area[raw_k + 1])
    return stats


# -- text -----------------------------------------------------------------

def _text_weight(thickness: int) -> int:
    return 400 if thickness <= 1 else 600


def _glyph_table(thickness: int):
    from . import _glyphs

    return _glyphs.table(_text_weight(thickness))


def text_pixel_size(scale: float) -> int:
    """The font's pixel size (its ascender) at `scale`."""
    return int(math.floor(scale * 1000.0 / 37.0 + 0.5))


_ASCENDER = 935  # the font's ascender in font units: `size` pixels


def _steps(text: str, size: int, advances) -> list:
    """Each glyph's advance in whole pixels (floored from 1/64 px)."""
    out = []
    for ch in text:
        if ch not in advances:
            raise ValueError(f"text draws printable ASCII only, got {ch!r}")
        out.append(int(math.floor(advances[ch] * size * 64 / _ASCENDER + 0.5)) >> 6)
    return out


def text_size(text: str, scale: float, thickness: int = 1) -> Tuple[Tuple[int, int], int]:
    """`cv2.getTextSize(text, cv2.FONT_HERSHEY_SIMPLEX, scale, thickness)`:
    ((width, height), baseline)."""
    if not text:
        return (0, 0), 0
    tab = _glyph_table(thickness)
    size = text_pixel_size(scale)
    width = sum(_steps(text, size, tab.advance)) + 1
    if 0 < size <= tab.max_size:  # OpenCV's baselines, tabulated per glyph
        baseline = max(tab.baseline[ch][size - 1] if ch in tab.baseline else 0 for ch in text)
    else:  # the deepest descender, rounded up
        depth = max(-tab.ymin[ch] * size / _ASCENDER for ch in text)
        baseline = max(0, int(math.ceil(depth - 0.01)))
    return (width, size), baseline


@functools.lru_cache(maxsize=None)
def _glyph_ink(weight: int, ch: str, size: int):
    """(ink bool (h, w), x0, y0): the pixels OpenCV's glyph covers by half or
    more at `size` px, its top-left corner relative to the pen on the
    baseline. The table's 27 px coverage sampled bilinearly at each pixel's
    centre, or where `size` is smaller, averaged over 4 x 4 samples of the
    pixel's footprint."""
    from . import _glyphs

    cov, gx0, gy0 = _glyphs.table(weight).coverage(ch)
    if not cov.size:
        return np.zeros((0, 0), bool), 0, 0
    gh, gw = cov.shape
    ratio = _glyphs.REF_SIZE / size  # reference px per px
    k = 1 if ratio <= 1 else 4
    tx0, ty0 = int(math.floor(gx0 / ratio)) - 1, int(math.floor(gy0 / ratio)) - 1
    tx1, ty1 = int(math.ceil((gx0 + gw) / ratio)) + 1, int(math.ceil((gy0 + gh) / ratio)) + 1
    sub = (np.arange(k) + 0.5) / k
    padded = np.pad(cov, 1)

    def taps(t0, t1, g0, n):  # sample points in `padded`'s pixel-centre frame
        f = ((np.arange(t0, t1)[:, None] + sub) * ratio).ravel() - g0 + 0.5
        f = np.clip(f, 0, n + 1 - 1e-9)
        i = np.floor(f).astype(np.int64)
        return i, f - i

    ix, wx = taps(tx0, tx1, gx0, gw)
    iy, wy = taps(ty0, ty1, gy0, gh)
    v = (padded[np.ix_(iy, ix)] * np.outer(1 - wy, 1 - wx) + padded[np.ix_(iy + 1, ix)] * np.outer(wy, 1 - wx)
         + padded[np.ix_(iy, ix + 1)] * np.outer(1 - wy, wx) + padded[np.ix_(iy + 1, ix + 1)] * np.outer(wy, wx))
    v = v.reshape(ty1 - ty0, k, tx1 - tx0, k).mean(axis=(1, 3))
    return v >= 128 / 255, tx0, ty0


def put_text(img: np.ndarray, text: str, org, scale: float, color, thickness: int = 1) -> np.ndarray:
    """Text in the glyphs of `cv2.putText(img, text, org,
    FONT_HERSHEY_SIMPLEX, scale, color, thickness)`, at the same pen
    positions, hard-edged where OpenCV blends: the pixels OpenCV covers by
    half or more (`_glyph_ink`); nothing is drawn outside the box
    `text_size` gives at `org` (baseline-left origin)."""
    _check_image(img)
    if not text:
        return img
    tab = _glyph_table(thickness)
    (width, height), baseline = text_size(text, scale, thickness)
    size = text_pixel_size(scale)
    H, W = img.shape[:2]
    ox, oy = _int_point(org)
    bx0, bx1 = max(ox, 0), min(ox + width, W)  # [x0, x1)
    by0, by1 = max(oy - height, 0), min(oy + baseline + 1, H)
    if bx0 >= bx1 or by0 >= by1 or size <= 0:
        return img
    mask = np.zeros((by1 - by0, bx1 - bx0), bool)
    pen = ox
    for ch, step in zip(text, _steps(text, size, tab.advance)):
        ink, gx0, gy0 = _glyph_ink(_text_weight(thickness), ch, size)
        if ink.size:
            gh, gw = ink.shape
            xs, ys = pen + gx0 + np.arange(gw), oy + gy0 + np.arange(gh)
            okx, oky = (xs >= bx0) & (xs < bx1), (ys >= by0) & (ys < by1)
            mask[np.ix_(ys[oky] - by0, xs[okx] - bx0)] |= ink[np.ix_(oky, okx)]
        pen += step
    _paint(img[by0:by1, bx0:bx1], mask, color)
    return img
