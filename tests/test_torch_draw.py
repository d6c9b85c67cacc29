"""The port's OpenCV-free drawing and labelling (`utils/draw`) against
OpenCV 5.0, on seeded random inputs: lines and rectangles bit for bit
(thickness 1-3 and 7, 1 and 3 channels, end points inside, on the edge and far
outside), the 3x3 opening and the 8-connected labelling with its stats and
label order on hundreds of random masks, `text_size` against
`cv2.getTextSize`, and `put_text` held to its box.

OpenCV 5 draws FONT_HERSHEY_SIMPLEX in an antialiased TrueType font, so
`put_text`'s glyph pixels are not cv2's: every pixel it sets lies inside the
box `cv2.getTextSize` gives at the origin, widened by the thickness, and
every pixel outside that box equals cv2's."""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from augmentedautoencoder_torch.utils import draw  # noqa: E402

FONT = cv2.FONT_HERSHEY_SIMPLEX
PRINTABLE = [chr(c) for c in range(32, 127)]


def _point(rng, where, W, H):
    if where == "inside":
        return int(rng.integers(0, W)), int(rng.integers(0, H))
    if where == "edge":
        return int(rng.choice([0, W - 1, -1, W])), int(rng.integers(-1, H + 1))
    return int(rng.integers(-5000, 5000)), int(rng.integers(-5000, 5000))


def _image(rng, channels, H, W):
    shape = (H, W, 3) if channels == 3 else (H, W)
    return rng.integers(0, 256, shape, dtype=np.uint8)


def _segments(seed, channels, where, n=150):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        H, W = int(rng.integers(5, 64)), int(rng.integers(5, 64))
        p0 = _point(rng, "inside" if where == "far" else where, W, H)
        yield _image(rng, channels, H, W), p0, _point(rng, where, W, H)


@pytest.mark.parametrize("where", ["inside", "edge", "far"])
@pytest.mark.parametrize("channels", [1, 3])
def test_thin_line_equals_cv2(channels, where):
    for img, p0, p1 in _segments(1, channels, where):
        want, got = img.copy(), img.copy()
        cv2.line(want, p0, p1, (10, 200, 30), 1)
        draw.line(got, p0, p1, (10, 200, 30), 1)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} -> {p1}")


@pytest.mark.parametrize("where", ["inside", "edge", "far"])
@pytest.mark.parametrize("thickness", [2, 3, 7])
@pytest.mark.parametrize("channels", [1, 3])
def test_thick_line_equals_cv2(channels, thickness, where):
    for img, p0, p1 in _segments(2 + thickness, channels, where):
        want, got = img.copy(), img.copy()
        cv2.line(want, p0, p1, (10, 200, 30), thickness)
        draw.line(got, p0, p1, (10, 200, 30), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} -> {p1}")


@pytest.mark.parametrize("where", ["inside", "edge", "far"])
@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("channels", [1, 3])
def test_rectangle_equals_cv2(channels, thickness, where):
    for img, p0, p1 in _segments(20 + thickness, channels, where, n=100):
        want, got = img.copy(), img.copy()
        cv2.rectangle(want, p0, p1, (0, 255, 0), thickness)
        draw.rectangle(got, p0, p1, (0, 255, 0), thickness)
        np.testing.assert_array_equal(got, want, err_msg=f"{p0} -> {p1}")


def _masks(seed, density, n=100):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        H, W = int(rng.integers(3, 70)), int(rng.integers(3, 70))
        yield (rng.random((H, W)) < density).astype(np.uint8)


@pytest.mark.parametrize("density", [0.2, 0.5, 0.8])
def test_opening_equals_cv2(density):
    for m in _masks(30, density):
        want = cv2.morphologyEx(m, cv2.MORPH_OPEN, np.ones((3, 3), np.uint8))
        got = draw.morph_open3x3(m)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("density", [0.2, 0.45, 0.7])
def test_labels_and_stats_equal_cv2_in_its_order(density):
    for m in _masks(40, density):
        n, labels = draw.connected_components(m)
        stats = draw.connected_components_stats(m)
        wn, wlabels, wstats, _ = cv2.connectedComponentsWithStats(m, 8)
        assert n == wn
        assert labels.dtype == wlabels.dtype and stats.dtype == wstats.dtype
        np.testing.assert_array_equal(labels, wlabels)
        np.testing.assert_array_equal(stats, wstats)


@pytest.mark.parametrize("mask", ["empty", "full", "one_pixel"])
def test_labelling_edge_cases_equal_cv2(mask):
    m = np.zeros((5, 6), np.uint8)
    if mask == "full":
        m[:] = 1
    elif mask == "one_pixel":
        m[2, 3] = 7
    n, labels = draw.connected_components(m)
    wn, wlabels, wstats, _ = cv2.connectedComponentsWithStats(m, 8)
    assert n == wn
    np.testing.assert_array_equal(labels, wlabels)
    np.testing.assert_array_equal(draw.connected_components_stats(m), wstats)


def _strings(seed, n):
    rng = np.random.default_rng(seed)
    demo = ["obj_1 z=0.75m", "sphere z=0.30m", "obj", "1", "cat", "obj_000001", "duck z=1.23m"]
    for s in demo:
        yield s
    for _ in range(n):
        yield "".join(rng.choice(PRINTABLE, int(rng.integers(1, 18))))


@pytest.mark.parametrize("thickness", [1, 2, 3])
@pytest.mark.parametrize("scale", [0.4, 0.5, 0.6, 1.0, 1.5, 3.3, 11.0])
def test_text_size_equals_cv2(scale, thickness):
    for s in _strings(int(scale * 10) + thickness, 300):
        assert draw.text_size(s, scale, thickness) == cv2.getTextSize(s, FONT, scale, thickness), s


def test_text_size_beyond_the_baseline_table_stays_within_a_pixel():
    """Above 320 px (scale 11.8) the baseline comes from the glyphs'
    outlines: width and height equal, the baseline at most 1 px off."""
    for s in _strings(5, 100):
        for scale in (12.0, 15.5):
            (w, h), base = draw.text_size(s, scale, 1)
            (ww, wh), wbase = cv2.getTextSize(s, FONT, scale, 1)
            assert (w, h) == (ww, wh) and abs(base - wbase) <= 1, s


def test_text_size_of_nothing_and_non_ascii():
    assert draw.text_size("", 0.5) == cv2.getTextSize("", FONT, 0.5, 1)
    with pytest.raises(ValueError, match="printable ASCII"):
        draw.text_size("é", 0.5)


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("scale", [0.5, 0.6, 1.0, 2.2])
def test_put_text_stays_in_its_box_and_leaves_the_rest_as_cv2(scale, thickness):
    rng = np.random.default_rng(int(scale * 10) + thickness)
    for s in _strings(thickness, 60):
        (w, h), b = cv2.getTextSize(s, FONT, scale, thickness)
        H, W = h + b + 24, w + 24
        org = (int(rng.integers(-4, 12)), h + int(rng.integers(-3, 12)))
        base = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        want, got = base.copy(), base.copy()
        cv2.putText(want, s, org, FONT, scale, (0, 255, 0), thickness)
        draw.put_text(got, s, org, scale, (0, 255, 0), thickness)
        box = np.zeros((H, W), bool)
        box[max(0, org[1] - h - thickness):max(0, org[1] + b + thickness + 1),
            max(0, org[0] - thickness):max(0, org[0] + w + thickness)] = True
        assert not ((got != base).any(-1) & ~box).any(), s
        outside = (got != want).any(-1) & ~box
        if outside.any():
            # only where cv2 itself reaches left of the box: a first glyph
            # whose ink starts left of the pen (a negative side bearing)
            _, x0, _ = draw._glyph_table(thickness).coverage(s[0])
            cols = np.nonzero(outside.any(0))[0]
            assert x0 < 0 and cols.max() < org[0] - thickness, s
        assert (got != base).any() or not s.strip(), s


def _inks(s, scale, thickness):
    """cv2.putText's ink (its antialiased coverage at 128 or more) and
    put_text's, white on black at a margin, both inside the getTextSize box
    at the origin (put_text draws nothing outside it)."""
    (w, h), b = cv2.getTextSize(s, FONT, scale, thickness)
    H, W = h + b + 24, w + 24
    org = (12, h + 12)
    want, got = np.zeros((H, W), np.uint8), np.zeros((H, W), np.uint8)
    cv2.putText(want, s, org, FONT, scale, 255, thickness)
    draw.put_text(got, s, org, scale, 255, thickness)
    box = np.zeros((H, W), bool)
    box[org[1] - h:org[1] + b + 1, org[0]:org[0] + w] = True
    return (want >= 128) & box, got != 0


#: the least IoU of put_text's ink with cv2's over `_strings(thickness, 60)`,
#: floored to 0.01 from this tree's readings: 0.5/1 0.9375, 0.6/1 0.9000,
#: 1.0/1 1.0000, 2.2/1 0.9024, 0.5/2 0.9286, 0.6/2 0.9412, 1.0/2 1.0000,
#: 2.2/2 0.9315 (at scale 1.0, 27 px, the table is cv2's own rendering)
INK_IOU_FLOOR = {(0.5, 1): 0.93, (0.6, 1): 0.90, (1.0, 1): 0.99, (2.2, 1): 0.90,
                 (0.5, 2): 0.92, (0.6, 2): 0.94, (1.0, 2): 0.99, (2.2, 2): 0.93}


@pytest.mark.parametrize("thickness", [1, 2])
@pytest.mark.parametrize("scale", [0.5, 0.6, 1.0, 2.2])
def test_put_text_draws_cv2s_glyphs(scale, thickness):
    """The text's shape: per string, put_text's ink overlaps cv2's by the
    floor's IoU; per glyph drawn alone, its ink spans cv2's columns and
    rows within 1 px, so a wrong, swapped or mis-scaled glyph fails."""
    ious = []
    for s in _strings(thickness, 60):
        if not s.strip():
            continue
        want, got = _inks(s, scale, thickness)
        ious.append((want & got).sum() / (want | got).sum())
    print(f"scale {scale} thickness {thickness}: least ink IoU {min(ious):.4f} over {len(ious)} strings")
    assert min(ious) >= INK_IOU_FLOOR[scale, thickness]
    for ch in PRINTABLE[1:]:
        want, got = _inks(ch, scale, thickness)
        for axis in (0, 1):
            a, b = np.nonzero(want.any(axis))[0], np.nonzero(got.any(axis))[0]
            assert len(b) and abs(a[0] - b[0]) <= 1 and abs(a[-1] - b[-1]) <= 1, (ch, axis, a, b)
