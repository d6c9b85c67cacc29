"""Write augmentedautoencoder_torch/utils/_glyphs.py: the glyph table behind
`utils/draw.text_size` and `utils/draw.put_text`.

OpenCV 5 draws FONT_HERSHEY_SIMPLEX in its built-in Rubik font (SIL Open
Font License), a variable font whose weight axis it sets to 400 for
thickness <= 1 and to 600 above. This script takes the font out of the
installed OpenCV library (a gzip member named Rubik.ttf), reads with
fontTools each printable ASCII glyph's advance and lowest point at both
weights (floored to whole font units, as OpenCV lays them out), keeps
OpenCV's own antialiased rendering of each glyph at scale 1.0 (27 px), the
coverage `put_text` resamples, and for each glyph that
has a baseline OpenCV's baseline at every pixel size up to MAX_SIZE (a
string's baseline is the largest of its glyphs').

Needs OpenCV 5 and fontTools (not the port): run it where both import,

    python scripts/make_text_glyphs.py
"""

from __future__ import annotations

import base64
import io
import json
import os
import re
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "augmentedautoencoder_torch", "utils", "_glyphs.py")
CHARS = [chr(c) for c in range(32, 127)]
#: the weight axis, normalized and mapped through the font's avar, as F2Dot14
LOCATIONS = {400: 0.1875, 600: 0.51251220703125}
THICKNESS = {400: 1, 600: 2}
REF_SCALE = 1.0
#: baselines are tabulated up to this pixel size (scale 11.8)
MAX_SIZE = 320


def rubik_ttf() -> bytes:
    import cv2

    lib = os.path.join(os.path.dirname(cv2.__file__))
    so = [f for f in os.listdir(lib) if f.startswith("cv2") and f.endswith(".so")][0]
    data = open(os.path.join(lib, so), "rb").read()
    for m in re.finditer(b"\x1f\x8b\x08\x08", data):
        name_end = data.find(b"\x00", m.start() + 10)
        if data[m.start() + 10:name_end] == b"Rubik.ttf":
            d = zlib.decompressobj(16 + zlib.MAX_WBITS)
            return d.decompress(data[m.start():m.start() + 4_000_000])
    raise SystemExit("no Rubik.ttf in the OpenCV library (is it OpenCV 5?)")


def metrics(font, loc):
    from fontTools.pens.boundsPen import BoundsPen
    from fontTools.varLib.varStore import VarStoreInstancer

    hvar = font["HVAR"].table
    inst = VarStoreInstancer(hvar.VarStore, font["fvar"].axes, {"wght": loc})
    glyphs = font.getGlyphSet(location={"wght": loc}, normalized=True)
    cmap = font.getBestCmap()
    out = {}
    for ch in CHARS:
        g = cmap[ord(ch)]
        pen = BoundsPen(glyphs)
        glyphs[g].draw(pen)
        if pen.bounds is None:  # no outline: OpenCV keeps the default advance
            adv, ymin = font["hmtx"][g][0], 0
        else:
            adv = int(np.floor(font["hmtx"][g][0] + inst[hvar.AdvWidthMap.mapping[g]]))
            ymin = int(np.floor(pen.bounds[1]))
        out[ch] = (adv, ymin)
    return out


def coverage(ch: str, thickness: int):
    """x0, y0 (the top-left corner relative to the pen on the baseline),
    h, w and the uint8 coverage of OpenCV's rendering at 27 px, hex."""
    import cv2

    pad = 60
    img = np.zeros((160, 160), np.uint8)
    cv2.putText(img, ch, (pad, pad + 27), cv2.FONT_HERSHEY_SIMPLEX, REF_SCALE, 255, thickness)
    ys, xs = np.nonzero(img)
    if len(xs) == 0:
        return 0, 0, 0, 0, ""
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    return int(x0 - pad), int(y0 - pad - 27), int(y1 - y0), int(x1 - x0), img[y0:y1, x0:x1].tobytes().hex()


def baselines(ch: str, thickness: int) -> str:
    """cv2.getTextSize's baseline of `ch` at pixel sizes 1..MAX_SIZE, hex;
    the glyph's rasterized descent, which no closed form of the outline
    matches in every size."""
    import cv2

    return bytes(cv2.getTextSize(ch, cv2.FONT_HERSHEY_SIMPLEX, size * 0.037, thickness)[1]
                 for size in range(1, MAX_SIZE + 1)).hex()


def main() -> None:
    from fontTools.ttLib import TTFont

    font = TTFont(io.BytesIO(rubik_ttf()))
    assert font["hhea"].ascent == 935, font["hhea"].ascent
    table = {}
    for weight, loc in LOCATIONS.items():
        m = metrics(font, loc)
        rows = {}
        for ch in CHARS:
            base = baselines(ch, THICKNESS[weight])
            rows[ch] = list(m[ch]) + list(coverage(ch, THICKNESS[weight])) + [base if base.strip("0") else ""]
        table[str(weight)] = rows
    blob = base64.b64encode(zlib.compress(json.dumps(table, separators=(",", ":")).encode(), 9)).decode()
    lines = [blob[i:i + 96] for i in range(0, len(blob), 96)]
    with open(OUT, "w") as fh:
        fh.write('"""Glyph table of OpenCV 5\'s FONT_HERSHEY_SIMPLEX (its built-in Rubik\n'
                 "font, SIL Open Font License) for `utils/draw`: per weight and printable\n"
                 "ASCII character, the advance and lowest point in font units, the glyph's\n"
                 "antialiased coverage at 27 px and its baseline at each pixel size.\n"
                 'Written by scripts/make_text_glyphs.py; do not edit."""\n\n'
                 "from __future__ import annotations\n\n"
                 "import base64\nimport functools\nimport json\nimport zlib\n\n"
                 "import numpy as np\n\n"
                 "REF_SIZE = 27\n"
                 f"MAX_SIZE = {MAX_SIZE}\n\n"
                 "_BLOB = (\n")
        for ln in lines:
            fh.write(f'    "{ln}"\n')
        fh.write(")\n\n\n"
                 "class _Table:\n"
                 "    def __init__(self, rows):\n"
                 "        self.advance = {ch: r[0] for ch, r in rows.items()}\n"
                 "        self.ymin = {ch: r[1] for ch, r in rows.items()}\n"
                 "        self.max_size = MAX_SIZE\n"
                 "        self.baseline = {ch: bytes.fromhex(r[7]) for ch, r in rows.items() if r[7]}\n"
                 "        self._rows = rows\n\n"
                 "    @functools.lru_cache(maxsize=None)\n"
                 "    def coverage(self, ch):\n"
                 "        \"\"\"(coverage float64 (h, w) in [0, 1], x0, y0): OpenCV's rendering and\n"
                 "        its top-left corner relative to the pen on the baseline, in\n"
                 "        reference pixels.\"\"\"\n"
                 "        _, _, x0, y0, h, w, grey, _ = self._rows[ch]\n"
                 "        if not h:\n"
                 "            return np.zeros((0, 0)), 0, 0\n"
                 "        return np.frombuffer(bytes.fromhex(grey), np.uint8).reshape(h, w) / 255.0, x0, y0\n\n\n"
                 "@functools.lru_cache(maxsize=None)\n"
                 "def table(weight: int) -> _Table:\n"
                 "    rows = json.loads(zlib.decompress(base64.b64decode(\"\".join(_BLOB))))\n"
                 "    return _Table(rows[str(weight)])\n")
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    main()
