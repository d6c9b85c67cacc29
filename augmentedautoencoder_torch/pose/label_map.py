"""TF-object-detection label-map (.pbtxt) support without protobuf/TF (a copy
of augmentedautoencoder_tpu/pose/label_map.py, whose package imports jax).

The reference's googledet demo resolves detector class ids to names through
the TF-OD API's protobuf label map
(reference: auto_pose/test/googledet_utils/label_map_util.py +
string_int_label_map_pb2.py, ~550 generated lines requiring tensorflow and
google.protobuf). The file format itself is trivial text:

    item {
      id: 1
      name: 'obj_000001'
      display_name: "duck"
    }

This module parses that grammar directly (quoted strings, ints, nested
`item { ... }` blocks) and reproduces the three functions the demos use:
`load_labelmap`, `convert_label_map_to_categories`, `create_category_index`.
"""

from __future__ import annotations

import re
from typing import Dict, List

_TOKEN = re.compile(
    r"""
    (?P<comment>\#[^\n]*)
  | (?P<open>\{)
  | (?P<close>\})
  | (?P<key>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<colon>:)
  | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
  | (?P<number>-?\d+)
  | (?P<ws>\s+)
    """,
    re.VERBOSE,
)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"label map: unexpected character at offset {pos}: "
                             f"{text[pos:pos + 20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        yield kind, m.group()


def _unquote(tok: str) -> str:
    body = tok[1:-1]
    return body.replace("\\'", "'").replace('\\"', '"').replace("\\\\", "\\")


def load_labelmap(path: str) -> List[Dict]:
    """Parse a .pbtxt label map into a list of item dicts.

    Each dict carries the fields present in the file (`id` int, `name` /
    `display_name` str). Mirrors label_map_util.load_labelmap + its
    _validate_label_map (ids must be >= 1; id 0 is reserved for background).
    """
    with open(path) as fh:
        text = fh.read()

    items: List[Dict] = []
    current: Dict | None = None
    key = None
    depth = 0
    tokens = _tokenize(text)
    for kind, tok in tokens:
        if kind == "key" and depth == 0:
            if tok != "item":
                raise ValueError(f"label map: unexpected top-level field {tok!r}")
            key = tok
        elif kind == "open":
            depth += 1
            if depth != 1:
                raise ValueError("label map: nested blocks are not supported")
            current = {}
        elif kind == "close":
            depth -= 1
            if depth < 0:
                raise ValueError("label map: unbalanced '}'")
            items.append(current)
            current = None
        elif kind == "key":
            key = tok
        elif kind == "colon":
            continue
        elif kind in ("string", "number"):
            if current is None or key is None:
                raise ValueError("label map: value outside an item block")
            current[key] = int(tok) if kind == "number" else _unquote(tok)
            key = None
    if depth != 0:
        raise ValueError("label map: unbalanced '{'")

    for item in items:
        if item.get("id", 0) < 1:
            raise ValueError("Label map ids should be >= 1.")
    return items


def convert_label_map_to_categories(
    label_map: List[Dict], max_num_classes: int, use_display_name: bool = True
) -> List[Dict]:
    """items -> [{'id': int, 'name': str}], as the TF-OD API does."""
    categories = []
    seen = set()
    for item in label_map:
        if item["id"] > max_num_classes:
            continue
        if item["id"] in seen:
            continue
        seen.add(item["id"])
        if use_display_name and "display_name" in item:
            name = item["display_name"]
        else:
            name = item.get("name", str(item["id"]))
        categories.append({"id": item["id"], "name": name})
    return categories


def create_category_index(categories: List[Dict]) -> Dict[int, Dict]:
    """[{'id','name'}] -> {id: {'id','name'}} (label_map_util parity)."""
    return {cat["id"]: cat for cat in categories}


def create_category_index_from_labelmap(
    path: str, max_num_classes: int = 2**31 - 1, use_display_name: bool = True
) -> Dict[int, Dict]:
    """One-call convenience used by the demo pipelines."""
    return create_category_index(
        convert_label_map_to_categories(
            load_labelmap(path), max_num_classes, use_display_name
        )
    )


def remap_box_classes(boxes, category_index: Dict[int, Dict]):
    """Rewrite detector class keys (int ids or digit strings) to label-map
    names, in place — the bridge from an id-emitting detector to the
    name-keyed multi-codebook AePoseEstimator (the role of
    category_index[...]['name'] lookups in aae_googledet_webcam_multi.py).
    Unknown ids keep their original key."""
    for box in boxes:
        remapped = {}
        for key, score in box.classes.items():
            cid = None
            if isinstance(key, int):
                cid = key
            elif isinstance(key, str) and key.isdigit():
                cid = int(key)
            if cid is not None and cid in category_index:
                remapped[category_index[cid]["name"]] = score
            else:
                remapped[key] = score
        box.classes = remapped
    return boxes
