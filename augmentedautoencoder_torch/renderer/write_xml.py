"""Pascal-VOC XML annotation writer for detector training data (a copy of
augmentedautoencoder_tpu/renderer/write_xml.py; reference
auto_pose/meshrenderer/write_xml.py role)."""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Sequence


def write_voc_xml(
    path: str,
    image_filename: str,
    width: int,
    height: int,
    objects: Sequence[dict],
    folder: str = "images",
    depth: int = 3,
) -> str:
    """objects: [{'id': class id or name, 'bb': [xmin, ymin, xmax, ymax]}]."""
    ann = ET.Element("annotation")
    ET.SubElement(ann, "folder").text = folder
    ET.SubElement(ann, "filename").text = image_filename
    size = ET.SubElement(ann, "size")
    ET.SubElement(size, "width").text = str(width)
    ET.SubElement(size, "height").text = str(height)
    ET.SubElement(size, "depth").text = str(depth)
    ET.SubElement(ann, "segmented").text = "0"

    for obj in objects:
        o = ET.SubElement(ann, "object")
        ET.SubElement(o, "name").text = str(obj["id"])
        ET.SubElement(o, "pose").text = "Unspecified"
        ET.SubElement(o, "truncated").text = "0"
        ET.SubElement(o, "difficult").text = "0"
        bnd = ET.SubElement(o, "bndbox")
        xmin, ymin, xmax, ymax = obj["bb"]
        ET.SubElement(bnd, "xmin").text = str(int(xmin))
        ET.SubElement(bnd, "ymin").text = str(int(ymin))
        ET.SubElement(bnd, "xmax").text = str(int(xmax))
        ET.SubElement(bnd, "ymax").text = str(int(ymax))

    tree = ET.ElementTree(ann)
    ET.indent(tree)
    tree.write(path)
    return path


def parse_voc_xml(path: str):
    """Round-trip reader for write_voc_xml output (and any Pascal-VOC
    annotation): [{'id': name string, 'bb': [xmin, ymin, xmax, ymax]}]."""
    root = ET.parse(path).getroot()
    objects = []
    for o in root.findall("object"):
        bnd = o.find("bndbox")
        objects.append(
            {
                "id": o.findtext("name"),
                "bb": [
                    int(bnd.findtext("xmin")),
                    int(bnd.findtext("ymin")),
                    int(bnd.findtext("xmax")),
                    int(bnd.findtext("ymax")),
                ],
            }
        )
    return objects
