"""Dataset converters: COCO JSON -> YOLO txt labels, and the class-id maps
(counterparts of ``xlstm_yolo_tpu/data/converter.py``; the standard library
only)."""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path


def coco91_to_coco80_class() -> list:
    """91-index -> 80-index map (None for the 11 unused ids)."""
    x = [None] * 91
    from xlstm_yolo_tpu_torch.engine.validator import _COCO91

    for i80, i91 in enumerate(_COCO91):
        x[i91 - 1] = i80
    return x


def coco80_to_coco91_class() -> list:
    from xlstm_yolo_tpu_torch.engine.validator import _COCO91

    return list(_COCO91)


def convert_coco(
    labels_dir: str | Path,
    save_dir: str | Path = "coco_converted",
    use_segments: bool = False,
    cls91to80: bool = True,
):
    """Convert COCO instances_*.json into YOLO txt labels.

    Writes labels/<split>/<image>.txt with 'cls cx cy w h' normalized
    rows, one file per annotated image.
    """
    labels_dir = Path(labels_dir)
    save_dir = Path(save_dir)
    id_map = coco91_to_coco80_class() if cls91to80 else None

    for json_file in sorted(labels_dir.glob("instances_*.json")):
        split = json_file.stem.replace("instances_", "")
        out_dir = save_dir / "labels" / split
        out_dir.mkdir(parents=True, exist_ok=True)
        data = json.loads(json_file.read_text())

        images = {img["id"]: img for img in data["images"]}
        anns = defaultdict(list)
        for a in data["annotations"]:
            anns[a["image_id"]].append(a)

        for img_id, img in images.items():
            h, w = img["height"], img["width"]
            lines = []
            for a in anns.get(img_id, []):
                if a.get("iscrowd", 0):
                    continue
                x, y, bw, bh = a["bbox"]  # top-left xywh
                cx, cy = (x + bw / 2) / w, (y + bh / 2) / h
                bw, bh = bw / w, bh / h
                if bw <= 0 or bh <= 0:
                    continue
                cid = a["category_id"] - 1
                if id_map is not None:
                    cid = id_map[a["category_id"] - 1]
                    if cid is None:
                        continue
                lines.append(f"{cid} {cx:.6f} {cy:.6f} {bw:.6f} {bh:.6f}")
            stem = Path(img["file_name"]).stem
            (out_dir / f"{stem}.txt").write_text("\n".join(lines))
        print(f"converted {json_file.name}: {len(images)} images -> {out_dir}")
    return save_dir
