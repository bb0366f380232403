"""Container compliance validation — the compliance.cc role
(avifIsCompliant, internal.h:649-651, which delegates to gpac
ComplianceWarden). Ours is a native structural checker for the MIAF/HEIF
constraints this framework relies on; returns findings instead of
aborting so callers can treat them as warnings or errors.
"""

from __future__ import annotations

import dataclasses

from ..constants import AvifError
from ..image import are_grid_dimensions_valid
from .parse import parse, parse_image_grid, read_item_payload


@dataclasses.dataclass
class Finding:
    level: str  # "error" | "warning"
    rule: str
    message: str

    def __str__(self):
        return f"[{self.level}] {self.rule}: {self.message}"


def validate(data: bytes) -> list[Finding]:
    """Structural MIAF/HEIF checks over a serialized file."""
    out: list[Finding] = []

    def err(rule, msg):
        out.append(Finding("error", rule, msg))

    def warn(rule, msg):
        out.append(Finding("warning", rule, msg))

    try:
        c = parse(data)
    except AvifError as e:
        return [Finding("error", "parse", str(e))]

    if not (c.has_brand("avif") or c.has_brand("avis") or c.has_brand("mif3")):
        warn("ftyp", f"no avif/avis/mif3 brand: {c.major_brand}")
    meta = c.meta
    if meta is None:
        if not c.tracks:
            err("meta", "no meta box and no tracks")
        return out

    # MIAF 7.3.2: a primary item is required.
    if not meta.primary_item_id:
        err("pitm", "no primary item")
        return out
    primary = meta.items.get(meta.primary_item_id)
    if primary is None:
        err("pitm", f"primary item {meta.primary_item_id} not declared")
        return out

    for item in meta.items.values():
        if item.item_type == "av01":
            if not item.has_property("av1C"):
                err("av1C", f"item {item.id}: av01 item without codec config")
            if not item.has_property("ispe"):
                # MIAF 7.3.6.7: ispe required on coded items
                err("ispe", f"item {item.id}: coded item without ispe")
            if not item.has_property("pixi"):
                warn("pixi", f"item {item.id}: missing pixel information")
            # extents inside the file
            if not item.idat:
                for e in item.extents:
                    if e.offset + e.size > len(data):
                        err(
                            "iloc",
                            f"item {item.id}: extent [{e.offset},+{e.size}) "
                            f"outside file of {len(data)} bytes",
                        )
        elif item.item_type == "grid":
            try:
                grid = item.grid or parse_image_grid(
                    read_item_payload(meta, item, data)
                )
            except AvifError as e:
                err("grid", f"item {item.id}: {e}")
                continue
            cells = [
                i for i in meta.items.values() if i.dimg_for_id == item.id
            ]
            if len(cells) != grid.rows * grid.columns:
                err(
                    "grid",
                    f"item {item.id}: {len(cells)} cells for "
                    f"{grid.rows}x{grid.columns} grid",
                )
            if cells:
                first = cells[0]
                ispe = first.find_property("ispe")
                if ispe is not None and not are_grid_dimensions_valid(
                    # cell format is unknown at container level; use 420
                    # (the strictest evenness rules) for the check
                    __import__("libavif_tpu_torch.constants", fromlist=["PixelFormat"]).PixelFormat.YUV420,
                    grid.output_width,
                    grid.output_height,
                    ispe.width,
                    ispe.height,
                ):
                    warn("grid", f"item {item.id}: MIAF grid dimension rules")

    # altr groups must reference declared items
    for group in meta.entity_groups:
        for eid in group.entity_ids:
            if eid not in meta.items:
                warn("grpl", f"group {group.group_id}: unknown entity {eid}")
    return out


def is_compliant(data: bytes) -> bool:
    """True when no error-level findings (avifIsCompliant role)."""
    return not any(f.level == "error" for f in validate(data))
