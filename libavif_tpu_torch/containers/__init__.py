from .items import (
    CodecConfiguration,
    Container,
    Extent,
    ImageGrid,
    Item,
    Meta,
    SampleTable,
    Track,
)
from .parse import parse, parse_image_grid, read_item_payload

__all__ = [
    "CodecConfiguration",
    "Container",
    "Extent",
    "ImageGrid",
    "Item",
    "Meta",
    "SampleTable",
    "Track",
    "parse",
    "parse_image_grid",
    "read_item_payload",
]
