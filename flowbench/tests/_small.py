"""Small traffic for the CPU tests: each cell's kind of traffic at 64x96,
with motions scaled to the size."""

from flowbench import spec

POOL = {"generator": "pool", "height": 64, "width": 96, "check_pairs": 1,
        "scenes": [{"kind": "layered", "count": 2, "bg_max": 4,
                    "fg": [5, 9], "boxes": 2}]}
VIDEO = {"generator": "video", "height": 64, "width": 96,
         "frames_per_second": 1, "check_pairs": 1, "pan": [1, 1],
         "boxes": [{"velocity": [-3, 1], "size": [0.3, 0.25]}]}


def small(cell: spec.Cell) -> dict:
    """The cell's traffic made small: a video stays a video."""
    full = spec.traffic(cell.traffic)
    return VIDEO if full["generator"] == "video" else POOL
