"""The ``stereo/scanline`` stage's roofline share in a cell above 256
disparities, where the scanline runs the composed route of wide banded
passes: its least time a pair at the cell's shapes (the configuration's
``work`` at the card's published peaks) over its device time a pair in the
traced window."""


def read(summary):
    t = summary.get("trace")
    bound = summary.get("stage_bound_s", {}).get("scanline")
    if not t or bound is None or not t["stage_device_s"].get("scanline"):
        return None
    return 100.0 * bound / (t["stage_device_s"]["scanline"] / t["pairs_traced"])
