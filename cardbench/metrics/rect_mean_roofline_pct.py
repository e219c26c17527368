"""The ``stereo/rect_mean`` stage's roofline share: its least time a pair at
the cell's shapes (the configuration's ``work`` at the card's published
peaks) over its device time a pair in the traced window."""


def read(summary):
    t = summary.get("trace")
    bound = summary.get("stage_bound_s", {}).get("rect_mean")
    if not t or bound is None or not t["stage_device_s"].get("rect_mean"):
        return None
    return 100.0 * bound / (t["stage_device_s"]["rect_mean"] / t["pairs_traced"])
