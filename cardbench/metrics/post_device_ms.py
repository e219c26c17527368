"""Device ms a pair of the card work launched inside the pipeline's
``stereo/post`` ranges, from the traced window."""


def read(summary):
    t = summary.get("trace")
    if not t or "post" not in t["stage_device_s"]:
        return None
    return 1e3 * t["stage_device_s"]["post"] / t["pairs_traced"]
