"""The share of the traced window in which no kernel, copy or fill ran on
the card (the union of their intervals, from the profiler's trace)."""


def read(summary):
    t = summary.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
