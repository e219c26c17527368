"""Kernels, copies and fills on the card in the traced window, a pair."""


def read(summary):
    t = summary.get("trace")
    return t["device_ops"] / t["pairs_traced"] if t else None
