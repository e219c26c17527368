"""Maps delivered to the host a second: every pair of the window over the
window's whole time, from its first ask of the loader to its last map."""


def read(summary):
    return summary["pairs"] / summary["served_s"]
