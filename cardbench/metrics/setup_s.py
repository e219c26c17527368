"""Seconds from the process's start to the window's first ask of a pair:
imports, the card's context, the pairs made and staged, the kernels built
(the first run of a checkout) and the warm-up of the cell's own shape."""


def read(summary):
    return summary["setup_s"]
