"""The 95th percentile, over every pair of the window, of the ms from the
loop's ask of the loader for a pair to its map on the host (loader wait
included): ``statistics.quantiles(n=20, method='inclusive')``."""

import statistics


def read(summary):
    lat = summary["latencies_s"]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[18] * 1e3
