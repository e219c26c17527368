"""The mean ms a pair spent in ``next()`` of the feed the benchmark hands to
``serve_pairs``, over every pair of the window: the serving layer's wait
for the native loader."""


def read(summary):
    waits = summary["loader_wait_s"]
    return 1e3 * sum(waits) / len(waits) if waits else None
