"""The 95th percentile (nearest rank) over every request the window
answered of the time from its batch's submission to its first token on
the host, in ms."""

import math


def read(run):
    if run.get("kind") != "prefill" or not run["units"]:
        return None
    times = sorted(t for _, n, t, *_ in run["batches"] for _ in range(n))
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
