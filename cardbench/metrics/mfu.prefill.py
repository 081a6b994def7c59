"""The prefill hand bound (``bounds.prefill_bound``) of every batch the
window served, summed, over the window, in %."""

from cardbench import bounds


def read(run):
    if run.get("kind") != "prefill" or not run["units"]:
        return None
    least = sum(bounds.prefill_bound(run["model"], run["weights"], reqs,
                                     n)[0]
                for n, reqs, *_ in run["batches"])
    return 100 * least / run["window_s"]
