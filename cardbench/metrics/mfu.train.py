"""The training step's hand bound (``bounds.train_bound``) over the
window's mean step time, in %: the whole step's share of the card's peak
by the bound's count, recomputation not counted."""


def read(run):
    if run.get("kind") != "train" or not run["units"]:
        return None
    return 100 * run["unit_bound_s"] * run["units"] / run["window_s"]
