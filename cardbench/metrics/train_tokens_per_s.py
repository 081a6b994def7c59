"""Tokens of every optimizer step the window finished, over the window."""


def read(run):
    if run.get("kind") != "train" or not run["units"]:
        return None
    return run["tokens"] / run["window_s"]
