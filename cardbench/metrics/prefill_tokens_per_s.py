"""Prompt tokens of every request the window answered, over the window."""


def read(run):
    if run.get("kind") != "prefill" or not run["units"]:
        return None
    return run["tokens"] / run["window_s"]
