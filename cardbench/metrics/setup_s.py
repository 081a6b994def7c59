"""Set-up: process start to the window's start (imports, the kernels'
build or load, weights, warm-up, the checked steps), host clock."""


def read(run):
    return run["setup_s"]
