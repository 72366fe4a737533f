"""Reports whose answers came back inside the window, over the window's
seconds (rank 0's gathered answers on several cards)."""


def read(run):
    return run["reports"] / run["window_s"]
