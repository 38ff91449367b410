"""The share of the traced window in which no operation ran on the card,
in % (``torch.profiler``'s device events, merged)."""


def read(run):
    p = run.profile
    if p is None or not p["window_s"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
