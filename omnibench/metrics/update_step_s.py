"""Mean seconds of the window's Update steps (``pipeline.sample``'s trace):
``models/dit.denoise_step`` in Update mode, with the sampler's per-step
work around it."""


def read(run):
    secs = [s["seconds"] for s in run.steps if s["kind"] == "update"]
    return sum(secs) / len(secs) if secs else None
