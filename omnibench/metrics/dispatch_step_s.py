"""Mean seconds of the window's Dispatch steps (``pipeline.sample``'s
trace): ``models/dit.denoise_step`` in Dispatch mode, with the sampler's
per-step work around it."""


def read(run):
    secs = [s["seconds"] for s in run.steps if s["kind"] == "dispatch"]
    return sum(secs) / len(secs) if secs else None
