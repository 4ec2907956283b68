"""Graph replays a tracked step: ``cudaGraphLaunch`` calls in the traced
window over the traced calls' tracked steps (frames a clip − 1). The entry
drivers replay each step once a pass, so this counts the passes over the
clip a call makes (entry drivers, ``slam/scan.py``)."""


def read(t):
    launches = sum(1 for n, _, _ in t.host_ops if n == "cudaGraphLaunch")
    steps = t.calls * t.steps_per_call
    return launches / steps if launches and steps else None
