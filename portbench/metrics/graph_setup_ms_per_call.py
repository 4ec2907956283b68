"""Host milliseconds a traced entry call spends on its warm-up step and
its CUDA-graph capture: the summed ``cilantro.scan.warmup`` and
``cilantro.scan.capture`` spans (``slam/scan.py`` ``_GraphStep``) over the
traced calls. ``None`` where the program emits no ``cilantro.`` event."""

SETUP = ("cilantro.scan.warmup", "cilantro.scan.capture")


def read(t):
    if not t.calls or not any(n.startswith("cilantro.") for n, _, _ in t.host_ops):
        return None
    return sum(e - s for n, s, e in t.host_ops if n in SETUP) * 1e3 / t.calls
