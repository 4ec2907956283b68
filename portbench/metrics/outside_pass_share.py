"""The share of the traced window, in percent, outside the passes over
the clip: 100 × (1 − the summed ``cilantro.scan.pass.*`` spans of
``slam/scan.py`` ``scan`` / the window). What a call does besides
replaying the clip: preparing the input, the warm-up and capture, the
results' read-back. ``None`` where the program emits no ``cilantro.``
event."""

PASS = "cilantro.scan.pass."


def read(t):
    if t.window_s <= 0 or not any(n.startswith("cilantro.") for n, _, _ in t.host_ops):
        return None
    inside = sum(e - s for n, s, e in t.host_ops if n.startswith(PASS))
    return 100.0 * (1.0 - inside / t.window_s)
