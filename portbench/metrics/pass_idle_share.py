"""The share, in percent, of the host's passes over the clip (the
``cilantro.scan.pass.*`` spans of ``slam/scan.py`` ``scan``) in which no
operation ran on the device: their summed length less its overlap with
the device's busy intervals, over their summed length. ``None`` where
the program emits no such span."""

import bisect

PASS = "cilantro.scan.pass."


def read(t):
    passes = [(s, e) for n, s, e in t.host_ops if n.startswith(PASS) and e > s]
    if not passes:
        return None
    busy = t.busy_intervals()
    starts = [s for s, _ in busy]
    length = covered = 0.0
    for s, e in passes:
        length += e - s
        i = max(bisect.bisect_right(starts, s) - 1, 0)
        while i < len(busy) and busy[i][0] < e:
            covered += max(0.0, min(e, busy[i][1]) - max(s, busy[i][0]))
            i += 1
    return 100.0 * (1.0 - covered / length)
