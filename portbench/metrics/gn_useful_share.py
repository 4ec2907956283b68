"""The share, in percent, of the GN / ICP iterations the graph form runs
that the fusion step keeps: the summed ``gn_iterations_kept`` counters
over the summed ``gn_iterations_run`` counters (``cilantro.count.<name>=
<int>`` events, one of each an entry call). ``None`` where the program
emits no such counter."""

import re

COUNT = re.compile(r"cilantro\.count\.(gn_iterations_kept|gn_iterations_run)=(\d+)$")


def read(t):
    sums = {"gn_iterations_kept": 0, "gn_iterations_run": 0}
    for n, _, _ in t.host_ops:
        m = COUNT.match(n)
        if m:
            sums[m.group(1)] += int(m.group(2))
    run = sums["gn_iterations_run"]
    return 100.0 * sums["gn_iterations_kept"] / run if run else None
