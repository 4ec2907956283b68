"""The share of the traced window, in percent, in which no operation ran
on the device."""


def read(t):
    busy = t.busy_s()
    return 100.0 * (1.0 - busy / t.window_s) if busy > 0 and t.window_s > 0 else None
