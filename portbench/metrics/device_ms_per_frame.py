"""Device milliseconds a delivered frame: the union of the device
operations' intervals in the traced window over the frames the traced
calls delivered (the fusion step and all else the calls run)."""


def read(t):
    busy = t.busy_s()
    return busy * 1e3 / t.frames if busy > 0 and t.frames else None
