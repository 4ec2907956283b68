"""Device milliseconds a delivered frame in the three splat kernels
(``csrc/splat_kernels.cu``: ``window_read_codes``, ``splat_argmin2``,
``flow_select_rows``)."""

NAMES = ("window_read_codes", "splat_argmin2", "flow_select_rows")


def read(t):
    sec = t.kernel_seconds(lambda n: any(k in n for k in NAMES))
    return sec * 1e3 / t.frames if sec > 0 and t.frames else None
