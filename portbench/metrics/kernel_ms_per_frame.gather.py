"""Device milliseconds a delivered frame in the wide-row gather kernel
(``csrc/gather_kernels.cu``: ``coalesced_gather``)."""


def read(t):
    sec = t.kernel_seconds(lambda n: "coalesced_gather" in n)
    return sec * 1e3 / t.frames if sec > 0 and t.frames else None
