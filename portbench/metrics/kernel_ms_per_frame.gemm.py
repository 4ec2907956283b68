"""Device milliseconds a delivered frame in cuBLAS / CUTLASS matrix
products (the GN normal equations' 6×6 JᵀJ and Jᵀr, the transforms of
point sets): kernels whose names hold ``gemm``, ``gemv`` or
``splitKreduce``."""

import re

_GEMM = re.compile(r"gemm|gemv|splitkreduce", re.IGNORECASE)


def read(t):
    sec = t.kernel_seconds(lambda n: bool(_GEMM.search(n)))
    return sec * 1e3 / t.frames if sec > 0 and t.frames else None
