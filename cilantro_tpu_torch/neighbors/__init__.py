"""Exact nearest-neighbour search (port of ``cilantro_tpu.neighbors``, the
nn1 part): ``bruteforce.nn1``, the fused / masked / compact nn1 kernels
and the Morton-tile prune plans in ``fused_nn``."""
