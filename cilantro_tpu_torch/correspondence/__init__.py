"""Correspondence search (port of ``cilantro_tpu.correspondence``, the
unidirectional nearest-neighbour part)."""
