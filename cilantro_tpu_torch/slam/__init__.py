"""Splat fusion and its kernels (port of ``cilantro_tpu.slam``)."""
