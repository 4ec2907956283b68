"""Transforms and RGBD conversions (port of ``cilantro_tpu.core``)."""
