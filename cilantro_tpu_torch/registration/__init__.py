"""Transform estimation (port of ``cilantro_tpu.registration``)."""
