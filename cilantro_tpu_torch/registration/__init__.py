"""Transform estimation and rigid ICP (port of ``cilantro_tpu.registration``)."""
