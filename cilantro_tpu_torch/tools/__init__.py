"""Measurement probes (port of the repository's ``tools/``). Importing a
probe runs nothing; each runs as ``python -m cilantro_tpu_torch.tools.<name>``."""
