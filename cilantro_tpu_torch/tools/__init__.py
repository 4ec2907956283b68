"""Measurement probes (port of the repository's ``tools/``) and the SLAM
backend's shared test problems (``slam_problems``). Importing a module
here runs nothing; each probe runs as ``python -m
cilantro_tpu_torch.tools.<name>``."""
