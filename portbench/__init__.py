"""The benchmark of ``cilantro_tpu_torch`` on one NVIDIA H100: RGBD fusion
frames/s through the package's whole-clip entries, checked against a plain
PyTorch reference. ``python3 -m portbench.run --help`` runs one cell."""
