"""Runnable demos (port of the JAX package's ``examples/*.py``), one module
each, covering every program in the reference's ``examples/`` directory:
``python -m cilantro_tpu_torch.examples.<name> [--device cpu]``. Each
prints what its JAX script prints, line for line; see ``README.md`` here
for the map of reference programs to modules.

Where a JAX script reads the reference's ``frame_1.ply`` by default, the
module's default input is a synthetic height field of 120,000 points
(:func:`._common.height_field`); a PLY path stays an optional argument.
Nothing runs at import."""
