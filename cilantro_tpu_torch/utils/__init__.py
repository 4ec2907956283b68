"""Utilities (port of ``cilantro_tpu.utils``, in part): nearest-neighbour
graph matrices (``utils/graph.py``) and classical MDS (``utils/mds.py``).
The package re-exports nothing yet: PLY and matrix I/O, colour maps,
timers and profiling are still to be ported."""
