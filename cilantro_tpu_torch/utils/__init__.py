"""Utilities (port of ``cilantro_tpu.utils``): PLY and matrix I/O,
nearest-neighbour graph matrices, classical MDS, colour maps, timers,
roofline lines, two-count op timing and profiling."""

from .ply_io import read_ply, read_point_cloud, write_point_cloud  # noqa: F401
from .graph import (  # noqa: F401
    neighborhood_degrees,
    adjacency_dense,
    distance_dense,
    function_value_dense,
    function_value_sparse,
)
from .mds import MDSResult, mds  # noqa: F401
from .colormap import (  # noqa: F401
    colormap,
    colormap_jet,
    colormap_gray,
    colormap_blue2red,
)
from .io import (  # noqa: F401
    read_matrix,
    write_matrix,
    read_matrix_raw,
    write_matrix_raw,
)
from .timer import Timer, time_blocked  # noqa: F401
from . import profiling  # noqa: F401
