"""One module a pipeline, found by the configuration's ``pipeline`` name.

A module defines ``Pipeline(config, traffic, device)`` with

* ``inputs(depths)``: the calls a set of clips ``(N, F, H, W)`` makes;
* ``call(inp)``: one call of the measured entry, an :class:`Output`;
* ``cloud(map)``: a returned map's world points, validity, normals and
  confidence;
* ``reference(inp, device)``: the plain reference's :class:`Output` for
  the same input.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class Output:
    poses: np.ndarray  # (streams, frames, 4, 4) camera-to-world
    maps: List[object]  # one map a stream, a tensor
    frames: int  # frames delivered, every stream's, the seed frames too
