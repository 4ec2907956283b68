"""Small cells for the benchmark's CPU tests: the real cells' files with the
sensor cut to 48×64 (intrinsics scaled by 0.1) and clips of 8 frames."""

from __future__ import annotations

from portbench import harness

SENSOR = {"height": 48, "width": 64, "fx": 52.5, "fy": 52.5, "cx": 31.5, "cy": 23.5}
CELLS = ("splat.clip16", "pool.clip16", "pool.streams8")


def small_cell(name: str) -> harness.Cell:
    c = harness.load_cell(name)
    c.config = dict(c.config, sensor=SENSOR)
    if "map_capacity" in c.config:
        c.config["map_capacity"] = int(1.4 * SENSOR["height"] * SENSOR["width"])
    streams = min(c.traffic["streams"], 2)
    c.traffic = dict(c.traffic, frames=8, streams=streams, distinct_clips=2 * streams,
                     trace_calls=1)
    return c
