"""Scalar → RGB colormaps (port of ``cilantro_tpu/utils/colormap.py``;
reference ``visualization/colormap.hpp:7-74``: JET / GRAY / BLUE2RED), in
float32 torch ops on the values' device, for colouring residuals,
curvature or confidence where they lie."""

from __future__ import annotations

import torch

from .. import on_device


def _normalize(values, vmin=None, vmax=None, device=None):
    v = on_device(values, device, torch.float32)
    lo = torch.min(v) if vmin is None else torch.tensor(vmin, dtype=torch.float32, device=v.device)
    hi = torch.max(v) if vmax is None else torch.tensor(vmax, dtype=torch.float32, device=v.device)
    return torch.clamp((v - lo) / torch.clamp(hi - lo, min=1e-30), 0.0, 1.0)


def colormap_gray(values, vmin=None, vmax=None, device=None):
    t = _normalize(values, vmin, vmax, device)
    return torch.stack([t, t, t], dim=-1)


def colormap_blue2red(values, vmin=None, vmax=None, device=None):
    t = _normalize(values, vmin, vmax, device)
    return torch.stack([t, torch.zeros_like(t), 1.0 - t], dim=-1)


def colormap_jet(values, vmin=None, vmax=None, device=None):
    t = _normalize(values, vmin, vmax, device) * 4.0
    r = torch.clamp(torch.minimum(t - 1.5, -t + 4.5), 0.0, 1.0)
    g = torch.clamp(torch.minimum(t - 0.5, -t + 3.5), 0.0, 1.0)
    b = torch.clamp(torch.minimum(t + 0.5, -t + 2.5), 0.0, 1.0)
    return torch.stack([r, g, b], dim=-1)


def colormap(values, name: str = "jet", vmin=None, vmax=None, device=None):
    """``values`` (any shape) → ``(..., 3)`` RGB in [0, 1]. A tensor stays
    on its device; other arrays go to ``device`` (the card by default)."""
    return {
        "jet": colormap_jet,
        "gray": colormap_gray,
        "blue2red": colormap_blue2red,
    }[name](values, vmin, vmax, device)
