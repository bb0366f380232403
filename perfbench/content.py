"""Photo-like 4:2:0 frames made from a seed on the device.

The Kodak set is not in the repository, so each frame is drawn to have
what natural images give an encoder: smooth gradients (a coarse random
field, bicubically upsampled), edges (a Voronoi partition of 24 regions,
each with its own brightness and colour offset), texture (band-limited
noise in four octaves, its strength set per region)
and sensor-like noise. Every draw's distribution is fixed, so seeds
change where things are, not how much there is of each, and a batch of
frames costs an encoder about the same whatever the seed.

``frames`` returns numpy planes (Y (H, W), U and V (H/2, W/2), uint8,
limited range). The same seed and device give the same frames.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

REGIONS = 24


def _field(g, count: int, h: int, w: int, gh: int, gw: int, mode: str, device) -> torch.Tensor:
    """(count, h, w) noise of unit spread, band-limited by upsampling a
    (gh, gw) grid."""
    grid = torch.randn((count, 1, gh, gw), generator=g, device=device)
    kw = {"align_corners": False} if mode != "nearest" else {}
    return F.interpolate(grid, size=(h, w), mode=mode, **kw)[:, 0]


def _planes(g, count: int, h: int, w: int, device):
    """(Y (count, h, w), U, V (count, h/2, w/2)) float32, before rounding."""
    # Voronoi regions: every pixel takes the label of its nearest site
    sites = torch.rand((count, REGIONS, 2), generator=g, device=device) * torch.tensor([h, w], device=device)
    ys = torch.arange(h, device=device, dtype=torch.float32)
    xs = torch.arange(w, device=device, dtype=torch.float32)
    best = torch.full((count, h, w), float("inf"), device=device)
    label = torch.zeros((count, h, w), dtype=torch.int64, device=device)
    for r in range(REGIONS):
        d = (ys[None, :, None] - sites[:, r, 0, None, None]) ** 2 + (xs[None, None, :] - sites[:, r, 1, None, None]) ** 2
        closer = d < best
        best = torch.where(closer, d, best)
        label = torch.where(closer, r, label)
    offset = torch.randn((count, REGIONS, 3), generator=g, device=device) * torch.tensor([30.0, 10.0, 10.0],
                                                                                           device=device)
    strength = torch.rand((count, REGIONS), generator=g, device=device) * 18.0 + 3.0
    flat = label.reshape(count, -1)

    def per_region(values):
        return torch.gather(values, 1, flat).reshape(count, h, w)

    # a 1/f spectrum: about equal spread in every octave, the coarse
    # octaves everywhere, the fine ones scaled by each region's texture
    y = 125.0 + per_region(offset[..., 0])
    for cells in (4, 8, 16):
        y = y + 16.0 * _field(g, count, h, w, cells, cells * 3 // 2, "bicubic", device)
    amp = per_region(strength)
    for cells in (32, 64, 128, 256):
        y = y + amp * _field(g, count, h, w, cells, cells * 3 // 2, "bilinear", device)
    y = y + 2.0 * torch.randn((count, h, w), generator=g, device=device)
    ch, cw = h // 2, w // 2
    chroma = []
    for k in (1, 2):
        c = 128.0 + 14.0 * _field(g, count, ch, cw, 4, 5, "bicubic", device)
        c = c + per_region(offset[..., k])[:, ::2, ::2]
        c = c + 0.8 * torch.randn((count, ch, cw), generator=g, device=device)
        chroma.append(c)
    return y, chroma[0], chroma[1]


def frames(count: int, width: int, height: int, seed: int, device) -> list:
    """``count`` frames of ``width`` x ``height`` (both even) from ``seed``,
    made on ``device`` in a few large calls; per frame its (Y, U, V)
    planes as numpy uint8, limited range."""
    if width % 2 or height % 2:
        raise ValueError("4:2:0 frames need an even width and height")
    device = torch.device(device)
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 64))
    y, u, v = _planes(g, count, height, width, device)
    y = y.round().clamp(16, 235).to(torch.uint8).cpu().numpy()
    u = u.round().clamp(16, 240).to(torch.uint8).cpu().numpy()
    v = v.round().clamp(16, 240).to(torch.uint8).cpu().numpy()
    return [(y[k], u[k], v[k]) for k in range(count)]
