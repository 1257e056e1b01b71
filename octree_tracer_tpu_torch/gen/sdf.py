"""Floating-island terrain SDF in plain PyTorch (the port of the JAX
package's ``gen/sdf.py``; kernel K7 evaluates the same expression)."""

from __future__ import annotations

import torch

from .noise import sdf_box, sdf_cone, simplex_noise3, smin, smoothstep

_CONE_SCALE = (1.5, -1.5, 1.5)
# The factors that scale a position into the noise: the base octaves take
# BASE_SCALE and twice it, the spike octaves SPIKE_SCALE and twice it.
BASE_SCALE = 1.6
SPIKE_SCALE = (2.3, 0.4, 2.3)


def island_sdf(pos: torch.Tensor) -> torch.Tensor:
    """Signed distance of the island terrain; ``pos`` f32[..., 3] -> f32[...].

    Negative is inside: a rounded box core, two octaves of simplex noise,
    smin-blended under-spikes, and a spike-noise bias shaped by height and
    radial distance."""
    v = sdf_box(pos, (0.7, 0.1, 0.7)) - 0.1
    scale = BASE_SCALE
    base_noise = simplex_noise3(pos * scale) + 0.5 * simplex_noise3(pos * (scale * 2.0))
    v = v + 0.07 * base_noise

    dist = torch.sqrt(pos[..., 0] * pos[..., 0] + pos[..., 2] * pos[..., 2])
    cone_scale = torch.tensor(_CONE_SCALE, dtype=pos.dtype, device=pos.device)
    cone_shift = torch.tensor((0.0, 1.0, 0.0), dtype=pos.dtype, device=pos.device)
    cone = sdf_cone(pos * cone_scale - cone_shift, (0.5, 0.5), 0.9) - 0.1
    v = smin(v, cone, 0.2)

    spike_scale = torch.tensor(SPIKE_SCALE, dtype=pos.dtype, device=pos.device)
    spike_noise = simplex_noise3(pos * spike_scale) + 0.5 * simplex_noise3(
        pos * (spike_scale * 2.0))
    height_bias = smoothstep(0.0, -1.5, pos[..., 1]) + smoothstep(0.0, 0.2, pos[..., 1])
    spike_noise = spike_noise + 1.6 * dist + height_bias * 2.0 - 1.0
    return v + 0.3 * spike_noise
