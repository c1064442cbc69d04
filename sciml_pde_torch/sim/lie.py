"""Lie-point-symmetry augmentation for Navier-Stokes (port of
``sciml_pde_tpu/sim/lie.py``).

Nine one-parameter symmetry groups of the 2D incompressible NS equations
(time, x and y translation, scaling, rotation, linear and quadratic
Galilean boosts), composed by 2nd- or higher-order Lie-Trotter splitting
of exp(sum_i g_i X_i).  The transforms act on coordinate and velocity
values; ``augment_ns_window`` keeps the transformed velocities and drops
the transformed coordinates (no resampling), as the reference loader does.

Every group takes the strength ``g`` as a tensor that broadcasts against
the state, so one call transforms a whole batch, each window with its own
strengths.  Strengths are drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch

# default strengths (reference utils_2d_ns_baseline_lie.py:13-23)
DEFAULT_STRENGTHS = (
    0.1,            # g1: time shift
    0.1,            # g2: x-translation
    0.1,            # g3: y-translation
    0.05,           # g4: scaling
    math.pi / 18,   # g5: rotation
    0.2,            # g6: x-Galilean boost
    0.2,            # g7: y-Galilean boost
    0.05,           # g8: x-quadratic boost
    0.05,           # g9: y-quadratic boost
)


# each group: (g, state) -> state with state = (t, x, y, u, v)
def _g1(g, s):
    t, x, y, u, v = s
    return (t + g, x, y, u, v)


def _g2(g, s):
    t, x, y, u, v = s
    return (t, x + g, y, u, v)


def _g3(g, s):
    t, x, y, u, v = s
    return (t, x, y + g, u, v)


def _g4(g, s):
    t, x, y, u, v = s
    e = torch.exp(g)
    return (e * e * t, e * x, e * y, u / e, v / e)


def _g5(g, s):
    t, x, y, u, v = s
    c, sn = torch.cos(g), torch.sin(g)
    return (t, c * x - sn * y, sn * x + c * y, c * u - sn * v, sn * u + c * v)


def _g6(g, s):
    t, x, y, u, v = s
    return (t, x + g * t, y, u + g, v)


def _g7(g, s):
    t, x, y, u, v = s
    return (t, x, y + g * t, u, v + g)


def _g8(g, s):
    # quadratic boost, pressure-free variant (reference group_8 px=None branch)
    t, x, y, u, v = s
    return (t, x + g * t, y, u + g, v)


def _g9(g, s):
    t, x, y, u, v = s
    return (t, x, y + g * t * t, u, v + g)


NS_GROUPS: Sequence[Callable] = (_g1, _g2, _g3, _g4, _g5, _g6, _g7, _g8, _g9)


def lie_trotter_exp_2(state, strengths, factor=1.0):
    """Strang (2nd-order) splitting sweep: reversed half-steps, then forward
    half-steps.  ``strengths[i]`` is group i's strength (a tensor)."""
    n = len(NS_GROUPS)
    for i in reversed(range(n)):
        state = NS_GROUPS[i](factor * strengths[i] / 2.0, state)
    for i in range(n):
        state = NS_GROUPS[i](factor * strengths[i] / 2.0, state)
    return state


def lie_trotter_exp(state, strengths, order: int = 2, steps: int = 1, factor: float = 1.0):
    """Higher-order Suzuki composition of the 2nd-order sweep."""
    if steps == 0:
        return state
    factor = factor / steps
    for _ in range(steps):
        if order == 2:
            state = lie_trotter_exp_2(state, strengths, factor=factor)
        elif order > 2:
            u_k = 1.0 / (4.0 - 4.0 ** (1.0 / (2 * order - 1)))
            for f in (u_k, u_k, 1 - 4 * u_k, u_k, u_k):
                state = lie_trotter_exp(state, strengths, order=order - 2, steps=1,
                                        factor=factor * f)
        elif order == 0:
            pass
        else:
            raise NotImplementedError(order)
    return state


def sample_strengths(generator: torch.Generator | None, batch: int, device=None,
                     max_strengths=DEFAULT_STRENGTHS) -> torch.Tensor:
    """(batch, 9) f32 strengths on ``device``: g1 ~ U(0, s1), g_i ~ U(-s_i,
    s_i) for i > 1.  ``generator`` must live on ``device``."""
    s = torch.tensor(max_strengths, dtype=torch.float32, device=device)
    lo = torch.cat([torch.zeros_like(s[:1]), -s[1:]])
    u = torch.rand((batch, len(max_strengths)), generator=generator, device=device)
    return lo + (s - lo) * u


def _unit_points(n: int, device) -> torch.Tensor:
    """n points from 0 to 1 as ``jnp.linspace`` makes them on XLA's CPU: i
    times the f32 reciprocal of n - 1, and 1 at the end (``torch.linspace``
    steps from both ends and can differ in the last bit)."""
    recip = torch.ones((), dtype=torch.float32) / max(n - 1, 1)
    pts = torch.arange(n, dtype=torch.float32) * recip
    if n > 1:
        pts[-1] = 1.0
    return pts.to(device)


def augment_ns_window(windows: torch.Tensor, strengths: torch.Tensor, order: int = 2,
                      steps: int = 2) -> torch.Tensor:
    """Lie-augment a batch of NS windows.

    windows (B, X, Y, T, C >= 3) with channels (u, v, particles, ...);
    strengths (B, 9), one row a window.  Returns the windows with u and v
    replaced by their transformed values; the other channels pass through."""
    b, nx, ny, nt = windows.shape[:4]
    x = _unit_points(nx, windows.device)[None, :, None, None].expand(b, nx, ny, nt)
    y = _unit_points(ny, windows.device)[None, None, :, None].expand(b, nx, ny, nt)
    t = _unit_points(nt, windows.device)[None, None, None, :].expand(b, nx, ny, nt)
    g = strengths.to(torch.float32).T[:, :, None, None, None]  # (9, B, 1, 1, 1)
    _, _, _, u2, v2 = lie_trotter_exp((t, x, y, windows[..., 0], windows[..., 1]), g,
                                      order=order, steps=steps)
    return torch.cat([u2[..., None], v2[..., None], windows[..., 2:]], dim=-1)
