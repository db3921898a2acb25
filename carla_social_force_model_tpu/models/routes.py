"""Padded per-pedestrian waypoint buffers.

The reference keeps remaining waypoints in a host-side dict of Python lists
popped on arrival (run_simulation.py:118-132, pedestrian_spawner.py:161-164).
On device, each slot owns a padded row of a ``(capacity, max_waypoints, 2)``
buffer plus a per-waypoint crossing-road flag; arrival advances an index.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass


@pytree_dataclass
class RouteBuffer:
    # coordinates as separate x/y planes (size-2 minor dims pad 2 -> 128
    # planes; see models/state.py)
    wp_x: jnp.ndarray       # (N, W) f32
    wp_y: jnp.ndarray       # (N, W) f32
    crossing: jnp.ndarray   # (N, W) bool: road crossed when heading to wp
    count: jnp.ndarray      # (N,) int32 number of valid waypoints

    @property
    def max_waypoints(self) -> int:
        return self.wp_x.shape[1]

    @property
    def waypoints(self) -> jnp.ndarray:
        """(N, W, 2) assembly view (host-side consumers)."""
        from ..ops.vecmath import stack_xy
        return stack_xy(self.wp_x, self.wp_y)


def build_route_buffer(routes: Sequence[np.ndarray],
                       crossing_flags: Sequence[Sequence[bool]],
                       capacity: int | None = None,
                       dtype=np.float32) -> RouteBuffer:
    """Pack per-ped waypoint lists into a RouteBuffer.

    ``routes[i]`` is an (W_i, 2) array; ``crossing_flags[i]`` aligns with it.
    Mismatched lengths are trimmed to the shorter (the reference's zip
    semantics, pedestrian_spawner.py:209).
    """
    n = capacity if capacity is not None else len(routes)
    w_max = max([1] + [min(len(r), len(c)) for r, c in zip(routes, crossing_flags)])
    wp = np.zeros((n, w_max, 2), dtype=dtype)
    cr = np.zeros((n, w_max), dtype=bool)
    cnt = np.zeros((n,), dtype=np.int32)
    for i, (r, c) in enumerate(zip(routes, crossing_flags)):
        k = min(len(r), len(c))
        wp[i, :k] = np.asarray(r, dtype=dtype).reshape(-1, 2)[:k]
        cr[i, :k] = np.asarray(c, dtype=bool)[:k]
        cnt[i] = k
    return RouteBuffer(wp_x=jnp.asarray(wp[..., 0]),
                       wp_y=jnp.asarray(wp[..., 1]),
                       crossing=jnp.asarray(cr), count=jnp.asarray(cnt))
