"""Fixed-capacity SoA pedestrian state (the on-device PedState).

The reference keeps a dynamically grown structured numpy array with a Python
object column for the FSM (/root/reference/pedestrian_state.py:17-19) and
appends/deletes rows on spawn/despawn.  Under jit everything must be static
shape, so the population lives in ``(capacity,)`` arrays with ``alive`` /
``spawned`` masks: spawn = write-at-slot, despawn = clear mask.  All force and
FSM kernels respect the masks, which makes a masked fixed-capacity rollout
bit-equivalent to the reference's grow/shrink semantics.

Positions/velocities are 2-D; the reference's math is already 2-D (z is only
carried to/from CARLA, SURVEY.md section 7 layer 1).  Coordinates are stored
as SEPARATE x/y planes, never ``(N, 2)``: every kernel and jnp pass reads
contiguous per-coordinate planes with N minor.  The ``pos`` /
``vel`` / ``waypoint`` properties assemble ``(N, 2)`` views for host-side
consumers (CSV, bridge, tests); on-device math uses the planes.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from ..ops.vecmath import split_xy, stack_xy  # noqa: F401  (re-export)
from . import modes


@pytree_dataclass
class PedState:
    """Per-slot pedestrian state arrays (all shaped ``(capacity,)``)."""

    pos_x: jnp.ndarray          # (N,) location [m]
    pos_y: jnp.ndarray
    vel_x: jnp.ndarray          # (N,) velocity [m/s]
    vel_y: jnp.ndarray
    radius: jnp.ndarray         # (N,)  pedestrian radius [m]
    base_speed: jnp.ndarray     # (N,)  configured walking target speed
    crossing_speed: jnp.ndarray  # (N,) crossing_speed_factor * base_speed
    safety_margin: jnp.ndarray  # (N,)  gap-acceptance safety margin [s]
    fsm_target: jnp.ndarray     # (N,)  FSM-internal target speed
    applied_target: jnp.ndarray  # (N,) target speed applied this tick (quirk)
    mode: jnp.ndarray           # (N,)  int32 PedMode
    next_mode_time: jnp.ndarray  # (N,) IDLE promotion deadline [s]
    wp_x: jnp.ndarray           # (N,) current next waypoint
    wp_y: jnp.ndarray
    waypoint_idx: jnp.ndarray   # (N,)  int32 index into the route buffer
    alive: jnp.ndarray          # (N,)  bool: currently simulated
    spawned: jnp.ndarray        # (N,)  bool: slot has been activated

    @property
    def capacity(self) -> int:
        return self.pos_x.shape[0]

    # (N, 2) assembly views for host-side consumers; device math uses planes
    @property
    def pos(self) -> jnp.ndarray:
        return stack_xy(self.pos_x, self.pos_y)

    @property
    def vel(self) -> jnp.ndarray:
        return stack_xy(self.vel_x, self.vel_y)

    @property
    def waypoint(self) -> jnp.ndarray:
        return stack_xy(self.wp_x, self.wp_y)

    def replace_coords(self, pos=None, vel=None, waypoint=None, **kw):
        """``dataclasses.replace`` accepting ``(N, 2)`` arrays (or (x, y)
        tuples) for the coordinate fields -- convenience for host-side
        construction; device code writes the planes directly."""
        import dataclasses
        if pos is not None:
            kw["pos_x"], kw["pos_y"] = split_xy(pos)
        if vel is not None:
            kw["vel_x"], kw["vel_y"] = split_xy(vel)
        if waypoint is not None:
            kw["wp_x"], kw["wp_y"] = split_xy(waypoint)
        return dataclasses.replace(self, **kw)

    def max_speed(self, max_speed_factor):
        """Speed cap = applied target speed * factor (reference
        pedestrian_state.py:72-73 with the effective default factor)."""
        return self.applied_target * max_speed_factor

    @staticmethod
    def empty(capacity: int, dtype=jnp.float32) -> "PedState":
        z = jnp.zeros((capacity,), dtype)
        return PedState(
            pos_x=z, pos_y=z, vel_x=z, vel_y=z, radius=z, base_speed=z,
            crossing_speed=z, safety_margin=z, fsm_target=z, applied_target=z,
            mode=jnp.full((capacity,), modes.WALKING_SIDEWALK, jnp.int32),
            next_mode_time=jnp.full((capacity,), -1.0, dtype),
            wp_x=z, wp_y=z,
            waypoint_idx=jnp.zeros((capacity,), jnp.int32),
            alive=jnp.zeros((capacity,), bool),
            spawned=jnp.zeros((capacity,), bool),
        )
