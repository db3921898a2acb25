"""Moussaid et al. (2010) social-group forces, on device.

Implements the three group terms of Moussaid, Perozo, Garnier, Helbing &
Theraulaz, "The walking behaviour of pedestrian social groups and its
impact on crowd dynamics" (PLoS ONE 5(4):e10047) on top of any base
pair-force family.  The reference framework has no group model at all
(/root/reference/forces.py implements only the 2009 individual forces);
this module is a beyond-reference capability, enabled by ``[forces]
group_force`` plus ``group_size`` on a ``[[walker.ped_spawner]]``.

Design:

* Group membership is STATIC -- it is decided by the spawn schedule, so it
  lives in scene data, not the scan carry: a per-slot ``group_id``
  ((N,), -1 = ungrouped, sharded with the slots) plus a global
  ``member_slot`` table ((G, M_max) slot indices, replicated).
* All three terms are computed in the small ``(G, M_max)`` member space
  (group sizes are 2-6 in the paper's data; M_max defaults to 8): gather
  the members' state, compute centroid/gaze/attraction plus the tiny
  (G, M, M) within-group repulsion, and scatter-add the forces back to
  the slots.  The gathers/scatter are ``O(total grouped members)`` --
  independent of the crowd size N, so a 10%-grouped million-agent crowd
  pays for 100k rows, not 1M.
* Under agent-sharding the member table holds GLOBAL slot ids, so the
  planes are ``all_gather``-ed over the axis (the same pattern as the
  autopilot's hazard-check gather) and each shard scatter-adds only its
  own rows (out-of-shard rows drop).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass
from .params import GroupParams


@pytree_dataclass
class GroupSet:
    """Static group structure (host-built; see :func:`build_groups`).

    ``member_slot``: (G, M_max) int32 global slot indices, -1-padded.
    Replicated under sharding (global ids); the per-slot ``group_id``
    companion rides SpawnSchedule.group_id and shards with the slots.
    """

    member_slot: jnp.ndarray

    @property
    def n_groups(self) -> int:
        return self.member_slot.shape[0]

    @property
    def max_members(self) -> int:
        return self.member_slot.shape[1]


def build_groups(group_id: np.ndarray, max_members: int = 8) -> GroupSet | None:
    """Build the (G, M_max) member table from per-slot group ids.

    ``group_id``: (N,) ints, -1 = not in a group.  Group ids need not be
    contiguous.  Returns None when no slot is grouped.  Groups larger than
    ``max_members`` raise (the paper's data covers sizes 2-6; raise
    ``max_members`` for larger parties).
    """
    group_id = np.asarray(group_id)
    ids = np.unique(group_id[group_id >= 0])
    if ids.size == 0:
        return None
    counts = {g: int((group_id == g).sum()) for g in ids}
    biggest = max(counts.values())
    if biggest > max_members:
        raise ValueError(
            f"group of {biggest} members exceeds max_members={max_members}; "
            f"raise max_members in build_groups")
    table = np.full((ids.size, max_members), -1, np.int32)
    for row, g in enumerate(ids):
        slots = np.nonzero(group_id == g)[0]
        table[row, : slots.size] = slots
    return GroupSet(member_slot=jnp.asarray(table))


def group_force(pos_x, pos_y, vel_x, vel_y, ex, ey, alive, groups: GroupSet,
                p: GroupParams, axis_name: str | None = None):
    """(fx, fy) planes of the Moussaid-2010 group force on every slot.

    ``ex, ey``: the members' desired (gaze) directions -- the paper's
    "gazing direction"; the stepper passes the desired direction toward
    the next waypoint (stable at v = 0, consistent with the Helbing FoV
    treatment).  Slots not in any group, dead members, and single-survivor
    groups get exactly zero.
    """
    n_local = pos_x.shape[0]
    if axis_name is not None:
        g = lambda a: jax.lax.all_gather(a, axis_name, tiled=True)  # noqa: E731
        gpx, gpy, gvx, gvy, gex, gey, gal = (
            g(pos_x), g(pos_y), g(vel_x), g(vel_y), g(ex), g(ey), g(alive))
        offset = jax.lax.axis_index(axis_name) * n_local
    else:
        gpx, gpy, gvx, gvy, gex, gey, gal = (
            pos_x, pos_y, vel_x, vel_y, ex, ey, alive)
        offset = 0
    n_global = gpx.shape[0]

    ms = groups.member_slot                       # (G, M)
    valid = ms >= 0
    idx = jnp.maximum(ms, 0)
    # ONE packed row gather instead of seven: pack the planes into (N, 8)
    # first, so the member fetch is one gather; the pack itself is a cheap
    # contiguous concat.
    packed = jnp.stack([gpx, gpy, gvx, gvy, gex, gey,
                        gal.astype(gpx.dtype)], axis=-1)    # (N, 7)
    m = packed[idx]                               # (G, M, 7): single gather
    mpx, mpy = m[..., 0], m[..., 1]
    mvx, mvy = m[..., 2], m[..., 3]
    mex, mey = m[..., 4], m[..., 5]
    mal = (m[..., 6] > 0.0) & valid               # (G, M) member liveness

    w = mal.astype(mpx.dtype)
    cnt = jnp.sum(w, axis=1, keepdims=True)       # (G, 1) alive members
    sx = jnp.sum(mpx * w, axis=1, keepdims=True)
    sy = jnp.sum(mpy * w, axis=1, keepdims=True)
    # centroid of the OTHER alive members, per member
    others = jnp.maximum(cnt - 1.0, 1.0)
    ocx = (sx - mpx * w) / others
    ocy = (sy - mpy * w) / others
    act = mal & (cnt >= 2.0)                      # terms need >= 2 members

    dx = ocx - mpx                                # member -> others' centroid
    dy = ocy - mpy
    d2 = dx * dx + dy * dy
    use = act & (d2 > 0.0)
    # every d2 == 0 operand is re-based before the singular op (sqrt at 0,
    # arctan2 at (0,0)): the masked-out lanes would otherwise poison
    # reverse-mode AD with 0-cotangent * inf = NaN -- systematic for
    # fully-dead groups parked at the zero-initialized origin (the same
    # VJP hazard the pair forces guard against)
    d2s = jnp.where(use, d2, 1.0)
    dist = jnp.sqrt(d2s)
    inv = jnp.where(use, 1.0 / dist, 0.0)
    ux = dx * inv
    uy = dy * inv

    # gaze: alpha = |angle(e_i, direction to others' centroid)|; the term
    # damps the velocity in proportion to how far the member must turn
    # their head (paper eq. f_vis = -beta1 * alpha * v_i)
    cross = jnp.where(use, mex * dy - mey * dx, 0.0)
    dot = jnp.where(use, mex * dx + mey * dy, 1.0)
    # a zero gaze vector (a member standing exactly on its waypoint) still
    # reaches arctan2 as (0, 0) on a USED lane -- rebase to alpha = 0 so
    # the VJP (which divides by cross^2 + dot^2) stays finite
    dot = jnp.where((cross == 0.0) & (dot == 0.0), 1.0, dot)
    alpha = jnp.abs(jnp.arctan2(cross, dot))
    aw = jnp.where(use, p.beta_vis * alpha, 0.0)
    fx = -aw * mvx
    fy = -aw * mvy

    # attraction toward the others' centroid beyond the size-dependent
    # threshold (M-1)/2 m (paper's q_A gate, M = alive group size)
    q_att = use & (dist > (cnt - 1.0) * 0.5)
    fx = fx + jnp.where(q_att, p.beta_att * ux, 0.0)
    fy = fy + jnp.where(q_att, p.beta_att * uy, 0.0)

    # within-group repulsion: away from each member closer than
    # rep_distance (social comfort spacing; paper's q_R gate)
    rdx = mpx[:, :, None] - mpx[:, None, :]       # (G, M, M): k -> i
    rdy = mpy[:, :, None] - mpy[:, None, :]
    rd2 = rdx * rdx + rdy * rdy
    rinv = jnp.where(rd2 == 0.0, 0.0,
                     1.0 / jnp.sqrt(jnp.where(rd2 == 0.0, 1.0, rd2)))
    pair = (mal[:, :, None] & mal[:, None, :]
            & (rd2 > 0.0) & (rd2 < p.rep_distance * p.rep_distance))
    rw = jnp.where(pair, p.beta_rep * rinv, 0.0)
    fx = fx + jnp.sum(rw * rdx, axis=2)
    fy = fy + jnp.sum(rw * rdy, axis=2)

    # scatter back to the local slots; padded/dead rows target n_global,
    # which "drop"s everywhere, and out-of-shard rows drop on this shard.
    # NB: .at[] wraps NEGATIVE indices (numpy semantics) even under
    # mode="drop", so below-shard rows must be remapped to an explicit
    # out-of-bounds index, not left negative
    tgt = jnp.where(mal, idx, n_global).reshape(-1) - offset
    tgt = jnp.where(tgt >= 0, tgt, n_local)
    # one packed scatter (same ~10 ns/row economics as the gather above)
    fxy = jnp.stack([fx.reshape(-1), fy.reshape(-1)], axis=-1)   # (G*M, 2)
    out = jnp.zeros((n_local, 2), mpx.dtype).at[tgt].add(fxy, mode="drop")
    return out[:, 0], out[:, 1]
