"""Float64 numpy parity oracle.

Independent re-derivation of the reference force math (Moussaid et al. 2009 /
Helbing-Molnar 1995, as realized in /root/reference/forces.py,
stateutils.py, check_traffic.py and ped_mode_manager.py), kept deliberately
simple and loop-based so it is easy to audit against the published formulas.
The jnp and kernel paths are validated against this oracle within tight
tolerances.

Conventions (matching the reference):
* pair direction e_ij points from pedestrian i toward partner j,
* relative velocity is v_i - v_j,
* theta = angle(e_ij) - angle(t_hat), wrapped to [-pi, pi],
* per border/obstacle only the single closest sampled point interacts,
  first-occurrence argmin tie-breaking.
"""
from __future__ import annotations

import numpy as np

IDLE, WALKING, CROSSING, ROAD_TO_SIDEWALK, CHECKING = 0, 1, 2, 3, 4


def unit(v):
    n = np.linalg.norm(v, axis=-1)
    safe = np.where(n == 0.0, 1.0, n)
    return v / np.expand_dims(safe, -1), n


def wrap(a):
    a = np.where(a > np.pi, a - 2 * np.pi, a)
    a = np.where(a < -np.pi, a + 2 * np.pi, a)
    return a


def acceleration_force(pos, vel, waypoint, target_speed, tau):
    e, _ = unit(waypoint - pos)
    return (target_speed[:, None] * e - vel) / tau


def moussaid_term(e, d, dv, lam, A, gamma, n, n_prime, eps):
    """One pairwise Moussaid force contribution (vector e, distance d,
    relative velocity dv). Returns a 2-vector; zero when the interaction
    strength vanishes."""
    t_vec = lam * dv + e
    t_len = np.linalg.norm(t_vec)
    if t_len == 0.0:
        return np.zeros(2)
    t_hat = t_vec / t_len
    n_hat = np.array([-t_hat[1], t_hat[0]])
    theta = wrap(np.arctan2(e[1], e[0]) - np.arctan2(t_hat[1], t_hat[0]))
    B = gamma * t_len
    theta = theta + B * (-eps)
    f_v = -A * np.exp(-d / B - (n_prime * B * theta) ** 2)
    f_t = -A * np.sign(theta) * np.exp(-d / B - (n * B * theta) ** 2)
    return f_v * t_hat + f_t * n_hat


def pedestrian_force(pos, vel, radius, alive, lam, A, gamma, n, n_prime, eps,
                     use_radius=False):
    cnt = pos.shape[0]
    out = np.zeros((cnt, 2))
    for i in range(cnt):
        if not alive[i]:
            continue
        for j in range(cnt):
            if j == i or not alive[j]:
                continue
            diff = pos[j] - pos[i]
            dist = np.linalg.norm(diff)
            e = diff / dist if dist > 0 else np.zeros(2)
            d = dist - (radius[i] + radius[j]) if use_radius else dist
            dv = vel[i] - vel[j]
            out[i] += moussaid_term(e, d, dv, lam, A, gamma, n, n_prime, eps)
    return out


def border_force(pos, mode, radius, alive, borders, centers, lengths, a, b,
                 use_radius=False):
    """borders: list of (P, 2) point arrays; centers/lengths per border."""
    cnt = pos.shape[0]
    out = np.zeros((cnt, 2))
    for i in range(cnt):
        if not alive[i]:
            continue
        if mode[i] in (CROSSING, ROAD_TO_SIDEWALK):
            continue
        for s, pts in enumerate(borders):
            if len(pts) == 0:
                continue
            if not (np.linalg.norm(pos[i] - centers[s]) < lengths[s]):
                continue
            k = int(np.argmin(np.linalg.norm(pos[i] - pts, axis=-1)))
            diff = pos[i] - pts[k]
            dist = np.linalg.norm(diff)
            e = diff / dist if dist > 0 else np.zeros(2)
            d = dist - radius[i] if use_radius else dist
            out[i] += e * a * np.exp(-d / b)
    return out


def obstacle_force(pos, vel, radius, alive, outlines, centers, obstacle_vel,
                   lam, A, gamma, n, n_prime, eps, threshold,
                   use_radius=False, active=None):
    cnt = pos.shape[0]
    out = np.zeros((cnt, 2))
    for i in range(cnt):
        if not alive[i]:
            continue
        for s, pts in enumerate(outlines):
            if active is not None and not active[s]:
                continue
            if len(pts) == 0:
                continue
            if not (np.linalg.norm(pos[i] - centers[s]) < threshold):
                continue
            k = int(np.argmin(np.linalg.norm(pos[i] - pts, axis=-1)))
            diff = pts[k] - pos[i]
            dist = np.linalg.norm(diff)
            e = diff / dist if dist > 0 else np.zeros(2)
            d = dist - radius[i] if use_radius else dist
            dv = vel[i] - obstacle_vel[s]
            out[i] += moussaid_term(e, d, dv, lam, A, gamma, n, n_prime, eps)
    return out


def ped_repulsive_force(pos, vel, desired_dir, alive, v0, sigma, fov_phi_deg,
                        fov_factor, step_width, b_min=0.1):
    """Helbing-Molnar 1995 elliptical repulsion + field-of-view weight,
    derived directly from the paper (eqs. 3, 4, 7).  ``b_min`` clamps the
    ellipse semi-minor axis (the b -> 0 equal-speed-follower singularity;
    see PedRepulsiveParams.b_min)."""
    cnt = pos.shape[0]
    out = np.zeros((cnt, 2))
    cos_phi = np.cos(np.deg2rad(fov_phi_deg))
    for i in range(cnt):
        if not alive[i]:
            continue
        for j in range(cnt):
            if j == i or not alive[j]:
                continue
            d = pos[i] - pos[j]
            y = step_width * vel[j]
            dmy = d - y
            nd, ndmy = np.linalg.norm(d), np.linalg.norm(dmy)
            s = nd + ndmy
            b2 = max(s * s - y @ y, 0.0) / 4.0
            b = np.sqrt(b2)
            if b == 0.0 or nd == 0.0 or ndmy == 0.0:
                continue
            b = max(b, b_min)
            grad = s / (4.0 * b) * (d / nd + dmy / ndmy)
            f = (v0 / sigma) * np.exp(-b / sigma) * grad
            toward = -f
            seen = desired_dir[i] @ toward >= np.linalg.norm(toward) * cos_phi
            out[i] += f if seen else fov_factor * f
    return out


def space_repulsive_force(pos, mode, alive, borders, centers, lengths, u0, r):
    cnt = pos.shape[0]
    out = np.zeros((cnt, 2))
    for i in range(cnt):
        if not alive[i] or mode[i] in (CROSSING, ROAD_TO_SIDEWALK):
            continue
        for s, pts in enumerate(borders):
            if len(pts) == 0:
                continue
            if not (np.linalg.norm(pos[i] - centers[s]) < lengths[s]):
                continue
            k = int(np.argmin(np.linalg.norm(pos[i] - pts, axis=-1)))
            diff = pos[i] - pts[k]
            dist = np.linalg.norm(diff)
            e = diff / dist if dist > 0 else np.zeros(2)
            out[i] += e * (u0 / r) * np.exp(-dist / r)
    return out


def cap_velocity(v, vmax):
    speed = np.linalg.norm(v, axis=-1)
    safe = np.where(speed == 0.0, 1.0, speed)
    factor = np.minimum(1.0, vmax / safe)
    return v * factor[:, None]


def gap_acceptance_ready(ped_loc, ped_goal, ped_speed, margin,
                         veh_center, veh_vel, veh_ext_long, active=None):
    """True when the pedestrian may start crossing (check_traffic.py:7-61),
    with per-vehicle longitudinal extents (the correct-physics variant of the
    reference's first-vehicle quirk)."""
    if margin < 0:
        return True
    t_ped = np.linalg.norm(ped_goal - ped_loc) / ped_speed
    for v in range(len(veh_center)):
        if active is not None and not active[v]:
            continue
        speed = np.linalg.norm(veh_vel[v])
        if speed == 0.0:
            continue
        direction = veh_vel[v] / speed
        front = veh_center[v] + direction * veh_ext_long[v]
        back = veh_center[v] - direction * veh_ext_long[v]
        goal = front + veh_vel[v] * (t_ped + margin)
        hit, point = _seg_intersect(ped_loc, ped_goal, back, goal)
        if not hit:
            continue
        tti_ped = np.linalg.norm(point - ped_loc) / ped_speed
        tti_front = np.linalg.norm(point - front) / speed
        tti_back = np.linalg.norm(point - back) / speed
        if tti_front - margin < tti_ped < tti_back + margin:
            return False
    return True


def _seg_intersect(p0, p1, q0, q1):
    r = p1 - p0
    s = q1 - q0
    denom = r[0] * s[1] - r[1] * s[0]
    if denom == 0.0:
        return False, np.zeros(2)
    qp = q0 - p0
    t = (qp[0] * s[1] - qp[1] * s[0]) / denom
    u = (qp[0] * r[1] - qp[1] * r[0]) / denom
    if 0.0 <= t <= 1.0 and 0.0 <= u <= 1.0:
        return True, p0 + t * r
    return False, np.zeros(2)


def group_force(pos, vel, desired, alive, group_id, beta_vis=4.0,
                beta_att=3.0, beta_rep=1.0, rep_distance=0.55):
    """Moussaid et al. 2010 social-group forces (PLoS ONE 5(4):e10047),
    loop-based f64: gaze f_vis = -beta1*alpha*v_i toward the OTHER alive
    members' centroid, attraction beta2*U beyond the (M-1)/2 m threshold,
    within-group repulsion beta3*W under rep_distance.  ``group_id``: -1 =
    ungrouped."""
    cnt = pos.shape[0]
    out = np.zeros((cnt, 2))
    for i in range(cnt):
        if not alive[i] or group_id[i] < 0:
            continue
        members = [j for j in range(cnt)
                   if alive[j] and group_id[j] == group_id[i]]
        m = len(members)
        if m < 2:
            continue
        others = [j for j in members if j != i]
        c = np.mean(pos[others], axis=0)
        d = c - pos[i]
        dist = np.linalg.norm(d)
        if dist > 0:
            e = desired[i]
            alpha = abs(np.arctan2(e[0] * d[1] - e[1] * d[0], e @ d))
            out[i] += -beta_vis * alpha * vel[i]
        if dist > (m - 1) / 2.0:
            out[i] += beta_att * d / dist
        for j in others:
            r = pos[i] - pos[j]
            nr = np.linalg.norm(r)
            if 0 < nr < rep_distance:
                out[i] += beta_rep * r / nr
    return out
