"""Force-kernel parity vs the float64 numpy oracle.

BASELINE.json names per-step force L-infinity parity as the correctness
metric; these tests enforce it per force on randomized states.
"""
import numpy as np
import jax.numpy as jnp
import pytest

import oracle
from carla_social_force_model_tpu.models.params import (
    AccelerationParams, BorderParams, MoussaidParams)
from carla_social_force_model_tpu.ops import forces
from carla_social_force_model_tpu.env.pointsets import build_chunked_pointset

RNG = np.random.default_rng(42)


def random_crowd(n, alive_frac=1.0):
    pos = RNG.uniform(-20, 20, (n, 2))
    vel = RNG.uniform(-2, 2, (n, 2))
    radius = RNG.uniform(0.2, 0.4, (n,))
    alive = RNG.uniform(size=n) < alive_frac
    return pos, vel, radius, alive


def linf(a, b):
    return np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))


def test_acceleration_force_matches_oracle():
    n = 64
    pos, vel, _, _ = random_crowd(n)
    waypoint = RNG.uniform(-30, 30, (n, 2))
    target = RNG.uniform(0.5, 2.0, (n,))
    got = forces.acceleration_force(
        jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
        jnp.asarray(waypoint, jnp.float32), jnp.asarray(target, jnp.float32),
        AccelerationParams(tau=0.5))
    want = oracle.acceleration_force(pos, vel, waypoint, target, 0.5)
    assert linf(got, want) < 1e-4


def test_acceleration_force_zero_distance_is_safe():
    pos = jnp.zeros((3, 2))
    got = forces.acceleration_force(
        pos, jnp.ones((3, 2)), pos, jnp.ones((3,)), AccelerationParams(tau=0.5))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(np.asarray(got), -2.0 * np.ones((3, 2)), rtol=1e-6)


@pytest.mark.parametrize("use_radius", [False, True])
@pytest.mark.parametrize("n", [2, 7, 64])
def test_pedestrian_force_matches_oracle(n, use_radius):
    pos, vel, radius, _ = random_crowd(n)
    alive = np.ones(n, bool)
    p = MoussaidParams()
    got = forces.pedestrian_force(
        jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
        jnp.asarray(radius, jnp.float32), jnp.asarray(alive), p,
        use_ped_radius=use_radius)
    want = oracle.pedestrian_force(
        pos, vel, radius, alive, p.lambda_, p.A, p.gamma, p.n, p.n_prime,
        p.epsilon, use_radius=use_radius)
    assert linf(got, want) < 2e-4


def test_pedestrian_force_respects_alive_mask():
    n = 16
    pos, vel, radius, alive = random_crowd(n, alive_frac=0.6)
    p = MoussaidParams()
    got = forces.pedestrian_force(
        jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
        jnp.asarray(radius, jnp.float32), jnp.asarray(alive), p)
    want = oracle.pedestrian_force(
        pos, vel, radius, alive, p.lambda_, p.A, p.gamma, p.n, p.n_prime, p.epsilon)
    assert linf(got, want) < 2e-4
    assert np.all(np.asarray(got)[~alive] == 0.0)


def test_pedestrian_force_row_blocking_equivalence():
    n = 50
    pos, vel, radius, _ = random_crowd(n)
    alive = np.ones(n, bool)
    p = MoussaidParams()
    args = (jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
            jnp.asarray(radius, jnp.float32), jnp.asarray(alive), p)
    full = forces.pedestrian_force(*args, row_block=64)
    blocked = forces.pedestrian_force(*args, row_block=16)
    assert linf(full, blocked) < 1e-6


def test_coincident_pedestrians_do_not_nan():
    pos = jnp.zeros((2, 2), jnp.float32)
    vel = jnp.zeros((2, 2), jnp.float32)
    got = forces.pedestrian_force(
        pos, vel, jnp.full((2,), 0.3), jnp.ones((2,), bool), MoussaidParams())
    assert np.all(np.isfinite(got))
    assert np.all(np.asarray(got) == 0.0)


def make_borders():
    """A few straight sampled borders of different lengths."""
    b1 = np.column_stack([np.linspace(-10, 10, 201), np.full(201, 3.0)])
    b2 = np.column_stack([np.linspace(-10, 10, 201), np.full(201, -3.0)])
    b3 = np.column_stack([np.full(31, 12.0), np.linspace(-1.5, 1.5, 31)])
    borders = [b1, b2, b3]
    centers = np.array([b[len(b) // 2] for b in borders])
    lengths = np.array([len(b) * 0.1 for b in borders])
    return borders, centers, lengths


@pytest.mark.parametrize("use_radius", [False, True])
def test_border_force_matches_oracle(use_radius):
    n = 40
    pos, vel, radius, _ = random_crowd(n)
    pos = pos * np.array([0.6, 0.15])  # keep peds near the corridor
    alive = np.ones(n, bool)
    mode = RNG.integers(0, 5, n)
    borders, centers, lengths = make_borders()
    pset = build_chunked_pointset(borders, centers, lengths, chunk_size=64)
    bp = BorderParams(a=6.0, b=0.3)
    got = forces.border_force(
        jnp.asarray(pos, jnp.float32), jnp.asarray(mode, jnp.int32),
        jnp.asarray(radius, jnp.float32), jnp.asarray(alive), pset, bp,
        use_ped_radius=use_radius)
    want = oracle.border_force(pos, mode, radius, alive, borders, centers,
                               lengths, 6.0, 0.3, use_radius=use_radius)
    assert linf(got, want) < 2e-3


def test_border_force_zero_when_crossing():
    borders, centers, lengths = make_borders()
    pset = build_chunked_pointset(borders, centers, lengths, chunk_size=64)
    pos = jnp.asarray([[0.0, 2.5]], jnp.float32)
    f_walk = forces.border_force(
        pos, jnp.asarray([oracle.WALKING], jnp.int32), jnp.asarray([0.3]),
        jnp.ones((1,), bool), pset, BorderParams(a=6.0, b=0.3))
    f_cross = forces.border_force(
        pos, jnp.asarray([oracle.CROSSING], jnp.int32), jnp.asarray([0.3]),
        jnp.ones((1,), bool), pset, BorderParams(a=6.0, b=0.3))
    assert np.linalg.norm(np.asarray(f_walk)) > 0.0
    assert np.all(np.asarray(f_cross) == 0.0)


def make_obstacles():
    """Two ellipse-ish outlines and one tiny outline."""
    th = np.linspace(0, 2 * np.pi, 40, endpoint=False)
    o1 = np.column_stack([5 + 2 * np.cos(th), 1.5 * np.sin(th)])
    o2 = np.column_stack([-6 + 1 * np.cos(th), 4 + 3 * np.sin(th)])
    o3 = np.array([[0.0, -8.0], [0.2, -8.0], [0.4, -8.0]])
    outlines = [o1, o2, o3]
    centers = np.array([[5.0, 0.0], [-6.0, 4.0], [0.2, -8.0]])
    return outlines, centers


@pytest.mark.parametrize("dynamic", [False, True])
def test_obstacle_force_matches_oracle(dynamic):
    n = 32
    pos, vel, radius, _ = random_crowd(n)
    pos = pos * 0.5
    alive = np.ones(n, bool)
    outlines, centers = make_obstacles()
    threshold = 20.0 if not dynamic else 50.0
    pset = build_chunked_pointset(
        outlines, centers, np.full(len(outlines), threshold), chunk_size=32)
    if dynamic:
        obs_vel = RNG.uniform(-5, 5, (len(outlines), 2))
        p = MoussaidParams(lambda_=2.0, A=50.0, gamma=0.4, n=1.0,
                           n_prime=3.0, epsilon=0.005, perception_threshold=50.0)
    else:
        obs_vel = np.zeros((len(outlines), 2))
        p = MoussaidParams(lambda_=2.3, A=15.0, gamma=0.4, n=2.1,
                           n_prime=3.0, epsilon=0.005, perception_threshold=20.0)
    got = forces.obstacle_force(
        jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
        jnp.asarray(radius, jnp.float32), jnp.asarray(alive), pset,
        jnp.asarray(obs_vel, jnp.float32), p)
    want = oracle.obstacle_force(
        pos, vel, radius, alive, outlines, centers, obs_vel,
        p.lambda_, p.A, p.gamma, p.n, p.n_prime, p.epsilon, threshold)
    assert linf(got, want) < 2e-3


def test_obstacle_force_active_mask():
    outlines, centers = make_obstacles()
    pset = build_chunked_pointset(
        outlines, centers, np.full(len(outlines), 50.0), chunk_size=32)
    pos = jnp.asarray([[3.0, 0.0]], jnp.float32)
    vel = jnp.zeros((1, 2), jnp.float32)
    p = MoussaidParams(A=50.0, perception_threshold=50.0)
    obs_vel = jnp.zeros((3, 2), jnp.float32)
    f_on = forces.obstacle_force(pos, vel, jnp.asarray([0.3]), jnp.ones((1,), bool),
                                 pset, obs_vel, p)
    f_off = forces.obstacle_force(pos, vel, jnp.asarray([0.3]), jnp.ones((1,), bool),
                                  pset, obs_vel, p,
                                  obstacle_active=jnp.zeros((3,), bool))
    assert np.linalg.norm(np.asarray(f_on)) > 0.0
    assert np.all(np.asarray(f_off) == 0.0)
