"""Fused pair-force kernel (Pallas, Triton route) vs the jnp path, in the
Pallas interpreter on the CPU (tests/test_gpu_kernels.py runs it compiled)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from carla_social_force_model_tpu.models.params import MoussaidParams
from carla_social_force_model_tpu.ops import forces
from carla_social_force_model_tpu.ops.pallas_forces import pedestrian_force_pallas

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("n,use_radius", [(16, False), (40, True), (130, False)])
def test_pallas_matches_jnp(n, use_radius):
    pos = jnp.asarray(RNG.uniform(-15, 15, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.asarray(RNG.uniform(0.2, 0.4, (n,)), jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.8)
    p = MoussaidParams()
    want = forces.pedestrian_force(pos, vel, radius, alive, p,
                                   use_ped_radius=use_radius)
    got = pedestrian_force_pallas(pos, vel, radius, alive, p,
                                  use_ped_radius=use_radius,
                                  row_tile=64, col_tile=128, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    assert np.all(np.asarray(got)[~np.asarray(alive)] == 0.0)


def test_pallas_sharded_matches_unsharded():
    """Kernel under shard_map (rows sharded, cols gathered) == single-device."""
    import jax
    from jax.sharding import PartitionSpec as P
    from carla_social_force_model_tpu.parallel.mesh import make_mesh

    n = 64
    pos = jnp.asarray(RNG.uniform(-12, 12, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.9)
    p = MoussaidParams()

    want = pedestrian_force_pallas(pos, vel, radius, alive, p,
                                   row_tile=8, col_tile=128, interpret=True)

    mesh = make_mesh(n_agent_shards=8)
    fn = jax.shard_map(
        lambda *a: pedestrian_force_pallas(*a, p, row_tile=8, col_tile=128,
                                           interpret=True,
                                           axis_name="agents"),
        mesh=mesh, in_specs=(P("agents"), P("agents"), P("agents"), P("agents")),
        out_specs=P("agents"), check_vma=False)
    got = jax.jit(fn)(pos, vel, radius, alive)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_cutoff_kernel_matches_exact_with_large_cutoff():
    """A cutoff beyond the world size changes nothing (same pairs)."""
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas_sorted)
    n = 90
    pos = jnp.asarray(RNG.uniform(-30, 30, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.9)
    p = MoussaidParams()
    exact = pedestrian_force_pallas(pos, vel, radius, alive, p,
                                    row_tile=16, col_tile=128, interpret=True)
    cut = pedestrian_force_pallas_sorted(pos, vel, radius, alive, p,
                                         cutoff=1000.0, row_tile=16,
                                         col_tile=128, interpret=True)
    np.testing.assert_allclose(np.asarray(cut), np.asarray(exact),
                               rtol=2e-5, atol=2e-5)


def test_cutoff_kernel_truncates_interactions():
    """Moderate cutoff == brute-force sum over pairs within the radius."""
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas_sorted)
    import oracle
    n, cutoff = 40, 12.0
    pos = RNG.uniform(-40, 40, (n, 2))
    vel = RNG.uniform(-2, 2, (n, 2))
    radius = np.full((n,), 0.3)
    alive = np.ones(n, bool)
    p = MoussaidParams()
    got = pedestrian_force_pallas_sorted(
        jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
        jnp.asarray(radius, jnp.float32), jnp.asarray(alive), p,
        cutoff=cutoff, row_tile=8, col_tile=128, interpret=True)
    # oracle with pairs beyond the cutoff removed
    want = np.zeros((n, 2))
    for i in range(n):
        for j in range(n):
            if j == i:
                continue
            diff = pos[j] - pos[i]
            dist = np.linalg.norm(diff)
            if dist > cutoff:
                continue
            want[i] += oracle.moussaid_term(
                diff / dist, dist, vel[i] - vel[j], p.lambda_, p.A, p.gamma,
                p.n, p.n_prime, p.epsilon)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-3, atol=1e-4)


def test_morton_order_roundtrip():
    from carla_social_force_model_tpu.ops.spatial import morton_order
    pos = jnp.asarray(RNG.uniform(-50, 50, (33, 2)), jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=33) < 0.7)
    perm, inv = morton_order(pos, alive)
    np.testing.assert_array_equal(np.asarray(perm)[np.asarray(inv)],
                                  np.arange(33))
    # dead slots sort last
    sorted_alive = np.asarray(alive)[np.asarray(perm)]
    first_dead = np.argmin(sorted_alive) if (~sorted_alive).any() else 33
    assert not sorted_alive[first_dead:].any()


def test_pallas_coincident_peds_zero():
    pos = jnp.zeros((4, 2), jnp.float32)
    vel = jnp.zeros((4, 2), jnp.float32)
    got = pedestrian_force_pallas(pos, vel, jnp.full((4,), 0.3),
                                  jnp.ones((4,), bool), MoussaidParams(),
                                  row_tile=8, col_tile=128, interpret=True)
    assert np.all(np.asarray(got) == 0.0)


def test_pallas_ring_matches_gather():
    """Ring column comm (ppermute block rotation) == all-gather comm for the
    fused kernel on the 8-device mesh."""
    import jax
    from jax.sharding import PartitionSpec as P
    from carla_social_force_model_tpu.parallel.mesh import make_mesh

    n = 64
    pos = jnp.asarray(RNG.uniform(-12, 12, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.9)
    p = MoussaidParams()

    mesh = make_mesh(n_agent_shards=8)

    def run(comm):
        fn = jax.shard_map(
            lambda *a: pedestrian_force_pallas(
                *a, p, row_tile=8, col_tile=128, interpret=True,
                axis_name="agents", axis_comm=comm),
            mesh=mesh,
            in_specs=(P("agents"), P("agents"), P("agents"), P("agents")),
            out_specs=P("agents"), check_vma=False)
        return jax.jit(fn)(pos, vel, radius, alive)

    got_ring = run("ring")
    got_gather = run("gather")
    np.testing.assert_allclose(np.asarray(got_ring), np.asarray(got_gather),
                               rtol=2e-5, atol=2e-5)
    want = pedestrian_force_pallas(pos, vel, radius, alive, p,
                                   row_tile=8, col_tile=128, interpret=True)
    np.testing.assert_allclose(np.asarray(got_ring), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_pallas_sorted_cutoff_under_sharding():
    """Morton-sorted cutoff kernel under agent-sharding (per-device local
    sort + ring comm) == single-device sorted cutoff kernel."""
    import jax
    from jax.sharding import PartitionSpec as P
    from carla_social_force_model_tpu.parallel.mesh import make_mesh
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas_sorted)

    n, cutoff = 64, 15.0
    pos = jnp.asarray(RNG.uniform(-40, 40, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.9)
    p = MoussaidParams()

    want = pedestrian_force_pallas_sorted(
        pos, vel, radius, alive, p, cutoff=cutoff, row_tile=8, col_tile=128,
        interpret=True)

    mesh = make_mesh(n_agent_shards=8)
    for comm in ("ring", "gather"):
        fn = jax.shard_map(
            lambda *a: pedestrian_force_pallas_sorted(
                *a, p, cutoff=cutoff, row_tile=8, col_tile=128,
                interpret=True, axis_name="agents", axis_comm=comm),
            mesh=mesh,
            in_specs=(P("agents"), P("agents"), P("agents"), P("agents")),
            out_specs=P("agents"), check_vma=False)
        got = jax.jit(fn)(pos, vel, radius, alive)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=2e-4, atol=2e-5, err_msg=comm)


def test_pallas_epsilon_zero_no_spurious_tangential():
    """epsilon=0 makes theta==0 for every pair whose interaction vector is
    parallel to the separation (e.g. mutually stationary agents); the
    reference's np.sign(0)=0 emits no tangential force there (regression:
    a copysign-based sign gave every such pair a full-magnitude sideways
    push)."""
    import dataclasses
    p = dataclasses.replace(MoussaidParams(), epsilon=0.0)
    pos = jnp.asarray([[0.0, 0.0], [1.0, 0.0]], jnp.float32)
    vel = jnp.zeros((2, 2), jnp.float32)
    want = forces.pedestrian_force(pos, vel, jnp.full((2,), 0.3),
                                   jnp.ones((2,), bool), p)
    got = pedestrian_force_pallas(pos, vel, jnp.full((2,), 0.3),
                                  jnp.ones((2,), bool), p,
                                  row_tile=8, col_tile=128, interpret=True)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)
    assert abs(np.asarray(got)[0, 1]) < 1e-6   # no sideways force


def test_pallas_overlapping_radii_zero_interaction_vector():
    """use_ped_radius with overlapping agents and a vanishing interaction
    vector (lam*dv + e == 0): d < 0 and B == 0 -> the reference/jnp rule is
    zero force (regression: exp(+inf)*0 NaN poisoned the row sums)."""
    p = MoussaidParams()   # lambda = 2
    pos = jnp.asarray([[0.0, 0.0], [0.4, 0.0]], jnp.float32)
    vel = jnp.asarray([[0.0, 0.0], [0.5, 0.0]], jnp.float32)  # lam*dv = -e
    radius = jnp.full((2,), 0.3, jnp.float32)
    alive = jnp.ones((2,), bool)
    want = forces.pedestrian_force(pos, vel, radius, alive, p,
                                   use_ped_radius=True)
    got = pedestrian_force_pallas(pos, vel, radius, alive, p,
                                  use_ped_radius=True,
                                  row_tile=8, col_tile=128, interpret=True)
    assert np.isfinite(np.asarray(got)).all()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-5, atol=2e-5)


def test_morton_sort_matches_morton_order():
    """morton_sort's co-sorted order is bit-identical to morton_order's
    permutation (stable sort), including tied keys (coincident agents,
    dead slots) and the inverse-permutation contract."""
    from carla_social_force_model_tpu.ops.spatial import (morton_order,
                                                          morton_sort)
    n = 200
    pos = RNG.uniform(-30, 30, (n, 2)).astype(np.float32)
    pos[40:60] = pos[20:40]            # tied keys: coincident agents
    pos = jnp.asarray(pos)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.8)   # dead slots tie too
    vals = jnp.arange(n, dtype=jnp.float32) * 1.5

    perm, inv = morton_order(pos, alive)
    (sorted_vals, sorted_alive), inv2 = morton_sort(
        (pos[:, 0], pos[:, 1]), alive, (vals, alive))
    np.testing.assert_array_equal(np.asarray(sorted_vals),
                                  np.asarray(vals[perm]))
    np.testing.assert_array_equal(np.asarray(sorted_alive),
                                  np.asarray(alive[perm]))
    np.testing.assert_array_equal(np.asarray(inv2), np.asarray(inv))
    np.testing.assert_array_equal(np.asarray(sorted_vals[inv2]),
                                  np.asarray(vals))


def test_cutoff_f32_exact_threshold():
    """A cutoff >= 110*gamma*(2*lambda*v_max+1) is BIT-exact: every skipped
    pair's exponential underflows to +0 in f32 (d/B > 110 since each pair's
    B = gamma*|t| <= gamma*(2*lambda*v_max+1)), so skipping it changes
    nothing (ops/pallas_forces.pedestrian_force_pallas docstring claim)."""
    n, v_max = 96, 2.0
    p = MoussaidParams()
    thresh = 110.0 * p.gamma * (2.0 * p.lambda_ * v_max + 1.0)
    # spread agents so many pairs sit far beyond the threshold (arena much
    # wider than ~346 m) and some inside it
    pos = jnp.asarray(RNG.uniform(-600, 600, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-v_max, v_max, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.9)
    kw = dict(row_tile=8, col_tile=128, interpret=True)
    exact = pedestrian_force_pallas(pos, vel, radius, alive, p, **kw)
    at_thresh = pedestrian_force_pallas(pos, vel, radius, alive, p,
                                        cutoff=float(np.ceil(thresh)), **kw)
    np.testing.assert_array_equal(np.asarray(at_thresh), np.asarray(exact))
    # negative control: a clearly-truncating cutoff does differ
    low = pedestrian_force_pallas(pos, vel, radius, alive, p, cutoff=30.0,
                                  **kw)
    assert not np.array_equal(np.asarray(low), np.asarray(exact))


def test_hilbert_curve_properties():
    """_hilbert_d is a bijection onto 0..4^bits-1 and consecutive indices
    are grid neighbors (the defining Hilbert property -- no Z-jumps)."""
    from carla_social_force_model_tpu.ops.spatial import _hilbert_d
    bits = 3
    side = 1 << bits
    xs, ys = np.meshgrid(np.arange(side, dtype=np.uint32),
                         np.arange(side, dtype=np.uint32), indexing="ij")
    d = np.asarray(_hilbert_d(jnp.asarray(xs.ravel()),
                              jnp.asarray(ys.ravel()), bits=bits))
    assert sorted(d.tolist()) == list(range(side * side))  # bijection
    order = np.argsort(d)
    px, py = xs.ravel()[order], ys.ravel()[order]
    steps = np.abs(np.diff(px.astype(int))) + np.abs(np.diff(py.astype(int)))
    assert (steps == 1).all()  # every consecutive pair is grid-adjacent


def test_hilbert_sorted_kernel_matches_exact():
    """cutoff kernel with spatial_order='hilbert' == exact up to f32 sum
    order (same per-pair math, different permutation)."""
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas_sorted)
    n = 80
    pos = jnp.asarray(RNG.uniform(-30, 30, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.9)
    p = MoussaidParams()
    exact = pedestrian_force_pallas(pos, vel, radius, alive, p,
                                    row_tile=16, col_tile=128, interpret=True)
    hil = pedestrian_force_pallas_sorted(
        pos, vel, radius, alive, p, cutoff=1000.0, row_tile=16, col_tile=128,
        interpret=True, spatial_order="hilbert")
    np.testing.assert_allclose(np.asarray(hil), np.asarray(exact),
                               rtol=2e-5, atol=2e-5)


def test_hilbert_tiles_tighter_than_morton():
    """The point of the knob: Hilbert-sorted tiles have tighter bounding
    boxes than Morton-sorted ones (fixed seed, statistical but stable)."""
    from carla_social_force_model_tpu.ops.spatial import (morton_sort,
                                                          tile_bboxes)
    rng = np.random.default_rng(7)
    n, tile = 4096, 128
    px = jnp.asarray(rng.uniform(0, 400, n), jnp.float32)
    py = jnp.asarray(rng.uniform(0, 400, n), jnp.float32)
    alive = jnp.ones((n,), bool)

    def mean_semiperimeter(order):
        (sx, sy), _ = morton_sort((px, py), alive, (px, py), order=order)
        bb = np.asarray(tile_bboxes(sx, sy, alive, tile))
        return float(((bb[:, 1] - bb[:, 0]) + (bb[:, 3] - bb[:, 2])).mean())

    assert mean_semiperimeter("hilbert") < mean_semiperimeter("morton")


def test_kernel_padding_and_dead_tile():
    """N not a multiple of either tile, and one whole row tile of dead
    agents: padded and dead rows are exactly zero, live rows match jnp."""
    n = 77                               # 3 row tiles of 32, 2 col tiles of 64
    pos = jnp.asarray(RNG.uniform(-10, 10, (n, 2)), jnp.float32)
    vel = jnp.asarray(RNG.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(RNG.uniform(size=n) < 0.9).at[32:64].set(False)
    p = MoussaidParams()
    want = forces.pedestrian_force(pos, vel, radius, alive, p)
    got = np.asarray(pedestrian_force_pallas(pos, vel, radius, alive, p,
                                             row_tile=32, col_tile=64,
                                             interpret=True))
    assert got.shape == (n, 2)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)
    assert np.all(got[32:64] == 0.0)
    assert np.all(got[~np.asarray(alive)] == 0.0)


def test_cutoff_skip_exactly_at_tile_boundary():
    """A column tile whose bounding box lies exactly at the cutoff from the
    row tile is computed (gap^2 <= cutoff^2): pairs at distance == cutoff
    count, as in the per-pair rule; a hair less cutoff drops them."""
    import oracle
    c = 4.0
    ys = np.arange(8) * 0.125              # exact in f32
    pos = np.concatenate([np.column_stack([np.zeros(8), ys]),
                          np.column_stack([np.full(8, c), ys])])
    vel = RNG.uniform(-1, 1, (16, 2))
    p = MoussaidParams()
    args = (jnp.asarray(pos, jnp.float32), jnp.asarray(vel, jnp.float32),
            jnp.full((16,), 0.3, jnp.float32), jnp.ones((16,), bool), p)
    kw = dict(row_tile=8, col_tile=8, interpret=True)

    def brute(cut):
        want = np.zeros((16, 2))
        for i in range(16):
            for j in range(16):
                diff = pos[j] - pos[i]
                dist = np.linalg.norm(diff)
                if j != i and dist <= cut:
                    want[i] += oracle.moussaid_term(
                        diff / dist, dist, vel[i] - vel[j], p.lambda_, p.A,
                        p.gamma, p.n, p.n_prime, p.epsilon)
        return want

    at = np.asarray(pedestrian_force_pallas(*args, cutoff=c, **kw))
    np.testing.assert_allclose(at, brute(c), rtol=2e-3, atol=1e-5)
    below = np.asarray(pedestrian_force_pallas(*args, cutoff=c - 1e-3, **kw))
    np.testing.assert_allclose(below, brute(c - 1e-3), rtol=2e-3, atol=1e-5)
    assert not np.allclose(at, below)


@pytest.mark.parametrize("n,tr,tc", [
    (5, 32, 32), (33, 16, 16), (77, 32, 32), (100, 32, 64), (130, 16, 128)])
def test_column_padding_matches_jnp(n, tr, tc):
    """N not a multiple of the column tile: the padded columns (sentinels)
    add nothing, every row matches jnp, padded rows are cut off."""
    rng = np.random.default_rng(n)
    pos = jnp.asarray(rng.uniform(-8, 8, (n, 2)), jnp.float32)
    vel = jnp.asarray(rng.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(rng.uniform(size=n) < 0.9)
    p = MoussaidParams()
    got = np.asarray(pedestrian_force_pallas(pos, vel, radius, alive, p,
                                             row_tile=tr, col_tile=tc,
                                             interpret=True))
    assert got.shape == (n, 2)
    want = np.asarray(forces.pedestrian_force(pos, vel, radius, alive, p))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_tiles_must_be_powers_of_two():
    pos = jnp.zeros((4, 2), jnp.float32)
    with pytest.raises(ValueError, match="powers of two"):
        pedestrian_force_pallas(pos, pos, jnp.full((4,), 0.3),
                                jnp.ones((4,), bool), MoussaidParams(),
                                row_tile=24, col_tile=64, interpret=True)


def test_cutoff_survivor_list_matches_in_loop_skip(monkeypatch):
    """The compacted cutoff launch (per-row-tile survivor lists) equals the
    in-loop bbox skip; a list too narrow for the geometry falls back to the
    in-loop skip and stays exact."""
    from carla_social_force_model_tpu.ops import pallas_forces as PF
    rng = np.random.default_rng(4)
    n = 1500
    pos = jnp.asarray(rng.uniform(-200, 200, (n, 2)), jnp.float32)
    vel = jnp.asarray(rng.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(rng.uniform(size=n) < 0.9)
    p = MoussaidParams()
    kw = dict(cutoff=30.0, row_tile=32, col_tile=16, interpret=True)

    def run(width):
        monkeypatch.setattr(PF, "_MAX_SURV", width)
        return np.asarray(PF.pedestrian_force_pallas_sorted(
            pos, vel, radius, alive, p, **kw))

    def plan(width):
        monkeypatch.setattr(PF, "_MAX_SURV", width)
        counts, w = PF.survivor_counts(pos, alive, 30.0, row_tile=32,
                                       col_tile=16)
        return int(np.asarray(counts).max()), w

    # the list width that fits this geometry (and the one that does not)
    assert plan(10**6)[1] == 0                       # never engages
    most, w = plan(32)
    assert w == 32 and 2 < most <= w                 # engages and fits
    most, w = plan(2)
    assert w == 2 and most > w                       # engages, overflows

    skip = run(10**6)
    listed = run(32)
    np.testing.assert_allclose(listed, skip, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(run(2), skip)      # overflow -> skip
    assert np.abs(skip).max() > 0.0


@pytest.mark.parametrize("max_surv,fits", [(8, True), (2, False)])
def test_pairwise_compact_under_sharding_gather(monkeypatch, max_surv, fits):
    """Survivor lists per device (rows sharded, columns gathered) match the
    single-device in-loop skip; a list too narrow for the geometry
    overflows to the in-loop skip.

    One spatial cluster per device slot-range: the gathered column blocks
    (each device's locally sorted shard) tile into cluster-tight bboxes, so
    each row tile survives against its own cluster's 4 of the 32 column
    tiles -- a width of 8 fits, a width of 2 overflows."""
    from jax.sharding import PartitionSpec as P
    from carla_social_force_model_tpu.ops import pallas_forces as PF
    from carla_social_force_model_tpu.parallel.mesh import make_mesh

    rng = np.random.default_rng(23)
    n = 8 * 128
    cx = (np.arange(n) // 128) * 200.0
    pos = jnp.asarray(np.column_stack([cx + rng.uniform(-8, 8, n),
                                       rng.uniform(-8, 8, n)]), jnp.float32)
    vel = jnp.asarray(rng.uniform(-2, 2, (n, 2)), jnp.float32)
    radius = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.asarray(rng.uniform(size=n) < 0.9)
    p = MoussaidParams()
    kw = dict(cutoff=30.0, row_tile=8, col_tile=32, interpret=True)
    monkeypatch.setattr(PF, "_MAX_SURV", 10**6)
    want = np.asarray(PF.pedestrian_force_pallas_sorted(
        pos, vel, radius, alive, p, **kw))          # in-loop skip

    monkeypatch.setattr(PF, "_MAX_SURV", max_surv)
    mesh = make_mesh(n_agent_shards=8)
    width = []

    def counts(pos, alive):
        c, w = PF.survivor_counts(pos, alive, 30.0, row_tile=8, col_tile=32,
                                  axis_name="agents")
        width.append(w)
        return c

    cnt = np.asarray(jax.jit(jax.shard_map(
        counts, mesh=mesh, in_specs=(P("agents"),) * 2,
        out_specs=P("agents"), check_vma=False))(pos, alive))
    assert width == [max_surv] and cnt.max() == 4   # dead tiles: 0
    assert bool((cnt <= max_surv).all()) == fits

    fn = jax.shard_map(
        lambda *a: PF.pedestrian_force_pallas_sorted(
            *a, p, axis_name="agents", axis_comm="gather", **kw),
        mesh=mesh, in_specs=(P("agents"),) * 4, out_specs=P("agents"),
        check_vma=False)
    got = np.asarray(jax.jit(fn)(pos, vel, radius, alive))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    assert np.abs(want).max() > 0.0
