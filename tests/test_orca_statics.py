"""ORCA static-constraint feature feed (ops/geometry.nearest_features_topk
+ env/pointsets.build_static_features).

The feed supplies the k nearest distinct wall features per agent (exact
closest points on Douglas-Peucker-simplified wall segments where sections
simplify safely; 128-point-chunk closest points elsewhere) that
ops/orca._static_constraints turns into hard half-planes.  Checked here:

* analytic distances are the true segment distances (numpy float64
  oracle), not the reference's 0.1 m sampling quantization;
* a mixed split (simplifiable walls + an unsafe multi-piece section)
  merges both parts into the correct overall top-k;
* within-section corners produce two distinct features whose half-planes
  box the corner;
* the end-to-end wall guarantees (approach-rate bound, zero penetration)
  hold on the feature feed exactly as tests/test_orca.py pins them for
  the chunk feed.
"""
import numpy as np
import jax.numpy as jnp

from carla_social_force_model_tpu.env.borders import (build_border_set,
                                                      sample_borderline)
from carla_social_force_model_tpu.env.pointsets import (StaticFeatures,
                                                        build_static_features)
from carla_social_force_model_tpu.models.params import OrcaParams
from carla_social_force_model_tpu.ops.geometry import (k_smallest_features,
                                                       nearest_features_topk)
from carla_social_force_model_tpu.ops.orca import (_static_topk,
                                                   orca_velocities)

DT = 0.05


def _pset(segs, resolution=0.1):
    lines = [sample_borderline(s, e, resolution) for s, e in segs]
    return build_border_set(lines, [ln[len(ln) // 2] for ln in lines],
                            [len(ln) * resolution for ln in lines])


def _crowd(n, lo=(-14, -6), hi=(14, 8), seed=0):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(lo[0], hi[0], n), jnp.float32),
            jnp.asarray(rng.uniform(lo[1], hi[1], n), jnp.float32))

SEGS = [([-12.0, 2.0], [12.0, 2.0]), ([-12.0, -2.0], [12.0, -2.0]),
        ([12.0, -2.0], [12.0, 6.0]), ([-12.0, 2.0], [-12.0, 6.0])]


def test_analytic_distances_are_exact():
    """The analytic feed returns true segment distances; the chunk feed is
    quantized by the 0.1 m sampling (distance to the nearest SAMPLE)."""
    feats = build_static_features(_pset(SEGS))
    px, py = _crowd(300, seed=5)
    d2, _, _ = nearest_features_topk(px, py, feats.seg, 1, 1e3)

    def exact(px_, py_):
        best = np.inf
        for s, e in SEGS:
            a = np.asarray(s, np.float64)
            u = np.asarray(e, np.float64) - a
            t = np.clip((np.array([px_, py_]) - a) @ u / (u @ u), 0.0, 1.0)
            best = min(best, np.sum((np.array([px_, py_]) - a - t * u) ** 2))
        return best

    ref = np.array([exact(float(x), float(y)) for x, y in zip(px, py)])
    np.testing.assert_allclose(np.asarray(d2[0]), ref, rtol=1e-4, atol=1e-5)


def test_mixed_split_merges_both_parts():
    """A multi-piece section (consecutive-gap safety gate) stays sampled;
    the merged top-k over (analytic ∪ chunked) features matches a numpy
    oracle over the union."""
    lines = [sample_borderline([-12.0, 2.0], [12.0, 2.0], 0.1),
             # two disjoint pieces packed as ONE section: unsafe for DP
             np.concatenate([sample_borderline([-12, -2.0], [-2, -2.0], 0.1),
                             sample_borderline([2, -2.0], [12, -2.0], 0.1)])]
    pset = build_border_set(lines, [ln[len(ln) // 2] for ln in lines],
                            [len(ln) * 0.1 for ln in lines])
    feats = build_static_features(pset)
    assert feats.seg is not None and feats.seg.num_features == 1
    assert feats.rest is not None and feats.rest.num_segments == 1

    px, py = _crowd(400, lo=(-14, -5), hi=(14, 5), seed=7)
    k, nd = 3, 12.0
    d2m, _, _ = _static_topk(px, py, feats, k, nd)
    d2m = np.asarray(d2m)

    # oracle: feature distances = 1 exact segment + per-chunk sample minima
    feat_d2 = [np.minimum(
        (np.asarray(px) - np.clip(np.asarray(px), -12, 12)) ** 2
        + (np.asarray(py) - 2.0) ** 2, np.inf)]
    pts = np.asarray(feats.rest.points)
    val = np.asarray(feats.rest.valid)
    for c in range(pts.shape[0]):
        p = pts[c][val[c]]
        if p.shape[0] == 0:
            continue
        d = ((np.asarray(px)[:, None] - p[None, :, 0]) ** 2
             + (np.asarray(py)[:, None] - p[None, :, 1]) ** 2).min(axis=1)
        feat_d2.append(d)
    all_d2 = np.stack(feat_d2)                       # (F, N)
    all_d2 = np.where(all_d2 <= nd * nd, all_d2, np.inf)
    ref = np.sort(all_d2, axis=0)[:k]
    np.testing.assert_allclose(d2m, ref, rtol=1e-5, atol=1e-6)


def test_within_section_corner_gives_two_features():
    """An L-shaped SINGLE section simplifies to two DP segments = two
    distinct features; an agent inside the corner gets both half-planes
    (the corner-coverage semantics the chunk feed approximated with
    accidental 12.8 m cuts)."""
    corner = np.concatenate([sample_borderline([-8.0, 2.0], [0.0, 2.0], 0.1),
                             sample_borderline([0.0, 2.0], [0.0, 10.0], 0.1)])
    pset = build_border_set([corner], [np.array([0.0, 2.0])], [16.0])
    feats = build_static_features(pset)
    assert feats.rest is None and feats.seg.num_features == 2

    px = jnp.asarray([-1.0], jnp.float32)     # inside the corner elbow
    py = jnp.asarray([3.0], jnp.float32)
    d2, wx, wy = nearest_features_topk(px, py, feats.seg, 2, 15.0)
    assert np.isfinite(np.asarray(d2)).all()
    # one closest point on each leg: (-1, 2) on the horizontal,
    # (0, 3) on the vertical
    got = sorted([(round(float(wx[i, 0]), 3), round(float(wy[i, 0]), 3))
                  for i in range(2)])
    assert got == [(-1.0, 2.0), (0.0, 3.0)]


def test_k_smallest_features_matches_transposed_k_nearest():
    from carla_social_force_model_tpu.ops.orca import _k_nearest
    rng = np.random.default_rng(11)
    d2 = rng.uniform(0, 10, (37, 64)).astype(np.float32)
    d2[rng.random((37, 64)) < 0.3] = np.inf
    pay = rng.normal(size=(37, 64)).astype(np.float32)
    payf = np.where(np.isfinite(d2), pay, 0.0)
    (sel,), valid = k_smallest_features(jnp.asarray(d2), (jnp.asarray(payf),),
                                        4)
    (sel_t,), valid_t = _k_nearest(jnp.asarray(d2.T), (jnp.asarray(payf.T),),
                                   4)
    np.testing.assert_allclose(np.asarray(sel), np.asarray(sel_t).T)
    np.testing.assert_array_equal(np.asarray(valid), np.asarray(valid_t).T)


def test_wall_guarantees_hold_on_feature_feed():
    """tests/test_orca.py pins the approach-rate bound on the chunk feed;
    the same bound must hold (tighter -- exact geometry) on the analytic
    feature feed, and exempt rows keep the raw preference."""
    pset = _pset([([-10.0, 2.0], [10.0, 2.0])])
    feats = build_static_features(pset)
    rng = np.random.default_rng(7)
    n = 8
    px = jnp.asarray(np.linspace(-8, 8, n), jnp.float32)
    py = jnp.asarray(rng.uniform(-1.0, 1.6, n), jnp.float32)
    z = jnp.zeros((n,), jnp.float32)
    r = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.ones((n,), bool)
    pref = (z, jnp.full((n,), 1.8, jnp.float32))
    vmax = jnp.full((n,), 2.0, jnp.float32)
    p = OrcaParams(tau_static=2.0)
    ovx, ovy = orca_velocities((px, py), (z, z), r, alive, pref, vmax, p,
                               DT, borders=feats)
    gap = (2.0 - np.asarray(py)) - 0.3
    # exact: no sampling slack needed at all
    assert (np.asarray(ovy) <= gap / 2.0 + 1e-5).all()
    one = slice(0, 1)
    _, evy = orca_velocities(
        (px[one], py[one]), (z[one], z[one]), r[one], alive[one],
        (pref[0][one], pref[1][one]), vmax[one], p, DT, borders=feats,
        static_exempt=jnp.ones((1,), bool))
    np.testing.assert_allclose(np.asarray(evy), 1.8, atol=1e-5)


def test_prepare_scene_builds_orca_features():
    from carla_social_force_model_tpu.models.spawn import (
        SpawnerSpec, build_spawn_schedule)
    from carla_social_force_model_tpu.models.stepper import (Scene,
                                                             prepare_scene)
    specs = [SpawnerSpec(spawn_location=np.array([0.0, 0.0, 0.3]),
                         waypoints=np.array([[5.0, 0.0]]),
                         crossing_road=[False], quantity=1)]
    scene = Scene(spawn=build_spawn_schedule(specs, DT, 10),
                  borders=_pset(SEGS))
    assert prepare_scene(scene).borders_feat is None
    prepped = prepare_scene(scene, orca=True)
    assert isinstance(prepped.borders_feat, StaticFeatures)
    assert prepped.borders_feat.seg.num_features == 4
    # idempotent
    assert prepare_scene(prepped, orca=True).borders_feat is \
        prepped.borders_feat
