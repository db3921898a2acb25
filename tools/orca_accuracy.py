"""ORCA neighbor-truncation accuracy study: (window, K) vs correctness.

The production ORCA pass (ops/orca.py) truncates twice: candidates come
from a +-window/2 band of the Hilbert-sorted order (instead of all N),
and only the K nearest of those become half-planes (RVO2's maxNeighbors
semantics).  This study measures what these knobs COST in correctness,
in the mold of the interaction-cutoff study (tools/cutoff_accuracy.py):

* **missed-neighbor rate** (static, per sampled frame): of each agent's
  true K nearest alive neighbors within ``neighbor_dist`` (exact N^2),
  the fraction NOT inside the cyclic Hilbert band -- the only error the
  window introduces, since the in-band selection is an exact K-extraction.
* **collision / clearance statistics** (rollout): body-overlap events
  (center distance < r_i + r_j between alive agents) and the minimum
  pairwise gap over the whole trajectory, vs the full-N control -- the
  metric ORCA exists to guarantee.
* **trajectory divergence** (rollout): position L-inf vs the full-N
  control, read against the chaos floor the cutoff study established
  (any bit-level perturbation diverges dense-crowd trajectories).

Densities: the default crowd (~0.25 ped/m^2, benchmark_bundle's extent
rule) plus 2x and 4x compressions of the same N.  Results table lives in
BENCH.md ("ORCA truncation accuracy").

Run (GPU or CPU): python tools/orca_accuracy.py [N] [duration_s]
"""
import dataclasses
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

# honor an explicit JAX_PLATFORMS=cpu (the study is plain jnp, one jit per
# (window, K) point)
if os.environ.get("JAX_PLATFORMS") == "cpu":
    jax.config.update("jax_platforms", "cpu")

SWEEP = ((32, 6), (32, 10), (64, 6), (64, 10), (128, 10))
FRAME_SAMPLES = 8          # frames per rollout for the exact N^2 passes


def _true_neighbor_sets(pos, alive, k, neigh_dist):
    """Exact K-nearest-within-neigh_dist neighbor indices per agent
    ((N, k) int, -1 = fewer than k) -- numpy, one frame."""
    import numpy as np
    n = pos.shape[0]
    d2 = np.sum((pos[None, :, :] - pos[:, None, :]) ** 2, axis=-1)
    ok = alive[None, :] & alive[:, None]
    np.fill_diagonal(ok, False)
    ok &= d2 <= neigh_dist * neigh_dist
    d2 = np.where(ok, d2, np.inf)
    idx = np.argsort(d2, axis=1)[:, :k]
    take = np.take_along_axis(d2, idx, axis=1)
    return np.where(np.isfinite(take), idx, -1)


def missed_rate(pos, alive, window, k, neigh_dist, order="hilbert"):
    """(mean missed fraction, fraction of agents missing >= 1) for one
    frame: true K-nearest vs the cyclic +-window/2 Hilbert band."""
    import numpy as np
    import jax.numpy as jnp
    from carla_social_force_model_tpu.ops.spatial import morton_order

    n = pos.shape[0]
    perm, _inv = morton_order(
        (jnp.asarray(pos[:, 0]), jnp.asarray(pos[:, 1])),
        jnp.asarray(alive), order=order)
    perm = np.asarray(perm)
    sidx = np.empty(n, np.int64)
    sidx[perm] = np.arange(n)          # slot -> position in sorted order
    true_nb = _true_neighbor_sets(pos, alive, k, neigh_dist)

    half = window // 2
    valid = true_nb >= 0
    delta = (sidx[np.where(valid, true_nb, 0)]
             - sidx[:, None]) % n                      # cyclic offset
    in_band = (delta <= half) | (delta >= n - half)
    missed = valid & ~in_band
    nb_counts = valid.sum(axis=1)
    has = nb_counts > 0
    frac = missed.sum(axis=1)[has] / nb_counts[has]
    return float(frac.mean()), float((missed.any(axis=1))[has].mean())


def _collision_stats(pos, alive, radii, sample_stride=4):
    """(overlap rate [% of alive pairs], min gap [m]) over sampled frames
    of a recorded trajectory -- exact N^2 per sampled frame, numpy.

    The rate is overlap events / alive pairs, summed over sampled frames:
    despawn-on-arrival makes raw event COUNTS incomparable between runs
    (a run whose agents arrive sooner sees fewer alive pairs)."""
    import numpy as np
    events = 0
    pairs = 0
    min_gap = np.inf
    for t in range(0, pos.shape[0], sample_stride):
        p, a = pos[t], alive[t]
        if a.sum() < 2:
            continue
        pa = p[a]
        ra = radii[a]
        d = np.sqrt(np.sum((pa[None] - pa[:, None]) ** 2, axis=-1))
        rsum = ra[None, :] + ra[:, None]
        iu = np.triu_indices(len(pa), 1)
        gap = (d - rsum)[iu]
        events += int((gap < 0).sum())
        pairs += gap.size
        min_gap = min(min_gap, float(gap.min()))
    return 100.0 * events / max(pairs, 1), min_gap


def main():
    import numpy as np
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    from carla_social_force_model_tpu.models.stepper import make_rollout_fn

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    duration = float(sys.argv[2]) if len(sys.argv) > 2 else 30.0
    steps = int(round(duration / 0.05))
    base_extent = max(25.0, float(np.sqrt(n)))

    for dens_label, extent in (("1x", base_extent),
                               ("2x", base_extent / np.sqrt(2.0)),
                               ("4x", base_extent / 2.0)):
        scene, params, cfg, state = benchmark_bundle(
            n, extent=extent, num_steps_hint=steps)
        params = dataclasses.replace(params, enable_pedestrian=False,
                                     enable_orca=True)
        dens = n / (2.0 * extent) ** 2
        print(f"\n== density {dens_label} ({dens:.2f} ped/m^2, extent "
              f"{extent:.0f} m, N={n}, {steps} steps) ==", flush=True)

        def run(window, k):
            p = dataclasses.replace(
                params, orca=dataclasses.replace(
                    params.orca, window=window, max_neighbors=k))
            fn = make_rollout_fn(scene, p, cfg, steps, record=True)
            _, recs = fn(state)
            return (np.asarray(recs.pos, np.float64),
                    np.asarray(recs.alive))

        kd = params.orca.neighbor_dist
        rad = np.asarray(scene.spawn.radius, np.float64)

        # full-N control at the default K (window=0 -> exact neighbors)
        ref_pos, ref_alive = run(0, params.orca.max_neighbors)
        ev0, gap0 = _collision_stats(ref_pos, ref_alive, rad)
        print(f"{'window:K':>10} {'missed':>8} {'any-miss':>9} "
              f"{'overlap%':>9} {'min gap':>9} {'traj Linf':>10}",
              flush=True)
        print(f"{'full:10':>10} {'-':>8} {'-':>9} {ev0:>9.4f} "
              f"{gap0:>9.3f} {'0 (ctrl)':>10}", flush=True)

        sample_ts = np.linspace(0, steps - 1, FRAME_SAMPLES).astype(int)
        for window, k in SWEEP:
            mr = [missed_rate(ref_pos[t].astype(np.float64),
                              ref_alive[t], window, k, kd)
                  for t in sample_ts]
            mean_missed = float(np.mean([m[0] for m in mr]))
            any_miss = float(np.mean([m[1] for m in mr]))
            pos, alive = run(window, k)
            ev, gap = _collision_stats(pos, alive, rad)
            err = np.abs(pos - ref_pos)
            err = np.where(ref_alive[..., None] & alive[..., None], err, 0.0)
            print(f"{f'{window}:{k}':>10} {mean_missed:>8.4f} "
                  f"{any_miss:>9.4f} {ev:>9.4f} {gap:>9.3f} "
                  f"{err.max():>10.3e}", flush=True)


if __name__ == "__main__":
    main()
