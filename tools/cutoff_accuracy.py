"""Cutoff-accuracy study: interaction-cutoff radius vs trajectory divergence.

Runs a 60 s dense-crowd rollout (BASELINE config #1 shape) once exact and
once per cutoff radius, and reports the L-inf position divergence over the
whole trajectory plus the end-state divergence.  Justifies the 30 m
example cutoff as a default recommendation (the Moussaid force decays as
exp(-d/B) with B of a few meters) and demonstrates the f32-exact regime
(cutoff >= 110*gamma*(2*lambda*v_max+1), ops/pallas_forces.py) at zero
divergence.  Results table lives in BENCH.md.

Run on the card: python tools/cutoff_accuracy.py [N] [duration_s]
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def force_level(n=10_000):
    """Single-step force L-inf error vs the exact unsorted kernel: isolates
    the cutoff truncation error from trajectory chaos (the rollout study
    measures mostly f32 summation-order divergence -- see BENCH.md)."""
    import numpy as np
    import jax.numpy as jnp
    from carla_social_force_model_tpu.models.params import MoussaidParams
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas, pedestrian_force_pallas_sorted)

    rng = np.random.default_rng(0)
    extent = float(np.sqrt(n))
    pos = jnp.asarray(rng.uniform(-extent, extent, (n, 2)), jnp.float32)
    vel = jnp.asarray(rng.uniform(-2, 2, (n, 2)), jnp.float32)
    rad = jnp.full((n,), 0.3, jnp.float32)
    alive = jnp.ones((n,), bool)
    p = MoussaidParams()
    exact = np.asarray(pedestrian_force_pallas(pos, vel, rad, alive, p),
                       np.float64)
    fmax = np.abs(exact).max()
    print(f"force-level error, N={n}, extent={extent:.0f} "
          f"(|F|_max = {fmax:.3f} N):", flush=True)
    print(f"{'cutoff':>10} {'force Linf':>12} {'rel to |F|max':>14}",
          flush=True)
    for cutoff in (5.0, 10.0, 20.0, 30.0, 50.0, 100.0):
        got = np.asarray(pedestrian_force_pallas_sorted(
            pos, vel, rad, alive, p, cutoff=cutoff), np.float64)
        err = np.abs(got - exact).max()
        print(f"{cutoff:>10.0f} {err:>12.3e} {err / fmax:>14.3e}", flush=True)


def main():
    import dataclasses
    import numpy as np
    import jax
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    from carla_social_force_model_tpu.models.stepper import make_rollout_fn

    if len(sys.argv) > 1 and sys.argv[1] == "force":
        force_level(int(sys.argv[2]) if len(sys.argv) > 2 else 10_000)
        return

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 2000
    duration = float(sys.argv[2]) if len(sys.argv) > 2 else 60.0
    steps = int(round(duration / 0.05))
    scene, params, cfg, state = benchmark_bundle(n, num_steps_hint=steps,
                                                 use_pallas=True)
    v_max = float(np.asarray(scene.spawn.speed).max()) * 1.3
    m = params.pedestrian
    f32_exact = 110.0 * m.gamma * (2.0 * m.lambda_ * v_max + 1.0)
    print(f"N={n} steps={steps} extent={float(np.sqrt(n)):.0f} "
          f"f32-exact cutoff={f32_exact:.1f} m", flush=True)

    def run(cutoff):
        c = dataclasses.replace(cfg, interaction_cutoff=cutoff)
        fn = make_rollout_fn(scene, params, c, steps, record=True)
        final, recs = fn(state)
        return np.asarray(recs.pos, np.float64), np.asarray(recs.alive)

    ref_pos, alive = run(None)
    print(f"{'cutoff':>10} {'traj Linf [m]':>14} {'end Linf [m]':>13}",
          flush=True)
    for cutoff in (5.0, 10.0, 20.0, 30.0, 50.0, 100.0, round(f32_exact)):
        pos, _ = run(float(cutoff))
        err = np.abs(pos - ref_pos)
        err = np.where(alive[..., None], err, 0.0)
        print(f"{cutoff:>10.0f} {err.max():>14.3e} {err[-1].max():>13.3e}",
              flush=True)


if __name__ == "__main__":
    main()
