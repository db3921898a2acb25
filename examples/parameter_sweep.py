#!/usr/bin/env python
"""Parameter sweep demo: how the interaction amplitude A shapes a corridor
counterflow (BASELINE.json config #5's sweep capability on a real scenario).

Runs a batch of rollouts of the shipped corridor scenario with
``pedestrian_force.A`` swept across a range -- one vmapped launch, fused
Pallas kernel on the GPU -- and reports/plots mean evacuation progress per A.

Run:  python examples/parameter_sweep.py [--points 16] [--out sweep.png]
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--points", type=int, default=16)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--out", type=str, default=None)
    args = ap.parse_args(argv)

    import jax.numpy as jnp
    from carla_social_force_model_tpu.api.scenario import build_scenario
    from carla_social_force_model_tpu.parallel.sweeps import (
        batch_params, make_sweep_rollout)

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    bundle = build_scenario(
        os.path.join(repo, "configs", "scenarios", "corridor_counterflow.toml"),
        os.path.join(repo, "configs", "sfm.toml"), num_steps=args.steps)

    a_values = np.linspace(0.5, 12.0, args.points)
    swept = batch_params(bundle.params, pedestrian_A=jnp.asarray(a_values))
    run = make_sweep_rollout(bundle.scene, bundle.cfg, args.steps)
    finals, _ = run(swept)

    # evacuation progress: fraction of spawned peds that reached their goal
    spawned = np.asarray(finals.spawned)          # (B, N)
    alive = np.asarray(finals.alive)
    progress = 1.0 - alive.sum(-1) / np.maximum(spawned.sum(-1), 1)

    for a, pr in zip(a_values, progress):
        print(f"A = {a:5.2f}: evacuated {pr * 100:5.1f}%")

    if args.out:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(7, 4))
        ax.plot(a_values, progress * 100, "o-")
        ax.set_xlabel("pedestrian force amplitude A")
        ax.set_ylabel("evacuated after %.0fs [%%]" % (args.steps * bundle.dt))
        ax.set_title("corridor counterflow: interaction strength sweep")
        fig.savefig(args.out, dpi=130, bbox_inches="tight")
        print("wrote", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
