"""Ensemble rollouts: hundreds of independent crowds in one launch.

BASELINE.json config #5's shape -- B independent scenario instances of N
pedestrians each, vmapped over the crowd axis with the fused Pallas
pairwise kernel under the vmap on the GPU (PERF.md).  The reference runs one real-time
scenario per process (run_simulation.py:211-221), so this whole mode of
operation -- seed ensembles, Monte-Carlo evacuation studies -- exists only
here.

With more than one device, pass a mesh and the batch shards over it
(pure data parallelism, no cross-rollout communication):

    from carla_social_force_model_tpu.parallel.mesh import make_mesh
    run = make_ensemble_rollout(scene, params, cfg, steps,
                                mesh=make_mesh(n_batch_shards=8))

Run: python examples/ensemble_rollouts.py  [B]  [N]  (defaults 64 x 500)
"""
import sys
import os
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import dataclasses

import numpy as np

from carla_social_force_model_tpu.api.synthetic import (batched_crowds,
                                                        benchmark_bundle)
from carla_social_force_model_tpu.parallel.sweeps import make_ensemble_rollout


def main():
    batch = int(sys.argv[1]) if len(sys.argv) > 1 else 64
    n = int(sys.argv[2]) if len(sys.argv) > 2 else 500
    steps = 200

    scene, params, cfg, _ = benchmark_bundle(n)
    # one spawn schedule per crowd, different seeds -> an independent
    # antipodal-counterflow instance each
    scene = dataclasses.replace(scene, spawn=batched_crowds(batch, n))

    run = make_ensemble_rollout(scene, params, cfg, steps)
    finals, _ = run(scene)             # compile + run
    np.asarray(finals.pos_x)
    t0 = time.perf_counter()
    finals, _ = run(scene)
    np.asarray(finals.pos_x)
    dt = time.perf_counter() - t0

    # per-crowd outcome statistics across the ensemble
    disp = np.linalg.norm(np.asarray(finals.pos)
                          - np.asarray(scene.spawn.pos), axis=-1)
    mean_disp = disp.mean(axis=1)      # (B,)
    print(f"{batch} crowds x {n} peds x {steps} steps: "
          f"{dt / steps * 1e3:.2f} ms/step, "
          f"{batch * n * steps / dt / 1e6:.1f}M agent-steps/s aggregate")
    print(f"mean displacement across the ensemble: "
          f"{mean_disp.mean():.1f} m (min {mean_disp.min():.1f}, "
          f"max {mean_disp.max():.1f}) -- per-crowd spread comes from the "
          f"seeded spawn layouts")


if __name__ == "__main__":
    main()
