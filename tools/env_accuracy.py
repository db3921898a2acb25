"""Accuracy study for the analytic border tier (StepConfig.env_analytic).

Measures, on the urban street-grid geometry (api/synthetic.urban_bundle
walls), the force-level deviation between the reference's 0.1 m sampled
argmin and the analytic closest-point-on-segment path, and shows the
sampled path CONVERGES to the analytic one as the sampling refines --
i.e. the analytic tier is the zero-quantization limit of the reference's
own discretization, not an approximation of it.

Run on the card (or the CPU, where the kernels run in the Pallas
interpreter): python tools/env_accuracy.py
Results land in BENCH.md's analytic-tier section.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from carla_social_force_model_tpu.env.borders import build_border_set
    from carla_social_force_model_tpu.models.params import SfmParams
    from carla_social_force_model_tpu.models.state import PedState
    from carla_social_force_model_tpu.models.stepper import (Scene,
                                                             prepare_scene)
    from carla_social_force_model_tpu.ops.pallas_env import (
        fused_environment_terms)

    from carla_social_force_model_tpu.ops.backend import kernels_available
    interpret = not kernels_available()
    n = int(os.environ.get("ACC_N", 10_000))
    rng = np.random.default_rng(7)

    # urban-style walls: 8 roads, curbs at +-4.5 m, 600 m wide, sections
    # <= 30 m at a given sampling resolution
    def walls(resolution):
        lines, centers, lengths = [], [], []
        for i in range(8):
            y = 60.0 * i
            for off in (-4.5, 4.5):
                x0 = 0.0
                while x0 < 600.0 - 1e-6:
                    x1 = min(x0 + 30.0, 600.0)
                    xs = np.arange(x0, x1, resolution)
                    pts = np.column_stack([xs, np.full(xs.shape, y + off)])
                    lines.append(pts)
                    centers.append(pts[len(pts) // 2])
                    lengths.append(float(x1 - x0))
                    x0 = x1
        return build_border_set(lines, centers, lengths)

    # pedestrians clustered near sidewalks (where border forces matter)
    road = rng.integers(0, 8, n)
    side = rng.choice([-1.0, 1.0], n)
    pos = np.column_stack([
        rng.uniform(0.0, 600.0, n),
        60.0 * road + side * rng.uniform(4.6, 8.0, n)]).astype(np.float32)
    st = PedState.empty(n).replace_coords(
        pos=jnp.asarray(pos), vel=jnp.zeros((n, 2), jnp.float32),
        radius=jnp.full((n,), 0.3, jnp.float32),
        alive=jnp.ones((n,), bool))
    params = SfmParams(enable_border=True)

    def border(scene, analytic):
        t = fused_environment_terms(st, scene, params, None,
                                    interpret=interpret, analytic=analytic)
        return np.stack([np.asarray(a) for a in t["border_force"]], axis=-1)

    # per resolution, compare the sampled argmin against the analytic
    # closest point of the SAME sampled polyline (the DP chord through a
    # straight line's samples covers exactly the first..last sample, so
    # the difference is the pure quantization error of the sampling --
    # the thing the reference's discretization adds and the analytic
    # tier removes)
    scale = None
    for res in (0.1, 0.05, 0.02, 0.01):
        scene = prepare_scene(Scene(spawn=None, borders=walls(res)))
        f_a = border(scene, True)
        f_s = border(scene, False)
        if scale is None:
            scale = np.abs(f_a).max()
            print(f"|F|_max = {scale:.3f} N over {n} peds", flush=True)
        d = np.abs(f_s - f_a).max()
        tag = " (reference)" if res == 0.1 else ""
        print(f"res {res} m{tag}: sampled vs analytic L_inf = {d:.2e} "
              f"({d / scale:.2e} rel)", flush=True)


if __name__ == "__main__":
    main()
