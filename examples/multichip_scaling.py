"""Agent-sharded crowd rollout over a device mesh (multi-chip scaling demo).

Shards 100k+ pedestrian slots over the mesh's ``agents`` axis and runs the
fused Pallas force kernel with the Morton-sorted interaction cutoff and the
ring column-communication schedule: each step, every device ppermutes one
shard-sized (pos, vel, radius, bbox) block around the ring and accumulates
partial forces, so peak memory is O(N/devices) and XLA's async collective
permute overlaps each transfer with the previous block's kernel.

Runs on real multi-chip hardware unchanged; on a CPU dev box use virtual
devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \\
        python examples/multichip_scaling.py --n 4096 --steps 20 --interpret

(``--interpret`` runs the kernels in the Pallas interpreter; without it a
backend with no compiled kernel raises.)
"""
import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--n", type=int, default=4096, help="pedestrians")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--cutoff", type=float, default=30.0)
    p.add_argument("--comm", choices=("ring", "gather"), default="ring")
    p.add_argument("--interpret", action="store_true",
                   help="Pallas interpreter with small tiles (CPU runs)")
    args = p.parse_args(argv)

    import jax
    if os.environ.get("JAX_PLATFORMS") == "cpu":
        jax.config.update("jax_platforms", "cpu")
    import numpy as np
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    from carla_social_force_model_tpu.models.state import PedState
    from carla_social_force_model_tpu.parallel.mesh import make_mesh
    from carla_social_force_model_tpu.parallel.sharding import (
        make_sharded_rollout, prepare_sharded_scene)

    n_dev = jax.device_count()
    print(f"devices: {n_dev} ({jax.default_backend()})")

    scene, params, cfg, _ = benchmark_bundle(args.n)
    cfg = dataclasses.replace(
        cfg, use_pallas=True, interaction_cutoff=args.cutoff,
        axis_comm=args.comm)
    if args.interpret:
        cfg = dataclasses.replace(cfg, pallas_interpret=True,
                                  pallas_row_tile=8, pallas_col_tile=128)

    mesh = make_mesh(n_agent_shards=n_dev)
    scene, capacity = prepare_sharded_scene(scene, n_dev)
    run = make_sharded_rollout(mesh, scene, params, cfg, args.steps)

    final, _ = run(PedState.empty(capacity))
    jax.block_until_ready(final)          # compile + warmup
    t0 = time.perf_counter()
    final, _ = run(PedState.empty(capacity))
    total = float(np.asarray(final.pos).sum())  # force transfer
    dt = time.perf_counter() - t0

    alive = int(np.asarray(final.alive).sum())
    rate = args.n * args.steps / dt
    print(f"{args.n} peds x {args.steps} steps, comm={args.comm}, "
          f"cutoff={args.cutoff} m: {dt / args.steps * 1e3:.2f} ms/step, "
          f"{rate / 1e6:.2f}M agent-steps/s, alive={alive} "
          f"(checksum {total:.1f})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
