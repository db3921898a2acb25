#!/usr/bin/env python
"""Kernel-level measurements on the card behind PERF.md's tables.

    python tools/kernel_probe.py            # every section
    python tools/kernel_probe.py lists      # named sections only

One process on one card; every line ends with the card's name and power
limit.  Sections:

* ``calls`` -- one jitted force call, best of 5, on an N=10k uniform crowd
  at 0.25/m^2: each pair law, and the environment terms of the
  ``borders``/``obstacles``/``urban`` bench modes (pair force off), fused
  kernel against XLA;
* ``tiles`` -- the Moussaid pair call over row x column tiles, and the
  ``borders`` environment call over pedestrian tiles;
* ``lists`` -- the N=50k, 30 m cutoff launch with survivor lists
  (``_MAX_SURV`` 128, the default) against the in-loop skip alone: the
  force call and 500-step ``ped`` rollouts;
* ``tilerolls`` -- pair-kernel tiles 32x32 (the default) against 32x64 in
  whole rollouts: ``ped`` with each pair law at N=10k, and N=50k with the
  30 m cutoff;
* ``warps`` -- the N=10k Moussaid pair call over Triton warps per program
  and pipeline stages (``_NUM_WARPS``, ``_NUM_STAGES``).

A/B sections compile both variants first and time them A, B, B, A.
"""
import dataclasses
import functools
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N = 10_000
N_CUTOFF = 50_000


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def best_ms(fn, reps: int = 5) -> float:
    import jax
    jax.block_until_ready(fn())
    t = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        t = min(t, time.perf_counter() - t0)
    return t * 1e3


def crowd(n, seed=0):
    """Uniform crowd at 0.25/m^2 with walking speeds."""
    import numpy as np
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    ext = float(np.sqrt(n))
    pos = jnp.asarray(rng.uniform(-ext, ext, (n, 2)), jnp.float32)
    vel = jnp.asarray(rng.uniform(-1.5, 1.5, (n, 2)), jnp.float32)
    rad = jnp.asarray(rng.uniform(0.2, 0.4, n), jnp.float32)
    alive = jnp.asarray(rng.uniform(size=n) < 0.95)
    return pos, vel, rad, alive


def pair_calls(pos, vel, rad, alive):
    """{law: (xla_fn, kernel_fn(**tiles))} of jitted pair-force calls; the
    crowd rides as arguments (XLA constant-folds what a closure holds)."""
    import jax
    import jax.numpy as jnp
    from carla_social_force_model_tpu.models.params import (
        MoussaidParams, PedRepulsiveParams, PowerLawParams)
    from carla_social_force_model_tpu.ops import forces
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas)
    e = vel / (jnp.linalg.norm(vel, axis=1, keepdims=True) + 1e-6)
    args = (pos, vel, rad, alive, e)
    refs = {"moussaid": (MoussaidParams(),
                         lambda x, v, r, a, e, p: forces.pedestrian_force(
                             x, v, r, a, p)),
            "powerlaw": (PowerLawParams(),
                         lambda x, v, r, a, e, p: forces.powerlaw_force(
                             x, v, r, a, p)),
            "helbing": (PedRepulsiveParams(),
                        lambda x, v, r, a, e, p: forces.ped_repulsive_force(
                            x, v, e, a, p))}
    out = {}
    for law, (p, ref) in refs.items():
        def kern(law=law, p=p, **tiles):
            return functools.partial(jax.jit(
                lambda x, v, r, a, e: pedestrian_force_pallas(
                    x, v, r, a, p, law=law, desired=(
                        (e[:, 0], e[:, 1]) if law == "helbing" else None),
                    **tiles)), *args)
        out[law] = (functools.partial(jax.jit(
            lambda *a, ref=ref, p=p: ref(*a, p)), *args), kern)
    return out


def env_call(mode, use_pallas, **cfg_kw):
    """Jitted environment-force call of a bench mode (pair force off)."""
    import jax
    import jax.numpy as jnp
    from carla_social_force_model_tpu.api.synthetic import (benchmark_bundle,
                                                            urban_bundle)
    from carla_social_force_model_tpu.models.autopilot import (
        autopilot_snapshot)
    from carla_social_force_model_tpu.models.spawn import apply_spawn
    from carla_social_force_model_tpu.models.state import PedState
    from carla_social_force_model_tpu.models.stepper import (force_terms,
                                                             prepare_scene)
    from carla_social_force_model_tpu.models.vehicles import (
        vehicle_snapshot_at)
    if mode == "urban":
        scene, params, cfg, _ = urban_bundle(N)
        snap = autopilot_snapshot(scene.autopilot,
                                  scene.autopilot.initial_state())
    else:
        scene, params, cfg, _ = benchmark_bundle(
            N, with_borders=True, with_obstacles=mode == "obstacles")
        snap = (vehicle_snapshot_at(scene.vehicles, jnp.asarray(10))
                if scene.vehicles is not None else None)
    params = dataclasses.replace(params, enable_pedestrian=False)
    state = apply_spawn(PedState.empty(N), scene.spawn, jnp.asarray(0))
    scn = prepare_scene(scene)
    c = dataclasses.replace(cfg, use_pallas=use_pallas, **cfg_kw)
    f = jax.jit(lambda s: force_terms(s, scn, params, c, snap))
    return lambda: f(state)


def section_calls(tag):
    pos, vel, rad, alive = crowd(N)
    for law, (xla, kern) in pair_calls(pos, vel, rad, alive).items():
        print(f"calls pair {law} N={N}: xla {best_ms(xla):.3f} ms, kernel "
              f"{best_ms(kern()):.3f} ms [{tag}]", flush=True)
    for mode in ("borders", "obstacles", "urban"):
        print(f"calls env {mode} N={N}: xla "
              f"{best_ms(env_call(mode, False)):.3f} ms, kernel "
              f"{best_ms(env_call(mode, True)):.3f} ms [{tag}]", flush=True)


def section_tiles(tag):
    pos, vel, rad, alive = crowd(N)
    kern = pair_calls(pos, vel, rad, alive)["moussaid"][1]
    for tr, tc in ((16, 16), (16, 32), (32, 16), (32, 32), (32, 64),
                   (64, 32), (64, 64), (32, 128), (64, 128), (128, 64)):
        print(f"tiles pair moussaid {tr}x{tc} N={N}: "
              f"{best_ms(kern(row_tile=tr, col_tile=tc)):.3f} ms [{tag}]",
              flush=True)
    for tp in (32, 64, 128):
        print(f"tiles env borders ped_tile {tp} N={N}: "
              f"{best_ms(env_call('borders', True, env_ped_tile=tp)):.3f} ms "
              f"[{tag}]", flush=True)


def ab(label, name, variants, tag):
    """Time two compiled variants A, B, B, A; ``variants``: [(value, fn)]."""
    (va, fa), (vb, fb) = variants
    for v, fn in ((va, fa), (vb, fb), (vb, fb), (va, fa)):
        print(f"{label} {name}={v}: {fn()} [{tag}]", flush=True)


def _with(module, name, value, build):
    """Build (trace) under a patched module constant, then restore it."""
    keep = getattr(module, name)
    setattr(module, name, value)
    try:
        return build()
    finally:
        setattr(module, name, keep)


def _rollout_rate(run, state, agents, steps):
    import bench
    rate = agents * steps / bench.time_rollout(run, state)
    return f"{rate:.1f} agent-steps/s"


def _compiled(fn):
    import jax
    jax.block_until_ready(fn())
    return fn


def _traced(case):
    """Compile a rollout case now (while a patched constant holds)."""
    import jax
    run, state, tag = case
    jax.block_until_ready(run(state))
    return run, state, tag


def section_lists(tag):
    import jax
    import bench
    from carla_social_force_model_tpu.models.params import MoussaidParams
    from carla_social_force_model_tpu.ops import pallas_forces as PF
    pos, vel, rad, alive = crowd(N_CUTOFF)
    p = MoussaidParams()
    cnt, width = PF.survivor_counts(pos, alive, 30.0)
    print(f"lists N={N_CUTOFF} 30 m: width {width}, column tiles within "
          f"30 m per row tile: mean {float(cnt.mean()):.1f}, max "
          f"{int(cnt.max())} [{tag}]", flush=True)
    variants = []
    for v in (PF._MAX_SURV, 10**9):
        # the crowd rides as arguments: XLA would constant-fold the sort
        f = _with(PF, "_MAX_SURV", v, lambda: _compiled(functools.partial(
            jax.jit(lambda *a: PF.pedestrian_force_pallas_sorted(
                *a, p, cutoff=30.0)), pos, vel, rad, alive)))
        variants.append((v, lambda f=f: f"{best_ms(f):.3f} ms"))
    ab(f"lists call N={N_CUTOFF} 30 m", "_MAX_SURV", variants, tag)
    steps = 500
    runs = []
    for v in (PF._MAX_SURV, 10**9):
        run, state, _ = _with(PF, "_MAX_SURV", v, lambda: _traced(
            bench.rollout_case("ped", N_CUTOFF, steps, cutoff=30.0)))
        runs.append((v, lambda r=run, s=state: _rollout_rate(
            r, s, N_CUTOFF, steps)))
    ab(f"lists rollout ped N={N_CUTOFF} 30 m {steps} steps", "_MAX_SURV",
       runs, tag)


def section_tilerolls(tag):
    import bench
    for mode, law, n, cutoff, steps in (
            ("ped", "", N, None, 1000), ("ped", "powerlaw", N, None, 1000),
            ("ped", "helbing", N, None, 1000),
            ("ped", "", N_CUTOFF, 30.0, 500)):
        runs = []
        for tiles in ("32x32", "32x64"):
            run, state, _ = _traced(bench.rollout_case(
                mode, n, steps, law=law, cutoff=cutoff, tiles=tiles))
            runs.append((tiles, lambda r=run, s=state: _rollout_rate(
                r, s, n, steps)))
        ab(f"tilerolls {mode} {law or 'moussaid'} N={n} cutoff={cutoff} "
           f"{steps} steps", "tiles", runs, tag)


def section_warps(tag):
    from carla_social_force_model_tpu.ops import pallas_forces as PF
    pos, vel, rad, alive = crowd(N)
    kern = pair_calls(pos, vel, rad, alive)["moussaid"][1]
    for warps, stages in ((4, 1), (2, 1), (8, 1), (4, 2), (4, 3)):
        keep = PF._NUM_WARPS, PF._NUM_STAGES
        PF._NUM_WARPS, PF._NUM_STAGES = warps, stages
        try:
            f = _compiled(kern())
        finally:
            PF._NUM_WARPS, PF._NUM_STAGES = keep
        print(f"warps pair moussaid N={N} num_warps={warps} "
              f"num_stages={stages}: {best_ms(f):.3f} ms [{tag}]", flush=True)


SECTIONS = {"calls": section_calls, "tiles": section_tiles,
            "lists": section_lists,
            "tilerolls": section_tilerolls, "warps": section_warps}


def main(argv=None) -> int:
    import jax
    names = (argv if argv is not None else sys.argv[1:]) or list(SECTIONS)
    bad = [s for s in names if s not in SECTIONS]
    if bad:
        raise SystemExit(f"unknown sections {bad}; choose from "
                         f"{list(SECTIONS)}")
    if jax.default_backend() == "cpu":
        raise SystemExit("kernel_probe.py measures the card; JAX found only "
                         "the CPU")
    from carla_social_force_model_tpu.utils.compile_cache import (
        enable_compile_cache)
    enable_compile_cache()
    tag = card()
    for name in names:
        SECTIONS[name](tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
