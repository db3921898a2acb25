#!/usr/bin/env python
"""Benchmark: agent-steps/s of one whole jitted ``lax.scan`` rollout.

Workloads (``BENCH_MODE``):

* ``ped`` (default) -- config #1: acceleration + Moussaid pedestrian forces,
  full mode/waypoint pipeline, N=10k.
* ``borders`` -- config #2: + border force over a street-grid wall point
  cloud at the reference's 0.1 m sampling.
* ``obstacles`` -- config #3: + static (parked-car grid) and dynamic
  (moving vehicles) obstacle forces.
* ``urban`` -- config #4: nav-graph-routed pedestrians on a synthetic
  street grid with curb borders, crosswalk mode transitions, gap-acceptance
  road crossing, and a reactive autopilot fleet (the full tick pipeline,
  run_simulation.py:47-132).
* ``ensemble`` -- config #5 shape: BENCH_BATCH (default 256) independent
  rollouts x N (default 1k) pedestrians vmapped in one launch; the value is
  the aggregate agent-steps/s.

The reference itself is real-time paced at N*20 agent-steps/s
(BASELINE.md); ``vs_baseline`` divides by the 1M agent-steps/s north star.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device"}, the device as JAX reports it.  Refuses to run without an
accelerator: a CPU time is not a device time.

Env: BENCH_N, BENCH_STEPS, BENCH_CUTOFF (meters; locality-sorted cutoff on
the kernel path), BENCH_BATCH (ensemble only), BENCH_TILES ("<row>x<col>"
pair-kernel tiles), BENCH_ENV_ANALYTIC ("1" enables the analytic border
tier), BENCH_PALLAS ("0" runs the plain XLA path instead of the fused
kernels -- the kernel-vs-XLA comparison; metric tagged "-xla"), BENCH_LAW
("powerlaw" swaps the pair-force family to the Karamouzas-2014
time-to-collision law, "helbing" to the Helbing-Molnar-1995 elliptical
repulsion, "orca" to the van-den-Berg-2011 reciprocal-collision-avoidance
velocity law; rollout modes only), BENCH_ORCA ("<window>:<max_neighbors>"),
BENCH_ORCA_PURE ("1" with BENCH_LAW=orca turns the soft border force OFF so
walls act only as ORCA's hard half-plane constraints), BENCH_MIX
("moussaid,powerlaw,orca" -- a MIXED-MODEL crowd: equal contiguous slot
chunks, each perceiving the crowd through its own family; rollout modes
only, exclusive with BENCH_LAW), BENCH_GROUPS ("<frac>:<size>", e.g.
"0.5:4" -- social parties plus the Moussaid-2010 group force).
"""
import dataclasses
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

MODES = ("ped", "borders", "obstacles", "urban", "ensemble")
BASELINE_AGENT_STEPS_PER_SEC = 1_000_000.0


def default_steps(mode: str) -> int:
    """Steps per timed rollout.  On a local card one dispatch costs tens of
    microseconds, so the window only has to be long enough that the host
    timer and the launch are noise: 1000 steps of an N=10k rollout take
    ~0.1-1 s.  One ensemble step already covers BATCH x N agents, so 100
    steps suffice there."""
    return 100 if mode == "ensemble" else 1_000


def rollout_case(mode: str, n: int, steps: int, *, law: str = "",
                 mix: str = "", groups: str = "", cutoff: float | None = None,
                 env_analytic: bool = False, tiles: str = "",
                 use_pallas: bool | None = None, orca: str = "",
                 orca_pure: bool = False, record: bool = False):
    """(run, state, tag): a jitted rollout of one bench configuration, its
    initial state, and the metric-name suffix that identifies it.
    ``record`` keeps the per-step StepRecord (off for timing)."""
    from carla_social_force_model_tpu.api.synthetic import (benchmark_bundle,
                                                            urban_bundle)
    from carla_social_force_model_tpu.models.stepper import make_rollout_fn

    if mode == "urban":
        scene, params, cfg, state = urban_bundle(
            n, num_steps_hint=steps, use_pallas=use_pallas)
    else:
        scene, params, cfg, state = benchmark_bundle(
            n, with_borders=mode in ("borders", "obstacles"),
            with_obstacles=mode == "obstacles", num_steps_hint=steps,
            use_pallas=use_pallas)
    if law == "powerlaw":
        params = dataclasses.replace(params, enable_pedestrian=False,
                                     enable_powerlaw=True)
    elif law == "helbing":
        params = dataclasses.replace(params, enable_pedestrian=False,
                                     enable_ped_repulsive=True)
    elif law == "orca":
        # windowed Hilbert-band neighbors + exact LP (ops/orca.py);
        # "<window>:<max_neighbors>" overrides the neighbor knobs
        params = dataclasses.replace(params, enable_pedestrian=False,
                                     enable_orca=True)
        if orca:
            w, k = (int(v) for v in orca.split(":"))
            params = dataclasses.replace(
                params, orca=dataclasses.replace(
                    params.orca, window=w, max_neighbors=k))
        if orca_pure:
            # pure RVO2 semantics: walls act only as hard half-planes
            params = dataclasses.replace(params, enable_border=False)
    elif law:
        raise SystemExit(
            f"BENCH_LAW must be powerlaw|helbing|orca, got {law!r}")
    fams = []
    if mix:
        # mixed-model crowd: equal contiguous slot chunks, one pair-force
        # family each (models/spawn.LAW_IDS row masks)
        if law:
            raise SystemExit("BENCH_MIX and BENCH_LAW are mutually exclusive")
        import numpy as np
        from carla_social_force_model_tpu.models.spawn import LAW_IDS
        fams = [f.strip() for f in mix.split(",") if f.strip()]
        bad = [f for f in fams if f not in LAW_IDS]
        if bad or not fams:
            raise SystemExit(
                f"BENCH_MIX entries must be in {sorted(LAW_IDS)}, got {mix!r}")
        cap = scene.spawn.capacity
        law_arr = np.full(cap, -1, np.int32)
        for fam, chunk in zip(fams, np.array_split(np.arange(cap), len(fams))):
            law_arr[chunk] = LAW_IDS[fam]
        scene = dataclasses.replace(
            scene, spawn=dataclasses.replace(scene.spawn, law_id=law_arr))
        params = dataclasses.replace(
            params,
            enable_pedestrian="moussaid" in fams,
            enable_powerlaw="powerlaw" in fams,
            enable_ped_repulsive="helbing" in fams,
            enable_orca="orca" in fams)
    if groups:
        # Moussaid-2010 social parties on top of the pair force
        import numpy as np
        from carla_social_force_model_tpu.models.groups import build_groups
        frac, size = groups.split(":")
        cap = scene.spawn.capacity
        k = int(float(frac) * cap)
        gid = np.full(cap, -1, np.int32)
        gid[:k] = np.arange(k) // int(size)
        scene = dataclasses.replace(
            scene, groups=build_groups(gid, max_members=int(size)))
        params = dataclasses.replace(params, enable_group=True)
    if cutoff is not None:
        cfg = dataclasses.replace(cfg, interaction_cutoff=float(cutoff))
    if tiles:
        tr, tc = (int(v) for v in tiles.split("x"))
        cfg = dataclasses.replace(cfg, pallas_row_tile=tr,
                                  pallas_col_tile=tc)
    if env_analytic:
        cfg = dataclasses.replace(cfg, env_analytic=True)
    run = make_rollout_fn(scene, params, cfg, steps, record=record)

    # mixed runs encode the family NAMES so different mixes of the same
    # size produce distinct metric records
    tag = f"_{law}" if law else (f"_mix-{'-'.join(fams)}" if mix else "")
    if law == "orca" and orca:
        tag += "-w" + orca.replace(":", "k")
    if law == "orca" and orca_pure:
        tag += "-pure"
    if env_analytic:
        tag += "-env"
    if not cfg.use_pallas:
        tag += "-xla"
    return run, state, tag


def ensemble_case(n: int, batch: int, steps: int,
                  cutoff: float | None = None,
                  use_pallas: bool | None = None, record: bool = False):
    """(run, scene, tag) for the vmapped ensemble of ``batch`` crowds."""
    from carla_social_force_model_tpu.api.synthetic import (batched_crowds,
                                                            benchmark_bundle)
    from carla_social_force_model_tpu.parallel.sweeps import (
        make_ensemble_rollout)

    scene, params, cfg, _ = benchmark_bundle(n, use_pallas=use_pallas)
    if cutoff is not None:
        cfg = dataclasses.replace(cfg, interaction_cutoff=float(cutoff))
    scene = dataclasses.replace(scene, spawn=batched_crowds(batch, n))
    run = make_ensemble_rollout(scene, params, cfg, steps, record=record)
    return run, scene, f"_b{batch}" + ("" if cfg.use_pallas else "-xla")


def time_rollout(run, arg, repeats: int = 3) -> float:
    """Best wall time of ``repeats`` calls after one warm-up (compile) call;
    each call ends in ``jax.block_until_ready``."""
    import jax
    jax.block_until_ready(run(arg))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(run(arg))
        best = min(best, time.perf_counter() - t0)
    return best


def device_info() -> dict:
    import jax
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def main():
    mode = os.environ.get("BENCH_MODE", "ped")
    if mode not in MODES:
        raise SystemExit(
            f"BENCH_MODE must be one of {'|'.join(MODES)}, got {mode!r}")
    import jax
    from carla_social_force_model_tpu.utils.compile_cache import (
        enable_compile_cache)
    if jax.default_backend() == "cpu":
        raise SystemExit("bench.py measures the accelerator; JAX found "
                         "only the CPU")
    enable_compile_cache()
    n = int(os.environ.get("BENCH_N", 1_000 if mode == "ensemble" else 10_000))
    steps = int(os.environ.get("BENCH_STEPS", default_steps(mode)))
    cutoff = (float(os.environ["BENCH_CUTOFF"])
              if os.environ.get("BENCH_CUTOFF") else None)
    use_pallas = (None if os.environ.get("BENCH_PALLAS", "") == ""
                  else os.environ["BENCH_PALLAS"] != "0")
    if mode == "ensemble":
        for knob in ("BENCH_LAW", "BENCH_MIX", "BENCH_GROUPS"):
            if os.environ.get(knob):
                # refuse rather than silently benchmark something else
                raise SystemExit(f"{knob} applies to rollout modes only")
        batch = int(os.environ.get("BENCH_BATCH", 256))
        run, arg, extra = ensemble_case(n, batch, steps, cutoff, use_pallas)
        agents = batch * n
    else:
        run, arg, extra = rollout_case(
            mode, n, steps, law=os.environ.get("BENCH_LAW", ""),
            mix=os.environ.get("BENCH_MIX", ""),
            groups=os.environ.get("BENCH_GROUPS", ""), cutoff=cutoff,
            env_analytic=os.environ.get("BENCH_ENV_ANALYTIC", "0") != "0",
            tiles=os.environ.get("BENCH_TILES", ""), use_pallas=use_pallas,
            orca=os.environ.get("BENCH_ORCA", ""),
            orca_pure=os.environ.get("BENCH_ORCA_PURE") == "1")
        agents = n
    value = agents * steps / time_rollout(run, arg)
    tag = "" if mode == "ped" else f"_{mode}"
    print(json.dumps({
        "metric": f"agent_steps_per_sec_n{n}{tag}{extra}",
        "value": round(value, 1),
        "unit": "agent-steps/s",
        "vs_baseline": round(value / BASELINE_AGENT_STEPS_PER_SEC, 3),
        "device": device_info(),
    }))


if __name__ == "__main__":
    main()
