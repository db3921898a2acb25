#!/usr/bin/env python
"""Smoke test of the simulator on one NVIDIA GPU.

    python chip_smoke.py            # phases 1-5 on one card
    python chip_smoke.py --multi    # the sharded paths on four cards only

Runs in one process.  Every phase raises on failure and the script then
exits non-zero; the last line of standard output is printed only when all
phases passed:

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": 1}}

Phases:

1. device -- JAX must find a GPU; prints nvidia-smi's name and power limit.
2. CLI -- ``api.cli.main`` on two shipped scenarios with ``--csv``; the
   pedestrian CSV has the reference schema and finite rows.
3. kernels -- every fused kernel compiled for the card against the plain
   jnp reference at real widths (N=10k; N=50k for the cutoff, at the
   f32-exact threshold and at the bench cell's 30 m, where the survivor
   lists must run; N=2k rows against the float64 oracle), then the
   card-only pytest tests (a skip fails).  No device-path operation is a
   matrix product, so TF32 never enters; the tolerances cover summation
   order and GPU transcendental rounding.
4. rollouts -- whole ``lax.scan`` rollouts at N=10k (and a 64 x 1k
   ensemble), kernel path against jnp path: positions after 20 steps
   (within 1 mm; the power law and Helbing laws, whose gates are
   discontinuous, as ROLLOUTS states, beside a summation-order witness),
   alive counts, finiteness over 200 steps.
5. timings -- agent-steps/s of those rollouts (informational).
"""
import argparse
import csv
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

#: crowd sizes: the repo's N=10k configs, the N=50k cutoff regime, the
#: float64-oracle check, the four-card sharded crowd, the ensemble
N = 10_000
N_CUTOFF = 50_000
N_ORACLE = 2_000
N_MULTI = 40_000
ENSEMBLE = (64, 1_000)
#: positions of the kernel and jnp rollouts after 20 steps (meters): the
#: forces agree to ~1e-6 relative, and 20 ticks of crowd dynamics
#: amplify that below a millimetre (3.7e-4 m measured for urban, N=10k)
POS_TOL = 1e-3


class SmokeError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()
    check(out, "nvidia-smi printed nothing")
    return out


def phase_device(n_cards: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SmokeError(f"JAX found no GPU (devices: {devs})")
    check(len(devs) >= n_cards, f"need {n_cards} GPUs, JAX sees {len(devs)}")
    print(card_line(), flush=True)
    from carla_social_force_model_tpu.utils.compile_cache import (
        enable_compile_cache)
    print(f"compile cache: {enable_compile_cache()}", flush=True)


def phase_cli():
    import numpy as np
    from carla_social_force_model_tpu.api import cli
    for name in ("corridor_counterflow", "routed_town"):
        with tempfile.TemporaryDirectory() as out:
            rc = cli.main(["--scenario-config",
                           os.path.join(ROOT, "configs/scenarios",
                                        f"{name}.toml"),
                           "--steps", "300", "--csv", "--output", out])
            check(rc == 0, f"cli {name}: exit {rc}")
            paths = glob.glob(os.path.join(out, "**", "pedestrian.csv"),
                              recursive=True)
            check(len(paths) == 1, f"cli {name}: no pedestrian.csv")
            with open(paths[0], newline="") as f:
                rows = list(csv.reader(f))
            check(rows[0] == ["ped_id", "frame", "time", "x", "y", "v_x",
                              "v_y", "mode"], f"cli {name}: header {rows[0]}")
            check(len(rows) > 1, f"cli {name}: no rows")
            vals = np.asarray([[float(v) for v in r[2:7]] for r in rows[1:]])
            check(np.isfinite(vals).all(), f"cli {name}: non-finite rows")
            print(f"cli {name}: {len(rows) - 1} rows ok", flush=True)


def _crowd(n, extent, seed):
    import numpy as np
    import jax.numpy as jnp
    rng = np.random.default_rng(seed)
    pos = jnp.asarray(rng.uniform(-extent, extent, (n, 2)), jnp.float32)
    vel = jnp.asarray(rng.uniform(-1.5, 1.5, (n, 2)), jnp.float32)
    rad = jnp.asarray(rng.uniform(0.2, 0.4, n), jnp.float32)
    alive = jnp.asarray(rng.uniform(size=n) < 0.95)
    return pos, vel, rad, alive


def phase_kernels():
    import numpy as np
    import jax
    import jax.numpy as jnp
    from carla_social_force_model_tpu.models.params import (
        MoussaidParams, PedRepulsiveParams, PowerLawParams)
    from carla_social_force_model_tpu.ops import forces
    from carla_social_force_model_tpu.ops.pallas_forces import (
        pedestrian_force_pallas, pedestrian_force_pallas_sorted)

    # pair forces, all three laws, N=10k exact all-pairs; the power law's
    # rows sum cancelling near-collision terms (tests/test_powerlaw.py)
    pos, vel, rad, alive = _crowd(N, 100.0, seed=0)
    e = vel / (jnp.linalg.norm(vel, axis=1, keepdims=True) + 1e-6)
    laws = (("moussaid", MoussaidParams(), 2e-5,
             lambda p: forces.pedestrian_force(pos, vel, rad, alive, p)),
            ("powerlaw", PowerLawParams(), 3e-4,
             lambda p: forces.powerlaw_force(pos, vel, rad, alive, p)),
            ("helbing", PedRepulsiveParams(), 2e-5,
             lambda p: forces.ped_repulsive_force(pos, vel, e, alive, p)))
    for law, p, rtol, ref in laws:
        want = np.asarray(jax.jit(ref)(p))
        got = np.asarray(jax.jit(lambda p_, law_=law: pedestrian_force_pallas(
            pos, vel, rad, alive, p_, law=law_,
            desired=(e[:, 0], e[:, 1]) if law_ == "helbing" else None))(p))
        np.testing.assert_allclose(got, want, rtol=rtol, atol=2e-5,
                                   err_msg=f"pair {law} N={N}")
        check(np.all(got[~np.asarray(alive)] == 0.0), f"{law}: dead rows")
        print(f"pair {law} N={N}: max|d| {np.abs(got - want).max():.3e} ok",
              flush=True)

    # the same kernel at N=2k against the float64 oracle (tests/oracle.py),
    # on 128 sampled rows (the oracle is a per-pair Python loop)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import oracle
    p = MoussaidParams()
    pos2, vel2, rad2, alive2 = _crowd(N_ORACLE, 45.0 * (N_ORACLE / 2000)
                                      ** 0.5, seed=1)
    got = np.asarray(jax.jit(lambda: pedestrian_force_pallas(
        pos2, vel2, rad2, alive2, p))())
    P, V = np.asarray(pos2, np.float64), np.asarray(vel2, np.float64)
    A = np.asarray(alive2)
    rows = np.flatnonzero(A)[:: max(1, int(A.sum()) // 128)][:128]
    want = np.zeros((rows.size, 2))
    for k, i in enumerate(rows):
        for j in np.flatnonzero(A):
            if j != i:
                diff = P[j] - P[i]
                dist = np.linalg.norm(diff)
                want[k] += oracle.moussaid_term(
                    diff / dist, dist, V[i] - V[j], p.lambda_, p.A, p.gamma,
                    p.n, p.n_prime, p.epsilon)
    np.testing.assert_allclose(got[rows], want, rtol=2e-3, atol=1e-4,
                               err_msg="pair moussaid vs float64 oracle")
    print(f"pair moussaid N={N_ORACLE} vs f64 oracle ({rows.size} rows) ok",
          flush=True)

    # the cutoff kernel at the f32-exact threshold, N=50k: bitwise equal to
    # the all-pairs kernel; the sorted launch equal up to summation order;
    # both against XLA's all-pairs
    n5 = N_CUTOFF
    pos5, vel5, rad5, alive5 = _crowd(n5, float(np.sqrt(n5)), seed=2)
    v_max = float(np.abs(np.asarray(vel5)).max() * np.sqrt(2.0))
    thresh = float(np.ceil(110.0 * p.gamma * (2.0 * p.lambda_ * v_max + 1.0)))
    exact = np.asarray(jax.jit(lambda: pedestrian_force_pallas(
        pos5, vel5, rad5, alive5, p))())
    cut = np.asarray(jax.jit(lambda: pedestrian_force_pallas(
        pos5, vel5, rad5, alive5, p, cutoff=thresh))())
    check(np.array_equal(cut, exact), "cutoff at f32-exact threshold is not "
          "bitwise equal to all-pairs")
    srt = np.asarray(jax.jit(lambda: pedestrian_force_pallas_sorted(
        pos5, vel5, rad5, alive5, p, cutoff=thresh))())
    np.testing.assert_allclose(srt, exact, rtol=2e-5, atol=2e-5,
                               err_msg="sorted cutoff vs all-pairs")
    xla = np.asarray(jax.jit(lambda: forces.pedestrian_force(
        pos5, vel5, rad5, alive5, p))())
    np.testing.assert_allclose(exact, xla, rtol=2e-5, atol=2e-5,
                               err_msg="N=50k kernel vs XLA")
    print(f"cutoff {thresh:.0f} m N={n5}: bitwise == all-pairs, sorted and "
          f"XLA agree ok", flush=True)

    # the bench cell's 30 m cutoff at N=50k runs the survivor-list launch:
    # the lists engage and fit; they equal the in-loop skip bitwise (the
    # same tiles in the same order); sampled rows
    # agree with a jnp per-pair sum over the pairs within 30 m
    from carla_social_force_model_tpu.ops import pallas_forces as PF
    near = 30.0
    cnt, width = PF.survivor_counts(pos5, alive5, near)
    most = int(np.asarray(cnt).max())
    check(width > 0 and most <= width, f"{near} m survivor lists do not run "
          f"at N={n5}: width {width}, most survivors {most}")
    listed = np.asarray(jax.jit(lambda: PF.pedestrian_force_pallas_sorted(
        pos5, vel5, rad5, alive5, p, cutoff=near))())
    keep, PF._MAX_SURV = PF._MAX_SURV, 10**9          # lists never engage
    try:
        skip = np.asarray(jax.jit(lambda: PF.pedestrian_force_pallas_sorted(
            pos5, vel5, rad5, alive5, p, cutoff=near))())
    finally:
        PF._MAX_SURV = keep
    check(np.array_equal(listed, skip), f"{near} m survivor lists differ "
          f"from the in-loop skip by {np.abs(listed - skip).max():.3g}")
    rows = np.flatnonzero(np.asarray(alive5))[:: n5 // 256][:256]

    def in_range_sum():
        diff = pos5[None, :, :] - pos5[rows][:, None, :]    # x_j - x_i
        ok = (alive5[None, :] & (jnp.arange(n5)[None, :] != rows[:, None])
              & (jnp.sum(diff * diff, axis=-1) <= near * near))
        return jnp.sum(forces._moussaid_pair_force(
            diff, 0.0, vel5[rows][:, None, :] - vel5[None, :, :], p, ok),
            axis=1)
    np.testing.assert_allclose(listed[rows], np.asarray(jax.jit(
        in_range_sum)()), rtol=2e-5, atol=2e-5,
        err_msg=f"{near} m cutoff vs jnp pairs within {near} m")
    print(f"cutoff {near:.0f} m N={n5}: survivor lists (width {width}, most "
          f"{most}) == in-loop skip bitwise, jnp per-pair sum agrees ok",
          flush=True)

    # environment terms at N=10k, sampled and analytic, against jnp
    import dataclasses
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
    for mode in ("borders", "obstacles", "urban"):
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
        for analytic in (False, True):
            scn = prepare_scene(scene, analytic=analytic)
            base = dataclasses.replace(cfg, env_analytic=analytic)
            terms = [jax.jit(lambda s, k=k: force_terms(
                s, scn, params, dataclasses.replace(base, use_pallas=k),
                snap))(state) for k in (True, False)]
            for name in terms[1]:
                g = np.stack([np.asarray(a) for a in terms[0][name]], -1)
                w = np.stack([np.asarray(a) for a in terms[1][name]], -1)
                # per-agent vector tolerance: a wall-hugging agent's unit
                # vector carries the f32 rounding of the closest point
                err = np.linalg.norm(g - w, axis=1)
                lim = 3e-4 * np.linalg.norm(w, axis=1) + 3e-5
                check(np.all(err <= lim),
                      f"env {mode} analytic={analytic} {name}: "
                      f"worst err/lim {(err / lim).max():.3g}")
            print(f"env {mode} analytic={analytic}: {sorted(terms[1])} ok",
                  flush=True)

    # the card-only pytest tests, in this process (a skip is a failure)
    import pytest

    class Tally:
        passed = skipped = 0

        def pytest_collectreport(self, report):
            self.skipped += bool(report.skipped)

        def pytest_runtest_logreport(self, report):
            if report.skipped:
                self.skipped += 1
            elif report.when == "call" and report.passed:
                self.passed += 1

    tally = Tally()
    os.environ["SFM_TEST_PLATFORM"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_gpu_kernels.py")],
                     plugins=[tally])
    check(rc == 0 and tally.passed > 0 and tally.skipped == 0,
          f"card-only tests: pytest exit {rc}, {tally.passed} passed, "
          f"{tally.skipped} skipped")
    print(f"card-only tests: {tally.passed} passed ok", flush=True)


#: (mode, law, step at which kernel and jnp positions are compared, meters
#: allowed).  Two laws have discontinuous gates that amplify the ~1e-6 m
#: one-step difference of summation order: the power law's time-to-
#: collision gates (tau < tau_max, disc > 0) grow it ~10x every 4-5 ticks
#: (3.8e-6 m after 1 step, 8e-5 after 5, 0.16 after 20 on the CPU at
#: N=300; 2.7e-3 m after 5 on the card at N=10k), so it is compared at step
#: 5; Helbing's field-of-view weight jumps between 1 and fov_factor at the
#: +-phi boundary (1.4e-3 m after 20 steps on the card at N=10k).  Both
#: within 1 cm.  Both print a summation-order witness (WITNESS_TILES): on
#: an H100 two kernels that differ only in column tile (32x32, 32x64)
#: start 10-50x closer to each other than kernel and jnp do, yet drift as
#: far by step 20: 0.49-0.57 m for the power law (kernel-jnp 0.47-0.59 m)
#: and, in one of two pairings, 2.3e-3 m for Helbing (kernel-jnp
#: 1.4e-3-2.3e-3 m; 5.3e-5 m in the other pairing, where no agent crossed
#: the +-phi boundary differently).  The drift is the laws' amplification
#: of rounding, which the one-step force checks of phase 3 bound
ROLLOUTS = (("ped", "", 20, POS_TOL), ("borders", "", 20, POS_TOL),
            ("obstacles", "", 20, POS_TOL), ("urban", "", 20, POS_TOL),
            ("ped", "powerlaw", 5, 1e-2), ("ped", "helbing", 20, 1e-2),
            ("ped", "orca", 20, POS_TOL))
#: pair-kernel tiles of the witness rollout: the same pairs as the default
#: 32x32 launch, summed in another order (64-wide partial sums), so its
#: drift from the default kernel is what summation order alone produces
WITNESS_TILES = "32x64"


def _max_dpos(ra, rb, k):
    """Largest position difference after ``k`` steps over agents alive in
    both records."""
    import numpy as np
    al = np.asarray(ra.alive[k]) & np.asarray(rb.alive[k])
    d = np.abs(np.asarray(ra.pos[k]) - np.asarray(rb.pos[k]))[al]
    return float(d.max()) if d.size else 0.0


def phase_rollouts():
    """Phases 4 and 5: correctness of whole rollouts, then their rates."""
    import numpy as np
    import jax
    import bench
    card = card_line()
    rates = []
    for mode, law, at, tol in ROLLOUTS:
        runs = {}
        for kern in (True, False):
            run, state, tag = bench.rollout_case(mode, N, 200, law=law,
                                                 use_pallas=kern, record=True)
            final, rec = run(state)
            if not hasattr(rec, "pos"):          # (StepRecord, fleet record)
                rec = rec[0]
            jax.block_until_ready(rec)
            runs[kern] = (run, state, rec)
            check(np.isfinite(np.asarray(rec.pos)).all(),
                  f"rollout {mode}{tag}: non-finite positions in 200 steps")
        rk, rx = runs[True][2], runs[False][2]
        al = np.asarray(rk.alive[at])
        check(np.array_equal(al, np.asarray(rx.alive[at])),
              f"rollout {mode}_{law}: alive differs after {at} steps")
        d = _max_dpos(rk, rx, at)
        check(d <= tol, f"rollout {mode}_{law}: positions differ by "
              f"{d:.3g} m after {at} steps")
        print(f"rollout {mode} {law or 'moussaid'} N={N}: alive "
              f"{int(al.sum())}, max|dpos| at step {at} {d:.3e} m ok",
              flush=True)
        if tol != POS_TOL:
            wrun, wstate, _ = bench.rollout_case(
                mode, N, 200, law=law, use_pallas=True, record=True,
                tiles=WITNESS_TILES)
            rw = wrun(wstate)[1]
            for k in (5, 10, 20):
                print(f"witness {law} step {k}: kernel vs jnp "
                      f"{_max_dpos(rk, rx, k):.3e} m, kernel vs kernel "
                      f"{WITNESS_TILES} tiles {_max_dpos(rk, rw, k):.3e} m",
                      flush=True)
        for kern in (True, False):
            run, state, _ = runs[kern]
            rates.append((f"{mode} {law or 'moussaid'} "
                          f"{'kernel' if kern else 'xla'}",
                          N * 200 / bench.time_rollout(run, state, 2)))

    # ensemble, kernel vs jnp
    b, n1 = ENSEMBLE
    outs = {}
    for kern in (True, False):
        run, scene, _ = bench.ensemble_case(n1, b, 20, use_pallas=kern)
        outs[kern] = run(scene)[0]
        rates.append((f"ensemble {b}x{n1} {'kernel' if kern else 'xla'}",
                      b * n1 * 20 / bench.time_rollout(run, scene, 2)))
    fk, fx = outs[True], outs[False]
    check(np.array_equal(np.asarray(fk.alive), np.asarray(fx.alive)),
          "ensemble: alive differs")
    d = float(np.abs(np.asarray(fk.pos) - np.asarray(fx.pos)).max())
    check(d <= POS_TOL, f"ensemble: positions differ by {d:.3g} m")
    print(f"ensemble {b}x{n1}: max|dpos| after 20 steps {d:.3e} m ok",
          flush=True)

    for name, rate in rates:
        print(f"rate {name}: {rate:.1f} agent-steps/s [{card}]", flush=True)


def phase_multi():
    """Agent sharding over four cards against one card, jnp and kernel
    paths, gather and ring column comm; the 2 x 2 sharded ensemble."""
    import dataclasses
    import numpy as np
    import jax
    from carla_social_force_model_tpu.api.synthetic import (batched_crowds,
                                                            benchmark_bundle)
    from carla_social_force_model_tpu.models.state import PedState
    from carla_social_force_model_tpu.models.stepper import make_rollout_fn
    from carla_social_force_model_tpu.parallel.mesh import make_mesh
    from carla_social_force_model_tpu.parallel.sharding import (
        make_sharded_rollout, prepare_sharded_scene)
    from carla_social_force_model_tpu.parallel.sweeps import (
        make_ensemble_rollout, make_sharded_ensemble_rollout)

    n, steps = N_MULTI, 20
    mesh = make_mesh(n_agent_shards=4)
    scene, params, cfg, _ = benchmark_bundle(n)
    scene, cap = prepare_sharded_scene(scene, 4)
    for kern in (False, True):
        c1 = dataclasses.replace(cfg, use_pallas=kern)
        one = make_rollout_fn(scene, params, c1, steps, record=False)(
            PedState.empty(cap))[0]
        for comm in ("gather", "ring"):
            c = dataclasses.replace(c1, axis_comm=comm)
            run = make_sharded_rollout(mesh, scene, params, c, steps)
            fin = run(PedState.empty(cap))[0]
            devs = {s.device for s in fin.pos_x.addressable_shards}
            check(len(devs) == 4, f"shards on {len(devs)} devices, want 4")
            check(np.array_equal(np.asarray(fin.alive), np.asarray(one.alive)),
                  f"sharded {comm} kernel={kern}: alive differs")
            d = float(np.abs(np.asarray(fin.pos) - np.asarray(one.pos)).max())
            check(d <= POS_TOL, f"sharded {comm} kernel={kern}: positions "
                  f"differ by {d:.3g} m")
            t = _time(run, PedState.empty(cap))
            print(f"sharded N={n} {comm} kernel={kern}: max|dpos| {d:.3e} m "
                  f"ok, {n * steps / t:.1f} agent-steps/s on 4 cards",
                  flush=True)

    mesh2 = make_mesh(n_agent_shards=2, n_batch_shards=2)
    scene2, params2, cfg2, _ = benchmark_bundle(1000)
    scene2 = dataclasses.replace(scene2, spawn=batched_crowds(8, 1000))
    for kern in (False, True):
        c = dataclasses.replace(cfg2, use_pallas=kern)
        fin = make_sharded_ensemble_rollout(mesh2, scene2, params2, c,
                                            steps)()[0]
        ref = make_ensemble_rollout(scene2, params2, c, steps)(scene2)[0]
        devs = {s.device for s in fin.pos_x.addressable_shards}
        check(len(devs) == 4, f"2x2 ensemble on {len(devs)} devices")
        d = float(np.abs(np.asarray(fin.pos_x)[:, :1000]
                         - np.asarray(ref.pos_x)).max())
        check(d <= POS_TOL, f"2x2 ensemble kernel={kern}: differs by {d:.3g}")
        print(f"2x2 sharded ensemble 8x1000 kernel={kern}: max|dx| {d:.3e} m "
              f"ok", flush=True)


def _time(run, arg):
    import jax
    jax.block_until_ready(run(arg))
    t0 = time.perf_counter()
    jax.block_until_ready(run(arg))
    return time.perf_counter() - t0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    phase_device(4 if args.multi else 1)
    if args.multi:
        phase_multi()
    else:
        for phase in (phase_cli, phase_kernels, phase_rollouts):
            t = time.perf_counter()
            phase()
            print(f"phase {phase.__name__} passed in "
                  f"{time.perf_counter() - t:.1f} s", flush=True)
    import jax
    d = jax.devices()[0]
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s",
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
