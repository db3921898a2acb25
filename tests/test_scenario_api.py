"""Scenario building, reference-TOML compatibility, CSV output, CLI."""
import csv
import os

import numpy as np
import pytest

from carla_social_force_model_tpu.api.scenario import build_scenario
from carla_social_force_model_tpu.api.simulation import Simulation
from carla_social_force_model_tpu.utils.config import load_toml

REF_CONFIG = "/root/reference/config"

SFM_DICT = {
    "max_speed_multiplier": 1.3,
    "use_ped_radius": False,
    "forces": {"acceleration_force": True, "pedestrian_force": True,
               "border_force": True},
    "acceleration_force": {"tau": 0.5},
    "pedestrian_force": {"lambda": 2.0, "A": 4.5, "gamma": 0.35, "n": 2.0,
                         "n_prime": 3.0, "epsilon": 0.005},
    "border_force": {"a": 6.0, "b": 0.3},
}

CORRIDOR = {
    "scenario_name": "corridor-test",
    "step_length": 0.05,
    "walker": {
        "pedestrian_seed": 2015,
        "despawn_on_arrival": True,
        "waypoint_threshold": 1,
        "ped_spawner": [
            {"spawn_location": [-8.0, 0.3, 1.0], "destination": [8.0, 0.3, 0.0],
             "speed": 1.3, "quantity": 2, "spawn_time": 0.0, "spawn_interval": 1.0},
            {"spawn_location": [8.0, -0.3, 1.0], "destination": [-8.0, -0.3, 0.0],
             "speed": 1.2, "quantity": 2, "spawn_time": 0.5, "spawn_interval": 1.0},
        ],
    },
    "obstacles": {
        "resolution": 0.1,
        "borders": [
            {"start_point": [-10.0, 1.5], "end_point": [10.0, 1.5]},
            {"start_point": [-10.0, -1.5], "end_point": [10.0, -1.5]},
        ],
    },
}


@pytest.mark.skipif(not os.path.isdir(REF_CONFIG),
                    reason="reference configs not mounted")
def test_reference_scenario_tomls_parse_unchanged():
    """Every reference scenario TOML must build a ScenarioBundle (manual-
    waypoint spawners headless; generate_route ones need a graph and are
    exercised in routing tests)."""
    sfm = load_toml(os.path.join(REF_CONFIG, "sfm_config.toml"))
    scenarios_dir = os.path.join(REF_CONFIG, "scenarios")
    built = 0
    for name in sorted(os.listdir(scenarios_dir)):
        scenario = load_toml(os.path.join(scenarios_dir, name))
        spawners = scenario.get("walker", {}).get("ped_spawner", [])
        if any(sp.get("generate_route") for sp in spawners):
            continue  # needs nav graph (routing/bridge)
        bundle = build_scenario(scenario, sfm, num_steps=10)
        assert bundle.capacity >= 1
        built += 1
    assert built >= 4  # circle, circle2, crossing, vehicle(2), obstacle...


@pytest.mark.skipif(not os.path.isdir(REF_CONFIG),
                    reason="reference configs not mounted")
def test_crossing_scenario_borders_match_reference_geometry():
    sfm = load_toml(os.path.join(REF_CONFIG, "sfm_config.toml"))
    scenario = load_toml(os.path.join(
        REF_CONFIG, "scenarios", "crossing_scenario_config.toml"))
    bundle = build_scenario(scenario, sfm, num_steps=10)
    assert len(bundle.border_lines) == 8  # 8 manual borders in the config
    assert bundle.capacity == 20          # 20 spawners x quantity 1
    # border sampling: int(30.0 / 0.1) = 299 samples in IEEE floats -- the
    # reference computes exactly this (obstacles.py:348)
    assert len(bundle.border_lines[0]) == 299


def test_simulation_runs_and_writes_reference_schema_csv(tmp_path):
    sim = Simulation.from_config(CORRIDOR, SFM_DICT, duration=20.0)
    final, recs = sim.run()
    assert int(np.asarray(final.spawned).sum()) == 4
    # everyone should have despawned after reaching the far end
    assert int(np.asarray(final.alive).sum()) == 0

    out = sim.write_csv(str(tmp_path))
    with open(os.path.join(out, "pedestrian.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["ped_id", "frame", "time", "x", "y", "v_x", "v_y", "mode"]
    assert len(rows) > 100
    # modes are PedMode ints
    assert set(int(r[7]) for r in rows[1:]) <= {0, 1, 2, 3, 4}
    with open(os.path.join(out, "borders.csv")) as f:
        brows = list(csv.reader(f))
    assert brows[0] == ["x", "y"]
    assert len(brows) - 1 == sum(len(b) for b in sim.bundle.border_lines)
    with open(os.path.join(out, "vehicle.csv")) as f:
        vrows = list(csv.reader(f))
    assert vrows[0] == ["veh_id", "frame", "time", "x", "y", "heading", "vel",
                        "ext_x", "ext_y"]


def _write_toml(path, text):
    with open(path, "w") as f:
        f.write(text)


def test_cli_headless_run(tmp_path):
    scen = tmp_path / "scen.toml"
    _write_toml(scen, """
scenario_name = 'cli-test'
step_length = 0.05

[walker]
despawn_on_arrival = true
waypoint_threshold = 1

[[walker.ped_spawner]]
spawn_location = [0.0, 0.0, 1.0]
destination = [5.0, 0.0, 0.0]
speed = 1.4
quantity = 1
""")
    from carla_social_force_model_tpu.api.cli import main
    rc = main(["--scenario-config", str(scen), "--duration", "10",
               "--csv", "--output", str(tmp_path / "out")])
    assert rc == 0
    runs = os.listdir(tmp_path / "out")
    assert len(runs) == 1
    assert "cli-test" in runs[0]


def test_package_import_initializes_no_backend():
    """Importing the package must not create device arrays: a module-level
    ``jnp`` constant would initialize the JAX backend at import time, before
    a CLI ``--platform`` override (api/cli.py) or an embedding application's
    ``jax.config.update("jax_platforms", ...)`` can take effect, and
    before an entry point enables the compile cache.  Regression guard for
    the np-vs-jnp module constants in ops/geometry.py and ops/spatial.py."""
    import subprocess
    import sys

    code = (
        "import jax\n"
        "import carla_social_force_model_tpu\n"
        "import carla_social_force_model_tpu.api.cli\n"
        "from jax._src import xla_bridge\n"
        "assert not xla_bridge._backends, "
        "f'import initialized backends: {list(xla_bridge._backends)}'\n"
    )
    # cwd-independent: another test may have chdir'd away from the repo
    # root, and `python -c` resolves the package from its cwd
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
