"""The backend predicate (ops/backend.py) and the compile-cache placement
(utils/compile_cache.py)."""
import dataclasses
import os

import jax
import pytest

from carla_social_force_model_tpu.ops import backend
from carla_social_force_model_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bundle(**kw):
    from carla_social_force_model_tpu.api.synthetic import benchmark_bundle
    return benchmark_bundle(16, extent=8.0, **kw)


def test_cpu_selects_jnp():
    assert jax.default_backend() == "cpu"
    assert not backend.kernels_available()
    _, _, cfg, _ = _bundle()
    assert cfg.use_pallas is False


def test_use_pallas_on_cpu_without_interpret_raises():
    from carla_social_force_model_tpu.models.stepper import force_terms
    scene, params, cfg, state = _bundle()
    cfg = dataclasses.replace(cfg, use_pallas=True)
    with pytest.raises(ValueError, match="compiled kernels"):
        force_terms(state, scene, params, cfg, None)
    with pytest.raises(ValueError, match="'cpu'"):
        backend.check_kernels(True, False)


def test_interpret_is_an_explicit_opt_in():
    backend.check_kernels(True, True)      # the interpreter: allowed
    backend.check_kernels(False, False)    # the jnp path: always allowed
    from carla_social_force_model_tpu.models.stepper import (force_terms,
                                                             prepare_scene)
    scene, params, cfg, state = _bundle()
    cfg = dataclasses.replace(cfg, use_pallas=True, pallas_interpret=True)
    terms = force_terms(state, prepare_scene(scene), params, cfg, None)
    assert "pedestrian_force" in terms


def test_cutoff_without_kernels_raises():
    from carla_social_force_model_tpu.models.stepper import force_terms
    scene, params, cfg, state = _bundle()
    cfg = dataclasses.replace(cfg, interaction_cutoff=30.0)
    with pytest.raises(ValueError, match="interaction_cutoff"):
        force_terms(state, scene, params, cfg, None)


def test_scenario_engine_default_follows_backend():
    from carla_social_force_model_tpu.api.simulation import Simulation
    sim = Simulation.from_config(
        os.path.join(ROOT, "configs/scenarios/corridor_counterflow.toml"),
        os.path.join(ROOT, "configs/sfm.toml"), duration=0.5)
    assert sim.bundle.cfg.use_pallas is False
    forced = Simulation.from_config(
        os.path.join(ROOT, "configs/scenarios/corridor_counterflow.toml"),
        os.path.join(ROOT, "configs/sfm.toml"), duration=0.5,
        engine={"use_pallas": True})
    assert forced.bundle.cfg.use_pallas is True


def test_compile_cache_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert calls == []          # JAX reads the variable itself


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    path = compile_cache.compile_cache_dir()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert path == compile_cache.compile_cache_dir()   # no temp names
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == path
    assert calls == [("jax_compilation_cache_dir", path)]

