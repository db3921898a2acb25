"""Differentiable calibration: fit SFM parameters to observed trajectories.

A capability the reference architecture cannot offer: its engine is numpy
driven by a CARLA server across an RPC boundary, so the map from model
parameters to trajectories is not differentiable.  Here the whole rollout is
one pure jittable function of the parameters (models/stepper.py), so any
force parameter of the reference's ``sfm_config.toml`` surface
(/root/reference/config/sfm_config.toml:1-56, read by
/root/reference/forces.py:44,60-73,141-143,196-199) can be fitted to
observed pedestrian trajectories by gradient descent THROUGH the simulation:
``jax.grad`` backpropagates through the ``lax.scan`` rollout, with
:func:`jax.checkpoint` rematerialization keeping activation memory at
O(steps x carry) instead of O(steps x pairwise intermediates).

Typical uses:

* recover force parameters from recorded crowd data (the reference's
  ``pedestrian.csv`` schema, utils/csvout.py, is a natural source);
* sensitivity analysis: ``jax.grad`` of any trajectory statistic with
  respect to any parameter;
* scenario tuning: pick parameters that reproduce a target flow rate or
  evacuation time;
* PER-AGENT heterogeneity fitting (round 4): ``fit`` names prefixed
  ``"scene."`` select Scene leaves instead of SfmParams leaves --
  ``"scene.spawn.pair_scale"`` fits each pedestrian's individual
  interaction sensitivity (a (capacity,) vector theta; optax updates
  pytrees, so the machinery is unchanged), recovering who in an observed
  crowd was distracted/oblivious vs hypersensitive.  Group betas
  (``"group.beta_vis"`` etc.) are ordinary SfmParams leaves and fit the
  same way.

The observation format is :class:`~..models.stepper.StepRecord` -- exactly
what a recorded rollout returns, so "simulate with true params, perturb,
re-fit" round-trips are one-liners (see tests/test_calibrate.py and
examples/calibrate_params.py).  Recorded runs and real CARLA captures load
via ``utils.csvout.read_pedestrian_csv`` (accepts both this framework's and
the reference's pedestrian.csv, including ``PedMode.<NAME>`` mode text).

Calibration runs the differentiable jnp force path (``use_pallas=False``);
the fused Pallas kernels define no VJP.  For the small-to-medium N where
calibration data exists this is not a constraint (the jnp path is the same
physics, oracle-tested), and a fitted parameter set drops straight into the
Pallas production config.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Mapping, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..models.params import SfmParams
from ..models.state import PedState
from ..models.stepper import (Scene, StepConfig, StepRecord, prepare_scene,
                              rollout, simulation_step)

#: default fit set: the Moussaid interaction parameters (the ones with the
#: most trajectory leverage; reference forces.py:60-73)
DEFAULT_FIT = ("pedestrian.A", "pedestrian.gamma", "pedestrian.lambda_")

#: prefix selecting SCENE leaves instead of SfmParams leaves in a ``fit``
#: name -- e.g. ``"scene.spawn.pair_scale"`` fits the per-agent
#: interaction-sensitivity VECTOR (crowd heterogeneity, SpawnSchedule.
#: pair_scale): theta entries may be arrays, the gradient machinery is
#: identical (optax updates pytrees), and the per-agent scale is the
#: cheap-gradient case -- it post-multiplies the summed pair force row-wise
#: (models/stepper.py force_terms), so d loss / d s_i needs no extra
#: pairwise work.
SCENE_PREFIX = "scene."


def get_param(params: SfmParams, name: str):
    """Fetch a parameter by dotted path, e.g. ``"pedestrian.A"`` or
    ``"acceleration.tau"``."""
    obj = params
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def _apply_theta(params: SfmParams, scene: Scene, theta: Mapping[str, object],
                 log_space: bool):
    """Substitute theta (possibly log-space, possibly vector-valued) into
    the params / scene pair."""
    pvals, svals = {}, {}
    for name, v in theta.items():
        v = jnp.exp(v) if log_space else v
        if name.startswith(SCENE_PREFIX):
            svals[name[len(SCENE_PREFIX):]] = v
        else:
            pvals[name] = v
    if pvals:
        params = replace_params(params, pvals)
    for name, v in svals.items():
        scene = replace_param(scene, name, v)
    return params, scene


def replace_param(params, name: str, value):
    """Functional update of a (possibly nested) parameter by dotted path."""
    head, _, rest = name.partition(".")
    if rest:
        value = replace_param(getattr(params, head), rest, value)
    return dataclasses.replace(params, **{head: value})


def replace_params(params: SfmParams, values: Mapping[str, object]) -> SfmParams:
    """Apply a ``{dotted-name: value}`` mapping to ``params``."""
    for name, value in values.items():
        params = replace_param(params, name, value)
    return params


def _check_theta(theta: Mapping[str, object], fit: Sequence[str]) -> None:
    """Guard: a theta dict whose keys don't match ``fit`` means a typo'd
    dotted name -- without this, the stray entry would silently fit the
    wrong parameter set (replace_params would raise only on names that
    don't exist at all)."""
    if set(theta) != set(fit):
        raise ValueError(
            f"theta keys {sorted(theta)} do not match fit={sorted(fit)}")


def trajectory_mse(rec: StepRecord, observed: StepRecord,
                   vel_weight: float = 0.0) -> jnp.ndarray:
    """Masked mean squared error between two recorded rollouts.

    Positions are compared only where BOTH records mark the slot alive (so a
    parameter change that shifts an arrival/despawn tick by a step does not
    inject a discontinuous penalty; spawn schedules are parameter-independent,
    so co-alive masks cover all commonly observed steps).  ``vel_weight``
    adds a weighted velocity-error term.
    """
    m = (rec.alive & observed.alive)
    w = m.astype(rec.pos.dtype)
    denom = jnp.maximum(jnp.sum(w), 1.0)
    se = jnp.sum(jnp.square(rec.pos - observed.pos), axis=-1)
    loss = jnp.sum(se * w) / denom
    if vel_weight:
        sev = jnp.sum(jnp.square(rec.vel - observed.vel), axis=-1)
        loss = loss + vel_weight * (jnp.sum(sev * w) / denom)
    return loss


def make_loss_fn(state0: PedState, scene: Scene, params: SfmParams,
                 cfg: StepConfig, observed: StepRecord, num_steps: int,
                 fit: Sequence[str] = DEFAULT_FIT, log_space: bool = True,
                 record_stride: int = 1, vel_weight: float = 0.0,
                 remat: bool = True,
                 grad_horizon: int | None = None) -> Callable[[dict], jnp.ndarray]:
    """Scalar loss over the fitted parameters.

    Returns ``loss_fn(theta)`` where ``theta`` maps each dotted name in
    ``fit`` to a scalar; with ``log_space=True`` (default) the scalars are
    log-parameters (``param = exp(theta)``), which keeps strictly-positive
    physics parameters positive under unconstrained gradient steps.

    ``observed`` must have leading dimension ``num_steps // record_stride``
    (a rollout recorded with the same stride).

    ``grad_horizon=K`` truncates backpropagation to K-tick windows
    (truncated BPTT; see :func:`~..models.stepper.rollout`).  Required in
    practice for the Karamouzas power-law family, whose hard
    collision-course gates make full-rollout reverse-mode gradients
    overflow beyond ~40 ticks; K of 10-20 keeps them O(1) while the loss
    landscape (which is well-behaved either way) still identifies the
    parameters.  The Moussaid family's smooth exponentials tolerate full
    BPTT at the horizons tested (~100+ ticks), so the default is off.
    """
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca)
    if cfg.use_pallas:
        # the fused kernels define no VJP; the jnp path is the same physics
        cfg = dataclasses.replace(cfg, use_pallas=False)
    t_obs = observed.pos.shape[0]
    if t_obs != num_steps // record_stride:
        raise ValueError(
            f"observed record has {t_obs} frames; expected "
            f"{num_steps // record_stride} (= num_steps/record_stride)")

    def loss_fn(theta: dict) -> jnp.ndarray:
        _check_theta(theta, fit)
        p, sc = _apply_theta(params, scene, theta, log_space)
        _, rec = rollout(state0, sc, p, cfg, num_steps, record=True,
                         record_stride=record_stride, remat=remat,
                         grad_horizon=grad_horizon)
        return trajectory_mse(rec, observed, vel_weight=vel_weight)

    return loss_fn


def make_teacher_forced_loss_fn(state0: PedState, scene: Scene,
                                params: SfmParams, cfg: StepConfig,
                                observed: StepRecord, num_steps: int,
                                fit: Sequence[str] = DEFAULT_FIT,
                                window: int = 8, log_space: bool = True,
                                vel_weight: float = 0.0,
                                ) -> Callable[[dict], jnp.ndarray]:
    """Windowed teacher-forced loss: short-horizon prediction error.

    The full-trajectory MSE of :func:`make_loss_fn` is the right objective
    for smooth families (Moussaid), but for stiff, hard-gated dynamics
    (the Karamouzas power law's collision-course gates) it is chaotic in
    the parameters: a 1-ulp force change flips a gate, trajectories
    diverge, and the landscape turns rugged while reverse-mode gradients
    overflow (measured ~1e7 amplification per 10 ticks).  The standard
    system-identification fix is teacher forcing / multiple shooting:
    every ``window`` ticks the simulated state's positions/velocities are
    RESET from the observed record (where both mark the slot alive), so
    the loss is the mean squared ``<= window``-step prediction error --
    no chaos amplification, smooth landscape, bounded gradients.

    The reset passes the carry through ``stop_gradient``, so each window's
    gradient is exact (not truncated -- the window simply *starts* from
    data).  Non-observed state components (modes, waypoint progress,
    timers) carry over from the simulation, which is also what
    calibration against real data (where only positions are observed)
    requires.  Requires a stride-1 ``observed`` record and a scene without
    a reactive autopilot fleet.
    """
    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca)
    if cfg.use_pallas:
        cfg = dataclasses.replace(cfg, use_pallas=False)
    if scene.autopilot is not None:
        raise NotImplementedError(
            "teacher-forced calibration does not support reactive "
            "autopilot scenes (the fleet state is not observable)")
    if observed.pos.shape[0] != num_steps:
        raise ValueError(
            f"teacher forcing requires a stride-1 record: observed has "
            f"{observed.pos.shape[0]} frames, num_steps={num_steps}")
    if window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    # planar observation streams for the scan (x/y planes, no (N, 2))
    obs = dict(
        px=observed.pos[..., 0], py=observed.pos[..., 1],
        vx=observed.vel[..., 0], vy=observed.vel[..., 1],
        alive=observed.alive)

    def loss_fn(theta: dict) -> jnp.ndarray:
        _check_theta(theta, fit)
        p, sc = _apply_theta(params, scene, theta, log_space)

        def body(carry, inp):
            st, acc_se, acc_w = carry
            t, opx, opy, ovx, ovy, oal = inp

            def reset(s):
                s = jax.tree_util.tree_map(jax.lax.stop_gradient, s)
                take = oal & s.alive
                return dataclasses.replace(
                    s,
                    pos_x=jnp.where(take, opx, s.pos_x),
                    pos_y=jnp.where(take, opy, s.pos_y),
                    vel_x=jnp.where(take, ovx, s.vel_x),
                    vel_y=jnp.where(take, ovy, s.vel_y))

            is_reset = (t % window) == 0
            st = jax.lax.cond(is_reset, reset, lambda s: s, st)
            new_st, rec = simulation_step(st, sc, p, cfg, t)
            # the record snapshots the pre-integration state, so a reset
            # tick's "error" is identically zero by construction -- counting
            # it would deflate the reported loss by ~(W-1)/W
            w = ((rec.alive & oal & ~is_reset)
                 .astype(rec.pos_x.dtype))
            se = jnp.square(rec.pos_x - opx) + jnp.square(rec.pos_y - opy)
            if vel_weight:
                se = se + vel_weight * (jnp.square(rec.vel_x - ovx)
                                        + jnp.square(rec.vel_y - ovy))
            return (new_st, acc_se + jnp.sum(se * w), acc_w + jnp.sum(w)), None

        steps = jnp.arange(num_steps)
        zero = jnp.zeros((), jnp.float32)
        (_, se, wsum), _ = jax.lax.scan(
            body, (state0, zero, zero),
            (steps, obs["px"], obs["py"], obs["vx"], obs["vy"], obs["alive"]))
        return se / jnp.maximum(wsum, 1.0)

    return loss_fn


@dataclasses.dataclass
class CalibrationResult:
    """Outcome of :func:`fit_params`."""

    params: SfmParams           #: params with the fitted values substituted
    fitted: dict                 #: {dotted-name: float, or np.ndarray for
                                 #: vector-valued (per-agent) parameters}
    losses: np.ndarray           #: per-iteration loss curve
    initial_loss: float
    final_loss: float
    #: scene with fitted ``scene.``-prefixed leaves substituted (None when
    #: no scene leaves were fit)
    scene: Scene | None = None


def fit_params(state0: PedState, scene: Scene, params: SfmParams,
               cfg: StepConfig, observed: StepRecord, num_steps: int,
               fit: Sequence[str] = DEFAULT_FIT, iters: int = 150,
               learning_rate: float = 0.05, optimizer=None,
               log_space: bool = True, record_stride: int = 1,
               vel_weight: float = 0.0, remat: bool = True,
               grad_horizon: int | None = None,
               teacher_window: int | None = None,
               callback: Callable[[int, float, dict], None] | None = None,
               ) -> CalibrationResult:
    """Fit the named parameters to ``observed`` by Adam over the rollout loss.

    ``params`` provides both the initial guesses for the fitted names and
    the fixed values of everything else.  ``optimizer`` overrides the
    default ``optax.adam(learning_rate)``.  ``callback(i, loss, values)``
    is invoked per iteration with the current *parameter-space* values.

    ``teacher_window=W`` switches the objective to the windowed
    teacher-forced prediction error (:func:`make_teacher_forced_loss_fn`)
    -- use it for stiff families (the power law); ``grad_horizon`` then
    has no effect (windows already bound the backprop depth).
    """
    import optax

    if teacher_window is not None:
        loss_fn = make_teacher_forced_loss_fn(
            state0, scene, params, cfg, observed, num_steps, fit=fit,
            window=teacher_window, log_space=log_space,
            vel_weight=vel_weight)
    else:
        loss_fn = make_loss_fn(state0, scene, params, cfg, observed,
                               num_steps, fit=fit, log_space=log_space,
                               record_stride=record_stride,
                               vel_weight=vel_weight, remat=remat,
                               grad_horizon=grad_horizon)
    init = {}
    for name in fit:
        if name.startswith(SCENE_PREFIX):
            v = get_param(scene, name[len(SCENE_PREFIX):])
            if v is None and name == "scene.spawn.pair_scale":
                # homogeneous crowds store None; start the per-agent fit
                # at the reference behavior (all ones)
                v = jnp.ones((scene.spawn.capacity,), jnp.float32)
            elif v is None:
                raise ValueError(
                    f"{name!r} is None on this scene; set an initial "
                    f"array before fitting it")
        else:
            v = get_param(params, name)
        v = jnp.asarray(v, jnp.float32)
        if log_space and bool((v <= 0.0).any()):
            raise ValueError(
                f"log_space fit requires positive initial value(s) for "
                f"{name!r}; pass log_space=False")
        init[name] = jnp.log(v) if log_space else v

    opt = optimizer if optimizer is not None else optax.adam(learning_rate)
    opt_state = opt.init(init)

    @jax.jit
    def update(theta, opt_state):
        loss, grads = jax.value_and_grad(loss_fn)(theta)
        updates, opt_state = opt.update(grads, opt_state, theta)
        return optax.apply_updates(theta, updates), opt_state, loss

    theta = init
    losses = []
    best_theta, best_loss = theta, np.inf
    for i in range(iters):
        new_theta, opt_state, loss = update(theta, opt_state)
        loss = float(loss)
        losses.append(loss)
        if loss < best_loss:
            best_theta, best_loss = theta, loss
        if callback is not None:
            callback(i, loss, _theta_values(theta, log_space))
        theta = new_theta
    # the loss at theta_i is reported before the i-th update, so evaluate
    # the final iterate too and keep the best seen
    final_loss = float(loss_fn(theta))
    if final_loss < best_loss:
        best_theta, best_loss = theta, final_loss

    fitted = _theta_values(best_theta, log_space)
    pfit = {k: v for k, v in fitted.items()
            if not k.startswith(SCENE_PREFIX)}
    sfit = {k[len(SCENE_PREFIX):]: v for k, v in fitted.items()
            if k.startswith(SCENE_PREFIX)}
    out_scene = None
    if sfit:
        out_scene = scene
        for name, v in sfit.items():
            out_scene = replace_param(out_scene, name,
                                      jnp.asarray(v, jnp.float32))
    return CalibrationResult(
        params=replace_params(params, pfit), fitted=fitted,
        losses=np.asarray(losses, np.float64),
        initial_loss=float(losses[0]) if losses else float("nan"),
        final_loss=best_loss, scene=out_scene)


def _theta_values(theta: Mapping[str, object], log_space: bool) -> dict:
    """Parameter-space values: floats for scalars, np arrays for vectors."""
    out = {}
    for k, v in theta.items():
        v = jnp.exp(v) if log_space else v
        out[k] = float(v) if jnp.ndim(v) == 0 else np.asarray(v)
    return out
