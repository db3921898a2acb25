"""Simulation checkpoint / resume.

The reference has no simulation-state persistence (SURVEY.md section 5);
here the whole rollout carry is a pytree of arrays, so a snapshot is one
npz (content-addressed by step) and resume is exact: a segmented rollout
that checkpoints every K steps produces bit-identical trajectories to an
uninterrupted one (covered by tests).

Two interchangeable backends:

* ``"npz"`` (default) -- one compressed npz file per snapshot; zero extra
  dependencies, loads anywhere.
* ``"orbax"`` -- an orbax-checkpoint directory per snapshot (the standard
  JAX ecosystem format: async-friendly, sharding-aware on restore).  Same
  ``ckpt_<step>`` naming with an ``.orbax`` suffix; ``latest_checkpoint``
  and ``load_state`` dispatch on the suffix, so the two formats can be
  mixed in one directory and a run can resume from either.

Snapshot keys mirror PedState's fields verbatim (``state__pos_x`` etc.);
``load_state`` transparently migrates snapshots written before the
planar-state layout (``state__pos`` (N, 2) -> x/y planes).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import jax

from ..models.state import PedState


def _orbax_checkpointer():
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise ImportError(
            "the orbax checkpoint backend needs the 'orbax-checkpoint' "
            "package, which is not installed; use the npz backend "
            "(--checkpoint-backend npz)") from e
    try:
        return ocp.PyTreeCheckpointer()
    except AttributeError:  # newer orbax dropped the alias
        return ocp.Checkpointer(ocp.PyTreeCheckpointHandler())


def save_state(path: str, state: PedState, step: int,
               autopilot=None) -> str:
    """Snapshot the rollout carry at ``step`` to ``path``.

    ``path`` ending in ``.orbax`` selects the orbax directory format,
    anything else writes a compressed npz file.

    ``autopilot``: the AutopilotState of a reactive-fleet rollout, saved
    alongside so a resumed rollout restores vehicles mid-route.
    """
    payload = {f"state__{f.name}": np.asarray(getattr(state, f.name))
               for f in dataclasses.fields(PedState)}
    if autopilot is not None:
        for f in dataclasses.fields(type(autopilot)):
            payload[f"ap__{f.name}"] = np.asarray(getattr(autopilot, f.name))
    payload["step"] = np.asarray(step, np.int64)
    if path.endswith(".orbax"):
        path = os.path.abspath(path)
        if os.path.isdir(path):    # orbax refuses to overwrite in place
            import shutil
            shutil.rmtree(path)
        _orbax_checkpointer().save(path, payload)
        return path
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(path, **payload)
    return path


def load_state(path: str, with_autopilot: bool = False):
    """Returns ``(state, step)``, or ``(state, step, autopilot_or_None)``
    when ``with_autopilot`` (None for checkpoints without a fleet).
    Dispatches on the path suffix (``.orbax`` directory vs npz file)."""
    if path.rstrip("/").endswith(".orbax"):
        data = _orbax_checkpointer().restore(os.path.abspath(path))
        files = list(data.keys())
    else:
        data = np.load(path)
        files = data.files
    try:
        if "state__pos" in files:
            # pre-planar snapshot (state__pos (N, 2) etc.): migrate the
            # coordinate arrays into the planar fields on load
            def field_arr(name):
                for c in ("pos", "vel"):
                    if name in (f"{c}_x", f"{c}_y"):
                        return data[f"state__{c}"][:, 0 if name.endswith("x")
                                                   else 1]
                if name in ("wp_x", "wp_y"):
                    return data["state__waypoint"][:, 0 if name == "wp_x"
                                                   else 1]
                return data[f"state__{name}"]
            kwargs = {f.name: jax.numpy.asarray(field_arr(f.name))
                      for f in dataclasses.fields(PedState)}
        else:
            kwargs = {f.name: jax.numpy.asarray(data[f"state__{f.name}"])
                      for f in dataclasses.fields(PedState)}
        step = int(data["step"])
        ap = None
        if with_autopilot and any(k.startswith("ap__") for k in files):
            from ..models.autopilot import AutopilotState

            def ap_arr(name):
                # fields added after a snapshot was written restore to
                # their rest value (pre-overtaking checkpoints carry no
                # lane_off/overtaking planes: both are zero at rest)
                if f"ap__{name}" in files:
                    return jax.numpy.asarray(data[f"ap__{name}"])
                base = np.asarray(data["ap__speed"])
                fill = (np.zeros(base.shape, bool)
                        if name == "overtaking"
                        else np.zeros(base.shape, base.dtype))
                return jax.numpy.asarray(fill)
            ap = AutopilotState(**{
                f.name: ap_arr(f.name)
                for f in dataclasses.fields(AutopilotState)})
    finally:
        if hasattr(data, "close"):
            data.close()
    if with_autopilot:
        return PedState(**kwargs), step, ap
    return PedState(**kwargs), step


def run_segmented(state: PedState, scene, params, cfg, num_steps: int,
                  segment_steps: int, checkpoint_dir: str | None = None,
                  start_step: int = 0, record: bool = True,
                  autopilot_state=None, backend: str = "npz"):
    """Rollout in jitted segments with host-side checkpoints in between.

    Returns ``(final_state, stacked_records_or_None)``.  Resume by loading
    the newest checkpoint and passing its step as ``start_step``; with a
    reactive autopilot fleet, also pass its saved ``autopilot_state``
    (``load_state(..., with_autopilot=True)``) -- the record output is then
    a ``(StepRecord, AutopilotRecord)`` pair like :func:`rollout`'s.
    """
    from ..models.stepper import StepRecord, prepare_scene, rollout
    import jax.numpy as jnp
    import functools

    scene = prepare_scene(scene, analytic=cfg.env_analytic,
                          orca=params.enable_orca)
    fleet = getattr(scene, "autopilot", None)
    ap = autopilot_state
    if fleet is not None and ap is None:
        if start_step != 0:
            raise ValueError(
                "resuming a reactive-fleet rollout needs the checkpointed "
                "autopilot_state (load_state(..., with_autopilot=True))")
        ap = fleet.initial_state()

    @functools.partial(jax.jit, static_argnames=("n",))
    def seg(s, ap, start, n):
        return rollout(s, scene, params, cfg, n, record=record,
                       start_step=start, autopilot_state=ap,
                       return_autopilot_state=fleet is not None)

    records = []
    step = start_step
    end = start_step + num_steps
    while step < end:
        n = min(segment_steps, end - step)
        out, rec = seg(state, ap, jnp.asarray(step), n)
        # NOTE: start_step is traced; rollout uses jnp.arange(start, start+n)
        state, ap = out if fleet is not None else (out, None)
        if record:
            records.append(jax.tree_util.tree_map(np.asarray, rec))
        step += n
        if checkpoint_dir is not None:
            ext = "orbax" if backend == "orbax" else "npz"
            save_state(os.path.join(checkpoint_dir, f"ckpt_{step:08d}.{ext}"),
                       state, step, autopilot=ap)
    if record and records:
        def stack(tuples, cls):
            return cls(*[np.concatenate([getattr(r, f) for r in tuples])
                         for f in cls._fields])
        if fleet is not None:
            from ..models.autopilot import AutopilotRecord
            stacked = (stack([r[0] for r in records], StepRecord),
                       stack([r[1] for r in records], AutopilotRecord))
        else:
            stacked = stack(records, StepRecord)
        return state, stacked
    return state, None


def latest_checkpoint(checkpoint_dir: str):
    """Newest ``ckpt_*`` snapshot (npz file or .orbax directory) or None."""
    if not os.path.isdir(checkpoint_dir):
        return None
    files = sorted((f for f in os.listdir(checkpoint_dir)
                    if f.startswith("ckpt_")
                    and (f.endswith(".npz") or f.endswith(".orbax"))),
                   key=lambda f: f.split(".")[0])
    return os.path.join(checkpoint_dir, files[-1]) if files else None
