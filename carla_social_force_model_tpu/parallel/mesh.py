"""Device-mesh helpers.

Two mesh axes cover the framework's parallelism (SURVEY.md section 2,
"Parallelism & distributed-communication inventory"):

* ``agents`` -- shard pedestrian slots across devices; the N x N force
  all-gathers column state over the interconnect (the analogue of tensor/sequence
  parallelism for an n-body kernel).
* ``batch``  -- data parallelism over independent scenario rollouts
  (parameter sweeps), mapped with vmap + sharding annotations.
"""
from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh

AGENT_AXIS = "agents"
BATCH_AXIS = "batch"


def make_mesh(n_agent_shards: int | None = None, n_batch_shards: int = 1,
              devices=None) -> Mesh:
    """Build a (batch, agents) mesh over the available devices."""
    devices = list(devices if devices is not None else jax.devices())
    if n_agent_shards is None:
        n_agent_shards = len(devices) // n_batch_shards
    n = n_agent_shards * n_batch_shards
    if n > len(devices):
        raise ValueError(f"mesh {n_batch_shards}x{n_agent_shards} needs {n} "
                         f"devices, have {len(devices)}")
    grid = np.asarray(devices[:n]).reshape(n_batch_shards, n_agent_shards)
    return Mesh(grid, (BATCH_AXIS, AGENT_AXIS))


def round_up(x: int, multiple: int) -> int:
    return -(-x // multiple) * multiple
