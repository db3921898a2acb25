"""Which force path runs: the compiled GPU kernels or plain jnp.

The package has two implementations of its hot operations: fused Pallas
kernels compiled for the GPU through Triton (ops/pallas_forces.py,
ops/pallas_env.py) and plain jnp that XLA compiles for any backend
(ops/forces.py, ops/geometry.py).  This module is the one place that
decides between them:

* on ``gpu`` the compiled kernels run by default;
* on ``cpu`` plain jnp runs by default;
* the Pallas interpreter runs only when a caller asks for it explicitly
  (``StepConfig.pallas_interpret``, the CPU tests);
* asking for the kernels on a backend that has no compiled kernel raises
  (:func:`check_kernels`) instead of interpreting or falling back.
"""
from __future__ import annotations

#: JAX platforms the fused kernels are compiled for
KERNEL_PLATFORMS = ("gpu",)


def platform() -> str:
    import jax
    return jax.default_backend()


def kernels_available() -> bool:
    """True when the default backend has compiled fused kernels, i.e. the
    default for ``StepConfig.use_pallas`` where a builder leaves it unset."""
    return platform() in KERNEL_PLATFORMS


def check_kernels(use_pallas: bool, interpret: bool) -> None:
    """Raise when the fused kernels are requested where none is compiled.

    ``interpret=True`` is the explicit opt-in to the Pallas interpreter and
    is allowed on every backend."""
    if use_pallas and not interpret and not kernels_available():
        raise ValueError(
            f"use_pallas=True needs a backend with compiled kernels "
            f"({', '.join(KERNEL_PLATFORMS)}); the default backend is "
            f"{platform()!r}.  Use use_pallas=False for the jnp path, or "
            f"pallas_interpret=True to run the kernels in the Pallas "
            f"interpreter (tests only)")
