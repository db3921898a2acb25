"""JAX Social Force Model crowd-simulation framework.

A brand-new JAX/XLA/Pallas pedestrian crowd-simulation framework with the
capabilities of felixlutz/carla-social-force-model (see SURVEY.md for the
reference analysis and the build plan).  Headless scenarios run entirely on
device as a jitted ``lax.scan``; CARLA is an optional host-side frontend.
"""

from .models.params import SfmParams
from .models.state import PedState
from .models import modes

__version__ = "0.1.0"

__all__ = ["SfmParams", "PedState", "modes", "__version__"]
