"""sphfluidsimulation_tpu — SPH fluid simulation framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of the Unity
compute-shader simulator ``leandro-barcelos/SPHFluidSimulation`` (see
SURVEY.md for the structural map of the reference). Public API:

    from sphfluidsimulation_tpu import SimConfig, Scene
    scene = Scene(SimConfig(particle_number=65536))
    scene.step(100)
"""

from .config import GOLDEN_CONFIG, TINY_CONFIG, SimConfig  # noqa: F401
from .params import PhysParams, stack_params  # noqa: F401
from .state import FrameAux, ParticleState, StepMetrics, make_state  # noqa: F401
from .models.scene import Scene  # noqa: F401
from .sim.stepper import (  # noqa: F401
    initial_state,
    integrate_substep,
    make_dt_rollout,
    make_frame_step,
    make_param_step,
    make_rollout,
)
from . import parallel, render, utils  # noqa: F401

__version__ = "0.1.0"
