"""Runtime utilities: checkpoint/resume, metrics logging, profiling.

All of these are absent in the reference (SURVEY.md §5: no checkpointing —
state never leaves the GPU, SphFluidSimulation.cs:110-120 just releases
buffers; no metrics beyond the NaN alpha marker; no tracing beyond debug
symbols). They are framework requirements here.
"""

from .checkpoint import load_checkpoint, save_checkpoint  # noqa: F401
from .diagnostics import StateError, checkify_step, validate_state  # noqa: F401
from .metrics import MetricsLogger  # noqa: F401
from .profiling import phase_breakdown, trace  # noqa: F401
