"""Host utilities: device handling, profiling, the progress display."""

from .profile import Profiler, profiled, scope, active_profiler
from .progress import enable_progress, disable_progress

__all__ = ["Profiler", "profiled", "scope", "active_profiler",
           "enable_progress", "disable_progress"]
