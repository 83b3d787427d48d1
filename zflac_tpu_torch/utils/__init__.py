"""Host utilities of the port (scoped debug logging, stage timers)."""

from .log import get_logger, scoped_loggers  # noqa: F401
from .timer import StageTimers  # noqa: F401
