"""Framework-wide settings of the port (the port of paddle_tpu/core's flag
registry)."""
from .flags import get_flags, set_flags

__all__ = ["get_flags", "set_flags"]
