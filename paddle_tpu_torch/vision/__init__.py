"""Vision models of the port (the port of paddle_tpu/vision/)."""
from . import models

__all__ = ["models"]
