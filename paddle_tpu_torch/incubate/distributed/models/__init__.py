"""Incubate models (the port of paddle_tpu/incubate/distributed/models)."""
