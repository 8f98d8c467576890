"""Distributed incubate models of the port (the port of
paddle_tpu/incubate/distributed)."""
