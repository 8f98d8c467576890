"""Fused ops beyond the plain layers (the port of paddle_tpu/incubate)."""
