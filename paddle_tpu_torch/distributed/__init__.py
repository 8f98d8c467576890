"""Distributed helpers of the port (one device so far: `recompute`)."""
