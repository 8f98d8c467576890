"""Structured findings (the port's copy of the schema of
paddle_tpu/analysis/findings.py that the serving preflight speaks)."""
from .findings import ConfigValidationError, Finding, Findings

__all__ = ["ConfigValidationError", "Finding", "Findings"]
