"""paddle.amp.debugging — numeric debugging helpers (the port of
paddle_tpu/amp/debugging.py, a facade over paddle_tpu_torch.debugging).

Reference: python/paddle/amp/debugging.py (check_numerics,
check_layer_numerics, enable_operator_stats_collection, TensorCheckerConfig)
over the C++ check_numerics kernels / FLAGS_check_nan_inf machinery.

The reference semantics are kept (check_numerics raises FloatingPointError
with NaN/Inf counts; the enable/disable toggles flip FLAGS_check_nan_inf
and FLAGS_benchmark), but the counting is one device reduction
(debugging.sentinel.array_stats) and one host read, check_layer_numerics
installs the per-module sentinels, and TensorCheckerConfig translates into
a debugging.NumericsConfig for jit.TrainStep(numerics=...). As in the JAX
package, the flags are recorded and read by nothing else: the per-op scan
they name is what TrainStep's numerics mode does per module.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import flags as _flags
from .. import debugging as _dbg


class DebugMode:
    """reference: paddle.amp.debugging.DebugMode values."""
    CHECK_NAN_INF_AND_ABORT = 0
    CHECK_NAN_INF = 1
    CHECK_ALL = 4


def check_numerics(tensor, op_type: str = "", var_name: str = "",
                   debug_mode=None):
    """Raise on NaN/Inf in `tensor` (reference: amp/debugging.py
    check_numerics). One device reduction + one host read. Non-floating
    tensors pass unchecked."""
    arr = tensor if torch.is_tensor(tensor) else \
        torch.from_numpy(np.asarray(tensor))
    if not arr.is_floating_point():
        return tensor
    row = _dbg.array_stats(arr.detach()).cpu().numpy()
    n_nan, n_inf = int(row[1]), int(row[2])
    if n_nan or n_inf:
        raise FloatingPointError(
            f"check_numerics: {op_type or 'tensor'} {var_name} contains "
            f"{n_nan} NaN and {n_inf} Inf values")
    return tensor


def check_layer_numerics(model, root: Optional[str] = None):
    """Instrument `model`'s submodules with the numerics sentinels
    (reference: paddle.amp.debugging.check_layer_numerics decorator).
    Rows are recorded inside debugging.collect_stats() scopes, which
    TrainStep's numerics mode opens. Returns the handle (`.paths`,
    `.remove()`)."""
    return _dbg.check_layer_numerics(model, root=root)


class TensorCheckerConfig:
    """reference: paddle.amp.debugging.TensorCheckerConfig — kept as the
    legacy configuration bag; `to_numerics_config()` maps it onto the new
    subsystem for use with jit.TrainStep(numerics=...)."""

    def __init__(self, enable=True, debug_mode=None, output_dir=None,
                 checked_op_list=None, skipped_op_list=None, **kw):
        self.enable = enable
        self.debug_mode = debug_mode
        self.output_dir = output_dir
        self.checked_op_list = checked_op_list
        self.skipped_op_list = skipped_op_list

    def to_numerics_config(self) -> Optional[_dbg.NumericsConfig]:
        if not self.enable:
            return None
        abort = self.debug_mode in (None, DebugMode.CHECK_NAN_INF_AND_ABORT)
        return _dbg.NumericsConfig(
            every_n_steps=1, dump_dir=self.output_dir,
            raise_on_nonfinite=abort)


_checker_config: Optional[TensorCheckerConfig] = None


def enable_tensor_checker(config: Optional[TensorCheckerConfig] = None):
    """reference semantics: turn the per-op NaN/Inf scan on. Also stashes
    `config` so a caller can hand TrainStep its abort/dump policy via
    get_tensor_checker_config()."""
    global _checker_config
    _checker_config = config
    _flags.set_flags({"FLAGS_check_nan_inf": True})


def disable_tensor_checker():
    global _checker_config
    _checker_config = None
    _flags.set_flags({"FLAGS_check_nan_inf": False})


def get_tensor_checker_config() -> Optional[TensorCheckerConfig]:
    return _checker_config


def enable_operator_stats_collection():
    _flags.set_flags({"FLAGS_benchmark": True})


def disable_operator_stats_collection():
    _flags.set_flags({"FLAGS_benchmark": False})
