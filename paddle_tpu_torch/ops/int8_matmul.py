"""Weight-only int8 matmul (the port of paddle_tpu/ops/pallas/int8_matmul.py).

y = (x @ widen(q)) * s with an f32 accumulator, cast to x's dtype. The
scale is per output channel, so scaling the accumulator equals multiplying
by the dequantized weight. Layouts: "kn" - q [K, N]; "nk" - q [N, K] (the
port's nn.Linear weights and the tied embedding / LM-head table, both
stored [out, in]).

`int8_matmul` routes by device and by nothing else: a CUDA tensor goes to
the hand-written kernel (ops/cuda/int8_matmul.py), which launches or
raises; a CPU tensor goes to the plain PyTorch version here. The JAX
package's shape gate (`use_int8_matmul`) is a TPU tiling rule and has no
counterpart: on CUDA a shape the kernel cannot take raises ValueError.
"""
from __future__ import annotations

from .attention import _on_cuda
from .cuda.int8_matmul import int8_matmul_cuda


def int8_matmul_reference(x, q, s, w_layout="kn"):
    """Plain version: the codes widened to f32 (exact), one f32 matmul,
    the per-channel scale on the accumulator, then the cast to x's dtype.
    Computes what the JAX fallback computes."""
    w = q.float() if w_layout == "kn" else q.float().t()
    acc = x.float() @ w
    return (acc * s).to(x.dtype)


def int8_matmul(x, q, s, *, w_layout="kn"):
    """y = (x @ widen(q)) * s for x [M, K]: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if w_layout not in ("kn", "nk"):
        raise ValueError(f"w_layout must be 'kn' or 'nk'; got {w_layout!r}")
    if _on_cuda(x):
        return int8_matmul_cuda(x, q, s, w_layout=w_layout)
    return int8_matmul_reference(x, q, s, w_layout)


def int8_linear_nd(x, q, s, bias=None, *, w_layout="kn"):
    """N-d wrapper: flattens the leading dims of x [..., K] into one matmul
    M; the bias is added after the cast, as in the JAX package."""
    lead = x.shape[:-1]
    y = int8_matmul(x.reshape(-1, x.shape[-1]).contiguous(), q, s,
                    w_layout=w_layout)
    y = y.reshape(*lead, y.shape[-1])
    if bias is not None:
        y = y + bias
    return y
