"""The JAX package's Xavier initialisers (paddle_tpu/nn/initializer.py),
drawn in place from an explicit ``torch.Generator``. Fans follow the JAX
package's rule: a 1-D shape is its own fan both ways, a 2-D ``[in, out]``
shape gives (in, out), and a higher rank gives ``(shape[1] * r, shape[0]
* r)`` with r the product of the dims after the second."""
from __future__ import annotations

import math

import torch


def fans(shape):
    shape = tuple(shape)
    if not shape:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    r = math.prod(shape[2:])
    return shape[1] * r, shape[0] * r


@torch.no_grad()
def xavier_uniform_(p, generator):
    fan_in, fan_out = fans(p.shape)
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return p.uniform_(-bound, bound, generator=generator)


@torch.no_grad()
def xavier_normal_(p, generator):
    fan_in, fan_out = fans(p.shape)
    return p.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)),
                     generator=generator)
