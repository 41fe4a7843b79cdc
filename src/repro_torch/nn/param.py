"""Parameters with initialisers, drawn from explicit ``torch.Generator``s.

A :class:`ParamModule` declares each parameter with its shape, dtype and
initialiser, on the ``meta`` device: nothing is allocated until
:func:`materialize` draws every parameter on the target device from a
generator seeded by ``(seed, parameter name)`` (``repro_torch.generator``).
The bridge (``repro_torch.bridge``) fills the same declared parameters from a
reference checkpoint instead.

The initialisers match the reference's (``repro/nn/param.py``) in
distribution, drawing in fp32 and casting to the parameter dtype; they cannot
match its bits, since JAX's PRNG is not torch's.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence

import torch
from torch import nn

from repro_torch import generator

Initializer = Callable[[torch.Generator, Sequence[int], torch.dtype], torch.Tensor]


def _f32(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32, device=gen.device)


def normal(stddev: float = 0.02) -> Initializer:
    def init(gen, shape, dtype):
        return _f32(gen, shape).normal_(0.0, stddev, generator=gen).to(dtype)
    return init


def fan_in(scale: float = 1.0) -> Initializer:
    """LeCun-style: stddev = sqrt(scale / fan_in); fan_in = prod of all dims
    but the last."""
    def init(gen, shape, dtype):
        fin = max(1, math.prod(shape[:-1]))
        return _f32(gen, shape).normal_(0.0, (scale / fin) ** 0.5,
                                        generator=gen).to(dtype)
    return init


def uniform(scale: float = 1.0) -> Initializer:
    """U(-scale, scale)."""
    def init(gen, shape, dtype):
        return _f32(gen, shape).uniform_(-scale, scale, generator=gen).to(dtype)
    return init


def zeros() -> Initializer:
    def init(gen, shape, dtype):
        return torch.zeros(tuple(shape), dtype=dtype, device=gen.device)
    return init


def ones() -> Initializer:
    def init(gen, shape, dtype):
        return torch.ones(tuple(shape), dtype=dtype, device=gen.device)
    return init


class ParamModule(nn.Module):
    """An ``nn.Module`` whose own parameters each carry an initialiser."""

    def __init__(self):
        super().__init__()
        self.inits: Dict[str, Initializer] = {}

    def param(self, name: str, shape: Sequence[int], init: Initializer,
              dtype: torch.dtype) -> None:
        self.inits[name] = init
        self.register_parameter(name, nn.Parameter(
            torch.empty(tuple(shape), dtype=dtype, device="meta"),
            requires_grad=False))


def set_param(module: nn.Module, name: str, value: torch.Tensor) -> None:
    """Replace the declared parameter ``name`` (dotted path) by ``value``,
    which must have its declared shape; it is cast to the declared dtype."""
    *path, leaf = name.split(".")
    owner = module.get_submodule(".".join(path))
    old = owner._parameters[leaf]
    if tuple(value.shape) != tuple(old.shape):
        raise ValueError(f"{name}: shape {tuple(value.shape)} != declared "
                         f"{tuple(old.shape)}")
    owner._parameters[leaf] = nn.Parameter(value.to(old.dtype),
                                           requires_grad=False)


def materialize(module: nn.Module, seed: int, device: torch.device) -> nn.Module:
    """Draw every declared parameter of ``module`` on ``device``."""
    for prefix, mod in module.named_modules():
        if not isinstance(mod, ParamModule):
            continue
        for pname, init in mod.inits.items():
            full = f"{prefix}.{pname}" if prefix else pname
            gen = generator(device, seed, full)
            p = mod._parameters[pname]
            mod._parameters[pname] = nn.Parameter(
                init(gen, p.shape, p.dtype), requires_grad=False)
    return module
