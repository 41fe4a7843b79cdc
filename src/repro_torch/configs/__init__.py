"""Architecture registry of the port: the architectures it runs today.

``get_config("rwkv6-1.6b")``.  Every other architecture of the reference's
zoo is still to be ported; asking for one raises and points at the plan.
"""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "rwkv6-1.6b": "rwkv6_1_6b",
}


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"arch {name!r} is not ported to repro_torch yet (have "
            f"{sorted(_MODULES)}); ROADMAP.md lists the slices still to port")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[name]}").CONFIG
