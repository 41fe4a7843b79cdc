"""Parameters between the reference's flat checkpoint form and the port.

``flat`` is a ``dict[str, np.ndarray]`` keyed as ``repro/checkpoint/npz.py``
flattens a parameter tree: ``|``-joined paths, stacked layers with a leading
layer dim (``layers|tm|wr`` is (L, d, d)), and a ``::bf16`` suffix on keys
whose array is the ``uint16`` view of a bfloat16 leaf.  In the port the
layers are ``layers.<i>.*`` modules, so a stacked leaf is split on the way
in and stacked on the way out.  Both directions are exact.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.model import RWKV6LM
from repro_torch.nn.param import set_param

_BF16 = "::bf16"


def _to_torch(key: str, arr: np.ndarray) -> torch.Tensor:
    arr = np.array(arr)                      # a writable copy
    if key.endswith(_BF16):
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _BF16, t.view(torch.int16).numpy().view(np.uint16)
    return "", t.numpy()


def _ref_key(name: str):
    """Port parameter name -> (reference key, layer index or None)."""
    parts = name.split(".")
    if parts[0] == "layers":
        return "|".join(["layers"] + parts[2:]), int(parts[1])
    return "|".join(parts), None


def from_reference(flat: Dict[str, np.ndarray], cfg, device="cuda") -> RWKV6LM:
    """Build the port's model for ``cfg`` with exactly the parameters in
    ``flat``; every key must be used and every parameter filled."""
    dev = resolve_device(device)
    model = RWKV6LM(cfg)
    by_key = {k[:-len(_BF16)] if k.endswith(_BF16) else k: k for k in flat}
    used = set()
    for name, _ in list(model.named_parameters()):
        key, layer = _ref_key(name)
        if key not in by_key:
            raise KeyError(f"{name}: reference key {key!r} missing from flat")
        src = by_key[key]
        used.add(src)
        value = _to_torch(src, flat[src])
        if layer is not None:
            value = value[layer]
        set_param(model, name, value.to(dev))
    extra = set(flat) - used
    if extra:
        raise KeyError(f"flat keys the {cfg.name} model has no place for: "
                       f"{sorted(extra)}")
    return model.eval()


def to_reference(model: RWKV6LM) -> Dict[str, np.ndarray]:
    """The model's parameters in the reference's flat form."""
    stacks: Dict[str, list] = {}
    flat: Dict[str, np.ndarray] = {}
    for name, p in model.named_parameters():
        key, layer = _ref_key(name)
        if layer is None:
            suffix, arr = _to_numpy(p)
            flat[key + suffix] = arr
        else:
            stacks.setdefault(key, []).append(p)
    for key, ps in stacks.items():
        suffix, arr = _to_numpy(torch.stack(ps))
        flat[key + suffix] = arr
    return flat
