"""repro_torch: the PyTorch and CUDA port of ``repro``, for NVIDIA Hopper.

The package mirrors ``repro``'s module layout (``configs``, ``models``,
``nn``, ``kernels``, ``serve``, ``launch``) and imports nothing from it:
``torch``, ``numpy`` and the standard library only.  Entry points take a
``device`` that defaults to ``"cuda"``; without a card they raise unless the
caller asks for ``device="cpu"``, where every kernel wrapper runs its plain
PyTorch version.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` raises when no card is
    present, so a run never slips onto the CPU unasked.  On the card TF32 is
    switched off for matmuls and cuDNN: the port is held to the reference in
    full fp32."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} asked for, but torch sees no CUDA device; "
                "pass device='cpu' to run the plain PyTorch path")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev


def generator(device, *parts) -> torch.Generator:
    """A generator on ``device`` seeded from ``parts`` (ints and strings) by
    a 64-bit FNV-1a hash: stable across processes (unlike ``hash``), and it
    spreads every part over all 64 bits, since torch's CPU generator keeps
    only the low 32 bits of a seed."""
    h = 0xCBF29CE484222325
    for ch in "/".join(str(p) for p in parts).encode():
        h = ((h ^ ch) * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    gen = torch.Generator(device=device)
    gen.manual_seed(h ^ (h >> 32))
    return gen
