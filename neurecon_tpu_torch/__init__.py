"""neurecon_tpu_torch — the PyTorch and CUDA port of `neurecon_tpu` for one
NVIDIA H100 (Hopper, sm_90a).

The port keeps the JAX package's module names and layout. Plain tensor code is
PyTorch; every Pallas kernel on a ported path is a hand-written CUDA kernel
under `csrc/`, built with nvcc on first use (`ops/_build.py`).

Entry points run on the card. The CPU is used only when the caller asks for it
(`device="cpu"`, `--device cpu`): there the kernel wrappers take their plain
PyTorch versions, which is how the tests hold the port against the JAX package.
"""
from __future__ import annotations

import torch

__version__ = "0.1.0"


def get_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and no card is
    present, so a run never drops quietly onto the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is present; pass device='cpu' (--device cpu) "
                "to run the plain PyTorch path on the CPU")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev
