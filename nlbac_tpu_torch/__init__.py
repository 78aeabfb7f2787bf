"""nlbac_tpu_torch: the PyTorch/CUDA port of ``nlbac_tpu``.

The JAX package ``nlbac_tpu`` stays the reference; this package mirrors its
layout module by module (``nlbac_tpu_torch/nn/node.py`` ports
``nlbac_tpu/nn/node.py``, and so on) and imports nothing of it. Parameters
are plain dicts of tensors with weights stored ``(in, out)`` as in
``nlbac_tpu/nn/mlp.py``; randomness comes from explicit
``torch.Generator``s. The control-affine NODE Euler step runs as a
hand-written CUDA kernel (``ops/node_kernel.py`` + ``csrc/node_euler.cu``).

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; nothing moves to the CPU silently.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on; raises when CUDA is asked for and
    no GPU is present (the CPU is taken only when the caller names it)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    return dev
