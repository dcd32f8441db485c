"""paddle_tpu_torch — the PyTorch/CUDA port of ``paddle_tpu``.

The port runs on one NVIDIA Hopper card (sm_90a).  Plain tensor code is
PyTorch; every Pallas kernel of ``paddle_tpu`` that a ported slice runs
becomes a hand-written CUDA kernel under ``ops/kernels/csrc/``, built at
first use.  The module layout mirrors ``paddle_tpu`` so each counterpart
is found under the same path.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(the CPU tests do).  Asking for ``cuda`` on a machine without a card
raises :class:`RuntimeError`; nothing carries on on the CPU.

Ported slices: serving (``inference.GenerationServer`` over
``text.models.LlamaForCausalLM``), training (``optimizer.AdamW`` and
``distributed.fleet.DistributedTrainStep`` over the same model), int8
inference (``quantization.convert_to_int8_inference`` over
``vision.models.resnet50`` and its family), parameter-server training
(``distributed.fleet.HeterTrainer``), the elastic data plane
(``distributed.fleet.ElasticTrainer``) and the online loop
(``online.StreamingTrainer`` over ``distributed.fleet.PSServer``); the
subpackages are imported on use, as in ``paddle_tpu``.

This package never imports ``jax`` or any module of ``paddle_tpu``.
"""
from __future__ import annotations

import threading

import torch

__version__ = "2.0.0"

__all__ = ["seed", "get_seed", "resolve_device", "make_generator",
           "__version__"]

_lock = threading.Lock()
_SEED = 0


def seed(s: int) -> torch.Generator:
    """Reset the global seed (mirrors ``paddle.seed``).  Models built
    afterwards without an explicit generator draw their weights from
    :func:`make_generator`, which starts from this seed.  Returns a CPU
    generator seeded with ``s``."""
    global _SEED
    with _lock:
        _SEED = int(s)
    torch.manual_seed(int(s))
    return torch.Generator().manual_seed(int(s))


def get_seed() -> int:
    with _lock:
        return _SEED


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  A ``cuda`` device without a card raises:
    the port never falls back to the CPU on its own."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddle_tpu_torch: a CUDA device was requested (the default) "
            "but torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU")
    if d.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {d}")
    return d


def make_generator(device, offset: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded with the global seed + ``offset``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        get_seed() + int(offset))
