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
(``distributed.fleet.ElasticTrainer``), the online loop
(``online.StreamingTrainer`` over ``distributed.fleet.PSServer``, with
geo replication, the tiered table and the fleet PS entry points) and
ResNet training (``optimizer.Momentum``, ``nn.functional.cross_entropy``
and batch norm with batch statistics under the same step) and the rest
of the one-device step (``optimizer.lr``, ``nn.clip``, ``regularizer``,
the optimizer zoo, ``amp``, ``train_guard.TrainGuard``, float16 loss
scaling and gradient merge in the step, chunked attention and loss).  The
subpackages are imported on first attribute access, so
``paddle_tpu_torch.optimizer.Momentum`` reads as ``paddle.optimizer.
Momentum`` does.

This package never imports ``jax`` or any module of ``paddle_tpu``.
"""
from __future__ import annotations

import importlib
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


_SUBPACKAGES = ("amp", "distributed", "framework", "inference", "io", "nn",
                "observability", "online", "ops", "optimizer",
                "quantization", "regularizer", "text", "tools",
                "train_guard", "vision")


def __getattr__(name):
    if name in _SUBPACKAGES:
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def make_generator(device, offset: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded with the global seed + ``offset``."""
    return torch.Generator(device=resolve_device(device)).manual_seed(
        get_seed() + int(offset))
