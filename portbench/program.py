"""The system under test: the PyTorch/CUDA port, ``repro_torch``.

The only module of the benchmark that imports the program; the entries
reach it through here.  It gives a configuration file's ``model`` group to
the port as its ``ModelConfig`` and returns the port's own model,
training step and optimizer state.
"""
from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if os.path.join(ROOT, "src") not in sys.path:
    sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.launch.train import lm_train_step  # noqa: E402,F401
from repro_torch.models.api import build_model as _build  # noqa: E402
from repro_torch.optim.adam import init_adam  # noqa: E402,F401


def model_config(m: dict) -> ModelConfig:
    """The port's ``ModelConfig`` holding every size of ``m``."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = sorted(set(m) - fields)
    if unknown:
        raise KeyError(f"the port's ModelConfig has no {unknown}")
    return ModelConfig(**m)


def build_model(m: dict, device):
    return _build(model_config(m), device)


def param_shapes(model):
    """The port's parameter tree as meta tensors (shapes, no storage)."""
    return model.on_meta().init()
