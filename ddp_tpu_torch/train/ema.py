"""Exponential moving average of parameters (port of ``ddp_tpu/train/ema.py``;
reference: LitEma, controlnet/ldm/modules/ema.py): after each optimizer step
``ema = ema · d + p · (1 − d)`` with the warm-up decay
``d = min(decay, (1 + n) / (10 + n))``, n the number of updates so far
including this one, computed in float32 as JAX computes it.

Neither package's training loop calls it (ROADMAP.md queue 1 names its
slice); it is held to the JAX function on the CPU.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch


def ema_init(params: Mapping[str, torch.Tensor]) -> Tuple[Dict[str, torch.Tensor], int]:
    """(copies of ``params``, 0 updates)."""
    return {k: v.detach().clone() for k, v in params.items()}, 0


@torch.no_grad()
def ema_update(ema_state: Tuple[Dict[str, torch.Tensor], int],
               params: Mapping[str, torch.Tensor], decay: float = 0.9999
               ) -> Tuple[Dict[str, torch.Tensor], int]:
    """The next (ema parameters, updates); ``ema_state`` is not changed."""
    ema, n = ema_state
    n += 1
    d = np.minimum(np.float32(decay), np.float32(1.0 + n) / np.float32(10.0 + n))
    keep, take = float(d), float(np.float32(1.0) - d)
    return {k: e * keep + params[k].to(e.dtype) * take for k, e in ema.items()}, n
