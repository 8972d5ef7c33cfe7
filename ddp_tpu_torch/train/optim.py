"""Optimizer and learning-rate schedules (port of ``ddp_tpu/train/optim.py``).

The JAX package's update is one optax chain, ``clip_by_global_norm`` ->
``adamw`` (masked weight decay, scheduled lr, optionally scheduled b1) ->
per-parameter lr multiplier. ``AdamW`` here runs the same chain on the port's
parameters with ``torch._foreach`` ops and keeps optax's arithmetic where it
differs from ``torch.optim.AdamW`` and ``clip_grad_norm_``:

  - the clip scales by ``max_norm / norm`` only when ``norm >= max_norm``,
    with no ``+ 1e-6`` in the denominator;
  - ε is added to √v̂ (eps_root 0), the bias corrections use the step count,
    the decay ``wd · p`` is added to the Adam direction before the lr scales
    it, and only on masked parameters; then the lr multiplier.

Paramwise rules (``_rule_for``) match substrings of the parameter's name.
The port names its parameters by the JAX package's flax paths (``convert.py``
is a rename and a transpose), and the renames touch only 1-D norm
parameters, which the rule exempts from decay anyway, so the mask and the
multipliers equal the JAX package's (``tests/test_torch_port_train.py``
checks every parameter of ``ade20k_swin_t``).
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import nn


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 6e-5
    betas: Tuple[float, float] = (0.9, 0.999)
    weight_decay: float = 0.01
    grad_clip: float = 0.1
    # substring -> (lr_mult, decay_mult); first match wins (mmseg semantics)
    custom_keys: Tuple[Tuple[str, Tuple[float, float]], ...] = (
        ("pos_block", (1.0, 0.0)),
        ("norm", (1.0, 0.0)),
        ("relative_position_bias_table", (1.0, 0.0)),
        ("head", (1.0, 1.0)),
    )
    schedule: str = "poly"  # 'poly' | 'cosine' | 'constant' | 'cyclic'
    total_steps: int = 160_000
    warmup_steps: int = 1500
    warmup_ratio: float = 1e-6
    power: float = 1.0
    min_lr: float = 0.0
    cyclic_target_ratio: Tuple[float, float] = (10.0, 1e-4)
    cyclic_step_ratio_up: float = 0.4
    cyclic_momentum: bool = True
    cyclic_momentum_ratio: Tuple[float, float] = (0.8947368421, 1.0)
    layer_decay_rate: Optional[float] = None
    layer_decay_num_layers: int = 12


def _rule_for(path: str, ndim: int, custom_keys) -> Tuple[float, float]:
    """(lr_mult, decay_mult): the first custom key contained in ``path``
    wins; every parameter of at most one dimension is exempt from decay."""
    lr_mult, decay_mult = 1.0, 1.0
    for key, (lm, dm) in custom_keys:
        if key in path:
            lr_mult, decay_mult = lm, dm
            break
    if ndim <= 1:
        decay_mult = 0.0
    return lr_mult, decay_mult


def layer_id_for_path(path: str, num_layers: int) -> int:
    """Layer id for layer-wise lr decay (``ddp_tpu/train/optim.py:79-112``)."""
    if "backbone" not in path:
        return num_layers + 1
    if "stem" in path or "patch_embed" in path or "pos_embed" in path:
        return 0
    m = re.search(r"stage(\d+)_block(\d+)", path)
    if m:
        stage_id, block_id = int(m.group(1)), int(m.group(2))
        if stage_id == 0:
            return 1
        if stage_id == 1:
            return 2
        if stage_id == 2:
            return 3 + block_id // 3
        return num_layers
    m = re.search(r"down_(?:conv|norm)(\d+)", path)
    if m:
        return {1: 2, 2: 3}.get(int(m.group(1)), num_layers)
    m = re.search(r"layers?_?(\d+)", path)
    if m:
        return int(m.group(1)) + 1
    return num_layers


def param_rules(cfg: OptimConfig, named: List[Tuple[str, torch.Tensor]]
                ) -> Tuple[List[float], List[bool]]:
    """(lr multiplier, decay mask) of each named parameter, in order."""
    mults, mask = [], []
    for name, p in named:
        lm, dm = _rule_for(name, p.ndim, cfg.custom_keys)
        if cfg.layer_decay_rate is not None:
            lid = layer_id_for_path(name, cfg.layer_decay_num_layers)
            lm *= cfg.layer_decay_rate ** (cfg.layer_decay_num_layers + 1 - lid)
        mults.append(lm)
        mask.append(dm > 0)
    return mults, mask


def make_lr_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """lr at a 0-based step: poly/cosine/constant with linear warm-up, or the
    one-cycle 'cyclic' schedule (no warm-up)."""

    def sched(step: int) -> float:
        step = float(step)
        warm_frac = min(max(step / max(cfg.warmup_steps, 1), 0.0), 1.0)
        warm_mult = cfg.warmup_ratio + (1.0 - cfg.warmup_ratio) * warm_frac
        prog = min(max(step / cfg.total_steps, 0.0), 1.0)
        if cfg.schedule == "poly":
            lr = (cfg.lr - cfg.min_lr) * (1.0 - prog) ** cfg.power + cfg.min_lr
        elif cfg.schedule == "cosine":
            lr = cfg.min_lr + 0.5 * (cfg.lr - cfg.min_lr) * (1.0 + math.cos(math.pi * prog))
        elif cfg.schedule == "constant":
            lr = cfg.lr
        elif cfg.schedule == "cyclic":
            r_up, r_down = cfg.cyclic_target_ratio
            up = cfg.cyclic_step_ratio_up
            peak, floor = cfg.lr * r_up, cfg.lr * r_down
            up_frac = min(max(prog / up, 0.0), 1.0)
            down_frac = min(max((prog - up) / max(1.0 - up, 1e-8), 0.0), 1.0)
            if prog < up:
                return cfg.lr + (peak - cfg.lr) * 0.5 * (1.0 - math.cos(math.pi * up_frac))
            return floor + (peak - floor) * 0.5 * (1.0 + math.cos(math.pi * down_frac))
        else:
            raise ValueError(f"unknown schedule {cfg.schedule!r}")
        return lr * warm_mult

    return sched


def make_momentum_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """Cyclic b1, inverse-phased to the lr (mmcv CyclicMomentumUpdaterHook)."""
    b1 = cfg.betas[0]
    r_down, r_up = cfg.cyclic_momentum_ratio
    up = cfg.cyclic_step_ratio_up

    def sched(step: int) -> float:
        prog = min(max(float(step) / cfg.total_steps, 0.0), 1.0)
        low, high = b1 * r_down, b1 * r_up
        up_frac = min(max(prog / up, 0.0), 1.0)
        down_frac = min(max((prog - up) / max(1.0 - up, 1e-8), 0.0), 1.0)
        if prog < up:
            return high + (low - high) * 0.5 * (1.0 - math.cos(math.pi * up_frac))
        return high + (low - high) * 0.5 * (1.0 + math.cos(math.pi * down_frac))

    return sched


class AdamW:
    """The JAX package's optax chain on a list of named parameters (updated
    in place). ``step(grads)`` returns the global norm of the unclipped
    gradients as a 0-d device tensor (no host synchronisation)."""

    def __init__(self, cfg: OptimConfig, named: List[Tuple[str, nn.Parameter]]):
        self.cfg = cfg
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.lr_mults, self.decay_mask = param_rules(cfg, named)
        self.lr_schedule = make_lr_schedule(cfg)
        self.b1_schedule = (make_momentum_schedule(cfg)
                            if cfg.schedule == "cyclic" and cfg.cyclic_momentum else None)
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> torch.Tensor:
        cfg = self.cfg
        # dense like the moments, so that every _foreach op takes its fused
        # multi-tensor route (a stride mismatch drops it to one launch per tensor)
        g = [x.float().contiguous() for x in grads]
        g_norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        # optax.clip_by_global_norm: select(norm < max, g, g / norm * max)
        keep = g_norm < cfg.grad_clip
        one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
        g = torch._foreach_div(g, torch.where(keep, one, g_norm))
        torch._foreach_mul_(g, torch.where(keep, one, one * cfg.grad_clip))

        step = self.count
        self.count += 1
        b1 = self.b1_schedule(step) if self.b1_schedule else cfg.betas[0]
        b2 = cfg.betas[1]
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        # bias corrections in float32, as optax computes decay ** count
        bc1 = 1.0 - float(torch.tensor(b1, dtype=torch.float32) ** self.count)
        bc2 = 1.0 - float(torch.tensor(b2, dtype=torch.float32) ** self.count)
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, 1e-8)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        decayed = [i for i, m in enumerate(self.decay_mask) if m]
        if decayed and cfg.weight_decay:
            torch._foreach_add_([upd[i] for i in decayed],
                                torch._foreach_mul([self.params[i] for i in decayed],
                                                   cfg.weight_decay))
        torch._foreach_mul_(upd, -self.lr_schedule(step))
        if any(m != 1.0 for m in self.lr_mults):
            torch._foreach_mul_(upd, self.lr_mults)
        torch._foreach_add_(self.params, upd)
        return g_norm

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(zip(self.names, self.mu)),
                "nu": dict(zip(self.names, self.nu))}

    def load_state_dict(self, sd: Dict) -> None:
        self.count = int(sd["count"])
        with torch.no_grad():
            for name, mu, nu in zip(self.names, self.mu, self.nu):
                mu.copy_(sd["mu"][name])
                nu.copy_(sd["nu"][name])


def make_optimizer(cfg: OptimConfig, model: nn.Module) -> AdamW:
    return AdamW(cfg, list(model.named_parameters()))
