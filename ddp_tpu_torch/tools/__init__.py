"""The command-line tools (``python -m ddp_tpu_torch.tools.<name>``)."""
from __future__ import annotations


def segmentor(cfg, ckpt, device, input_size=None):
    """The preset's segmentor on ``device`` in eval mode (``served_model``)."""
    if cfg.model.task != "seg":
        raise SystemExit(f"task {cfg.model.task!r}: this tool runs a segmentor (task 'seg'), "
                         "as the JAX tool does")
    return served_model(cfg, ckpt, device, input_size)


def served_model(cfg, ckpt, device, input_size=None):
    """The preset's model on ``device`` in eval mode: the weights of a
    published ``.pt`` (``tools/publish_model.py``) or of the JAX package's
    published ``.msgpack`` loaded strictly, or without one the seeded random
    init, with a warning (as the JAX tools)."""
    from ..config import build_model
    from ..train.checkpoint import read_published

    model = build_model(cfg.model, device=device, seed=cfg.runtime.seed,
                        input_size=input_size or cfg.data.crop_size)
    if ckpt:
        model.load_state_dict(read_published(ckpt))
    else:
        print("WARNING: no --ckpt given; using random init (smoke test only)")
    return model.eval()
