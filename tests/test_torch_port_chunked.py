"""The chunked train step and loop (``steps_per_dispatch``) on the CPU.

  - ``train()`` on ``tiny_seg`` through ``make_train_iter`` with
    ``steps_per_dispatch=3`` for 7 iterations (a tail chunk of 1) gives the
    same losses and parameters, bit for bit, as ``steps_per_dispatch=1``;
  - the optimizer's device-tensor schedule: a chunk of 4 rows with the
    cyclic b1 schedule against optax, and against 4 eager steps bit for bit.

The loop's hook steps are in ``test_torch_port_chunked_hooks.py``, the
resume from a chunk-end checkpoint in ``test_torch_port_chunked_resume.py``
(files of their own, so that a parallel run spreads them).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from ddp_tpu.train import optim as joptim
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.loop import train
from torch_port_threads import _one_torch_thread  # noqa: F401


TOTAL = 7


def _cfg(workdir, spd, total=TOTAL, **rt):
    cfg = get_config("tiny_seg")
    return dataclasses.replace(
        cfg,
        model=dataclasses.replace(cfg.model, drop_path_rate=0.1),
        optim=dataclasses.replace(cfg.optim, warmup_steps=2, total_steps=TOTAL),
        runtime=dataclasses.replace(cfg.runtime, total_iters=total, steps_per_dispatch=spd,
                                    workdir=str(workdir), mixed_precision=False,
                                    tensorboard=False, max_keep_ckpts=-1, **rt))


def _log(workdir):
    with open(os.path.join(workdir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


def _skip(it, n):
    for _ in range(n):
        next(it)
    return it


def _assert_same_state(a, b):
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    for x, y in zip(a.optimizer.mu + a.optimizer.nu, b.optimizer.mu + b.optimizer.nu):
        assert torch.equal(x, y)
    assert a.step == b.step and a.optimizer.count == b.optimizer.count
    assert torch.equal(a.generator.get_state(), b.generator.get_state())


def test_chunked_train_equals_per_step(tmp_path):
    """Dropout and drop path on: the chunks draw what the single steps draw."""
    runs = {}
    for spd in (1, 3):
        cfg = _cfg(tmp_path / f"spd{spd}", spd, log_interval=1)
        runs[spd] = (train(cfg, make_train_iter(cfg), device="cpu"), _log(cfg.runtime.workdir))
    (s1, log1), (s3, log3) = runs[1], runs[3]
    assert [r["step"] for r in log3] == list(range(1, TOTAL + 1))
    for a, b in zip(log1, log3):
        for key in ("loss", "decode.loss_ce", "aux.loss_ce", "decode.acc_seg", "grad_norm",
                    "lr"):
            assert a[key] == b[key], (a["step"], key)
    _assert_same_state(s1, s3)


def test_chunk_of_four_cyclic_b1_matches_optax():
    """Four updates from one [4, 5] block of schedule rows (cyclic lr and b1)
    equal optax's chain, and equal four eager steps bit for bit."""
    kw = dict(lr=1e-3, total_steps=8, weight_decay=0.05, schedule="cyclic", grad_clip=100.0)
    m = get_config("tiny_seg").model
    model = build_model(m, device="cpu")
    names = [n for n, _ in model.named_parameters()]
    rng = np.random.RandomState(0)
    grads = [[torch.from_numpy(rng.randn(*p.shape).astype(np.float32))
              for p in model.parameters()] for _ in range(4)]
    init = {n: p.detach().clone() for n, p in model.named_parameters()}

    def run(chunked):
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(init[n])
        opt = toptim.make_optimizer(toptim.OptimConfig(**kw), model)
        if chunked:
            rows = opt.schedule(4)
            for g, row in zip(grads, rows):
                opt.step(g, row)
            opt.count += 4
        else:
            for g in grads:
                opt.step(g)
        return opt, {n: p.detach().clone() for n, p in model.named_parameters()}

    opt, got = run(chunked=True)
    _, eager = run(chunked=False)
    assert opt.count == 4
    for n in names:
        assert torch.equal(got[n], eager[n]), n
    # the rows are the float32 roundings of the host schedule
    sched = toptim.make_optimizer(toptim.OptimConfig(**kw), model)
    rows = sched.schedule(4)
    for step in range(4):
        b1 = sched.b1_schedule(step)
        want = [sched.lr_schedule(step), b1, 1.0 - b1,
                1.0 - float(torch.tensor(b1, dtype=torch.float32) ** (step + 1)),
                1.0 - float(torch.tensor(0.999, dtype=torch.float32) ** (step + 1))]
        assert rows[step].tolist() == torch.tensor(want, dtype=torch.float32).tolist()

    tree = _to_tree({n: jnp.asarray(init[n].numpy()) for n in names})
    tx = joptim.make_optimizer(joptim.OptimConfig(**kw), tree)
    state = tx.init(tree)
    update = jax.jit(tx.update)
    for g in grads:
        gt = _to_tree({n: jnp.asarray(x.numpy()) for n, x in zip(names, g)})
        upd, state = update(gt, state, tree)
        tree = optax.apply_updates(tree, upd)
    want = _from_tree(tree)
    for n in names:
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want[n]), rtol=1e-6,
                                   atol=1e-5 * 10 * kw["lr"], err_msg=n)


def _to_tree(flat):
    """Port names as nested dict paths, so that optax's mask rules see the
    same substrings ('norm', 'relative_position_bias_table', ...)."""
    tree = {}
    for name, v in flat.items():
        node = tree
        *parents, leaf = name.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def _from_tree(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_from_tree(v, key + "."))
        else:
            out[key] = v
    return out
