"""The chunked train step and loop (``steps_per_dispatch``) on the CPU.

  - ``train()`` on ``tiny_seg`` through ``make_train_iter`` with
    ``steps_per_dispatch=3`` for 7 iterations (a tail chunk of 1) gives the
    same losses and parameters, bit for bit, as ``steps_per_dispatch=1``;
  - it logs, checkpoints and evaluates at the steps where
    ``ddp_tpu.train.loop.train`` does with that configuration (the JAX loop
    driven with a stand-in for its compiled chunk, so that it runs in
    seconds), and warns on the same misaligned intervals;
  - a resume from a chunk-end checkpoint continues the run exactly;
  - the optimizer's device-tensor schedule: a chunk of 4 rows with the
    cyclic b1 schedule against optax, and against 4 eager steps bit for bit.
"""
import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddp_tpu.config import get_config as j_get_config
from ddp_tpu.train import loop as jloop
from ddp_tpu.train import optim as joptim
from ddp_tpu.train import state as jstate
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.train import checkpoint as tckpt
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.loop import train

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


def _port_hooks(tmp_path, monkeypatch, rt):
    saved, evals = [], []
    real_save = tckpt.CheckpointManager.save

    def save(self, step, state, meta=None):
        saved.append(step)
        return real_save(self, step, state, meta)

    monkeypatch.setattr(tckpt.CheckpointManager, "save", save)
    cfg = _cfg(tmp_path / "port", 3, **rt)
    train(cfg, make_train_iter(cfg), device="cpu",
          eval_fn=lambda state, step: evals.append(step) or {"mIoU": 0.5})
    return [r["step"] for r in _log(cfg.runtime.workdir)], saved, evals


def _jax_hooks(tmp_path, monkeypatch, rt):
    """ddp_tpu.train.loop.train with steps_per_dispatch 3 over 7 steps; its
    compiled chunk replaced by one that only advances the step."""
    saved, evals = [], []

    def chunked(model, tx, n, **kw):
        return lambda state, batches: (state.replace(step=state.step + n),
                                       {"loss": np.arange(n, dtype=np.float32)})

    monkeypatch.setattr(jstate, "make_chunked_train_step", chunked)
    monkeypatch.setattr(jloop.CheckpointManager, "save",
                        lambda self, step, state, meta=None: saved.append(step))
    cfg = j_get_config("converge_seg_window")
    cfg = dataclasses.replace(
        cfg, data=dataclasses.replace(cfg.data, batch_size=2),
        runtime=dataclasses.replace(cfg.runtime, total_iters=TOTAL, steps_per_dispatch=3,
                                    workdir=str(tmp_path / "jax"), tensorboard=False,
                                    max_keep_ckpts=-1, **rt))
    batch = {"image": np.zeros((2, 64, 64, 3), np.float32),
             "label": np.zeros((2, 64, 64), np.int32)}
    jloop.train(cfg, iter([batch] * TOTAL), init_params={"params": {"w": jnp.zeros(3)}},
                eval_fn=lambda state, step: evals.append(step) or {"mIoU": 0.5})
    return [r["step"] for r in _log(cfg.runtime.workdir)], saved, evals


@pytest.mark.parametrize("rt", [
    dict(log_interval=2, ckpt_interval=2, eval_interval=4),  # both misaligned with 3
    dict(log_interval=5, ckpt_interval=3, eval_interval=6),  # aligned; a log inside a chunk
])
def test_hook_steps_match_jax_loop(tmp_path, monkeypatch, capsys, rt):
    jax_steps = _jax_hooks(tmp_path, monkeypatch, rt)
    jax_warn = [line for line in capsys.readouterr().out.splitlines() if "[warn]" in line]
    port_steps = _port_hooks(tmp_path, monkeypatch, rt)
    port_warn = [line for line in capsys.readouterr().out.splitlines() if "[warn]" in line]
    assert port_steps == jax_steps
    assert port_warn == jax_warn
    if rt["log_interval"] == 2:
        assert port_steps == ([1, 2, 4, 6], [3, 6, 7], [6, 7]) and len(port_warn) == 2


def test_resume_from_chunk_end_checkpoint_is_exact(tmp_path):
    """7 steps straight (checkpoints at the chunk ends 3, 6 and 7) against a
    run resumed from the step-3 checkpoint alone."""
    cfg = _cfg(tmp_path / "full", 3, ckpt_interval=2)
    full = train(cfg, make_train_iter(cfg), device="cpu")
    assert tckpt._steps(os.path.join(cfg.runtime.workdir, "ckpts")) == [3, 6, 7]
    resumed_dir = tmp_path / "resumed"
    os.makedirs(resumed_dir / "ckpts")
    shutil.copy(os.path.join(cfg.runtime.workdir, "ckpts", "step_3.pt"), resumed_dir / "ckpts")
    rcfg = _cfg(resumed_dir, 3, ckpt_interval=2)
    resumed = train(rcfg, _skip(make_train_iter(rcfg), 3), resume=True, device="cpu")
    _assert_same_state(full, resumed)
    assert [r["step"] for r in _log(resumed_dir)] == [4]


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
