"""The BEV model's train step, end check and entry points on the CPU.

  - A BEV batch through ``make_train_step`` and a 2-step chunk of
    ``make_chunked_train_step`` with the BEV batch keys, f32 and bf16, bit
    for bit on the CPU; the bf16 policy casts every float32 batch value
    (the rig included) and no other.
  - ``tests/train_from_start.py`` takes a seed and initial weights.
  - ``python -m ddp_tpu_torch.tools.train smoke_bev`` (in-process, ``--device
    cpu``) logs and checkpoints; the test CLI refuses BEV, as JAX's has no
    BEV branch.
"""
import json
import os

import pytest
import torch

from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.data import bev_datasets as tbd
from ddp_tpu_torch.data.bev_datasets import BEV_BATCH_KEYS
from ddp_tpu_torch.evaluation import convergence as C
from ddp_tpu_torch.tools import test as test_cli
from ddp_tpu_torch.tools import train as train_cli
from ddp_tpu_torch.train import optim as toptim
from ddp_tpu_torch.train.step import TrainState, make_chunked_train_step, make_train_step

import train_from_start


def _bev_batch(b=2, seed=0):
    ds = tbd.SyntheticBEVDataset(num_cams=2, image_size=(32, 64), out_grid=20, num_classes=3,
                                 scope=8.0, length=8)
    batch = next(tbd.bev_batch_iterator(ds, b, seed=seed))
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("mixed", [False, True])
def test_bev_batch_through_eager_and_chunked_steps(mixed):
    """BEV batches through make_train_step and a 2-step chunk of
    make_chunked_train_step (named keys) from the same state: the same
    losses and parameters, bit for bit, on the CPU (the card runs the chunk
    as one CUDA graph; chip_smoke.py's bev_train holds it to the eager
    steps)."""
    cfg = get_config("smoke_bev")
    batches = [_bev_batch(seed=s) for s in (0, 1)]
    results = []
    for chunked in (False, True):
        model = build_model(cfg.model, device="cpu", seed=2)
        state = TrainState(model, toptim.make_optimizer(cfg.optim, model),
                           torch.Generator().manual_seed(0))
        state.optimizer.count = cfg.optim.warmup_steps
        if chunked:
            logs = make_chunked_train_step(2, mixed_precision=mixed, batch_keys=BEV_BATCH_KEYS)(
                state, {k: torch.stack([b[k] for b in batches]) for k in BEV_BATCH_KEYS})
            losses = logs["loss"].tolist()
        else:
            step = make_train_step(mixed_precision=mixed, batch_keys=BEV_BATCH_KEYS)
            losses = [step(state, b)["loss"].item() for b in batches]
        results.append((losses, {k: v.clone() for k, v in model.state_dict().items()}))
    assert results[0][0] == results[1][0]
    assert all(0 < loss < float("inf") for loss in results[0][0])
    for k, v in results[0][1].items():
        assert torch.equal(v, results[1][1][k]), k


class _Recorder(torch.nn.Module):
    """Records the dtypes of what the step hands it."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.seen = None

    def forward(self, *args, t=None, noise=None, generator=None):
        self.seen = ([a.dtype for a in args], None if t is None else t.dtype,
                     None if noise is None else noise.dtype, self.w.dtype)
        loss = self.w * sum(a.float().mean() for a in args)
        return loss, {"loss": loss}


def test_bf16_policy_casts_every_float_batch_value():
    """Under mixed precision the step passes every float32 batch value in
    bf16 (images, the rig, masks; JAX's _to_bf16), an int label and a given
    t untouched; f32 passes them as they are."""
    model = _Recorder()
    batch = _bev_batch()
    batch["t"] = torch.rand(2)
    batch["noise"] = torch.randn(2, 4)
    state = TrainState(model, toptim.make_optimizer(get_config("smoke_bev").optim, model),
                       torch.Generator().manual_seed(0))
    make_train_step(mixed_precision=True, batch_keys=BEV_BATCH_KEYS).grads(state, batch)
    assert model.seen == ([torch.bfloat16] * 7, torch.float32, torch.bfloat16, torch.bfloat16)
    make_train_step(batch_keys=BEV_BATCH_KEYS).grads(state, batch)
    assert model.seen == ([torch.float32] * 7, torch.float32, torch.float32, torch.float32)
    seg = {"image": torch.randn(2, 8, 8, 3), "label": torch.zeros(2, 8, 8, dtype=torch.int64)}
    make_train_step(mixed_precision=True).grads(state, seg)
    assert model.seen[0] == [torch.bfloat16, torch.int64]


def test_train_from_start_takes_a_seed_and_initial_weights(monkeypatch, tmp_path):
    """``tests/train_from_start.py``: the run's seed and its starting weights
    (a state_dict file, as ``tests/make_jax_init.py`` writes the JAX
    package's, or the port's init redrawn truncated as flax draws it) reach
    ``train()``, each in its own workdir, and the result names them; a
    fine-tune is refused."""
    monkeypatch.chdir(tmp_path)
    torch.save(build_model(get_config("smoke_bev").model, device="cpu", seed=7).state_dict(),
               "jax0.pt")
    seen = []

    def fake_train(cfg, data_iter, device=None, init_params=None):
        seen.append((cfg.runtime.seed, cfg.runtime.workdir, init_params))
        model = build_model(cfg.model, device="cpu", seed=cfg.runtime.seed)
        if init_params is not None:
            model.load_state_dict(init_params)
        return TrainState(model, None, None)

    monkeypatch.setattr(C, "train", fake_train)
    monkeypatch.setitem(C.SCORERS, "bev", lambda model, mc: {"map_mIoU@1step": 0.5})
    assert train_from_start.main(["smoke_bev", "--seed", "3"])["start"] == "seed3"
    res = train_from_start.main(["smoke_bev", "--init", "jax0.pt"])
    assert res["seed"] == 0 and res["start"] == "init_jax0"
    assert train_from_start.main(["smoke_bev", "--truncated"])["start"] == "trunc_seed0"
    (s3, w3, i3), (s0, w0, i0), (st, wt, it) = seen
    assert (s3, w3, i3) == (3, "work_dirs/torch_smoke_bev_seed3", None)
    assert os.path.exists(os.path.join(w3, "result.json"))
    want = build_model(get_config("smoke_bev").model, device="cpu", seed=7).state_dict()
    assert (s0, w0) == (0, "work_dirs/torch_smoke_bev_init_jax0")
    assert all(torch.equal(i0[k], want[k]) for k in want)
    assert (st, wt) == (0, "work_dirs/torch_smoke_bev_trunc_seed0")
    plain = build_model(get_config("smoke_bev").model, device="cpu").state_dict()
    w = it["vtransform.down0.weight"]
    std = w[0].numel() ** -0.5
    assert w.abs().max() <= 2.0 / 0.8796 * std * 1.0001
    assert abs(w.std() / std - 1.0) < 0.05
    assert plain["vtransform.down0.weight"].abs().max() > w.abs().max()
    table = it["backbone.stage0_block0.attn.relative_position_bias_table"]
    assert table.abs().max() <= 0.04
    for k in ("embedding_table.weight", "backbone.patch_norm.weight"):
        assert torch.equal(it[k], plain[k]), k
    with pytest.raises(SystemExit):
        train_from_start.main(["converge_seg_aligned_msda"])


# --- the entry points -----------------------------------------------------------------------

def test_train_cli_on_smoke_bev(tmp_path):
    """4 iterations of smoke_bev through make_train_iter, 2 per dispatch."""
    workdir = str(tmp_path)
    assert train_cli.main(["smoke_bev", "--workdir", workdir, "--device", "cpu", "--set",
                           "runtime.total_iters=4", "runtime.steps_per_dispatch=2",
                           "runtime.log_interval=2", "runtime.ckpt_interval=4",
                           "runtime.tensorboard=false", "optim.total_steps=4"]) == 0
    with open(os.path.join(workdir, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    assert [r["step"] for r in logs] == [1, 2, 4]
    assert all(0 < r["loss"] < float("inf") and "map.walkway.focal" in r for r in logs)
    assert os.listdir(os.path.join(workdir, "ckpts")) == ["step_4.pt"]
    with pytest.raises(SystemExit, match="no test CLI"):
        test_cli.main(["smoke_bev", "--workdir", workdir, "--device", "cpu"])

