"""The port's mmseg checkpoint importer (``ddp_tpu_torch/train/torch_import.py``)
and the fine-tune entry points, on the CPU.

  - One seeded random state_dict with mmseg's names and shapes for a tiny
    msda segmentor (``synthetic_mmseg_state``) goes through the JAX
    package's ``import_ddp_seg`` and forward and through the port's importer
    and forward: empty reports on both sides; ``sample``'s step-1 logits and
    the aux head's logits within 1e-4 abs.
  - The PatchMerging mapping against ``F.unfold(kernel_size=2, stride=2)``
    directly.
  - ``load_mmseg_checkpoint`` round-trips a ``torch.save``d file with and
    without a ``state_dict`` wrapper (the neck's GN under ``.bn`` or
    ``.gn``); a 4-head preset is refused an 8-head
    checkpoint with a message (the reference fault of ROADMAP.md queue 3).
  - ``train(init_params=...)`` starts from the given weights; the aligned
    end check refuses a missing base checkpoint.
"""
import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ddp_tpu.config import get_config as jget_config
from ddp_tpu.nn import transformer as jtr
from ddp_tpu.train.torch_import import import_ddp_seg
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.evaluation.convergence import run
from ddp_tpu_torch.nn.swin import PatchMerging, swin_variant
from ddp_tpu_torch.train import torch_import as TI
from ddp_tpu_torch.train.loop import train
from ddp_tpu_torch.train.optim import make_optimizer
from ddp_tpu_torch.train.step import TrainState, make_train_step
from test_torch_port_segmentor import _jax_sample
from test_torch_port_train import _jax_model


def _tiny(heads=4):
    cfg = get_config("tiny_seg")
    return dataclasses.replace(cfg, name="tiny_seg_msda", model=dataclasses.replace(
        cfg.model, decoder_attn="msda", decoder_heads=heads, drop_path_rate=0.0))


def test_import_matches_jax_import():
    """The same mmseg state_dict through both importers and both forwards."""
    cfg = _tiny()
    m = cfg.model
    state = TI.synthetic_mmseg_state(m)
    jvars, jreport = import_ddp_seg(state, "swin", m.backbone_variant,
                                    decoder_layers=m.decoder_layers)
    assert jreport == {"missing": [], "unused": []}
    tm = build_model(m, device="cpu")
    report = TI.load_mmseg_state(tm, state, cfg)
    assert report == {"missing": [], "unused": []}

    jm = _jax_model(m)
    img = np.random.RandomState(1).randn(2, 64, 64, 3).astype(np.float32)
    want, j_noise, j_logits = _jax_sample(jm, jvars, img)
    aux_want = jax.jit(lambda v, x: jm.apply(
        v, x, method=lambda mod, x: mod.aux_head(mod.extract_feat(x))))(jvars, jnp.asarray(img))
    tcap = []
    denoise = tm.denoise_logits
    tm.denoise_logits = lambda *a: tcap.append(denoise(*a)) or tcap[-1]
    with torch.no_grad():
        got = tm.sample(torch.from_numpy(img), init_noise=torch.from_numpy(j_noise)).numpy()
        aux = tm.aux_head(tm.extract_feat(torch.from_numpy(img))).numpy()
    assert np.abs(j_logits).max() > 1.0  # the weights give logits of O(1), not ~0
    np.testing.assert_allclose(tcap[0].numpy(), j_logits, rtol=0, atol=1e-4)
    np.testing.assert_allclose(aux, np.asarray(aux_want), rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_patch_merging_matches_unfold():
    """mmseg's PatchMerging: NCHW ``F.unfold(kernel_size=2, stride=2)`` ->
    LayerNorm(4C) -> Linear(4C -> 2C), against the port's PatchMerging with
    the importer's permutation of the same weights."""
    torch.manual_seed(1)
    c, h, w = 6, 4, 6
    norm = torch.nn.LayerNorm(4 * c)
    red = torch.nn.Linear(4 * c, 2 * c, bias=False)
    with torch.no_grad():
        norm.weight.add_(torch.randn(4 * c) * 0.3)
        norm.bias.add_(torch.randn(4 * c) * 0.3)
    x = torch.randn(2, h, w, c)
    u = F.unfold(x.permute(0, 3, 1, 2), kernel_size=2, stride=2).transpose(1, 2)
    want = red(norm(u)).reshape(2, h // 2, w // 2, 2 * c)
    perm = torch.from_numpy(TI._merge_perm(c))
    pm = PatchMerging(c, 2 * c)
    pm.load_state_dict({"norm.weight": norm.weight[perm], "norm.bias": norm.bias[perm],
                        "reduction.weight": red.weight[:, perm]})
    with torch.no_grad():
        torch.testing.assert_close(pm(x), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("wrapped,gn", [(False, "bn"), (True, "gn")])
def test_load_mmseg_checkpoint_round_trip(tmp_path, wrapped, gn):
    """A bare state_dict with the neck's GN under ``.bn`` (as the JAX
    importer reads it), and mmseg's file layout with it under ``.gn`` (mmcv
    ConvModule's name for a GN)."""
    cfg = _tiny()
    state = {k: torch.from_numpy(v)
             for k, v in TI.synthetic_mmseg_state(cfg.model, gn=gn).items()}
    assert any(".gn." in k for k in state) == (gn == "gn")
    path = str(tmp_path / "ckpt.pth")
    torch.save({"meta": {"CLASSES": ["a", "b"]}, "state_dict": state} if wrapped else state,
               path)
    model, report = TI.load_mmseg_checkpoint(path, cfg, device="cpu")
    assert report == {"missing": [], "unused": []}
    sd = model.state_dict()
    want, _, source = TI.import_mmseg_seg(state, cfg.model)
    assert set(want) == set(sd)
    for key, value in want.items():
        assert torch.equal(sd[key], value), key
    a = "decode_head.encoder.layer1.attn.sampling_offsets.weight"
    assert source[a] == "decode_head.encoder.layers.1.attentions.0.sampling_offsets.weight"
    assert torch.equal(sd[a], state[source[a]])


def test_import_cli_writes_port_checkpoint(tmp_path, monkeypatch):
    """``python -m ddp_tpu_torch.train.torch_import CKPT --preset P --out DIR``
    (called in-process, on the CPU, with a tiny msda preset registered)
    writes DIR/ckpts/step_0.pt, which the checkpoint manager restores."""
    from ddp_tpu_torch import config as tconfig
    from ddp_tpu_torch.train.checkpoint import read_model

    cfg = _tiny()
    monkeypatch.setitem(tconfig.PRESETS, cfg.name, lambda: cfg)
    state = {k: torch.from_numpy(v) for k, v in TI.synthetic_mmseg_state(cfg.model).items()}
    torch.save({"state_dict": state}, str(tmp_path / "ckpt.pth"))
    out = str(tmp_path / "imported")
    assert TI.main([str(tmp_path / "ckpt.pth"), "--preset", cfg.name, "--out", out,
                    "--device", "cpu"]) == 0
    step, sd = read_model(out)
    want, _, _ = TI.import_mmseg_seg(state, cfg.model)
    assert step == 0 and set(sd) == set(want)
    for key, value in want.items():
        assert torch.equal(sd[key], value), key


def test_reference_fault_msda_override_keeps_four_heads():
    """ddp_tpu's ade20k_swin_t with the decoder_attn=msda override (what
    tools/import_checkpoint.py does) keeps the window preset's 4 heads, so
    its sampling_offsets kernel is [256, 32] where a reference checkpoint's
    is [8·1·4·2, 256] = [64, 256]. The port's ade20k_swin_t_msda has 8 heads
    and the matching shape; its loader refuses a 4-head model an 8-head
    checkpoint, naming the preset and the tensor."""
    jm = jget_config("ade20k_swin_t", {"model.decoder_attn": "msda"}).model
    assert jm.decoder_attn == "msda" and jm.decoder_heads == 4
    shapes = jax.eval_shape(lambda: jtr.DeformableAttention(256, jm.decoder_heads).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4, 256)), jnp.zeros((1, 4, 256)), None,
        jnp.zeros((4, 1, 2)), ((2, 2),)))
    assert shapes["params"]["sampling_offsets"]["kernel"].shape == (256, 32)

    pm = build_model(get_config("ade20k_swin_t_msda").model, device="meta")
    assert pm.decode_head.encoder.layer0.attn.num_heads == 8
    assert tuple(pm.state_dict()[
        "decode_head.encoder.layer0.attn.sampling_offsets.weight"].shape) == (64, 256)

    eight = _tiny(heads=8)
    state = TI.synthetic_mmseg_state(eight.model)
    four = _tiny(heads=4)
    with pytest.raises(ValueError, match=r"preset tiny_seg_msda: mmseg tensor "
                       r"decode_head\.encoder\.layers\.0\.attentions\.0\.sampling_offsets\.weight"
                       r" has shape \(64, 64\).*8 decoder heads, the preset 4"):
        TI.load_mmseg_state(build_model(four.model, device="cpu"), state, four)
    TI.load_mmseg_state(build_model(eight.model, device="cpu"), state, eight)


def test_importer_refuses_incomplete_and_convnext():
    cfg = _tiny()
    state = TI.synthetic_mmseg_state(cfg.model)
    state.pop("embedding_table.weight")
    state["decode_head.extra.weight"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match=r"embedding_table\.weight.*decode_head\.extra\.weight"):
        TI.load_mmseg_state(build_model(cfg.model, device="cpu"), state, cfg)
    # ConvNeXt imports since the Cityscapes slice: a ConvNeXt (mmcls)
    # checkpoint is refused by a Swin preset, naming what is missing
    convnext = dataclasses.replace(cfg.model, backbone_type="convnext")
    with pytest.raises(KeyError, match=r"backbone\.patch_embed\.projection\.weight"):
        TI.load_mmseg_state(build_model(cfg.model, device="cpu"),
                            TI.synthetic_mmseg_state(convnext), cfg)
    with pytest.raises(ValueError, match="unknown backbone 'vit'"):
        TI.import_mmseg_seg({}, dataclasses.replace(cfg.model, backbone_type="vit"))


def test_train_starts_from_init_params(tmp_path):
    """The first logged loss of train(init_params=sd) is that of a step from
    sd with the run's seeded generator; with 0 iterations the model is sd."""
    cfg = _tiny()
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, total_iters=1, log_interval=1, tensorboard=False, steps_per_dispatch=1,
        workdir=str(tmp_path / "run")))
    sd = build_model(cfg.model, device="cpu", seed=5).state_dict()
    state = train(cfg, make_train_iter(cfg), device="cpu", init_params=sd)
    with open(os.path.join(cfg.runtime.workdir, "train_log.jsonl")) as f:
        logged = json.loads(f.readline())["loss"]
    model = build_model(cfg.model, device="cpu", seed=5)
    ref = TrainState(model, make_optimizer(cfg.optim, model),
                     torch.Generator().manual_seed(cfg.runtime.seed))
    batch = {k: torch.from_numpy(v) for k, v in next(make_train_iter(cfg)).items()
             if k in ("image", "label")}
    _, logs = make_train_step(mixed_precision=cfg.runtime.mixed_precision).grads(ref, batch)
    assert logged == pytest.approx(logs["loss"].item(), rel=1e-6)
    assert state.step == 1
    zero = dataclasses.replace(cfg, runtime=dataclasses.replace(
        cfg.runtime, total_iters=0, workdir=str(tmp_path / "zero")))
    start = train(zero, make_train_iter(zero), device="cpu", init_params=sd)
    for key, value in start.model.state_dict().items():
        assert torch.equal(value, sd[key]), key


def test_aligned_run_refuses_missing_base_checkpoint(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError, match="converge_seg_msda"):
        run("converge_seg_aligned_msda", device="cpu")
    assert not os.path.exists(tmp_path / "work_dirs" / "torch_converge_seg_aligned_msda")


def test_msda_modules_import_no_jax():
    """The new modules and the import entry point load without jax, flax or
    ddp_tpu, and the CLI's --help runs."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, ddp_tpu_torch.ops.deform_attn, ddp_tpu_torch.train.torch_import, "
            "ddp_tpu_torch.nn.pos_embed, ddp_tpu_torch.nn.transformer; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ddp_tpu')); print(bad); "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=repo + os.pathsep + os.environ.get("PYTHONPATH", ""))
    for args in (["-c", code], ["-m", "ddp_tpu_torch.train.torch_import", "--help"]):
        proc = subprocess.run([sys.executable, *args], cwd=repo, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stdout + proc.stderr
