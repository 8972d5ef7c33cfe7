"""The port's configuration surface and its train / test entry points, on
the CPU.

  - Presets field by field against ``ddp_tpu.config``: every preset the
    two packages share (the Cityscapes ConvNeXt and Swin families, the
    aligned fine-tunes, ``smoke``, the ADE20K Swin family, the end-check
    presets, the NYUv2 and KITTI Swin depthers, the BEV camera and fusion
    presets, the ControlNet ones; the
    end checks' workdirs differ on purpose, ``work_dirs/torch_*``); every
    field of the port's dataclasses exists in the JAX package's.
  - The dataclasses' defaults field by field: the same fields but those
    still to port (named in ``NOT_PORTED``: the data loader's worker count),
    the same values.
  - ``load_yaml_overlay`` (the port's YAML subset reader) against JAX's on
    overlays the tests write; what the reader does not read raises, naming
    the line; the train CLI's ``--yaml``.
  - ``get_config`` overrides coerced as the JAX package coerces them
    (bools, ints, floats, tuples, nested dataclasses); an unknown key raises
    in both.
  - ``python -m ddp_tpu_torch.tools.train`` and ``python -m
    ddp_tpu_torch.tools.test`` (called in-process) on tests/data/cityscapes
    with ``--device cpu``: the run logs and checkpoints, the evaluator
    restores it and prints the JAX tool's aAcc / mIoU / mAcc line in whole
    and slide modes, ``--uncertainty`` in whole mode only; without
    ``--device`` and without a GPU both refuse to run on the CPU.
"""
import dataclasses
import json
import os
import re

import pytest
import torch

from ddp_tpu import config as jconfig
from ddp_tpu_torch import config as tconfig
from ddp_tpu_torch.tools import test as test_cli
from ddp_tpu_torch.tools import train as train_cli
from torch_port_threads import _one_torch_thread  # noqa: F401


DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "cityscapes")
SHARED = sorted(set(tconfig.PRESETS) & set(jconfig.PRESETS))


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


def test_presets_match_jax_field_by_field():
    assert {"cityscapes_convnext_t", "cityscapes_convnext_s", "cityscapes_convnext_b",
            "cityscapes_convnext_l", "cityscapes_swin_t", "cityscapes_swin_l",
            "cityscapes_convnext_t_aligned", "cityscapes_convnext_l_aligned", "smoke",
            "ade20k_swin_t", "ade20k_swin_s", "ade20k_swin_b", "ade20k_swin_l",
            "converge_seg_window", "converge_seg_msda", "converge_seg_quarter",
            "converge_seg_w16h4", "converge_depth", "nuscenes_camera", "converge_bev",
            "smoke_bev", "nuscenes_fusion", "converge_bev_fusion", "smoke_fusion",
            "converge_controlnet", "controlnet_sd15",
            *(f"{d}_swin_{v}" for d in ("nyu", "kitti") for v in "tsbl")
            } <= set(SHARED)
    for name in SHARED:
        port, ref = _fields(tconfig.get_config(name)), _fields(jconfig.get_config(name))
        missing = sorted(set(port) - set(ref))
        assert not missing, (name, missing)
        diff = {k: (v, ref[k]) for k, v in port.items() if v != ref[k]}
        if name.startswith("converge_"):
            assert diff.pop("runtime.workdir")[0] == f"work_dirs/torch_{name}"
        assert not diff, (name, diff)
    city = tconfig.get_config("cityscapes_convnext_t")
    assert (city.model.num_classes, city.data.crop_size, city.data.batch_size,
            city.model.drop_path_rate, city.model.decoder_window,
            city.model.decoder_heads) == (19, (512, 1024), 16, 0.4, 16, 4)


# the JAX fields whose slices are still to port: none (DataConfig's
# num_workers is a field of both, read by neither package's loader)
NOT_PORTED = {
    "ModelConfig": set(),
    "DataConfig": set(), "OptimConfig": set(), "RuntimeConfig": set()}


@pytest.mark.parametrize("cls", sorted(NOT_PORTED))
def test_defaults_match_jax_field_by_field(cls):
    """Each config dataclass built with no arguments in both packages: the
    same fields but those still to port, each with the same default (the
    port's decoder_attn is JAX's 'msda')."""
    port, ref = getattr(tconfig, cls)(), getattr(jconfig, cls)()
    pf, rf = _fields(port), _fields(ref)
    skipped = {k for k in rf if k.split(".")[0] in NOT_PORTED[cls]}
    assert skipped == NOT_PORTED[cls]  # each named field is a JAX field
    assert set(pf) == set(rf) - skipped
    assert {k: v for k, v in pf.items() if v != rf[k]} == {}
    if cls == "ModelConfig":
        assert port.decoder_attn == ref.decoder_attn == "msda"


@pytest.mark.parametrize("key,value", [
    ("model.self_aligned", "true"), ("model.self_aligned", "yes"), ("model.num_classes", "7"),
    ("model.bit_scale", "0.1"), ("data.crop_size", "(48,96)"), ("data.crop_size", "[64, 64]"),
    ("data.mean", "1,2,3"), ("model.diffusion.timesteps", "5"),
    ("model.diffusion.sample_range", "(0.0,0.5)"), ("runtime.test_mode", "slide"),
    ("runtime.test_crop", "(32,64)"), ("data.data_root", "tests/data/cityscapes"),
    ("optim.lr", "1e-4"), ("model.decoder_attn", "msda")])
def test_overrides_coerce_as_jax(key, value):
    port = _fields(tconfig.get_config("cityscapes_convnext_t", {key: value}))
    ref = _fields(jconfig.get_config("cityscapes_convnext_t", {key: value}))
    assert port[key] == ref[key] and type(port[key]) is type(ref[key])
    assert port[key] != _fields(tconfig.get_config("cityscapes_convnext_t"))[key]


@pytest.mark.parametrize("key", ["model.not_a_field", "runtime.seed.deeper"])
def test_unknown_override_raises_as_jax(key):
    with pytest.raises((AttributeError, KeyError)) as want:
        jconfig.get_config("smoke", {key: "1"})
    with pytest.raises(want.type):
        tconfig.get_config("smoke", {key: "1"})
    with pytest.raises(KeyError, match="unknown preset"):
        tconfig.get_config("cityscapes_convnext_x")


YAML_OVERLAYS = {
    "nested": """# a comment line
model:
  num_classes: 19   # a trailing comment
  bit_scale: 0.1
  decoder_attn: 'msda'
  diffusion:
    timesteps: 5
    sample_range: [0.0, 0.5]
data:
  crop_size: [48, 96]
  data_root: "tests/data/cityscapes"
  mean: [1, 2.5, 3]
optim:
  lr: 1e-4
  weight_decay: 5.0e-3
runtime:
  test_mode: slide
""",
    "dotted": """model.self_aligned: true
model.drop_path_rate: 0.25
runtime.total_iters: 40
runtime.mixed_precision: false
'data.dataset': cityscapes
data.batch_size: +3
optim.layer_decay_rate: null
""",
    "empty": "# nothing but a comment\n\n",
}


@pytest.mark.parametrize("name", sorted(YAML_OVERLAYS))
def test_yaml_overlay_matches_jax(name, tmp_path):
    """The port's YAML reader (no PyYAML) against the JAX package's
    ``load_yaml_overlay`` (PyYAML's ``safe_load``) on the same file: the
    overlaid configs equal field by field, in value and type."""
    path = str(tmp_path / "overlay.yaml")
    with open(path, "w") as f:
        f.write(YAML_OVERLAYS[name])
    port = _fields(tconfig.load_yaml_overlay(tconfig.get_config("smoke"), path))
    ref = _fields(jconfig.load_yaml_overlay(jconfig.get_config("smoke"), path))
    assert set(port) <= set(ref)
    diff = {k: (v, ref[k]) for k, v in port.items()
            if v != ref[k] or type(v) is not type(ref[k])}
    assert not diff
    if name != "empty":
        assert port != _fields(tconfig.get_config("smoke"))


@pytest.mark.parametrize("text,line", [
    ("model:\n  num_classes: 19\n   bit_scale: 0.1\n", 3),
    ("model:\n  - 1\n", 2), ("a: {b: 1}\n", 1), ("a: &x 1\n", 1), ("a: yes\n", 1),
    ("a: |\n  text\n", 1), ("a: [1, [2]]\n", 1), ("a: 'open\n", 1), ("---\na: 1\n", 1),
    ("model:\n\tnum_classes: 3\n", 2), ("just text\n", 1)])
def test_yaml_reader_refuses_what_it_does_not_read(text, line):
    with pytest.raises(ValueError, match=rf"overlay\.yaml:{line}: "):
        tconfig.parse_yaml_subset(text, "overlay.yaml")


def test_train_cli_reads_the_yaml_overlay(tmp_path, monkeypatch):
    """``--yaml`` overlays the preset, then ``--set`` overrides it."""
    path = str(tmp_path / "o.yaml")
    with open(path, "w") as f:
        f.write("runtime:\n  total_iters: 3\n  seed: 4\noptim:\n  lr: 2.0e-3\n")
    seen = {}
    monkeypatch.setattr("ddp_tpu_torch.train.loop.train",
                        lambda cfg, it, resume, device: seen.update(cfg=cfg))
    assert train_cli.main(["smoke", "--device", "cpu", "--workdir", str(tmp_path / "w"),
                           "--yaml", path, "--set", "runtime.seed=5"]) == 0
    cfg = seen["cfg"]
    assert (cfg.runtime.total_iters, cfg.runtime.seed, cfg.optim.lr) == (3, 5, 2e-3)


SETS = ["data.dataset=cityscapes", f"data.data_root={DATA}", "model.num_classes=19"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """4 iterations of smoke on the tiny Cityscapes files, 2 per dispatch."""
    workdir = str(tmp_path_factory.mktemp("smoke_city"))
    assert train_cli.main(["smoke", "--workdir", workdir, "--device", "cpu", "--set", *SETS,
                           "runtime.total_iters=4", "runtime.steps_per_dispatch=2",
                           "runtime.log_interval=2", "runtime.ckpt_interval=4",
                           "runtime.tensorboard=false", "optim.total_steps=4",
                           "data.batch_size=2"]) == 0
    return workdir


def test_train_cli_logs_and_checkpoints(trained):
    with open(os.path.join(trained, "train_log.jsonl")) as f:
        logs = [json.loads(line) for line in f]
    assert [r["step"] for r in logs] == [1, 2, 4]
    assert all(r["loss"] == r["loss"] for r in logs)
    assert os.listdir(os.path.join(trained, "ckpts")) == ["step_4.pt"]


LINE = re.compile(r"^\[seed (\d)\] aAcc [\d.]+ \| mIoU ([\d.]+) \| mAcc [\d.]+  \(n=2\)$", re.M)


@pytest.mark.parametrize("mode", ["whole", "slide"])
def test_test_cli_prints_miou(trained, mode, capsys):
    extra = ["runtime.test_mode=slide", "runtime.test_crop=(32,64)",
             "runtime.test_stride=(16,32)"] if mode == "slide" else []
    assert test_cli.main(["smoke", "--workdir", trained, "--device", "cpu", "--seeds", "2",
                          "--set", *SETS, *extra]) == 0
    out = capsys.readouterr().out
    assert f"restored step 4 from {trained}" in out
    assert [m.group(1) for m in LINE.finditer(out)] == ["0", "1"]
    assert "seed-averaged mIoU" in out


def test_test_cli_uncertainty_and_step(trained, capsys):
    assert test_cli.main(["smoke", "--workdir", trained, "--device", "cpu", "--step", "4",
                          "--uncertainty", "--limit", "1", "--set", *SETS,
                          "model.diffusion.randsteps=2"]) == 0
    out = capsys.readouterr().out
    assert "mean ensemble variance" in out and "(n=1)" in out
    with pytest.raises(SystemExit, match="whole-image mode only"):
        test_cli.main(["smoke", "--workdir", trained, "--device", "cpu", "--uncertainty",
                       "--set", *SETS, "runtime.test_mode=slide"])
    with pytest.raises(FileNotFoundError, match="step 3"):
        test_cli.main(["smoke", "--workdir", trained, "--device", "cpu", "--step", "3",
                       "--set", *SETS])


def test_entry_points_refuse_the_cpu_by_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["smoke", "--workdir", str(tmp_path), "--set", *SETS])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        test_cli.main(["smoke", "--workdir", str(tmp_path), "--set", *SETS])
