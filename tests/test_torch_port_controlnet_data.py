"""The port's ControlNet data, EMA, SD import and entry points on the CPU,
against the JAX package where it has a counterpart.

  - The toy tokenizer, ``SyntheticFill50k``, ``Fill50kDataset`` on
    tests/data/fill50k (native 64² and resized through Pillow),
    ``controlnet_batch_iterator`` (epoch wrap, rank slices) and
    ``make_train_iter`` of ``converge_controlnet`` and ``controlnet_sd15``:
    bitwise JAX's; an empty fill50k tree raises FileNotFoundError.
  - ``device_fill50k_batch``: its renderer gives ``SyntheticFill50k``'s
    pixels bitwise for the same drawn parameters (geometry in float64), and
    its ids name the colours it drew.
  - ``ema_update`` over several steps against JAX's (5e-7: 2 float32 ulps at
    the parameters' scale of ~2; XLA fuses the update's multiply-adds).
  - ``import_sd_controlldm`` on a seeded random cldm-layout state_dict
    against JAX's importer through ``convert.py``: bitwise, nothing missing
    or unused on either side, and a strict load.
  - ``python -m ddp_tpu_torch.tools.train`` (a tiny ``converge_controlnet``),
    ``tools.control_demo`` on its checkpoint and ``scale.json``, and the end
    check's ``run_controlnet`` cut to a few steps, in-process with
    ``--device cpu``; the test CLI refuses the task, as JAX's has no branch.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from ddp_tpu import config as jconfig
from ddp_tpu.data import controlnet_data as jdata
from ddp_tpu.data import make_train_iter as jmake_train_iter
from ddp_tpu.train import ema as jema
from ddp_tpu.train import torch_import as jimport
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import params_from_flax
from ddp_tpu_torch.data import controlnet_data as tdata
from ddp_tpu_torch.data import make_train_iter
from ddp_tpu_torch.train import ema as tema
from ddp_tpu_torch.train import torch_import as timport
from torch_port_threads import _one_torch_thread  # noqa: F401

FILL50K = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "fill50k")
TINY = {"model.cn_size": "tiny", "model.cn_image_size": "32", "data.batch_size": "2",
        "runtime.total_iters": "4", "runtime.steps_per_dispatch": "2",
        "runtime.log_interval": "2", "runtime.ckpt_interval": "4", "optim.total_steps": "4",
        "optim.warmup_steps": "1"}


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("prompt", ["red circle with blue background", "",
                                    "Teal CIRCLE with unknown words background"])
def test_tokenize_matches_jax(prompt):
    assert tdata.VOCAB == jdata.VOCAB and tdata.COLORS == jdata.COLORS
    got, want = tdata.tokenize(prompt), jdata.tokenize(prompt)
    assert got.dtype == want.dtype == np.int32 and np.array_equal(got, want)
    assert np.array_equal(tdata.tokenize(" ".join(["red"] * 90)),
                          jdata.tokenize(" ".join(["red"] * 90)))


@pytest.mark.parametrize("size", [64, 32, 512])
def test_synthetic_fill50k_matches_jax(size):
    port, ref = tdata.SyntheticFill50k(size=size), jdata.SyntheticFill50k(size=size)
    for idx in (0, 7, 100_003):
        _equal(port.load(idx), ref.load(idx))


@pytest.mark.parametrize("size", [64, 32])
def test_fill50k_dataset_matches_jax(size):
    port, ref = tdata.Fill50kDataset(FILL50K, size), jdata.Fill50kDataset(FILL50K, size)
    assert len(port) == len(ref) == 2
    for idx in range(2):
        _equal(port.load(idx), ref.load(idx))
    assert len(tdata.Fill50kDataset(os.path.dirname(FILL50K))) == 0


def test_batch_iterator_matches_jax():
    port_ds, ref_ds = tdata.SyntheticFill50k(size=16, length=5), \
        jdata.SyntheticFill50k(size=16, length=5)
    for rank in (0, 1):
        port = tdata.controlnet_batch_iterator(port_ds, 4, seed=3, rank=rank, world=2)
        ref = jdata.controlnet_batch_iterator(ref_ds, 4, seed=3, rank=rank, world=2)
        for _ in range(4):  # wraps into epochs 1 and 2
            _equal(next(port), next(ref))


@pytest.mark.parametrize("preset,overrides", [
    ("converge_controlnet", {}),
    ("controlnet_sd15", {"data.data_root": FILL50K}),
    ("controlnet_sd15", {"data.data_root": FILL50K, "model.cn_image_size": "48"})])
def test_make_train_iter_matches_jax(preset, overrides):
    overrides = dict(overrides, **{"data.batch_size": "2"})
    port = make_train_iter(get_config(preset, overrides))
    ref = jmake_train_iter(jconfig.get_config(preset, overrides))
    for _ in range(2):
        _equal(next(port), next(ref))


def test_make_train_iter_refuses_an_empty_tree(tmp_path):
    with pytest.raises(FileNotFoundError, match="fill50k"):
        make_train_iter(get_config("controlnet_sd15", {"data.data_root": str(tmp_path)}))


@pytest.mark.parametrize("size", [64, 512])
def test_device_batch_renders_the_synthetic_pairs(size):
    """Fed ``SyntheticFill50k``'s drawn parameters (its geometry in float64, as
    numpy computes it), the renderer gives its pixels and ids bitwise; the
    float32 geometry of the card moves at most the pixels on a boundary."""
    ref = tdata.SyntheticFill50k(size=size)
    idxs = (0, 5, 100_001)
    params = [ref.params(i, size) for i in idxs]
    fill = torch.tensor([p[0] for p in params])
    bg = torch.tensor([p[1] for p in params])
    cxy = torch.tensor([p[2] for p in params], dtype=torch.float64)
    rad = torch.tensor([p[3] for p in params], dtype=torch.float64)
    want = [ref.load(i) for i in idxs]
    for dtype in (torch.float64, torch.float32):
        img, hint, ids = tdata.render_fill50k(fill, bg, cxy, rad, size, dtype=dtype)
        assert np.array_equal(ids.numpy(), np.stack([w["ids"] for w in want]))
        if dtype == torch.float64:
            assert np.array_equal(img.numpy(), np.stack([w["image"] for w in want]))
            assert np.array_equal(hint.numpy(), np.stack([w["hint"] for w in want]))
        else:
            moved = (img.numpy() != np.stack([w["image"] for w in want])).any(-1).mean()
            assert moved < 0.01, moved


def test_device_fill50k_batch_draws_named_colours():
    img, hint, ids = tdata.device_fill50k_batch(torch.Generator().manual_seed(0), 16, 64)
    assert img.shape == hint.shape == (16, 64, 64, 3) and ids.shape == (16, 77)
    assert img.dtype == hint.dtype == torch.float32 and ids.dtype == torch.int32
    assert set(hint.unique().tolist()) <= {0.0, 1.0}
    palette = np.asarray([rgb for _, rgb in tdata.COLORS], np.float32) / 127.5 - 1.0
    c0 = tdata.VOCAB["red"]
    for b in range(16):
        fill, bg = int(ids[b, 1]) - c0, int(ids[b, 4]) - c0
        assert fill != bg
        assert np.array_equal(img[b, 0, 0].numpy(), palette[bg])  # a corner: background
        center = img[b].reshape(-1, 3).numpy()
        assert (np.abs(center - palette[fill]).max(-1) == 0).any()
        assert np.array_equal(ids[b].numpy(), tdata.tokenize(
            f"{tdata.COLORS[fill][0]} circle with {tdata.COLORS[bg][0]} background"))


def test_ema_matches_jax():
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(4, 3).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    j_state = jema.ema_init({k: jax.numpy.asarray(v) for k, v in params.items()})
    t_state = tema.ema_init({k: torch.from_numpy(v) for k, v in params.items()})
    upd = jax.jit(jema.ema_update, static_argnames="decay")
    for step in range(12):
        new = {k: (v + rng.randn(*v.shape)).astype(np.float32) for k, v in params.items()}
        decay = 0.9999 if step < 6 else 0.5
        j_state = upd(j_state, {k: jax.numpy.asarray(v) for k, v in new.items()}, decay=decay)
        t_state = tema.ema_update(t_state, {k: torch.from_numpy(v) for k, v in new.items()},
                                  decay=decay)
        assert t_state[1] == int(j_state[1]) == step + 1
        for k in params:
            np.testing.assert_allclose(t_state[0][k].numpy(), np.asarray(j_state[0][k]),
                                       rtol=0, atol=5e-7)


def test_import_sd_controlldm_matches_jax():
    mc = get_config("converge_controlnet", {"model.cn_size": "tiny"}).model
    model = build_model(mc, device="cpu")
    state = timport.synthetic_sd_state(model, seed=3)
    unet = model.unet_cfg
    kw = dict(clip_layers=2, vae_ch=mc.cn_vae_ch, vae_ch_mult=tuple(mc.cn_vae_mult),
              vae_nrb=mc.cn_vae_nrb)
    sd, report = timport.import_sd_controlldm(state, unet, **kw)
    assert report == {"missing": [], "unused": []}
    imp_state = dict(state)
    tree = jimport.import_sd_controlldm(imp_state, unet, **kw, strict=True)
    want = params_from_flax(tree)
    assert set(sd) == set(want) == set(model.state_dict())
    for k in want:
        assert torch.equal(sd[k], want[k]), k
    assert timport.load_sd_controlldm(model, state) == report
    assert torch.equal(model.state_dict()["cond_stage_model.position_embedding"],
                       torch.from_numpy(state["cond_stage_model.transformer.text_model."
                                              "embeddings.position_embedding.weight"]))
    broken = dict(state)
    broken.pop("control_model.zero_convs.0.0.weight")
    broken["model.diffusion_model.extra.weight"] = np.zeros(1, np.float32)
    with pytest.raises(KeyError, match="zero_convs.0.0.weight"):
        timport.load_sd_controlldm(model, broken)


def _tiny_cfg(workdir):
    return dict(TINY, **{"runtime.workdir": workdir})


def test_train_cli_and_control_demo(tmp_path):
    from ddp_tpu_torch.tools import control_demo, train as train_cli
    from ddp_tpu_torch.tools import test as test_cli

    workdir = str(tmp_path / "cn")
    sets = [f"{k}={v}" for k, v in TINY.items()]
    assert train_cli.main(["converge_controlnet", "--device", "cpu", "--workdir", workdir,
                           "--set", *sets]) == 0
    logs = [json.loads(line) for line in open(os.path.join(workdir, "train_log.jsonl"))]
    assert [r["step"] for r in logs] == [1, 2, 4]
    assert all(np.isfinite(r["loss"]) and r["loss"] > 0 for r in logs)
    with open(os.path.join(workdir, "scale.json"), "w") as f:
        json.dump({"cn_scale_factor": 0.5}, f)
    out = str(tmp_path / "demo.png")
    assert control_demo.main(["--preset", "converge_controlnet", "--workdir", workdir,
                              "--index", "3", "--num-samples", "2", "--steps", "2",
                              "--device", "cpu", "--out", out, "--set",
                              "model.cn_size=tiny", "model.cn_image_size=32"]) == 0
    from PIL import Image

    assert np.asarray(Image.open(out)).shape == (32, 64, 3)
    with pytest.raises(SystemExit, match="no test CLI"):
        test_cli.main(["converge_controlnet", "--device", "cpu", "--workdir", workdir])


def test_control_demo_refuses_the_cpu_fallback():
    from ddp_tpu_torch.tools import control_demo

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        control_demo.main(["--set", "model.cn_size=tiny"])


def test_end_check_runs_cut_short(tmp_path):
    """``run_controlnet`` at the tiny scale, 3 VAE steps and 4 train steps
    (2 chunks): scale.json, a checkpoint, and PSNR / MAE of 8 held-out
    hints."""
    from ddp_tpu_torch.evaluation import convergence

    cfg = get_config("converge_controlnet", _tiny_cfg(str(tmp_path)))
    result = convergence.run_controlnet(cfg, device="cpu", vae_iters=3)
    assert set(result) >= {"psnr_db", "mae", "cfg_scale", "ddim_steps", "cn_scale_factor"}
    assert result["ddim_steps"] == 20 and result["cfg_scale"] == 1.0
    assert 0 < result["mae"] <= 2 and np.isfinite(result["psnr_db"])
    with open(tmp_path / "scale.json") as f:
        saved = json.load(f)
    assert saved == {"cn_scale_factor": result["cn_scale_factor"], "step": 4}
    assert os.path.exists(tmp_path / "ckpts" / "step_4.pt")
    assert os.path.exists(result["samples_png"])
