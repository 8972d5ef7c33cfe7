"""The torch port's serving slice against the JAX package, on the CPU.

  - Whole slice: the tiny preset's ``DDPSegmentor.sample`` (randsteps 2,
    3 DDIM steps) in both packages with the same weights and the same
    initial noise. JAX's PRNG cannot be reproduced in torch, so the noise
    JAX draws is captured from its first ``denoise_logits`` call and handed
    to the port.
  - Import hygiene: the port never imports jax, flax or ddp_tpu.
  - Bridge: every flax leaf of the segmentor maps to a torch entry of the
    right shape, and every torch entry is filled.
"""
import ast
import os
import subprocess
import sys

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.core.diffusion import DiffusionConfig as JDiffusionConfig
from ddp_tpu.models.segmentor import DDPSegmentor as JDDPSegmentor
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import check_complete, load_flax, params_from_flax
from torch_port_threads import _one_torch_thread  # noqa: F401


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_model(cfg):
    m = cfg.model
    d = m.diffusion
    return JDDPSegmentor(
        num_classes=m.num_classes, backbone_variant=m.backbone_variant,
        embed_dims=m.embed_dims, bit_scale=m.bit_scale, drop_path_rate=0.0,
        decoder_layers=m.decoder_layers, decoder_heads=m.decoder_heads,
        decoder_ffn_dim=m.decoder_ffn_dim, decoder_attn=m.decoder_attn,
        decoder_window=m.decoder_window,
        diffusion=JDiffusionConfig(timesteps=d.timesteps, randsteps=d.randsteps,
                                   accumulation=d.accumulation))


def _init(jm, hw):
    img = jnp.zeros((1,) + hw + (3,), jnp.float32)
    return jm.init({"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
                    "dropout": jax.random.PRNGKey(2)},
                   img, jnp.zeros((1,) + hw, jnp.int32), train=False)


def _jax_sample(jm, variables, img):
    """JAX ``sample`` plus the initial noise and step-1 logits it used.

    ``intercept_methods`` catches the first ``denoise_logits`` call; the
    captured arrays are returned from the traced function, so the whole
    call runs as one jitted program (seconds, where eager dispatch takes
    half a minute on the CPU)."""

    def run(variables, img):
        cap = {}

        def capture(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if context.method_name == "denoise_logits" and "noise" not in cap:
                cap["noise"], cap["logits"] = args[1], out
            return out

        with fnn.intercept_methods(capture):
            probs = jm.apply(variables, img, method=jm.sample,
                             rngs={"diffusion": jax.random.PRNGKey(7)})
        return probs, cap["noise"], cap["logits"]

    return [np.asarray(a) for a in jax.jit(run)(variables, jnp.asarray(img))]


@pytest.mark.parametrize("hw", [(64, 64), (56, 72)])
def test_sample_matches_jax(hw):
    """56x72 pads every Swin stage and the decoder grid (14x18) to the window.

    Step-1 logits compare tightly. Later steps re-embed an argmax, a
    discontinuous function of the logits, so the final probabilities are
    compared by value and by argmax agreement."""
    cfg = get_config("tiny_seg")
    jm = _jax_model(cfg)
    variables = jax.jit(lambda: _init(jm, hw))()
    img = np.random.RandomState(0).randn(2, *hw, 3).astype(np.float32)
    want, j_noise, j_logits = _jax_sample(jm, variables, img)

    tm = build_model(cfg.model, device="cpu")
    load_flax(tm, jax.tree_util.tree_map(np.asarray, variables["params"]),
              jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    tcap = []
    denoise = tm.denoise_logits
    tm.denoise_logits = lambda *a: tcap.append(denoise(*a)) or tcap[-1]
    got = tm.sample(torch.from_numpy(img), init_noise=torch.from_numpy(j_noise)).numpy()

    assert len(tcap) == cfg.model.diffusion.timesteps
    r = cfg.model.diffusion.randsteps
    assert tcap[0].shape == (r * 2, hw[0] // 4, hw[1] // 4, cfg.model.num_classes)
    # f32 on both sides; logits reach ~13, observed max difference ~4e-5
    np.testing.assert_allclose(tcap[0].numpy(), j_logits, rtol=0, atol=1e-4)
    assert got.shape == want.shape == (2, *hw, cfg.model.num_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


def test_smoke_serves_one_32px_image_as_jax():
    """``smoke`` on a single 32^2 image: the FPN's top level is 1 x 1 with
    one channel per GroupNorm group, where ``F.group_norm`` refuses; the
    port's step-1 logits are JAX's within 1e-4 (f32, the same weights)."""
    from ddp_tpu import config as jconfig

    cfg = get_config("smoke")
    jm = jconfig.build_model(jconfig.get_config("smoke").model)
    variables = jax.jit(lambda: _init(jm, (32, 32)))()
    img = np.random.RandomState(1).randn(1, 32, 32, 3).astype(np.float32)
    want, j_noise, j_logits = _jax_sample(jm, variables, img)

    tm = build_model(cfg.model, device="cpu", input_size=(32, 32))
    load_flax(tm, jax.tree_util.tree_map(np.asarray, variables["params"]),
              jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    tcap = []
    denoise = tm.denoise_logits
    tm.denoise_logits = lambda *a: tcap.append(denoise(*a)) or tcap[-1]
    got = tm.sample(torch.from_numpy(img), init_noise=torch.from_numpy(j_noise)).numpy()
    assert tcap[0].shape == j_logits.shape
    np.testing.assert_allclose(tcap[0].numpy(), j_logits, rtol=0, atol=1e-4)
    assert got.shape == want.shape == (1, 32, 32, cfg.model.num_classes)
    assert np.isfinite(got).all()


def test_port_imports_no_jax():
    code = ("import sys, ddp_tpu_torch, ddp_tpu_torch.models.segmentor, "
            "ddp_tpu_torch.config, ddp_tpu_torch.convert, ddp_tpu_torch.evaluation.batched, "
            "ddp_tpu_torch.evaluation.metrics, ddp_tpu_torch.ops._build, "
            "ddp_tpu_torch.ops.q_sample, ddp_tpu_torch.ops.upsample_ce, ddp_tpu_torch.nn.losses, "
            "ddp_tpu_torch.nn.common, ddp_tpu_torch.train.optim, ddp_tpu_torch.train.step, "
            "ddp_tpu_torch.train.checkpoint, ddp_tpu_torch.train.events, "
            "ddp_tpu_torch.train.loop, ddp_tpu_torch.data, ddp_tpu_torch.data.seg_datasets, "
            "ddp_tpu_torch.data.pipelines, ddp_tpu_torch.evaluation.convergence, "
            "ddp_tpu_torch.data.image_io, ddp_tpu_torch.nn.convnext, "
            "ddp_tpu_torch.evaluation.slide, ddp_tpu_torch.train.torch_import, "
            "ddp_tpu_torch.tools.train, ddp_tpu_torch.tools.test, ddp_tpu_torch.models.bev, "
            "ddp_tpu_torch.nn.bev, ddp_tpu_torch.ops.bev_pool, ddp_tpu_torch.data.bev_datasets, "
            "ddp_tpu_torch.data.transforms_3d, ddp_tpu_torch.models.depther, "
            "ddp_tpu_torch.nn.second, ddp_tpu_torch.nn.dla_vovnet, "
            "ddp_tpu_torch.tools.prepare_nuscenes, ddp_tpu_torch.tools.convert_datasets, "
            "ddp_tpu_torch.tools.browse_dataset, ddp_tpu_torch.tools.export; "
            # Pillow only inside read_image's JPEG branch, never at import;
            # flax's .msgpack files are read without the msgpack package
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'optax', 'ddp_tpu', 'PIL', 'msgpack')); print(bad); "
            # importing loads no CUDA library
            "sys.exit(1 if bad or ddp_tpu_torch.ops._build._lib is not None else 0)")
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_imports_no_jax():
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    assert not roots & {"jax", "jaxlib", "flax", "optax", "ddp_tpu"}, roots
    assert "ddp_tpu_torch" in roots


@pytest.mark.parametrize("preset", ["tiny_seg", "ade20k_swin_t"])
def test_bridge_is_complete(preset):
    """Every flax leaf has a torch home and every torch entry is filled.
    Trees come from jax.eval_shape and the torch model lives on the meta
    device, so nothing full-size is allocated."""
    cfg = get_config(preset)
    jm = _jax_model(cfg)
    shapes = jax.eval_shape(lambda: _init(jm, (64, 64)))

    def leaves(tree):
        return jax.tree_util.tree_map(
            lambda s: np.broadcast_to(np.zeros((), s.dtype), s.shape), tree)

    sd = params_from_flax(leaves(shapes["params"]), leaves(shapes["batch_stats"]))
    n_params = len(jax.tree_util.tree_leaves(shapes["params"]))
    n_stats = len(jax.tree_util.tree_leaves(shapes["batch_stats"]))
    # one entry per flax leaf, plus num_batches_tracked per BN (mean + var)
    assert len(sd) == n_params + n_stats + n_stats // 2
    check_complete(build_model(cfg.model, device="meta"), sd)


def test_bridge_rejects_unmapped_leaves():
    with pytest.raises(KeyError, match="no rule"):
        params_from_flax({"head": {"Dense_7": {"kernel": np.zeros((2, 3))}}})
    with pytest.raises(KeyError, match="no rule"):
        # ConvNeXt's layer scale "gamma" has a rule; "beta" has none
        params_from_flax({"head": {"conv": {"beta": np.zeros(3)}}})
    model = build_model(get_config("tiny_seg").model, device="meta")
    sd = {k: torch.empty(v.shape) for k, v in model.state_dict().items()}
    sd.pop("embedding_table.weight")
    with pytest.raises(KeyError, match="embedding_table.weight"):
        check_complete(model, sd)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(get_config("tiny_seg").model)
