"""The port's slide inference (``ddp_tpu_torch/evaluation/slide.py``)
against the JAX package's, on the CPU.

  - ``slide_grid`` equals JAX's for images smaller than, equal to and larger
    than the crop, strides that do and do not divide.
  - ``slide_inference`` on a linear ``predict_fn`` (a fixed per-pixel
    3 -> K map plus a bias that depends on the column, so a crop's place
    matters), for overlapping crops, a crop larger than the image and
    crops that meet without overlap: float32, atol 1e-5.
  - ``slide_inference`` of the ``smoke`` segmentor's ``sample`` (the same
    weights; every rollout starts from the same noise, a numpy draw of its
    shape, in both packages): atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.config import build_model as jbuild_model
from ddp_tpu.config import get_config as jget_config
from ddp_tpu.evaluation import slide as jslide
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import load_flax
from ddp_tpu_torch.evaluation import slide as tslide

K = 5


@pytest.mark.parametrize("h,w,crop,stride", [
    (1024, 2048, (1024, 1024), (768, 768)),  # Cityscapes: 3 crops
    (48, 96, (32, 64), (16, 32)),
    (30, 50, (32, 64), (16, 32)),  # smaller than the crop
    (100, 77, (40, 40), (40, 40)),  # stride = crop, ragged end
    (64, 64, (64, 64), (48, 48)),
])
def test_slide_grid_matches_jax(h, w, crop, stride):
    assert tslide.slide_grid(h, w, crop, stride) == jslide.slide_grid(h, w, crop, stride)


def _linear(rng):
    m = rng.randn(3, K).astype(np.float32)

    def fn_np(x, xp):
        cols = xp.arange(x.shape[2], dtype=x.dtype)[None, None, :, None]
        return x @ (xp.asarray(m) if xp is jnp else torch.from_numpy(m)) + 0.01 * cols

    return (lambda x: fn_np(x, jnp)), (lambda x: fn_np(x, torch))


def _close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=atol)


@pytest.mark.parametrize("crop,stride", [
    ((32, 64), (16, 32)),  # overlapping crops
    ((64, 128), (16, 32)),  # a crop larger than the image
    ((24, 48), (24, 48)),  # crops that meet without overlap
    ((40, 40), (16, 56)),  # a ragged last crop in both axes
])
def test_slide_inference_linear_matches_jax(crop, stride):
    rng = np.random.RandomState(0)
    img = rng.randn(2, 48, 96, 3).astype(np.float32)
    jfn, tfn = _linear(rng)
    want = jax.jit(lambda x: jslide.slide_inference(jfn, x, K, crop, stride))(jnp.asarray(img))
    _close(tslide.slide_inference(tfn, torch.from_numpy(img), K, crop, stride), want, 1e-5)


@pytest.fixture(scope="module")
def smoke_models():
    cfg = get_config("smoke")
    jm = jbuild_model(jget_config("smoke").model)
    variables = jax.jit(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
         "dropout": jax.random.PRNGKey(2)},
        jnp.zeros((1, 32, 64, 3)), jnp.zeros((1, 32, 64), jnp.int32), train=False))()
    tm = build_model(cfg.model, device="cpu")
    load_flax(tm, jax.tree_util.tree_map(np.asarray, variables["params"]),
              jax.tree_util.tree_map(np.asarray, variables["batch_stats"]))
    return jm, variables, tm


def _noise(shape):
    return np.random.RandomState(int(np.prod(shape)) % 2 ** 31).randn(*shape).astype(np.float32)


def test_slide_of_the_model_matches_jax(smoke_models, monkeypatch):
    """The rollout's initial noise in JAX is ``jax.random.normal`` of the
    latent shape; both packages get ``_noise`` of it instead."""
    jm, variables, tm = smoke_models
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.asarray(_noise(shape), dtype))
    img = np.random.RandomState(4).randn(1, 48, 96, 3).astype(np.float32)

    def jfn(x):
        return jm.apply(variables, x, method=jm.sample, rngs={"diffusion": jax.random.PRNGKey(0)})

    def tfn(x):
        b, h, w, _ = x.shape
        shape = (tm.diffusion.randsteps * b, h // 4, w // 4, tm.embed_dims)
        return tm.sample(x, init_noise=torch.from_numpy(_noise(shape)))

    ji, ti = jnp.asarray(img), torch.from_numpy(img)
    want = jax.jit(lambda x: jslide.slide_inference(jfn, x, 7, (32, 64), (16, 32)))(ji)
    got = tslide.slide_inference(tfn, ti, 7, (32, 64), (16, 32))
    assert got.shape == (1, 48, 96, 7)
    _close(got, want, 1e-4)
