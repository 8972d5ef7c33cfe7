"""Fused upsample + cross-entropy of the torch port vs the JAX package.

The port's ``upsample_ce`` runs its plain versions on CPU tensors (forward
``upsample_ce_fwd_plain``, backward the written-out phase backward
``upsample_ce_grad_plain``); it is held to ``fused_upsample_ce`` run as the
JAX package's own kernel tests run it, through the Pallas interpreter
(``DDP_TPU_FUSED_CE=interpret``), and to the XLA oracle
``cross_entropy_seg_upsampled``: values, accuracy and gradients. The CUDA
kernels themselves are held to the plain versions on the card (``cuda``
marker here, and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.nn.losses import cross_entropy_seg_upsampled as jax_oracle
from ddp_tpu_torch.nn.losses import cross_entropy_seg_upsampled
from ddp_tpu_torch.ops import upsample_ce as U
from torch_port_threads import _one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    # set for the whole test so that the custom_vjp backward also sees it
    monkeypatch.setenv("DDP_TPU_FUSED_CE", "interpret")


def _jax_fused(logits, labels, scale, with_acc=False):
    from ddp_tpu.ops.pallas.upsample_ce import fused_upsample_ce

    return fused_upsample_ce(logits, labels, scale, with_acc=with_acc)


def _data(b, h, w, k, scale, seed, ignore_block=True):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, h, w, k).astype(np.float32)
    labels = rng.randint(0, k, (b, scale * h, scale * w)).astype(np.int64)
    if ignore_block:
        labels[0, :3, :5] = 255
    return logits, labels


def _torch_value_and_grad(logits, labels, scale, with_acc=False):
    x = torch.from_numpy(logits).requires_grad_(True)
    out = U.upsample_ce(x, torch.from_numpy(labels), scale, with_acc=with_acc)
    loss = out[0] if with_acc else out
    loss.backward()
    return out, x.grad.numpy()


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("h,w,k", [(8, 16, 7), (12, 16, 19), (10, 16, 6)])
def test_value_and_grad_match_pallas(scale, h, w, k):
    """(10, 16, 6) is the Pallas kernel's row-padding case (h % 8 != 0)."""
    logits, labels = _data(2, h, w, k, scale, seed=h + k)
    l_jax, g_jax = jax.value_and_grad(
        lambda lg: _jax_fused(lg, jnp.asarray(labels, jnp.int32), scale))(jnp.asarray(logits))
    loss, grad = _torch_value_and_grad(logits, labels, scale)
    np.testing.assert_allclose(loss.item(), float(l_jax), rtol=1e-5)
    np.testing.assert_allclose(grad, np.asarray(g_jax), rtol=1e-4, atol=1e-6)


def test_value_and_grad_match_xla_oracle():
    logits, labels = _data(2, 8, 16, 7, 4, seed=5)
    l_jax, g_jax = jax.value_and_grad(
        lambda lg: jax_oracle(lg, jnp.asarray(labels, jnp.int32), 4))(jnp.asarray(logits))
    loss, grad = _torch_value_and_grad(logits, labels, 4)
    np.testing.assert_allclose(loss.item(), float(l_jax), rtol=1e-5)
    np.testing.assert_allclose(grad, np.asarray(g_jax), rtol=1e-4, atol=1e-6)


def test_accuracy_matches_pallas_and_oracle():
    """Random float logits have no ties, where the two accuracy rules differ."""
    rng = np.random.RandomState(1)
    logits = rng.randn(1, 8, 8, 5).astype(np.float32)
    labels = rng.randint(0, 5, (1, 32, 32)).astype(np.int64)
    labels[0, -3:, :] = 255
    _, acc_pallas = _jax_fused(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), 4,
                               with_acc=True)
    _, acc_xla = jax_oracle(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), 4,
                            with_acc=True)
    (_, acc), _ = _torch_value_and_grad(logits, labels, 4, with_acc=True)
    np.testing.assert_allclose(float(acc), float(acc_pallas), atol=1e-6)
    np.testing.assert_allclose(float(acc), float(acc_xla), atol=1e-6)
    loss, acc2 = cross_entropy_seg_upsampled(torch.from_numpy(logits),
                                             torch.from_numpy(labels), 4, with_acc=True)
    np.testing.assert_allclose(float(acc2), float(acc_xla), atol=1e-6)


def test_out_of_range_label_reference_discrepancy():
    """Reference fault (ROADMAP queue 3): for a valid label outside [0, K)
    the Pallas kernel adds lse − 0 to the NLL (its one-hot is all zero),
    while the XLA oracle adds 0. The port follows the Pallas kernel."""
    rng = np.random.RandomState(4)
    logits = rng.randn(1, 4, 8, 7).astype(np.float32)
    labels = rng.randint(0, 7, (1, 8, 16)).astype(np.int64)
    labels[0, -1, :] = 7 + 3  # one row of valid labels at K + 3
    lab_j = jnp.asarray(labels, jnp.int32)
    pallas = float(_jax_fused(jnp.asarray(logits), lab_j, 2))
    oracle = float(jax_oracle(jnp.asarray(logits), lab_j, 2))
    port = U.upsample_ce(torch.from_numpy(logits), torch.from_numpy(labels), 2).item()
    # the two references differ by that row's log-sum-exp over labels.size
    _, lse = U.upsample_ce_fwd_plain(torch.from_numpy(logits), torch.from_numpy(labels), 2)
    np.testing.assert_allclose(pallas - oracle, lse[0, -1].sum().item() / labels.size,
                               rtol=1e-4)
    assert pallas - oracle > 0.1
    np.testing.assert_allclose(port, pallas, rtol=1e-5)


def test_bf16_input():
    """bf16 logits, f32 arithmetic (as in the Pallas kernel) against the f32
    oracle at the bf16 rounding of the inputs."""
    logits, labels = _data(1, 8, 16, 9, 4, seed=3, ignore_block=False)
    lb = torch.from_numpy(logits).to(torch.bfloat16)
    want = jax_oracle(jnp.asarray(logits), jnp.asarray(labels, jnp.int32), 4)
    got = U.upsample_ce(lb, torch.from_numpy(labels), 4)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=5e-3)
    x = lb.clone().requires_grad_(True)
    U.upsample_ce(x, torch.from_numpy(labels), 4).backward()
    assert x.grad.dtype == torch.bfloat16 and torch.isfinite(x.grad.float()).all()


def test_plain_grad_matches_autograd_of_plain_forward():
    """The written-out phase backward equals autograd through the plain
    forward, and gradcheck holds in float64."""
    logits, labels = _data(1, 5, 6, 4, 3, seed=7)
    lab = torch.from_numpy(labels)
    x = torch.from_numpy(logits).double().requires_grad_(True)
    sums, lse = U.upsample_ce_fwd_plain(x, lab, 3)
    (auto,) = torch.autograd.grad(sums[0] * 0.5, x)
    manual = U.upsample_ce_grad_plain(x.detach(), lab, lse.detach(), torch.tensor(0.5), 3)
    np.testing.assert_allclose(manual.numpy(), auto.numpy(), rtol=1e-10, atol=1e-12)
    small = torch.from_numpy(logits[:, :3, :4]).double().requires_grad_(True)
    torch.autograd.gradcheck(
        lambda t: U.upsample_ce(t, lab[:, :9, :12], 3), (small,), eps=1e-6, atol=1e-7)


def test_cuda_wrappers_reject_cpu_tensors():
    logits, labels = _data(1, 4, 4, 3, 2, seed=0)
    before = dict(U.launches)
    with pytest.raises(ValueError, match="CUDA"):
        U.upsample_ce_fwd_cuda(torch.from_numpy(logits), torch.from_numpy(labels), 2)
    assert U.launches == before
    with pytest.raises(ValueError, match="x2 grid"):
        U.upsample_ce(torch.from_numpy(logits), torch.from_numpy(labels[:, :7]), 2)


@pytest.mark.cuda
def test_cuda_kernels_match_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    logits, labels = _data(2, 12, 16, 19, 4, seed=2)
    x, lab = torch.from_numpy(logits).cuda(), torch.from_numpy(labels).cuda()
    U.reset_launches()
    sums, lse = U.upsample_ce_fwd_cuda(x, lab, 4)
    want, want_lse = U.upsample_ce_fwd_plain(x, lab, 4)
    g = torch.ones(1, device="cuda")
    d = U.upsample_ce_bwd_cuda(x, lab, lse, g, 4)
    d_want = U.upsample_ce_grad_plain(x, lab, want_lse, g[0], 4)
    torch.cuda.synchronize()
    assert U.launches == {"upsample_ce_fwd": 1, "upsample_ce_bwd": 1}
    torch.testing.assert_close(sums[0], want[0], rtol=1e-5, atol=0)
    assert sums[1:].tolist() == want[1:].tolist()
    torch.testing.assert_close(d, d_want, rtol=1e-4, atol=1e-6)
