"""q_sample and the table gradient of the torch port vs the JAX package.

The port's plain versions (what its wrappers run on CPU tensors) are held to
the Pallas kernels run in interpret mode (as ``tests/test_pallas_qsample.py``
runs them) and to their XLA oracles; the port's autograd Functions, whose
backward is the closed-form VJP with the dtable kernel's plain version, are
held to ``jax.grad`` of ``fused_q_sample`` and ``fused_encode_map``, and to
``torch.autograd.gradcheck`` in float64. N = 300 is not a multiple of the
Pallas kernels' 256-row tile. The CUDA kernels are held to the plain versions
on the card (``cuda`` marker here, and ``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ops.pallas import q_sample as Q
from ddp_tpu_torch.ops import q_sample as TQ

BIT_SCALE = 0.01


@pytest.fixture()
def data():
    rng = np.random.RandomState(0)
    n, k, c = 300, 7, 64
    labels = rng.randint(0, k, n).astype(np.int64)
    table = rng.randn(k, c).astype(np.float32)
    alpha = rng.uniform(0.1, 1, n).astype(np.float32)
    sigma = np.sqrt(1 - alpha ** 2).astype(np.float32)
    noise = rng.randn(n, c).astype(np.float32)
    return labels, table, alpha, sigma, noise


def _interp_pallas(monkeypatch):
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setenv("DDP_TPU_FUSED_QSAMPLE", "1")


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def test_q_sample_plain_matches_pallas_and_xla(data, monkeypatch):
    labels, table, alpha, sigma, noise = data
    got = TQ.q_sample_plain(*_t(labels, table), BIT_SCALE, *_t(alpha, sigma, noise)).numpy()
    jargs = (jnp.asarray(labels, jnp.int32), jnp.asarray(table), BIT_SCALE,
             jnp.asarray(alpha), jnp.asarray(sigma), jnp.asarray(noise))
    want_xla = np.asarray(Q.q_sample_xla(*jargs))
    _interp_pallas(monkeypatch)
    want_pallas = np.asarray(Q._qsample_pallas(*jargs))
    np.testing.assert_allclose(got, want_xla, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, rtol=0, atol=1e-6)


def test_dtable_plain_matches_pallas_and_segment_sum(data, monkeypatch):
    labels, table, *_ = data
    k = table.shape[0]
    demb = np.random.RandomState(1).randn(labels.shape[0], table.shape[1]).astype(np.float32)
    got = TQ.dtable_plain(*_t(labels, demb), k).numpy()
    want_seg = np.asarray(jax.ops.segment_sum(jnp.asarray(demb), jnp.asarray(labels),
                                              num_segments=k))
    _interp_pallas(monkeypatch)
    want_pallas = np.asarray(Q._dtable_pallas(jnp.asarray(labels, jnp.int32),
                                              jnp.asarray(demb), k))
    np.testing.assert_allclose(got, want_seg, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-5, atol=1e-5)


def test_q_sample_grads_match_jax(data):
    """d/d(table, alpha, sigma, noise) of sum(sin(q_sample(...)))."""
    labels, table, alpha, sigma, noise = data

    def jax_loss(table, alpha, sigma, noise):
        return jnp.sum(jnp.sin(Q.fused_q_sample(jnp.asarray(labels, jnp.int32), table,
                                                BIT_SCALE, alpha, sigma, noise)))

    want = jax.grad(jax_loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (table, alpha, sigma, noise)))
    leaves = [t.requires_grad_(True) for t in _t(table, alpha, sigma, noise)]
    tt, ta, ts, tn = leaves
    torch.sin(TQ.q_sample(torch.from_numpy(labels), tt, BIT_SCALE, ta, ts, tn)).sum().backward()
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)


def test_encode_map_grad_matches_jax(data):
    labels, table, *_ = data
    want = jax.grad(lambda t: jnp.sum(Q.fused_encode_map(
        jnp.asarray(labels, jnp.int32), t, BIT_SCALE) ** 2))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_(True)
    (TQ.encode_map(torch.from_numpy(labels), tt, BIT_SCALE) ** 2).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_table_only_grad_matches_full_grad(data):
    """The train path asks for the table's gradient only (t has no grad):
    the backward then skips alpha, sigma and noise, and the table's gradient
    is the one of the full backward."""
    labels, table, alpha, sigma, noise = data
    lab = torch.from_numpy(labels)
    full = [t.requires_grad_(True) for t in _t(table, alpha, sigma, noise)]
    torch.sin(TQ.q_sample(lab, full[0], BIT_SCALE, *full[1:])).sum().backward()
    tt = torch.from_numpy(table).requires_grad_(True)
    rest = _t(alpha, sigma, noise)
    torch.sin(TQ.q_sample(lab, tt, BIT_SCALE, *rest)).sum().backward()
    assert all(t.grad is None for t in rest)
    assert torch.equal(tt.grad, full[0].grad)


def test_gradcheck_float64():
    rng = np.random.RandomState(3)
    n, k, c = 23, 5, 6
    labels = torch.from_numpy(rng.randint(0, k, n))
    args = [torch.from_numpy(a).double().requires_grad_(True) for a in (
        rng.randn(k, c), rng.uniform(0.1, 1, n), rng.uniform(0.1, 1, n), rng.randn(n, c))]
    # bit_scale 1 keeps the squash's derivative well above finite-difference noise
    torch.autograd.gradcheck(lambda t, a, s, z: TQ.q_sample(labels, t, 1.0, a, s, z), args)
    torch.autograd.gradcheck(lambda t: TQ.encode_map(labels, t, 1.0), args[:1])


def test_cuda_wrappers_reject_cpu_tensors(data):
    labels, table, alpha, sigma, noise = _t(*data)
    before = dict(TQ.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.q_sample_cuda(labels, table, BIT_SCALE, alpha, sigma, noise)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.dtable_cuda(labels, noise, 7)
    assert TQ.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(32768, 256), (32771, 250)])
def test_cuda_kernels_match_plain(n, c):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    g = torch.Generator().manual_seed(0)
    labels = torch.randint(0, 151, (n,), generator=g).cuda()
    table = torch.randn(151, c, generator=g).cuda()
    alpha, sigma = torch.rand(n, generator=g).cuda(), torch.rand(n, generator=g).cuda()
    noise = torch.randn(n, c, generator=g).cuda()
    TQ.reset_launches()
    got = TQ.q_sample_cuda(labels, table, BIT_SCALE, alpha, sigma, noise)
    dt = TQ.dtable_cuda(labels, noise, 151)
    torch.cuda.synchronize()
    assert TQ.launches == {"encode_map": 0, "q_sample": 1, "dtable": 1}
    want = TQ.q_sample_plain(labels, table, BIT_SCALE, alpha, sigma, noise)
    assert (got - want).abs().max().item() <= 1e-6
    torch.testing.assert_close(dt, TQ.dtable_plain(labels, noise, 151), rtol=1e-5, atol=1e-5)
