"""Encode-map of the torch port vs the JAX package's oracle and Pallas kernel.

The port's plain version (``encode_map_plain``, what ``encode_map`` runs on a
CPU tensor) is held to ``encode_map_xla`` and to ``_encode_pallas`` run in
Pallas interpret mode, on the same seeded numpy inputs. The CUDA kernel
itself is held to the plain version on the card (``cuda`` marker here, and
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddp_tpu.ops.pallas import q_sample as Q
from ddp_tpu_torch.ops import q_sample as TQ
from torch_port_threads import _one_torch_thread  # noqa: F401


def _interp_pallas(monkeypatch):
    """Force interpret-mode pallas_call (test-side only, as in
    tests/test_pallas_qsample.py)."""
    import jax.experimental.pallas as pl

    orig = pl.pallas_call

    def patched(*a, **kw):
        kw.setdefault("interpret", True)
        return orig(*a, **kw)

    monkeypatch.setattr(pl, "pallas_call", patched)
    monkeypatch.setenv("DDP_TPU_FUSED_QSAMPLE", "1")


def _data(k, n=300, c=64, seed=0):
    # n = 300 is not a multiple of the Pallas kernel's 256-row tile
    rng = np.random.RandomState(seed)
    return rng.randint(0, k, n).astype(np.int64), rng.randn(k, c).astype(np.float32)


@pytest.mark.parametrize("k", [7, 151])
def test_plain_matches_xla_oracle_and_pallas(k, monkeypatch):
    labels, table = _data(k)
    got = TQ.encode_map(torch.from_numpy(labels), torch.from_numpy(table), 0.01).numpy()
    want_xla = np.asarray(Q.encode_map_xla(jnp.asarray(labels, jnp.int32),
                                           jnp.asarray(table), 0.01))
    _interp_pallas(monkeypatch)
    want_pallas = np.asarray(Q._encode_pallas(jnp.asarray(labels, jnp.int32),
                                              jnp.asarray(table), 0.01))
    # f32 throughout; the two sigmoid implementations differ by ulps only
    np.testing.assert_allclose(got, want_xla, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, want_pallas, rtol=1e-6, atol=1e-6)


def test_plain_bf16_matches_pallas(monkeypatch):
    """bf16 table: like the Pallas kernel, the squash runs in f32 and only the
    result is rounded to bf16."""
    labels, table = _data(151)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    got = TQ.encode_map(torch.from_numpy(labels), tb, 0.01).float().numpy()
    _interp_pallas(monkeypatch)
    want = np.asarray(Q._encode_pallas(jnp.asarray(labels, jnp.int32),
                                       jnp.asarray(tb.float().numpy(), jnp.bfloat16),
                                       0.01).astype(jnp.float32))
    # at most one bf16 ulp of |out| <= 0.01 (2^-7 * 2^-7 = 6.1e-5)
    np.testing.assert_allclose(got, want, rtol=0, atol=6.2e-5)


def test_bf16_oracle_differs_from_kernel_reference_discrepancy(monkeypatch):
    """Reference fault (ROADMAP.md queue 3): with a bf16 table,
    encode_map_xla computes σ·2−1 in bf16 while _encode_kernel computes it in
    f32 and rounds once. The port equals the kernel; the oracle is up to
    1.2e-4 (1.2 % of bit_scale) away, on about three quarters of the
    elements, and cancels to exact zeros where the kernel has none."""
    labels, table = _data(151, n=4096, c=256)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    jl, jt = jnp.asarray(labels, jnp.int32), jnp.asarray(tb.float().numpy(), jnp.bfloat16)
    port = TQ.encode_map(torch.from_numpy(labels), tb, 0.01).float().numpy()
    oracle = np.asarray(Q.encode_map_xla(jl, jt, 0.01).astype(jnp.float32))
    _interp_pallas(monkeypatch)
    kernel = np.asarray(Q._encode_pallas(jl, jt, 0.01).astype(jnp.float32))
    np.testing.assert_array_equal(port, kernel)
    d = np.abs(oracle - kernel)
    assert 1.1e-4 < d.max() < 1.3e-4
    assert (d > 0).mean() > 0.7
    assert (oracle == 0).sum() > 7000 and (kernel == 0).sum() == 0


def test_plain_rejects_out_of_range_labels():
    """The JAX oracle gives NaN here and the Pallas kernel 0 (a reference
    fault, ROADMAP.md queue 3); the port refuses such labels on the host."""
    table = torch.zeros(7, 4)
    for bad in (-1, 7):
        with pytest.raises(ValueError, match="outside"):
            TQ.encode_map(torch.tensor([0, bad]), table, 0.01)


def test_cuda_wrapper_rejects_cpu_tensors():
    before = dict(TQ.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.encode_map_cuda(torch.zeros(3, dtype=torch.int64), torch.zeros(7, 4), 0.01)
    assert TQ.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("n", [32768, 32771])
def test_cuda_kernel_matches_plain(n):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernel has no CPU mode)")
    g = torch.Generator().manual_seed(0)
    labels = torch.randint(0, 151, (n,), generator=g).cuda()
    table = torch.randn(151, 256, generator=g).cuda()
    TQ.reset_launches()
    got = TQ.encode_map(labels, table, 0.01)
    torch.cuda.synchronize()
    assert TQ.launches["encode_map"] == 1
    want = TQ.encode_map_plain(labels, table, 0.01)
    assert (got - want).abs().max().item() <= 1e-6 * 0.01
