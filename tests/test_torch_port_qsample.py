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
from torch_port_threads import _one_torch_thread  # noqa: F401


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


@pytest.mark.parametrize("fused", ["q_sample", "encode_map"])
def test_squash_dtable_plain_matches_jax_grad(data, fused):
    """The fused table gradient's plain version against jax.grad w.r.t. the
    table of sum(x · G), G a fixed cotangent: through fused_q_sample (alpha)
    and through fused_encode_map (no alpha)."""
    labels, table, alpha, sigma, noise = data
    cot = np.random.RandomState(2).randn(*noise.shape).astype(np.float32)
    jl = jnp.asarray(labels, jnp.int32)
    if fused == "q_sample":
        fn = lambda t: Q.fused_q_sample(jl, t, BIT_SCALE, jnp.asarray(alpha),  # noqa: E731
                                        jnp.asarray(sigma), jnp.asarray(noise))
        a = torch.from_numpy(alpha)
    else:
        fn = lambda t: Q.fused_encode_map(jl, t, BIT_SCALE)  # noqa: E731
        a = None
    want = jax.grad(lambda t: jnp.sum(fn(t) * cot))(jnp.asarray(table))
    got = TQ.squash_dtable_plain(torch.from_numpy(labels), torch.from_numpy(cot), a,
                                 torch.from_numpy(table), BIT_SCALE)
    assert got.dtype == torch.float32 and got.shape == table.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_qs_fwd_bf16_reference_discrepancy(monkeypatch):
    """Reference fault (ROADMAP.md queue 3): under jax.grad the JAX package
    computes x_t with _qs_fwd, which rounds x0, alpha and sigma to bf16 and
    computes in bf16; _qsample_kernel computes in f32 and rounds once. They
    differ by one bf16 ulp of |x_t| on about a third of the elements. The
    port follows the kernel (one element of 2^20 off by one ulp of a
    smaller |x_t|)."""
    rng = np.random.RandomState(0)
    n, k, c = 4096, 151, 256
    labels = rng.randint(0, k, n).astype(np.int64)
    table = torch.from_numpy(rng.randn(k, c).astype(np.float32)).to(torch.bfloat16)
    alpha = rng.uniform(0.05, 1, n).astype(np.float32)
    sigma = np.sqrt(1 - alpha ** 2).astype(np.float32)
    noise = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(torch.bfloat16)
    jargs = (jnp.asarray(table.float().numpy(), jnp.bfloat16), BIT_SCALE, jnp.asarray(alpha),
             jnp.asarray(sigma), jnp.asarray(noise.float().numpy(), jnp.bfloat16))
    jl = jnp.asarray(labels, jnp.int32)
    _interp_pallas(monkeypatch)
    kernel = np.asarray(Q._qsample_pallas(jl, *jargs).astype(jnp.float32))
    fwd = np.asarray(Q._qs_fwd(jl.astype(jnp.float32), BIT_SCALE, jargs[0], *jargs[2:])[0]
                     .astype(jnp.float32))
    port = TQ.q_sample(torch.from_numpy(labels), table, BIT_SCALE, torch.from_numpy(alpha),
                       torch.from_numpy(sigma), noise).float().numpy()
    d_fwd, d_port = np.abs(fwd - kernel), np.abs(port - kernel)
    assert d_fwd.max() == 2.0 ** -5  # one bf16 ulp at |x_t| = 4.75, the largest
    assert (d_fwd > 0).mean() > 0.25
    # one bf16 ulp of |x_t| is 2^-8 to 2^-7 of it
    assert (d_port > 0).sum() <= 2 and (d_port <= 2.0 ** -7 * np.abs(kernel)).all()


def test_bf16_table_grad_vs_reference():
    """bf16 table and noise: the port's table gradient against jax.grad
    through fused_q_sample. JAX takes σ from the bf16 x0 it saved, the port
    from the table, so they differ (ROADMAP.md queue 3): max |Δ| 0.66 % of
    max |dtable| here, held to 2^-7 (0.78 %) of it. The port's gradient is
    the bf16 rounding of the f32 gradient of the bf16 inputs, exactly."""
    rng = np.random.RandomState(0)
    n, k, c = 300, 7, 64
    labels = rng.randint(0, k, n).astype(np.int64)
    table = torch.from_numpy(rng.randn(k, c).astype(np.float32)).to(torch.bfloat16)
    alpha = rng.uniform(0.1, 1, n).astype(np.float32)
    sigma = np.sqrt(1 - alpha ** 2).astype(np.float32)
    noise = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(torch.bfloat16)
    cot = np.random.RandomState(2).randn(n, c).astype(np.float32)

    def jax_loss(t):
        x = Q.fused_q_sample(jnp.asarray(labels, jnp.int32), t, BIT_SCALE, jnp.asarray(alpha),
                             jnp.asarray(sigma), jnp.asarray(noise.float().numpy(), jnp.bfloat16))
        return jnp.sum(x.astype(jnp.float32) * cot)

    want = jax.grad(jax_loss)(jnp.asarray(table.float().numpy(), jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    tt = table.clone().requires_grad_(True)
    lab, al, cott = torch.from_numpy(labels), torch.from_numpy(alpha), torch.from_numpy(cot)
    x = TQ.q_sample(lab, tt, BIT_SCALE, al, torch.from_numpy(sigma), noise)
    (x.float() * cott).sum().backward()
    assert tt.grad.dtype == torch.bfloat16
    got = tt.grad.float().numpy()
    exact = TQ.squash_dtable_plain(lab, cott.to(torch.bfloat16), al, table, BIT_SCALE)
    np.testing.assert_array_equal(got, exact.to(torch.bfloat16).float().numpy())
    d = np.abs(got - want)
    assert d.max() <= 2.0 ** -7 * np.abs(want).max()
    assert d.max() > 2.0 ** -9 * np.abs(want).max()  # the discrepancy is real


def _decomposition_sum(labels, g, k, geo, vec):
    """The (squash_)dtable kernel's decomposition, modelled in float64: per
    block its rows sorted by label (labels outside [0, K) dropped), per row
    group an even slice of them, summed run by run of one label and each run
    added to the output. Also returns how often each row was read and how
    many runs were added."""
    n, c = g.shape
    lanes = TQ.DTABLE_CHUNK // vec
    groups = TQ.DTABLE_THREADS // lanes
    out = torch.zeros(k, c, dtype=torch.float64)
    reads = torch.zeros(n, dtype=torch.int64)
    runs = 0
    for bx in range(geo.row_blocks):
        r0 = bx * geo.rows_per_block
        block = range(r0, min(n, r0 + geo.rows_per_block))
        order = sorted((int(labels[r]), r) for r in block if 0 <= labels[r] < k)
        slice_ = -(-len(order) // groups)
        for by in range(geo.col_chunks):
            cols = slice(by * TQ.DTABLE_CHUNK, min(c, (by + 1) * TQ.DTABLE_CHUNK))
            for grp in range(groups):
                run, acc = -1, 0.0
                for lab, row in order[grp * slice_:(grp + 1) * slice_]:
                    reads[row] += by == 0
                    if lab != run:
                        if run >= 0:
                            out[run, cols] += acc
                            runs += 1
                        run, acc = lab, 0.0
                    acc = acc + g[row, cols]
                if run >= 0:
                    out[run, cols] += acc
                    runs += 1
    return out, reads, runs


@pytest.mark.parametrize("n,c,k,sms,vec", [
    (300, 64, 7, 132, 4), (300, 64, 7, 2, 8), (1001, 250, 12, 3, 1), (4099, 136, 5, 1, 4),
    (257, 8, 3, 7, 8)])
def test_dtable_decomposition_matches_plain(n, c, k, sms, vec):
    """The kernel's grid (dtable_geometry), counting sort and slices read
    every row with a label in [0, K) once per column chunk and its run sums
    give dtable_plain's sums; other labels add nothing. A block adds at most
    one run per label and row group."""
    rng = np.random.RandomState(n)
    labels = torch.from_numpy(np.repeat(rng.randint(-1, k + 1, n // 3 + 1), 3)[:n])
    g = torch.from_numpy(rng.randn(n, c))
    geo = TQ.dtable_geometry(n, c, k, sms)
    assert geo.row_blocks * geo.rows_per_block >= n > (geo.row_blocks - 1) * geo.rows_per_block
    assert geo.col_chunks == -(-c // TQ.DTABLE_CHUNK)
    assert geo.smem_bytes == (k + 2) // 2 * 8 + geo.rows_per_block * 8
    got, reads, runs = _decomposition_sum(labels, g, k, geo, vec)
    inside = (labels >= 0) & (labels < k)
    assert (reads[inside] == 1).all() and (reads[~inside] == 0).all()
    groups = TQ.DTABLE_THREADS // (TQ.DTABLE_CHUNK // vec)
    assert runs <= geo.row_blocks * geo.col_chunks * (k + groups)
    want = TQ.dtable_plain(labels[inside], g[inside], k)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("n,k,sms", [(32768, 151, 132), (32771, 151, 132), (32768, 151, 114),
                                     (100, 151, 132), (1, 151, 1), (10 ** 6, 151, 132),
                                     (10 ** 6, 9000, 132)])
def test_dtable_geometry(n, k, sms):
    """At the path's shape the grid is DTABLE_BLOCKS_PER_SM blocks per SM; a
    block takes DTABLE_MIN_ROWS to DTABLE_MAX_ROWS rows (fewer for a large
    K), and its shared memory stays within the 48 KB that needs no opt-in."""
    geo = TQ.dtable_geometry(n, 256, k, sms)
    assert geo.col_chunks == 4
    assert geo.rows_per_block <= TQ.DTABLE_MAX_ROWS
    assert geo.rows_per_block >= TQ.DTABLE_MIN_ROWS or k > 4000
    assert geo.smem_bytes <= TQ.DTABLE_SMEM
    assert geo.row_blocks * geo.rows_per_block >= n
    if 32768 <= n <= 10 ** 5:
        assert geo.row_blocks * geo.col_chunks >= sms * TQ.DTABLE_BLOCKS_PER_SM


def test_dtable_geometry_rejects_a_table_too_large():
    with pytest.raises(ValueError, match="shared memory"):
        TQ.dtable_geometry(100, 256, 20000, 132)


def test_cuda_wrappers_reject_cpu_tensors(data):
    labels, table, alpha, sigma, noise = _t(*data)
    before = dict(TQ.launches)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.q_sample_cuda(labels, table, BIT_SCALE, alpha, sigma, noise)
    with pytest.raises(ValueError, match="CUDA"):
        TQ.dtable_cuda(labels, noise, 7)
    for a in (alpha, None):
        with pytest.raises(ValueError, match="CUDA"):
            TQ.squash_dtable_cuda(labels, noise, a, table, BIT_SCALE)
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


@pytest.mark.cuda
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_alpha", [True, False])
def test_cuda_squash_dtable_matches_plain(g_dtype, with_alpha):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels have no CPU mode)")
    g = torch.Generator().manual_seed(0)
    n, c, k = 32768, 256, 151
    labels = torch.randint(0, k, (n,), generator=g).cuda()
    cot = torch.randn(n, c, generator=g).to(g_dtype).cuda()
    alpha = torch.rand(n, generator=g).cuda() if with_alpha else None
    table = torch.randn(k, c, generator=g).cuda()
    TQ.reset_launches()
    got = TQ.squash_dtable_cuda(labels, cot, alpha, table, BIT_SCALE)
    torch.cuda.synchronize()
    assert TQ.launches == {"encode_map": 0, "q_sample": 0, "dtable": 1}
    want = TQ.squash_dtable_plain(labels, cot, alpha, table, BIT_SCALE)
    assert ((got - want).abs() <= 1e-5 * want.abs() + 1e-5 * want.abs().max()).all()
