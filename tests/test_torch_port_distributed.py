"""The port's data-parallel training (``ddp_tpu_torch/parallel/``,
``evaluation/dist.py``, the distributed ``train/step.py`` and
``train/loop.py``) on the CPU.

One 2-process gloo run (``tests/torch_port_dist_worker.py``, made once per
module, with a timeout of its own) trains each of six cases for two steps
on its rank's rows of two global batches: ``smoke`` (seg, drop path 0.2; a
batch of 4), the tiny depther of ``tests/test_torch_port_depth.py`` (drop
path 0.2), ``smoke_bev`` and ``smoke_fusion`` (batches of 2), ``smoke``
with ``microbatch`` 2 on a batch of 8 (``seg_mb2``: two rows a rank in each
chunk, dealt chunk-major; the aux head's BatchNorm on the path) and the tiny
``converge_controlnet`` stack (a batch of 2). Rank 1's rows of each global
batch are rescaled, so the ranks' rows differ in their statistics: a
per-rank BatchNorm, ``sig_loss`` or accuracy would not give the 1-process
numbers, nor would per-rank draws or, for ``seg_mb2``, chunks of each
rank's contiguous half. Each task is held to the same
``train`` in a third process, started with the two, on the whole global
batches (the JAX package's semantics: one
program on the global batch, ``tests/test_multiprocess.py:51-66``):

  - both ranks' logs bitwise equal; every log (losses, accuracy,
    ``grad_norm``) within 1e-5 relative of the 1-process run's;
  - the same initial state on every rank; the first step's gradients
    (averaged over the ranks) within 1e-5 of each tensor's max + 1e-6 of a
    typical tensor's (the median over the parameters: a gradient that is 0
    in exact arithmetic is all rounding); every BN statistic after 2 steps
    within 1e-5·max|x| + 1e-7, every parameter within 1e-3 of its update
    (L2) + 1e-7·sqrt(its size);
  - rank 0 alone writes the checkpoint and ``train_log.jsonl``, whose
    records are the logged values.

The runs are in float64 (models and batches; the step's gradients are
float32, and so are the BEV geometry and a few other islands), as the
compat zoo's CPU tests train. A parameter is held in L2 against its update,
not element by element: AdamW divides each gradient element by its own
magnitude, so an element whose gradient is near 0 (Swin's key biases, the
BEV encoders' last LayerNorm biases: 0 in exact arithmetic) turns the
rounding of its gradient into an update of up to ±lr, which differs between
any two summation orders.

Against the JAX package: the mesh's shape, axes and error and
``local_batch_size`` (``ddp_tpu/parallel/mesh.py``), ``allgather_metrics``
and ``broadcast_from_host0`` at world 1 (the identity) and at world 2 (a
sum, as ``tests/mp_worker.py:78-80``; rank 0's value); the global
BatchNorm at 2 ranks against flax's BatchNorm on the concatenated batch
(output, input gradient, running statistics) and ``sig_loss`` at 2 ranks
against JAX's on it (loss, gradient), jitted once at tiny shapes.
"""
import json
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import torch_port_dist_worker as W
from ddp_tpu.evaluation import dist as jdist
from ddp_tpu.nn.common import BatchNorm as JBatchNorm
from ddp_tpu.nn.losses import sig_loss as jsig_loss
from ddp_tpu.parallel import mesh as jmesh
from ddp_tpu_torch.evaluation import dist as tdist
from ddp_tpu_torch.parallel import mesh as tmesh

TIMEOUT_S = 240


def _free_port() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks and the 1-process run, three processes at once: their
    JSON results and saved tensors (ranks 0, 1, then the 1-process run),
    and their directory."""
    d = tmp_path_factory.mktemp("dist")
    port = _free_port()
    cases = [("0", "2"), ("1", "2"), ("0", "1")]
    outs = [str(d / f"rank{r}_of_{n}.json") for r, n in cases]
    procs = [subprocess.Popen([sys.executable, W.__file__, r, n, port, o, str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for (r, n), o in zip(cases, outs)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"
    return ([json.load(open(o)) for o in outs],
            [torch.load(o + ".pt", weights_only=True) for o in outs], str(d))


@pytest.fixture(scope="module")
def two_ranks(runs):
    """Both ranks' results and tensors, and the directory."""
    return runs[0][:2], runs[1][:2], runs[2]


@pytest.fixture(scope="module")
def one_rank(runs):
    """The 1-process runs on the whole global batches, by task: (logs,
    state_dict)."""
    return {task: (runs[0][2][task]["logs"], runs[1][2][task]) for task in W.TASKS}


@pytest.mark.parametrize("task", W.TASKS)
def test_two_ranks_train_as_one_process(task, two_ranks, one_rank):
    (r0, r1), (s0, s1), _ = two_ranks
    logs1, one = one_rank[task]
    # both ranks logged the same global values, bit for bit
    assert r0[task]["logs"] == r1[task]["logs"]
    assert len(r0[task]["logs"]) == len(logs1) == W.STEPS
    for got, want in zip(r0[task]["logs"], logs1):
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0, err_msg=k)
    init = one["init"]
    scale = float(np.median([g.abs().max().item() for g in one["grads"].values()]))
    for run in (s0[task], s1[task]):
        # the same start on every rank
        assert all(torch.equal(run["init"][k], v) for k, v in init.items())
        # the first step's averaged gradients
        for k, want in one["grads"].items():
            tol = 1e-5 * want.abs().max().item() + 1e-6 * scale
            assert (run["grads"][k] - want).abs().max().item() <= tol, f"{task} grad {k}"
        assert run["final"].keys() == one["final"].keys()
        for k, want in one["final"].items():
            got = run["final"][k]
            if not want.is_floating_point():
                assert torch.equal(got, want), k
            elif k in one["grads"]:  # a parameter: in L2 against its update
                upd = (want - init[k]).double().norm().item()
                err = (got - want).double().norm().item()
                assert err <= 1e-3 * upd + 1e-7 * want.numel() ** 0.5, f"{task} {k}"
            else:  # a BN statistic
                tol = 1e-5 * want.abs().max().item() + 1e-7
                assert (got - want).abs().max().item() <= tol, f"{task} {k}"
    # rank 0 alone writes; its log records are the logged values
    assert r0[task]["wrote"] == [f"{task}/ckpts/step_{W.STEPS}.pt", f"{task}/train_log.jsonl"]
    assert r1[task]["wrote"] == []


def test_rank_zero_log_holds_the_logged_values(two_ranks):
    (r0, _), _, d = two_ranks
    for task in W.TASKS:
        path = os.path.join(d, "rank0", task, "train_log.jsonl")
        recs = [json.loads(line) for line in open(path)]
        assert [r["step"] for r in recs] == list(range(1, W.STEPS + 1))
        for rec, logs in zip(recs, r0[task]["logs"]):
            assert all(rec[k] == v[0] for k, v in logs.items()), task


def test_two_rank_collectives_mesh_and_iterator(two_ranks):
    (r0, r1), _, _ = two_ranks
    for r in (r0, r1):
        assert r["device"] == "cpu"
        assert r["mesh"] == {"shape": [2, 1], "names": [jmesh.DATA_AXIS, jmesh.MODEL_AXIS]}
        assert r["local_batch_size"] == W.GLOBAL_BATCH["seg"] // 2
        assert r["gathered_hist"] == [3.0] * 4  # 1.0 + 2.0, as mp_worker's check
        assert r["broadcast"] == {"seed": 100, "v": [0, 1, 2]}
        assert r["iterator_rows"]


@pytest.fixture
def world_one():
    """A 1-rank gloo group in this process, destroyed after the test."""
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_mesh_and_metrics_at_world_one_match_jax(world_one):
    want = jmesh.make_mesh(n_data=1, n_model=1, devices=jax.devices()[:1])
    got = tmesh.make_mesh()
    assert tuple(got.shape) == tuple(want.devices.shape)
    assert tuple(got.mesh_dim_names) == tuple(want.axis_names)
    with pytest.raises(AssertionError) as jerr:
        jmesh.make_mesh(n_data=3, n_model=1, devices=jax.devices()[:1])
    with pytest.raises(AssertionError) as terr:
        tmesh.make_mesh(n_data=3, n_model=1)
    assert str(terr.value) == str(jerr.value)
    assert tmesh.local_batch_size(8) == jmesh.local_batch_size(8) == 8
    local = {"hist": np.arange(5, dtype=np.int64), "area": np.linspace(0, 1, 3)}
    for jv, tv in zip(jdist.allgather_metrics(local).values(),
                      tdist.allgather_metrics(local).values()):
        np.testing.assert_array_equal(tv, jv)
    tree = {"seed": 7, "v": np.arange(3)}
    assert tdist.broadcast_from_host0(tree) is jdist.broadcast_from_host0(tree) is tree
    # shard_batch: this process's rows (all 8 at world 1), dicts walked, the
    # leading dimension checked
    got = tmesh.shard_batch({"image": np.zeros((8, 2)), "rb": {"a": np.ones((8, 3))}}, 8)
    assert got["image"].shape == (8, 2) and torch.equal(got["rb"]["a"], torch.ones(8, 3))
    with pytest.raises(ValueError, match="local_batch_size = 8"):
        tmesh.shard_batch({"image": np.zeros((4, 2))}, 8)
    with pytest.raises(ValueError, match="axis 1"):
        tmesh.shard_batch_chunk({"image": np.zeros((2, 4, 2))}, 8)


def test_make_mesh_without_a_group_raises():
    with pytest.raises(RuntimeError, match="init_distributed"):
        tmesh.make_mesh()


@pytest.fixture(scope="module")
def jax_collectives():
    """flax's BatchNorm and JAX's sig_loss on the whole global batch."""
    g = W.collective_inputs()
    bn = JBatchNorm()
    variables = {"params": {"BatchNorm_0": {"scale": g["scale"], "bias": g["bias"]}},
                 "batch_stats": {"BatchNorm_0": {"mean": g["mean"], "var": g["var"]}}}

    @jax.jit
    def run(variables, x, w, pred, gt):
        def bn_loss(x):
            y, upd = bn.apply(variables, x, use_running_average=False,
                              mutable=["batch_stats"])
            return (y * w).sum(), (y, upd)

        (_, (y, upd)), dx = jax.value_and_grad(bn_loss, has_aux=True)(x)
        sig, dpred = jax.value_and_grad(jsig_loss)(pred, gt)
        return y, dx, upd["batch_stats"]["BatchNorm_0"], sig, dpred

    y, dx, stats, sig, dpred = run(variables, *(jnp.asarray(g[k])
                                                for k in ("x", "w", "pred", "gt")))
    return {"bn_y": y, "bn_dx": dx, "bn_mean": stats["mean"], "bn_var": stats["var"],
            "sig": sig, "sig_dpred": dpred}


def _held(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-5 * np.abs(want).max() + 1e-7, err_msg=what)


@pytest.mark.parametrize("world", [1, 2])
def test_global_batchnorm_and_sig_loss_match_jax(world, two_ranks, jax_collectives):
    """At 2 ranks, each rank's rows of the global BatchNorm's output and
    input gradient, its running statistics and ``sig_loss`` (and the ranks'
    mean of its gradient) are JAX's on the concatenated batch; at 1, the
    same in this process."""
    ranks = ([c["collectives"] for c in two_ranks[1]] if world == 2
             else [W.collectives_case()])
    j = jax_collectives
    n = 4 // world
    for rank, c in enumerate(ranks):
        rows = slice(rank * n, (rank + 1) * n)
        _held(c["bn_y"], np.asarray(j["bn_y"])[rows], "BatchNorm output")
        _held(c["bn_dx"], np.asarray(j["bn_dx"])[rows], "BatchNorm input gradient")
        for k in ("bn_mean", "bn_var"):
            _held(c[k], j[k], k)
        np.testing.assert_allclose(c["sig"].item(), float(j["sig"]), rtol=1e-5)
        _held(c["sig_dpred"], np.asarray(j["sig_dpred"])[rows], "sig_loss gradient")


def test_uncovered_data_parallel_cases_raise(monkeypatch):
    """Under a world of 2 (faked): a global batch that does not divide over
    the ranks, and a microbatched step whose chunks B/k do not (JAX's
    condition), raise; the ControlNet presets are accepted."""
    from ddp_tpu_torch.config import get_config
    from ddp_tpu_torch.train import loop, step

    monkeypatch.setattr(loop, "world", lambda: (0, 2))
    monkeypatch.setattr(step, "world", lambda: (0, 2))
    with pytest.raises(ValueError, match="divide"):
        loop.check_distributed(get_config("smoke", {"data.batch_size": 3}))
    for preset in ("smoke", "converge_controlnet", "controlnet_sd15"):
        loop.check_distributed(get_config(preset, {"data.batch_size": 4}))
    # a local batch of 3: the global batch 6 in chunks of 3, which 2 ranks cannot share
    with pytest.raises(ValueError, match=r"B = 6, k = 2\) must divide over the 2 ranks"):
        step.make_train_step(microbatch=2).grads(None, {"image": torch.zeros(3, 1)})


def test_chunk_major_dealing():
    """``shard_batch_microbatched``: rank r's rows of chunk i are global rows
    i·B/k + r·B/(k·n) + [0, B/(k·n)), dicts walked, a [B·h·w, C] value dealt
    by image; at world 1 (no group) the whole batch; the stacked local
    batches of the ranks, chunk by chunk, are the global batch."""
    b, k, n, hw = 12, 3, 2, 4
    batch = {"image": np.arange(b), "noise": np.arange(b * hw * 2).reshape(b * hw, 2),
             "rb": {"a": np.arange(b * 3).reshape(b, 3)}}
    got = [tmesh.shard_batch_microbatched(batch, k, rank=r, n=n) for r in range(n)]
    assert got[0]["image"].tolist() == [0, 1, 4, 5, 8, 9]
    assert got[1]["image"].tolist() == [2, 3, 6, 7, 10, 11]
    for r in range(n):
        img = got[r]["image"]
        assert torch.equal(got[r]["rb"]["a"], torch.from_numpy(batch["rb"]["a"])[img])
        assert torch.equal(got[r]["noise"].reshape(-1, hw, 2),
                           torch.from_numpy(batch["noise"]).reshape(b, hw, 2)[img])
    chunks = [torch.cat([g["image"].reshape(k, -1)[i] for g in got]) for i in range(k)]
    assert torch.equal(torch.cat(chunks), torch.arange(b))
    whole = tmesh.shard_batch_microbatched(batch, k)
    assert torch.equal(whole["image"], torch.arange(b))
    with pytest.raises(ValueError, match="multiple of 6"):
        tmesh.shard_batch_microbatched({"image": np.arange(8)}, k, rank=0, n=n)
