"""The port's export (``ddp_tpu_torch/tools/export.py``) and its reader of
the JAX package's published ``.msgpack`` (``convert.py: read_flax_msgpack``),
on the CPU.

  - Against JAX's artifact: ``tiny_seg`` at 64^2 (window and msda decoders)
    and a tiny depther. JAX's artifact is built as ``tools/export.py``
    builds it (``jax.export`` of the jitted ``sample`` with ``PRNGKey(0)``,
    serialised, deserialised, called); the noise it drew is captured with
    ``intercept_methods`` and baked into the port's program with the same
    weights (``load_flax``). The port's program, saved and loaded in a fresh
    process, is held to JAX's output within ``test_sample_matches_jax``'s
    limits (1e-4, argmax 99.9 %) and the depther sample test's (1e-4 m).
  - Against the port's eager ``sample``: bitwise, in this process and in the
    fresh one. The graph holds ``timesteps`` ``encode_map`` op calls for a
    segmentor and none for a depther; the fresh process imports no jax,
    flax, ddp_tpu or ``ddp_tpu_torch.models``.
  - Cache hygiene: with the device-constant caches emptied first, an eager
    ``sample`` after an export equals the one before it and is a real
    tensor, and a second export succeeds. Tracing reads the caches but
    never fills them, so ``export_sample``'s program (caches filled by an
    eager call first) copies no constant to the device at each call.
  - The CLI: ``smoke`` on the CPU exits 0, prints the JAX tool's line and
    computes ``sample`` with a generator seeded 0; ``smoke_bev`` exits
    non-zero; without ``--device`` and without a GPU it raises.
  - ``read_flax_msgpack`` against flax's ``msgpack_serialize`` (every dtype,
    scalars, nested and empty maps, chunked leaves) bitwise; unknown ext
    codes and dtypes raise; a ``publish_model``-layout file through
    ``tools.segmentor`` and through every ``--ckpt`` tool gives what the
    ``load_flax`` weights give, bitwise.
"""
import contextlib
import dataclasses
import functools
import io
import json
import os
import subprocess
import sys

import flax.linen as fnn
import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport
from torch._subclasses.fake_tensor import FakeTensor

from ddp_tpu import config as jconfig
from ddp_tpu_torch.config import build_model, get_config
from ddp_tpu_torch.convert import load_flax, read_flax_msgpack
from ddp_tpu_torch.data.image_io import write_png
from ddp_tpu_torch.nn import heads, swin, transformer
from ddp_tpu_torch.ops import resize
from ddp_tpu_torch.tools import (confusion_matrix, export, image_demo, model_ensemble,
                                 segmentor)
from test_torch_port_depth import _jax_model as _jax_depther
from test_torch_port_depth import _model_cfg as _depther_cfg
from test_torch_port_segmentor import _init as _jax_seg_init
from test_torch_port_segmentor import _jax_model as _jax_segmentor
from torch_port_threads import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ADE = os.path.join(REPO, "tests", "data", "ade")
HW = (64, 64)
CASES = ("window", "msda", "depth")
# the device-constant caches the tiny models fill
CACHES = (resize._nearest_index_on, resize._linear_weights_on, swin.shift_attn_mask,
          heads._sine_pos, heads._reference_points, transformer._normalizer)
# a fresh interpreter: torch and the op only; loads, calls, and reports the
# modules it holds of the packages a loader must not need
FRESH = """
import json, sys
import numpy as np
import torch
import ddp_tpu_torch.ops.q_sample
torch.set_num_threads(1)
program = torch.export.load(sys.argv[1]).module()
np.save(sys.argv[3], program(torch.from_numpy(np.load(sys.argv[2]))).numpy())
print(json.dumps(sorted(m for m in sys.modules if m.split(".")[0] in
                        ("jax", "jaxlib", "flax", "ddp_tpu", "ddp_tpu_torch"))))
"""


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _calls(program, target: str) -> int:
    """The program's calls of ``target`` (an op's name and overload, or its
    prefix), in its graph and the graphs nested in it."""
    return sum(1 for _, m in program.graph_module.named_modules()
               if isinstance(m, torch.fx.GraphModule)
               for n in m.graph.nodes
               if n.op == "call_function" and str(n.target).startswith(target))


def _encode_map_calls(program) -> int:
    return _calls(program, "ddp_tpu_torch.encode_map")


def _models(case):
    """(the port's model config, JAX's module, its variables)."""
    if case == "depth":
        mc = _depther_cfg()
        jm = _jax_depther(mc)
        variables = jax.jit(lambda: jm.init(
            {"params": jax.random.PRNGKey(0), "diffusion": jax.random.PRNGKey(1),
             "dropout": jax.random.PRNGKey(2)},
            jnp.zeros((1,) + HW + (3,)), jnp.ones((1,) + HW), train=False))()
        return dataclasses.replace(mc, drop_path_rate=0.0), jm, variables
    cfg = get_config("tiny_seg")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, decoder_attn=case))
    jm = _jax_segmentor(cfg)
    return cfg.model, jm, jax.jit(lambda: _jax_seg_init(jm, HW))()


def _jax_artifact(jm, variables, img, noise_method):
    """JAX's exported ``sample`` (``tools/export.py``: the jitted forward with
    the weights and ``PRNGKey(0)`` closed over), serialised, deserialised and
    called on ``img``; and the initial noise it drew (the latent of the first
    ``noise_method`` call, from the same program run with a capture)."""

    def fwd(x):
        return jm.apply(variables, x, method=jm.sample,
                        rngs={"diffusion": jax.random.PRNGKey(0)})

    exported = jexport.export(jax.jit(fwd))(jax.ShapeDtypeStruct(img.shape, jnp.float32))
    blob = exported.serialize()
    want = np.asarray(jexport.deserialize(blob).call(jnp.asarray(img)))

    def drawn(x):
        cap = {}

        def capture(next_fun, args, kwargs, context):
            if context.method_name == noise_method and "noise" not in cap:
                cap["noise"] = args[1]
            return next_fun(*args, **kwargs)

        with fnn.intercept_methods(capture):
            fwd(x)
        return cap["noise"]

    return want, np.asarray(jax.jit(drawn)(jnp.asarray(img)))


def _fresh(program_path, img, tmp):
    """The program loaded and called in a fresh interpreter: (output, the
    jax / flax / ddp_tpu / ddp_tpu_torch modules it loaded)."""
    inp, out = os.path.join(tmp, "img.npy"), os.path.join(tmp, "out.npy")
    np.save(inp, img)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.run([sys.executable, "-c", FRESH, program_path, inp, out], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return np.load(out), json.loads(proc.stdout.strip().splitlines()[-1])


@functools.lru_cache(maxsize=None)
def _case(case, tmp):
    mc, jm, variables = _models(case)
    img = np.random.RandomState(3).randn(2, *HW, 3).astype(np.float32)
    want, noise = _jax_artifact(jm, variables, img,
                                "denoise_depth" if case == "depth" else "denoise_logits")
    tm = build_model(mc, device="cpu", input_size=HW)
    variables = _np(variables)
    load_flax(tm, variables["params"], variables.get("batch_stats"))
    x, z = torch.from_numpy(img), torch.from_numpy(noise)
    before = tm.sample(x, None, z)
    for cache in CACHES:
        cache.cache.clear()
    # a trace on empty caches builds every constant while tracing
    cold = torch.export.export(export.ServedSample(tm, z), (x,))
    after = tm.sample(x, None, z)
    program = export.export_sample(tm, z, img.shape)
    path = os.path.join(tmp, f"{case}.pt2")
    torch.export.save(program, path)
    loaded = torch.export.load(path).module()(x)
    fresh, modules = _fresh(path, img, tmp)
    return dict(mc=mc, want=want, before=before, after=after, cold=cold, program=program,
                loaded=loaded, fresh=fresh, modules=modules)


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("export"))
    return lambda case: _case(case, tmp)


# --- the exported program --------------------------------------------------------------

@pytest.mark.parametrize("case", CASES)
def test_exported_program_matches_jax_artifact(cases, case):
    c = cases(case)
    got, want = c["fresh"], c["want"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    if case == "depth":
        assert got.shape == (2,) + HW
        assert got.min() >= c["mc"].min_depth and got.max() <= c["mc"].max_depth
    else:
        assert got.shape == (2,) + HW + (c["mc"].num_classes,)
        assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.999


@pytest.mark.parametrize("case", CASES)
def test_exported_program_is_the_eager_sample_bitwise(cases, case):
    c = cases(case)
    assert torch.equal(c["loaded"], c["before"])
    assert np.array_equal(c["fresh"], c["before"].numpy())


@pytest.mark.parametrize("case", CASES)
def test_graph_holds_one_encode_map_per_step(cases, case):
    c = cases(case)
    want = 0 if case == "depth" else c["mc"].diffusion.timesteps
    assert _encode_map_calls(c["program"]) == _encode_map_calls(c["cold"]) == want


@pytest.mark.parametrize("case", CASES)
def test_program_copies_no_constant_to_the_device(cases, case):
    """export_sample's program holds the cached constants as they are; a
    trace on empty caches copies each from the host at every call."""
    c = cases(case)
    assert _calls(c["program"], "aten.to.device") == 0
    assert _calls(c["cold"], "aten.to.device") > 0


@pytest.mark.parametrize("case", CASES)
def test_fresh_process_loads_no_model_code(cases, case):
    modules = cases(case)["modules"]
    assert not [m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "ddp_tpu")]
    assert "ddp_tpu_torch.ops.q_sample" in modules
    assert not [m for m in modules if m.startswith("ddp_tpu_torch.models")], modules


@pytest.mark.parametrize("case", CASES)
def test_eager_sample_after_export_is_unchanged_and_real(cases, case):
    """The first export traced on empty caches, the second (export_sample)
    on the ones the eager calls filled."""
    c = cases(case)
    assert type(c["after"]) is torch.Tensor and not isinstance(c["after"], FakeTensor)
    assert torch.equal(c["after"], c["before"])
    assert torch.equal(c["cold"].module()(torch.from_numpy(
        np.random.RandomState(3).randn(2, *HW, 3).astype(np.float32))), c["before"])
    assert isinstance(c["program"], torch.export.ExportedProgram)


def test_tracing_reads_but_never_fills_the_device_caches():
    """While tracing, a device-constant helper builds a missing tensor and
    keeps nothing, and hands out a cached one; run eagerly it caches one copy
    per arguments."""
    cache = resize._linear_weights_on.cache
    cache.clear()

    class Up(torch.nn.Module):
        def forward(self, x):
            return resize.resize(x, (9, 7), mode="bilinear")

    x = torch.randn(1, 5, 4, 2)
    cold = torch.export.export(Up(), (x,))
    assert len(cache) == 0 and _calls(cold, "aten.to.device") > 0
    want = Up()(x)
    assert len(cache) == 2
    entries = {k: [id(t) for t in v] for k, v in cache.items()}
    warm = torch.export.export(Up(), (x,))
    assert _calls(warm, "aten.to.device") == 0
    assert {k: [id(t) for t in v] for k, v in cache.items()} == entries
    assert all(type(t) is torch.Tensor for v in cache.values() for t in v)
    assert torch.equal(cold.module()(x), want) and torch.equal(warm.module()(x), want)
    assert resize._linear_weights_on(5, 9, False, x.device) is resize._linear_weights_on(
        5, 9, False, x.device)


# --- the CLI -------------------------------------------------------------------------------

def _run(module, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert module.main(argv) == 0
    return out.getvalue()


def test_cli_exports_smoke_on_the_cpu(tmp_path):
    path = str(tmp_path / "smoke.pt2")
    line = _run(export, ["smoke", path, "--size", "32", "--device", "cpu"]).splitlines()[-1]
    mb = os.path.getsize(path) / 1e6
    assert line == (f"exported {path} ({mb:.1f} MB), in [1, 32, 32, 3] float32 -> "
                    f"out [1, 32, 32, 7] torch.float32")
    cfg = get_config("smoke")
    model = build_model(cfg.model, device="cpu", seed=cfg.runtime.seed, input_size=(32, 32))
    img = torch.from_numpy(np.random.RandomState(4).randn(1, 32, 32, 3).astype(np.float32))
    want = model.sample(img, generator=torch.Generator().manual_seed(0))
    assert torch.equal(torch.export.load(path).module()(img), want)


def test_cli_refuses_a_bev_preset(tmp_path):
    with pytest.raises(SystemExit) as e:
        export.main(["smoke_bev", str(tmp_path / "bev.pt2"), "--device", "cpu"])
    assert e.value.code not in (0, None)
    assert not (tmp_path / "bev.pt2").exists()


def test_cli_runs_on_the_card_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        export.main(["smoke", str(tmp_path / "smoke.pt2"), "--size", "32"])


# --- flax's msgpack ----------------------------------------------------------------------

DTYPES = {"float32": (np.float32, torch.float32), "float16": (np.float16, torch.float16),
          "bfloat16": (jnp.bfloat16, torch.bfloat16), "int32": (np.int32, torch.int32),
          "int64": (np.int64, torch.int64), "uint8": (np.uint8, torch.uint8),
          "bool": (np.bool_, torch.bool)}


def _bits(t: torch.Tensor) -> bytes:
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


def _same(got, want):
    """``got`` (read_flax_msgpack's) is flax's ``want`` value for value, bit
    for bit for arrays and numpy scalars."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert isinstance(got, torch.Tensor)
        assert got.dtype == DTYPES[want.dtype.name][1] and tuple(got.shape) == want.shape
        assert _bits(got) == np.ascontiguousarray(want).tobytes()
    else:
        assert type(got) is type(want) and got == want


def _round_trip(tmp_path, tree):
    path = tmp_path / "tree.msgpack"
    path.write_bytes(fser.msgpack_serialize(tree))
    got = read_flax_msgpack(str(path))
    _same(got, fser.msgpack_restore(path.read_bytes()))
    return got


@pytest.mark.parametrize("name", sorted(DTYPES))
def test_msgpack_arrays_and_scalars_of_each_dtype(tmp_path, name):
    np_type = DTYPES[name][0]
    rng = np.random.RandomState(5)
    a = (rng.randn(3, 4, 5) * 50).astype(np.float32)
    tree = {"params": {"a": np.asarray(a, np_type), "empty": np.zeros((0, 3), np_type),
                       "zero_d": np.asarray(a[0, 0, 0], np_type)},
            "scalar": np.asarray(a[1, 2, 3], np_type)[()]}
    got = _round_trip(tmp_path, tree)
    assert got["scalar"].ndim == 0


def test_msgpack_maps_and_python_values(tmp_path):
    tree = {"params": {"Conv_0": {"kernel": np.ones((1, 1, 3, 2), np.float32),
                                  "bias": np.zeros(2, np.float32)}, "empty": {}},
            "batch_stats": {}, "ints": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                                        2 ** 63, -1, -32, -33, -128, -129, -32768,
                                        -32769, -2 ** 31 - 1, -2 ** 63],
            "floats": [0.5, -1e300, float("inf")], "flags": [True, False, None],
            "text": "é" * 40 + "x" * 300, "blob": b"\x00\x01" * 200,
            "wide": {f"k{i}": i for i in range(20)},
            "long": list(range(70000))}
    _round_trip(tmp_path, tree)


def test_msgpack_chunked_leaves(tmp_path, monkeypatch):
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 64)
    rng = np.random.RandomState(6)
    tree = {"params": {"big": rng.randn(7, 9).astype(np.float32),
                       "half": rng.randn(50).astype(jnp.bfloat16),
                       "small": np.arange(4, dtype=np.int32)}}
    blob = fser.msgpack_serialize(tree)
    assert blob.count(b"__msgpack_chunked_array__") == 2
    got = _round_trip(tmp_path, tree)
    assert _bits(got["params"]["big"]) == tree["params"]["big"].tobytes()


@pytest.mark.parametrize("payload", [
    fser.msgpack_serialize({"z": 1 + 2j}),                           # ext 2, complex
    b"\x81\xa1a\xd4\x05\x00",                                        # ext 5
    fser.msgpack_serialize({"a": np.zeros(3, np.float64)}),          # float64
], ids=["complex", "ext5", "float64"])
def test_msgpack_refuses_what_flax_params_do_not_hold(tmp_path, payload):
    path = tmp_path / "bad.msgpack"
    path.write_bytes(payload)
    with pytest.raises(ValueError, match="ext type|dtype"):
        read_flax_msgpack(str(path))


def _publish_jax(path, variables):
    """A file in the JAX ``tools/publish_model.py`` layout."""
    publish = {"params": variables["params"]}
    if variables.get("batch_stats"):
        publish["batch_stats"] = variables["batch_stats"]
    with open(path, "wb") as f:
        f.write(fser.msgpack_serialize(publish))


def test_published_msgpack_serves_as_load_flax(tmp_path):
    cfg = get_config("tiny_seg")
    jm = _jax_segmentor(cfg)
    variables = _np(jax.jit(lambda: _jax_seg_init(jm, HW))())
    path = str(tmp_path / "tiny-0000.msgpack")
    _publish_jax(path, variables)
    got = segmentor(cfg, path, torch.device("cpu"), input_size=HW)
    want = load_flax(build_model(cfg.model, device="cpu", input_size=HW),
                     variables["params"], variables["batch_stats"]).eval()
    sd_got, sd_want = got.state_dict(), want.state_dict()
    assert sd_got.keys() == sd_want.keys()
    assert all(torch.equal(sd_got[k], sd_want[k]) for k in sd_want)
    img = torch.from_numpy(np.random.RandomState(7).randn(1, *HW, 3).astype(np.float32))
    noise = torch.from_numpy(np.random.RandomState(8).randn(2, 16, 16, 64).astype(np.float32))
    assert torch.equal(got.sample(img, None, noise), want.sample(img, None, noise))


@functools.lru_cache(maxsize=None)
def _smoke_published(num_classes, tmp):
    """smoke's JAX init at ``num_classes``, published as JAX's .msgpack and,
    through load_flax, as the port's .pt."""
    jcfg = jconfig.get_config("smoke")
    jm = jconfig.build_model(dataclasses.replace(jcfg.model, num_classes=num_classes))
    variables = _np(jax.jit(lambda: _jax_seg_init(jm, (32, 32)))())
    msgpack_path = os.path.join(tmp, f"smoke{num_classes}-0000.msgpack")
    _publish_jax(msgpack_path, variables)
    cfg = get_config("smoke", {"model.num_classes": str(num_classes)})
    model = load_flax(build_model(cfg.model, device="cpu", input_size=(32, 32)),
                      variables["params"], variables.get("batch_stats"))
    pt_path = os.path.join(tmp, f"smoke{num_classes}-0000.pt")
    torch.save(model.state_dict(), pt_path)
    return msgpack_path, pt_path


def _tool_output(tool, ckpt, tmp):
    """What ``tool`` makes of ``ckpt``: its output file's bytes (or a loaded
    program's output) and its printed lines without the output path."""
    out = os.path.join(tmp, f"{tool}-{os.path.basename(ckpt)}")
    ade = ["--device", "cpu", "--set", "data.dataset=ade20k", f"data.data_root={ADE}",
           "model.num_classes=150"]
    if tool == "image_demo":
        img = os.path.join(tmp, "in.png")
        write_png(img, np.random.default_rng(5).integers(0, 256, (48, 64, 3), dtype=np.uint8))
        text = _run(image_demo, ["smoke", img, "--ckpt", ckpt, "--out", out] + ade)
    elif tool == "confusion_matrix":
        text = _run(confusion_matrix, ["smoke", "--ckpt", ckpt, "--out", out + ".npy"] + ade)
        out += ".npy"
    elif tool == "model_ensemble":
        return _run(model_ensemble, ["smoke", ckpt, ckpt] + ade)
    else:
        _run(export, ["smoke", out, "--size", "32", "--ckpt", ckpt, "--device", "cpu"])
        img = torch.from_numpy(np.random.RandomState(9).randn(1, 32, 32, 3).astype(np.float32))
        return torch.export.load(out).module()(img).numpy().tobytes()
    with open(out, "rb") as f:
        return f.read(), text.replace(out, "OUT")


@pytest.mark.parametrize("tool", ["image_demo", "confusion_matrix", "model_ensemble",
                                  "export"])
def test_every_ckpt_tool_takes_a_jax_msgpack(tmp_path_factory, tool):
    tmp = str(tmp_path_factory.getbasetemp())
    msgpack_path, pt_path = _smoke_published(7 if tool == "export" else 150, tmp)
    assert _tool_output(tool, msgpack_path, tmp) == _tool_output(tool, pt_path, tmp)
