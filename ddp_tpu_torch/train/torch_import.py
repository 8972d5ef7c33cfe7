"""Import the released mmseg DDP segmentor checkpoints (port of ``Importer``
and ``import_ddp_seg``, ``ddp_tpu/train/torch_import.py:53-252``: Swin and
ConvNeXt backbones).

An mmseg state_dict maps straight onto the port's state_dict: both are torch
layouts, so conv and linear weights copy as they are. What changes is names
and one permutation:

  - Swin's ``stages.{s}.blocks.{b}`` -> ``stage{s}_block{b}``; mmcls
    ConvNeXt's ``downsample_layers.0.{0,1}`` -> ``stem_{conv,norm}``,
    ``downsample_layers.{s}.{0,1}`` -> ``down_{norm,conv}{s}``,
    ``stages.{s}.{b}.{depthwise_conv,norm,pointwise_conv1,pointwise_conv2,gamma}``
    -> ``stage{s}_block{b}.{dwconv,norm,pwconv1,pwconv2,gamma}`` (the
    pointwise convs are Linears in both, the depthwise kernel [C, 1, 7, 7]
    in both); each backbone's ``norm{s}`` -> ``out_norm{s}``; the neck's
    ``neck.0`` (FPN) and ``neck.1.down`` (merge), the decoder's
    ``encoder.layers.{i}.attentions.0`` / ``ffns.0`` / ``norms.{0,1}`` /
    ``time_mlp.1``, the aux head's ``convs.0`` (with its BN running
    statistics), ``embedding_table``, ``transform`` and ``time_mlp.{0,1,3}``;
  - mmcv's ConvModule keeps its norm under ``.gn`` or ``.bn`` (the JAX
    importer reads ``.bn`` only; both are read here);
  - Swin's PatchMerging: mmseg's ``nn.Unfold`` emits the 4C inputs in (C,
    ky, kx) order, the port's in (ky, kx, C); the merge norm and the
    reduction's input columns are permuted;
  - ``relative_position_index`` and ``num_batches_tracked`` are dropped.

``import_mmseg_seg`` returns the port's state_dict and a ``{missing,
unused}`` report; ``load_mmseg_checkpoint`` reads a ``.pth`` (its
``state_dict`` entry, if it has one) and loads it strictly: a missing or
unused tensor, or one of another shape, raises with the preset's and the
tensor's names. The released checkpoints are msda-shaped (8 heads, 1 level,
4 points), so a preset of another decoder shape is refused, as is the JAX
package's ``ade20k_swin_t`` with the ``decoder_attn=msda`` override (4
heads; ROADMAP.md queue 3). A Cityscapes checkpoint loads into its preset
with both overrides (the window presets have 4 heads)::

    python -m ddp_tpu_torch.train.torch_import CKPT --preset ade20k_swin_t_msda --out DIR
    python -m ddp_tpu_torch.train.torch_import CKPT --preset cityscapes_convnext_t \
        --set model.decoder_attn=msda model.decoder_heads=8 --out DIR

writes DIR/ckpts/step_0.pt through ``train/checkpoint.py``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..nn.convnext import convnext_variant
from ..nn.swin import swin_variant
from ..nn.transformer import offset_bias_init


def _merge_perm(c_in: int) -> np.ndarray:
    """Index of the mmseg (C, ky, kx) position of each port (ky, kx, C)
    input of a PatchMerging over ``c_in`` channels."""
    return np.arange(4 * c_in).reshape(c_in, 4).T.reshape(-1)


class Importer:
    """Collects the port's state_dict from an mmseg one, recording which
    mmseg keys were missing and which it read."""

    def __init__(self, state: Mapping[str, object]):
        self.state = dict(state)
        self.used: set = set()
        self.missing: List[str] = []
        self.sd: Dict[str, torch.Tensor] = {}
        self.source: Dict[str, str] = {}  # port key -> mmseg key

    def take(self, key: str) -> Optional[torch.Tensor]:
        if key not in self.state:
            self.missing.append(key)
            return None
        self.used.add(key)
        value = self.state[key]
        if isinstance(value, torch.Tensor):
            return value.detach().cpu()
        return torch.as_tensor(np.asarray(value))

    def has(self, key: str) -> bool:
        return key in self.state

    def put(self, pkey: str, tkey: str, perm=None, dim: int = 0) -> None:
        value = self.take(tkey)
        if value is None:
            return
        if perm is not None and value.shape[dim] == len(perm):  # else refused by its shape
            value = value.index_select(dim, torch.from_numpy(perm))
        self.sd[pkey] = value
        self.source[pkey] = tkey

    def drop(self, key: str) -> None:
        if key in self.state:
            self.used.add(key)

    # --- modules ---------------------------------------------------------
    def layer_norm(self, tkey: str, pkey: str, perm=None) -> None:
        self.put(f"{pkey}.weight", f"{tkey}.weight", perm)
        self.put(f"{pkey}.bias", f"{tkey}.bias", perm)

    def linear(self, tkey: str, pkey: str) -> None:
        self.put(f"{pkey}.weight", f"{tkey}.weight")
        if self.has(f"{tkey}.bias"):
            self.put(f"{pkey}.bias", f"{tkey}.bias")

    def conv_module(self, tkey: str, pkey: str) -> None:
        """mmcv ConvModule: conv (+ bias) and its GN or BN under ``.gn``/``.bn``."""
        self.linear(f"{tkey}.conv", f"{pkey}.conv")
        norm = next((f"{tkey}.{n}" for n in ("gn", "bn") if self.has(f"{tkey}.{n}.weight")),
                    None)
        if norm is None:
            return
        self.layer_norm(norm, f"{pkey}.norm")
        if self.has(f"{norm}.running_mean"):
            self.put(f"{pkey}.norm.running_mean", f"{norm}.running_mean")
            self.put(f"{pkey}.norm.running_var", f"{norm}.running_var")
            self.sd[f"{pkey}.norm.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    def swin(self, depths, dims) -> None:
        t, p = "backbone", "backbone"
        self.linear(f"{t}.patch_embed.projection", f"{p}.patch_embed")
        self.layer_norm(f"{t}.patch_embed.norm", f"{p}.patch_norm")
        for si, depth in enumerate(depths):
            for bi in range(depth):
                tb, pb = f"{t}.stages.{si}.blocks.{bi}", f"{p}.stage{si}_block{bi}"
                self.layer_norm(f"{tb}.norm1", f"{pb}.norm1")
                self.layer_norm(f"{tb}.norm2", f"{pb}.norm2")
                a = f"{tb}.attn.w_msa"
                self.put(f"{pb}.attn.relative_position_bias_table",
                         f"{a}.relative_position_bias_table")
                self.drop(f"{a}.relative_position_index")
                self.linear(f"{a}.qkv", f"{pb}.attn.qkv")
                self.linear(f"{a}.proj", f"{pb}.attn.proj")
                self.linear(f"{tb}.ffn.layers.0.0", f"{pb}.ffn.fc1")
                self.linear(f"{tb}.ffn.layers.1", f"{pb}.ffn.fc2")
            if si < len(depths) - 1:
                perm = _merge_perm(dims[si])
                td, pd = f"{t}.stages.{si}.downsample", f"{p}.downsample{si}"
                self.layer_norm(f"{td}.norm", f"{pd}.norm", perm)
                self.put(f"{pd}.reduction.weight", f"{td}.reduction.weight", perm, dim=1)
        for si in range(len(depths)):
            self.layer_norm(f"{t}.norm{si}", f"{p}.out_norm{si}")

    def convnext(self, depths) -> None:
        t, p = "backbone", "backbone"
        self.linear(f"{t}.downsample_layers.0.0", f"{p}.stem_conv")
        self.layer_norm(f"{t}.downsample_layers.0.1", f"{p}.stem_norm")
        for si in range(1, len(depths)):
            self.layer_norm(f"{t}.downsample_layers.{si}.0", f"{p}.down_norm{si}")
            self.linear(f"{t}.downsample_layers.{si}.1", f"{p}.down_conv{si}")
        for si, depth in enumerate(depths):
            for bi in range(depth):
                tb, pb = f"{t}.stages.{si}.{bi}", f"{p}.stage{si}_block{bi}"
                self.linear(f"{tb}.depthwise_conv", f"{pb}.dwconv")
                self.layer_norm(f"{tb}.norm", f"{pb}.norm")
                self.linear(f"{tb}.pointwise_conv1", f"{pb}.pwconv1")
                self.linear(f"{tb}.pointwise_conv2", f"{pb}.pwconv2")
                self.put(f"{pb}.gamma", f"{tb}.gamma")
        for si in range(len(depths)):
            self.layer_norm(f"{t}.norm{si}", f"{p}.out_norm{si}")

    def fpn_and_merge(self) -> None:
        for i in range(4):
            self.conv_module(f"neck.0.lateral_convs.{i}", f"neck_fpn.lateral{i}")
            self.conv_module(f"neck.0.fpn_convs.{i}", f"neck_fpn.fpn{i}")
        self.conv_module("neck.1.down", "neck_merge.down")

    def decode_head(self, num_layers: int, learned_pos: bool) -> None:
        self.linear("decode_head.conv_seg", "decode_head.conv_seg")
        if learned_pos:
            for name in ("row_embed", "col_embed"):
                self.put(f"decode_head.pos_enc.{name}.weight",
                         f"decode_head.positional_encoding.{name}.weight")
        for i in range(num_layers):
            tl, pl = f"decode_head.encoder.layers.{i}", f"decode_head.encoder.layer{i}"
            for name in ("sampling_offsets", "attention_weights", "value_proj", "output_proj"):
                self.linear(f"{tl}.attentions.0.{name}", f"{pl}.attn.{name}")
            self.linear(f"{tl}.ffns.0.layers.0.0", f"{pl}.ffn.fc1")
            self.linear(f"{tl}.ffns.0.layers.1", f"{pl}.ffn.fc2")
            self.layer_norm(f"{tl}.norms.0", f"{pl}.norm1")
            self.layer_norm(f"{tl}.norms.1", f"{pl}.norm2")
            self.linear(f"{tl}.time_mlp.1", f"{pl}.time_mlp")

    def aux_head(self) -> None:
        self.conv_module("auxiliary_head.convs.0", "aux_head.conv0")
        self.linear("auxiliary_head.conv_seg", "aux_head.conv_seg")

    def diffusion_bits(self) -> None:
        self.put("embedding_table.weight", "embedding_table.weight")
        self.linear("transform.conv", "transform.conv")
        self.put("time_mlp.pos_emb.weights", "time_mlp.0.weights")
        self.linear("time_mlp.1", "time_mlp.fc1")
        self.linear("time_mlp.3", "time_mlp.fc2")


def import_mmseg_seg(state: Mapping[str, object], model_cfg
                     ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]], Dict[str, str]]:
    """An mmseg DDP segmentor state_dict -> (the port's state_dict, the
    ``{missing, unused}`` report of mmseg keys, port key -> mmseg key)."""
    if model_cfg.backbone_type not in ("swin", "convnext"):
        raise ValueError(f"unknown backbone {model_cfg.backbone_type!r}")
    if model_cfg.decoder_attn != "msda":
        raise ValueError(f"mmseg checkpoints hold an msda decoder; this config's decoder_attn "
                         f"is {model_cfg.decoder_attn!r}")
    imp = Importer(state)
    if model_cfg.backbone_type == "swin":
        kw = swin_variant(model_cfg.backbone_variant)
        imp.swin(kw["depths"], [kw["embed_dims"] * 2 ** i for i in range(len(kw["depths"]))])
    else:
        imp.convnext(convnext_variant(model_cfg.backbone_variant)["depths"])
    imp.fpn_and_merge()
    imp.decode_head(model_cfg.decoder_layers, model_cfg.decoder_pos == "learned")
    imp.aux_head()
    imp.diffusion_bits()
    unused = sorted(k for k in imp.state if k not in imp.used
                    and not k.endswith("num_batches_tracked"))
    return imp.sd, {"missing": imp.missing, "unused": unused}, imp.source


def synthetic_mmseg_state(m, seed: int = 0, gn: str = "bn") -> Dict[str, np.ndarray]:
    """A seeded random state_dict with the names and shapes of an mmseg DDP
    checkpoint of ``m`` (a ModelConfig: Swin or mmcls ConvNeXt, msda
    decoder with sine positions), numpy float32, for where no released
    checkpoint is at hand (the tests, ``chip_smoke.py``). Written from
    mmseg's and mmcls's module names, not from this module's mapping. The
    neck's GN sits under ``.{gn}`` (the JAX importer reads ``.bn``), the aux
    head's BN under ``.bn`` with running statistics. Matrices N(0, 1/fan_in), norm scales 1 + N(0, 0.1), biases
    N(0, 0.1), ConvNeXt's layer scales 0.5 + N(0, 0.1) (so that every block
    matters), BN variances U(0.5, 1.5), the sampling offsets' kernel N(0,
    0.01/fan_in) and its bias mmcv's ring + N(0, 0.04), so that the points
    move off their cells."""
    rng = np.random.RandomState(seed)
    st = {}

    def mat(key, *shape, scale=1.0):
        fan_in = int(np.prod(shape[1:]))
        st[key] = (rng.randn(*shape) * scale / fan_in ** 0.5).astype(np.float32)

    def vec(key, n, mean=0.0):
        st[key] = (mean + 0.1 * rng.randn(n)).astype(np.float32)

    def linear(key, out, inp, bias=True, scale=1.0):
        mat(f"{key}.weight", out, inp, scale=scale)
        if bias:
            vec(f"{key}.bias", out)

    def norm(key, n):
        vec(f"{key}.weight", n, 1.0)
        vec(f"{key}.bias", n)

    def conv_module(key, out, inp, k, bn=False):
        mat(f"{key}.conv.weight", out, inp, k, k)
        norm(f"{key}.{'bn' if bn else gn}", out)
        if bn:
            st[f"{key}.bn.running_mean"] = (0.1 * rng.randn(out)).astype(np.float32)
            st[f"{key}.bn.running_var"] = rng.uniform(0.5, 1.5, out).astype(np.float32)
            st[f"{key}.bn.num_batches_tracked"] = np.asarray(7, np.int64)

    if m.backbone_type == "swin":
        dims = _swin_state(st, rng, m.backbone_variant, mat, vec, linear, norm)
    else:
        dims = _convnext_state(st, rng, m.backbone_variant, mat, vec, linear, norm)
    e = m.embed_dims
    for i in range(4):
        conv_module(f"neck.0.lateral_convs.{i}", e, dims[i], 1)
        conv_module(f"neck.0.fpn_convs.{i}", e, e, 3)
    conv_module("neck.1.down", e, 4 * e, 1)
    k = m.num_classes
    mat("decode_head.conv_seg.weight", k, e, 1, 1)
    vec("decode_head.conv_seg.bias", k)
    n = m.decoder_heads * 4  # heads x 1 level x 4 points
    for i in range(m.decoder_layers):
        t = f"decode_head.encoder.layers.{i}"
        linear(f"{t}.attentions.0.sampling_offsets", 2 * n, e, scale=0.1)
        st[f"{t}.attentions.0.sampling_offsets.bias"] = offset_bias_init(
            m.decoder_heads, 1, 4) + (0.2 * rng.randn(2 * n)).astype(np.float32)
        linear(f"{t}.attentions.0.attention_weights", n, e)
        linear(f"{t}.attentions.0.value_proj", e, e)
        linear(f"{t}.attentions.0.output_proj", e, e)
        linear(f"{t}.ffns.0.layers.0.0", m.decoder_ffn_dim, e)
        linear(f"{t}.ffns.0.layers.1", e, m.decoder_ffn_dim)
        norm(f"{t}.norms.0", e)
        norm(f"{t}.norms.1", e)
        linear(f"{t}.time_mlp.1", 2 * e, 4 * e)
    conv_module("auxiliary_head.convs.0", e, e, 3, bn=True)
    mat("auxiliary_head.conv_seg.weight", k, e, 1, 1)
    vec("auxiliary_head.conv_seg.bias", k)
    st["embedding_table.weight"] = rng.randn(k + 1, e).astype(np.float32)
    mat("transform.conv.weight", e, 2 * e, 1, 1)
    vec("transform.conv.bias", e)
    st["time_mlp.0.weights"] = rng.randn(8).astype(np.float32)
    linear("time_mlp.1", 4 * e, 17)
    linear("time_mlp.3", 4 * e, 4 * e)
    return st


def _swin_state(st, rng, variant, mat, vec, linear, norm):
    """mmseg Swin's tensors into ``st``; returns the stages' widths."""
    kw = swin_variant(variant)
    dims = [kw["embed_dims"] * 2 ** i for i in range(4)]
    win = kw.get("window", 7)
    mat("backbone.patch_embed.projection.weight", dims[0], 3, 4, 4)
    vec("backbone.patch_embed.projection.bias", dims[0])
    norm("backbone.patch_embed.norm", dims[0])
    for si, depth in enumerate(kw["depths"]):
        c, heads = dims[si], kw["num_heads"][si]
        for bi in range(depth):
            t = f"backbone.stages.{si}.blocks.{bi}"
            norm(f"{t}.norm1", c)
            norm(f"{t}.norm2", c)
            st[f"{t}.attn.w_msa.relative_position_bias_table"] = (
                0.02 * rng.randn((2 * win - 1) ** 2, heads)).astype(np.float32)
            st[f"{t}.attn.w_msa.relative_position_index"] = np.zeros(
                (win * win, win * win), np.int64)
            linear(f"{t}.attn.w_msa.qkv", 3 * c, c)
            linear(f"{t}.attn.w_msa.proj", c, c)
            linear(f"{t}.ffn.layers.0.0", 4 * c, c)
            linear(f"{t}.ffn.layers.1", c, 4 * c)
        if si < 3:
            t = f"backbone.stages.{si}.downsample"
            norm(f"{t}.norm", 4 * c)
            linear(f"{t}.reduction", 2 * c, 4 * c, bias=False)
        norm(f"backbone.norm{si}", c)
    return dims


def _convnext_state(st, rng, variant, mat, vec, linear, norm):
    """mmcls ConvNeXt's tensors into ``st``; returns the stages' widths."""
    kw = convnext_variant(variant)
    dims = list(kw["dims"])
    mat("backbone.downsample_layers.0.0.weight", dims[0], 3, 4, 4)
    vec("backbone.downsample_layers.0.0.bias", dims[0])
    norm("backbone.downsample_layers.0.1", dims[0])
    for si in range(1, 4):
        norm(f"backbone.downsample_layers.{si}.0", dims[si - 1])
        mat(f"backbone.downsample_layers.{si}.1.weight", dims[si], dims[si - 1], 2, 2)
        vec(f"backbone.downsample_layers.{si}.1.bias", dims[si])
    for si, depth in enumerate(kw["depths"]):
        c = dims[si]
        for bi in range(depth):
            t = f"backbone.stages.{si}.{bi}"
            mat(f"{t}.depthwise_conv.weight", c, 1, 7, 7)
            vec(f"{t}.depthwise_conv.bias", c)
            norm(f"{t}.norm", c)
            linear(f"{t}.pointwise_conv1", 4 * c, c)
            linear(f"{t}.pointwise_conv2", c, 4 * c)
            vec(f"{t}.gamma", c, 0.5)
        norm(f"backbone.norm{si}", c)
    return dims


def load_mmseg_state(model: torch.nn.Module, state: Mapping[str, object], cfg
                     ) -> Dict[str, List[str]]:
    """Load an mmseg state_dict into ``model`` (built from ``cfg``) strictly.
    Raises, naming the preset and the tensor, on a missing or unused tensor
    or a shape the model does not have; returns the (empty) report."""
    sd, report, source = import_mmseg_seg(state, cfg.model)
    if report["missing"] or report["unused"]:
        raise KeyError(f"preset {cfg.name}: mmseg checkpoint does not match: missing "
                       f"{report['missing'][:10]} ({len(report['missing'])}), unused "
                       f"{report['unused'][:10]} ({len(report['unused'])})")
    want = model.state_dict()
    for key, value in sd.items():
        if tuple(value.shape) != tuple(want[key].shape):
            msg = (f"preset {cfg.name}: mmseg tensor {source.get(key, key)} has shape "
                   f"{tuple(value.shape)}, the port's {key} needs {tuple(want[key].shape)}")
            if key.endswith("sampling_offsets.weight"):
                attn = model.get_submodule(key[:-len(".sampling_offsets.weight")])
                per_head = 2 * attn.num_levels * attn.num_points
                msg += (f": the checkpoint has {value.shape[0] // per_head} decoder heads, "
                        f"the preset {attn.num_heads}")
            raise ValueError(msg)
    unfilled = sorted(set(want) - set(sd))
    if unfilled:
        raise KeyError(f"preset {cfg.name}: no mmseg tensor fills {unfilled[:10]}")
    model.load_state_dict(sd)
    return report


def read_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The tensors of a ``torch.save``d mmseg checkpoint (its ``state_dict``
    entry, if it has one), unpickled with ``weights_only``."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    state = raw.get("state_dict", raw)
    return {k: v for k, v in state.items() if isinstance(v, torch.Tensor)}


def load_mmseg_checkpoint(path: str, cfg, device=None):
    """(model, report): ``cfg``'s segmentor on ``device`` (default "cuda")
    with the weights of the mmseg checkpoint at ``path``, loaded strictly
    (``load_mmseg_state``)."""
    from ..config import build_model

    model = build_model(cfg.model, device=device, seed=cfg.runtime.seed,
                        input_size=cfg.data.crop_size)
    report = load_mmseg_state(model, read_state_dict(path), cfg)
    return model, report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Convert an mmseg DDP checkpoint (.pth) into "
                                             "a port checkpoint (<out>/ckpts/step_0.pt).")
    ap.add_argument("ckpt")
    ap.add_argument("--preset", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--set", nargs="*", default=[], metavar="K=V",
                    help="config overrides, e.g. model.decoder_attn=msda model.decoder_heads=8")
    ap.add_argument("--device", help="default: cuda")
    args = ap.parse_args(argv)

    import dataclasses

    from ..config import get_config
    from .checkpoint import CheckpointManager
    from .optim import make_optimizer
    from .step import TrainState

    cfg = get_config(args.preset, dict(kv.split("=", 1) for kv in args.set))
    model, report = load_mmseg_checkpoint(args.ckpt, cfg, args.device)
    print(f"missing ({len(report['missing'])}), unused ({len(report['unused'])})")
    device = next(model.parameters()).device
    state = TrainState(model, make_optimizer(cfg.optim, model),
                       torch.Generator(device=device).manual_seed(cfg.runtime.seed))
    cfg = dataclasses.replace(cfg, runtime=dataclasses.replace(cfg.runtime, workdir=args.out))
    CheckpointManager(args.out).save(0, state, meta={"config": cfg, "imported_from": args.ckpt,
                                                     "num_classes": cfg.model.num_classes})
    print(f"saved to {args.out}/ckpts/step_0.pt")
    return 0


if __name__ == "__main__":
    sys.exit(main())
