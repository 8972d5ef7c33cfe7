"""Import the released mmseg DDP segmentor checkpoints (port of ``Importer``
and ``import_ddp_seg``, ``ddp_tpu/train/torch_import.py:53-252``: Swin and
ConvNeXt backbones), and SD 1.5 + ControlNet state_dicts in the cldm layout
(``import_sd_controlldm``, ``:258-520``; section at the end).

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


# --- the SD 1.5 ControlLDM (``ddp_tpu/train/torch_import.py:258-520``) --------------
#
# (cldm key, port key, kind) pairs over the cldm/model.py + tool_add_control.py
# layout (model.diffusion_model.*, control_model.*, first_stage_model.*,
# cond_stage_model.transformer.text_model.*). Both sides are torch layouts:
# conv and linear weights copy as they are, but SD 1.5's 1x1-conv projections
# (the spatial transformers' proj_in / proj_out, the VAE attention's q, k, v,
# proj_out) load into Linears, and HF CLIP's q/k/v projections into one qkv.

def _sd_res(t, p, in_ch, out_ch):
    pairs = [(f"{t}.in_layers.0", f"{p}.in_norm", "norm"),
             (f"{t}.in_layers.2", f"{p}.in_conv", "conv"),
             (f"{t}.emb_layers.1", f"{p}.emb_proj", "lin"),
             (f"{t}.out_layers.0", f"{p}.out_norm", "norm"),
             (f"{t}.out_layers.3", f"{p}.out_conv", "conv")]
    if in_ch != out_ch:
        pairs.append((f"{t}.skip_connection", f"{p}.skip", "conv"))
    return pairs


def _sd_st(t, p, depth=1):
    pairs = [(f"{t}.norm", f"{p}.norm", "norm"),
             (f"{t}.proj_in", f"{p}.proj_in", "conv_as_lin"),
             (f"{t}.proj_out", f"{p}.proj_out", "conv_as_lin")]
    for d in range(depth):
        tb, pb = f"{t}.transformer_blocks.{d}", f"{p}.block_{d}"
        for attn in ("attn1", "attn2"):
            pairs += [(f"{tb}.{attn}.to_q", f"{pb}.{attn}.to_q", "lin"),
                      (f"{tb}.{attn}.to_k", f"{pb}.{attn}.to_k", "lin"),
                      (f"{tb}.{attn}.to_v", f"{pb}.{attn}.to_v", "lin"),
                      (f"{tb}.{attn}.to_out.0", f"{pb}.{attn}.to_out", "lin")]
        pairs += [(f"{tb}.ff.net.0.proj", f"{pb}.ff.proj_in", "lin"),
                  (f"{tb}.ff.net.2", f"{pb}.ff.proj_out", "lin"),
                  (f"{tb}.norm1", f"{pb}.norm1", "norm"),
                  (f"{tb}.norm2", f"{pb}.norm2", "norm"),
                  (f"{tb}.norm3", f"{pb}.norm3", "norm")]
    return pairs


def sd_unet_pairs(cfg, tprefix: str, pprefix: str, decoder_half: bool = True):
    """The SD UNet's pairs (``decoder_half=False``: the time embedding, the
    encoder and the middle only, the ControlNet's copy)."""
    pairs = [(f"{tprefix}.time_embed.0", f"{pprefix}.time_embed_0", "lin"),
             (f"{tprefix}.time_embed.2", f"{pprefix}.time_embed_2", "lin"),
             (f"{tprefix}.input_blocks.0.0", f"{pprefix}.encoder.conv_in", "conv")]
    in_ch, ds, k = cfg.model_channels, 1, 1
    for level, mult in enumerate(cfg.channel_mult):
        out_ch = cfg.model_channels * mult
        for i in range(cfg.num_res_blocks):
            pairs += _sd_res(f"{tprefix}.input_blocks.{k}.0",
                             f"{pprefix}.encoder.res_{level}_{i}", in_ch, out_ch)
            if ds in cfg.attention_resolutions:
                pairs += _sd_st(f"{tprefix}.input_blocks.{k}.1",
                                f"{pprefix}.encoder.attn_{level}_{i}", cfg.transformer_depth)
            in_ch = out_ch
            k += 1
        if level != len(cfg.channel_mult) - 1:
            pairs.append((f"{tprefix}.input_blocks.{k}.0.op",
                          f"{pprefix}.encoder.down_{level}.conv", "conv"))
            k += 1
            ds *= 2
    for j, name in enumerate(("mid_res1", "mid_attn", "mid_res2")):
        t, p = f"{tprefix}.middle_block.{j}", f"{pprefix}.middle.{name}"
        pairs += (_sd_st(t, p, cfg.transformer_depth) if name == "mid_attn"
                  else _sd_res(t, p, in_ch, in_ch))
    if not decoder_half:
        return pairs
    from ..nn.unet import skip_channels

    skips = skip_channels(cfg)
    h_ch, k = in_ch, 0
    for level in reversed(range(len(cfg.channel_mult))):
        out_ch = cfg.model_channels * cfg.channel_mult[level]
        for i in range(cfg.num_res_blocks + 1):
            pairs += _sd_res(f"{tprefix}.output_blocks.{k}.0", f"{pprefix}.up_res_{level}_{i}",
                             h_ch + skips.pop(), out_ch)
            has_attn = ds in cfg.attention_resolutions
            if has_attn:
                pairs += _sd_st(f"{tprefix}.output_blocks.{k}.1",
                                f"{pprefix}.up_attn_{level}_{i}", cfg.transformer_depth)
            if level != 0 and i == cfg.num_res_blocks:
                pairs.append((f"{tprefix}.output_blocks.{k}.{2 if has_attn else 1}.conv",
                              f"{pprefix}.up_{level}.conv", "conv"))
            h_ch = out_ch
            k += 1
        if level != 0:
            ds //= 2
    return pairs + [(f"{tprefix}.out.0", f"{pprefix}.out_norm", "norm"),
                    (f"{tprefix}.out.2", f"{pprefix}.out_conv", "conv")]


def sd_controlnet_pairs(cfg, tprefix: str = "control_model", pprefix: str = "control_model"):
    """The ControlNet's pairs: the encoder copy, the hint block's convs (even
    indices of input_hint_block), the zero convs and middle_block_out."""
    from ..nn.unet import skip_channels

    pairs = sd_unet_pairs(cfg, tprefix, pprefix, decoder_half=False)
    pairs += [(f"{tprefix}.input_hint_block.{2 * i}", f"{pprefix}.hint.conv_{i}", "conv")
              for i in range(7)]
    pairs.append((f"{tprefix}.input_hint_block.14", f"{pprefix}.hint.zero_conv", "conv"))
    pairs += [(f"{tprefix}.zero_convs.{k}.0", f"{pprefix}.zero_conv_{k}", "conv")
              for k in range(len(skip_channels(cfg)))]
    return pairs + [(f"{tprefix}.middle_block_out.0", f"{pprefix}.middle_out", "conv")]


def _sd_vae_res(t, p, in_ch, out_ch):
    pairs = [(f"{t}.norm1", f"{p}.norm1", "norm"), (f"{t}.conv1", f"{p}.conv1", "conv"),
             (f"{t}.norm2", f"{p}.norm2", "norm"), (f"{t}.conv2", f"{p}.conv2", "conv")]
    if in_ch != out_ch:
        pairs.append((f"{t}.nin_shortcut", f"{p}.nin_shortcut", "conv"))
    return pairs


def _sd_vae_mid(t, p, ch):
    return (_sd_vae_res(f"{t}.mid.block_1", f"{p}.mid_block_1", ch, ch)
            + [(f"{t}.mid.attn_1.norm", f"{p}.mid_attn.norm", "norm")]
            + [(f"{t}.mid.attn_1.{n}", f"{p}.mid_attn.{n}", "conv_as_lin")
               for n in ("q", "k", "v", "proj_out")]
            + _sd_vae_res(f"{t}.mid.block_2", f"{p}.mid_block_2", ch, ch))


def sd_vae_pairs(ch: int = 128, ch_mult=(1, 2, 4, 4), nrb: int = 2,
                 tprefix: str = "first_stage_model", pprefix: str = "first_stage_model"):
    te, pe = f"{tprefix}.encoder", f"{pprefix}.encoder"
    pairs = [(f"{te}.conv_in", f"{pe}.conv_in", "conv")]
    in_ch = ch
    for level, mult in enumerate(ch_mult):
        for i in range(nrb):
            pairs += _sd_vae_res(f"{te}.down.{level}.block.{i}", f"{pe}.down_{level}_block_{i}",
                                 in_ch, ch * mult)
            in_ch = ch * mult
        if level != len(ch_mult) - 1:
            pairs.append((f"{te}.down.{level}.downsample.conv",
                          f"{pe}.down_{level}_downsample", "conv"))
    pairs += _sd_vae_mid(te, pe, in_ch)
    td, pd = f"{tprefix}.decoder", f"{pprefix}.decoder"
    pairs += [(f"{te}.norm_out", f"{pe}.norm_out", "norm"),
              (f"{te}.conv_out", f"{pe}.conv_out", "conv"),
              (f"{tprefix}.quant_conv", f"{pprefix}.quant_conv", "conv"),
              (f"{tprefix}.post_quant_conv", f"{pprefix}.post_quant_conv", "conv"),
              (f"{td}.conv_in", f"{pd}.conv_in", "conv")]
    in_ch = ch * ch_mult[-1]
    pairs += _sd_vae_mid(td, pd, in_ch)
    for level in reversed(range(len(ch_mult))):
        for i in range(nrb + 1):
            pairs += _sd_vae_res(f"{td}.up.{level}.block.{i}", f"{pd}.up_{level}_block_{i}",
                                 in_ch, ch * ch_mult[level])
            in_ch = ch * ch_mult[level]
        if level != 0:
            pairs.append((f"{td}.up.{level}.upsample.conv", f"{pd}.up_{level}_upsample",
                          "conv"))
    return pairs + [(f"{td}.norm_out", f"{pd}.norm_out", "norm"),
                    (f"{td}.conv_out", f"{pd}.conv_out", "conv")]


def sd_clip_pairs(layers: int = 12, tprefix: str = "cond_stage_model.transformer.text_model",
                  pprefix: str = "cond_stage_model"):
    pairs = [(f"{tprefix}.embeddings.token_embedding", f"{pprefix}.token_embedding", "lin"),
             (f"{tprefix}.embeddings.position_embedding", f"{pprefix}.position_embedding",
              "pos_embed"),
             (f"{tprefix}.final_layer_norm", f"{pprefix}.ln_final", "norm")]
    for i in range(layers):
        tb, pb = f"{tprefix}.encoder.layers.{i}", f"{pprefix}.block_{i}"
        pairs += [(f"{tb}.self_attn", f"{pb}.qkv", "clip_qkv"),
                  (f"{tb}.self_attn.out_proj", f"{pb}.out_proj", "lin"),
                  (f"{tb}.layer_norm1", f"{pb}.ln_1", "norm"),
                  (f"{tb}.layer_norm2", f"{pb}.ln_2", "norm"),
                  (f"{tb}.mlp.fc1", f"{pb}.fc1", "lin"), (f"{tb}.mlp.fc2", f"{pb}.fc2", "lin")]
    return pairs


def sd_controlldm_pairs(cfg, clip_layers: int = 12, vae_ch: int = 128,
                        vae_ch_mult=(1, 2, 4, 4), vae_nrb: int = 2):
    """Every (cldm key, port key, kind) pair of a ControlLDM."""
    return (sd_unet_pairs(cfg, "model.diffusion_model", "diffusion_model")
            + sd_controlnet_pairs(cfg) + sd_vae_pairs(vae_ch, vae_ch_mult, vae_nrb)
            + sd_clip_pairs(clip_layers))


def import_sd_controlldm(state: Mapping[str, object], cfg, clip_layers: int = 12,
                         vae_ch: int = 128, vae_ch_mult=(1, 2, 4, 4), vae_nrb: int = 2
                         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """A cldm-layout SD + ControlNet state_dict -> (the port's ControlLDM
    state_dict, the ``{missing, unused}`` report of cldm keys). ``cfg``: the
    ``UNetConfig``."""
    imp = Importer(state)
    for tkey, pkey, kind in sd_controlldm_pairs(cfg, clip_layers, vae_ch, vae_ch_mult, vae_nrb):
        if kind in ("conv", "lin", "norm"):
            imp.linear(tkey, pkey)
        elif kind == "conv_as_lin":
            imp.linear(tkey, pkey)
            if f"{pkey}.weight" in imp.sd:
                imp.sd[f"{pkey}.weight"] = imp.sd[f"{pkey}.weight"][:, :, 0, 0]
        elif kind == "pos_embed":
            imp.put(pkey, f"{tkey}.weight")
        elif kind == "clip_qkv":
            parts = [imp.take(f"{tkey}.{n}_proj.{leaf}") for leaf in ("weight", "bias")
                     for n in "qkv"]
            if all(x is not None for x in parts[:3]):
                imp.sd[f"{pkey}.weight"] = torch.cat(parts[:3])
            if all(x is not None for x in parts[3:]):
                imp.sd[f"{pkey}.bias"] = torch.cat(parts[3:])
        else:
            raise ValueError(f"unknown kind {kind}")
    unused = sorted(k for k in imp.state if k not in imp.used)
    return imp.sd, {"missing": imp.missing, "unused": unused}


def load_sd_controlldm(model, state: Mapping[str, object]) -> Dict[str, List[str]]:
    """Load a cldm-layout state_dict into a ``ControlLDM`` strictly: a missing
    or unused tensor, or one of another shape, raises."""
    sd, report = import_sd_controlldm(state, model.unet_cfg, model.cond_stage_model.layers,
                                      model.vae_ch, model.vae_ch_mult, model.vae_nrb)
    if report["missing"] or report["unused"]:
        raise KeyError(f"cldm state_dict does not match: missing {report['missing'][:10]} "
                       f"({len(report['missing'])}), unused {report['unused'][:10]} "
                       f"({len(report['unused'])})")
    model.load_state_dict(sd, strict=True)
    return report


def synthetic_sd_state(model, seed: int = 0) -> Dict[str, np.ndarray]:
    """A seeded random cldm-layout state_dict for ``model`` (a ControlLDM),
    numpy float32, shaped from the model through the pairs (no SD checkpoint
    is in the repository): every tensor N(0, 0.05^2) plus 1 for norm scales."""
    rng = np.random.RandomState(seed)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    st = {}

    def draw(key, shape, mean=0.0):
        st[key] = (mean + 0.05 * rng.randn(*shape)).astype(np.float32)

    for tkey, pkey, kind in sd_controlldm_pairs(model.unet_cfg, model.cond_stage_model.layers,
                                                model.vae_ch, model.vae_ch_mult, model.vae_nrb):
        if kind == "pos_embed":
            draw(f"{tkey}.weight", shapes[pkey])
            continue
        if kind == "clip_qkv":
            out, inp = shapes[f"{pkey}.weight"]
            for n in "qkv":
                draw(f"{tkey}.{n}_proj.weight", (out // 3, inp))
                draw(f"{tkey}.{n}_proj.bias", (out // 3,))
            continue
        w = shapes[f"{pkey}.weight"]
        draw(f"{tkey}.weight", w + (1, 1) if kind == "conv_as_lin" else w,
             1.0 if kind == "norm" else 0.0)
        if f"{pkey}.bias" in shapes:
            draw(f"{tkey}.bias", shapes[f"{pkey}.bias"])
    return st


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
