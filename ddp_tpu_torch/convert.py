"""Weight bridge: a flax parameter tree of ``ddp_tpu`` -> a torch state_dict.

The port's modules carry the flax module names, so a flax path maps to a
torch key by a fixed rename of flax's automatic submodule names and of the
leaf names, plus a layout change of the kernels:

  - Conv ``kernel`` [kh, kw, in, out] -> ``weight`` [out, in, kh, kw]
  - Dense ``kernel`` [in, out]        -> ``weight`` [out, in]
  - LayerNorm / GroupNorm / BatchNorm ``scale`` -> ``weight``
  - Embed ``embedding``               -> ``weight``
  - BatchNorm ``mean`` / ``var`` (the ``batch_stats`` collection) ->
    ``running_mean`` / ``running_var`` (and ``num_batches_tracked`` = 0)

Swin's PatchMerging uses the same (ky, kx, C) channel order in both packages,
so its reduction needs only the Dense transpose. The msda decoder's leaves
need no rule of their own: its modules carry the flax names
(``attn/{sampling_offsets,attention_weights,value_proj,output_proj}``,
``pos_enc/{row_embed,col_embed}/embedding``, FiLM v2/v3's 4C ``time_mlp``),
so the renames above map them. ConvNeXt's modules carry the flax names
too: its depthwise kernel [7, 7, 1, C] takes the Conv rule to [C, 1, 7, 7],
and its layer scale ``gamma`` keeps its name. So do the depther's (``down``,
``time_mlp``, ``decode_head/encoder``, ``conv_depth``, the 'upconv' head's
``up_conv``), and the BEV camera model's (``camera_neck/{lateral,fpn}{i}``,
``vtransform/{depthnet,down{i},down_bn{i}}``, ``bev_backbone/stage{s}_block{b}/
{conv1,bn1,conv2,bn2,down_conv,down_bn}``, ``bev_neck/{fuse1,fuse2,up}``,
``transform``, ``time_mlp``, ``embedding_table``, ``decode_head``); a named
BatchNorm's inner flax ``BatchNorm_0`` is dropped; the fusion model's
camera and head modules are the BEV camera model's, and its ``fuser_conv``
is a ConvModule. The ControlLDM's modules (``nn/unet.py``,
``nn/autoencoder.py``, ``nn/clip_text.py``, ``nn/attention.py``) carry the
flax names too and run NCHW, so their conv kernels take the Conv rule; the
trainer's ``ldm`` level is dropped, CLIP's bare ``position_embedding``
parameter keeps its name and layout. The compat zoo's modules
(``nn/resnet.py``, ``nn/mobile_hrnet.py``, ``nn/mit.py``, ``nn/vit.py``,
``nn/compat_heads.py``, the registry heads of ``nn/heads.py``,
``models/compat_segmentor.py``) carry the flax names; grouped and depthwise
kernels [kh, kw, in/g, out] take the Conv rule to torch's [out, in/g, kh,
kw]; a ConvModule's ``LayerNorm_0`` is its ``norm``; DAHead's
``pam_gamma``/``cam_gamma`` and ViT's ``pos_embed``/``cls_token`` keep their
names. The sparse conv layers (the fusion model's ``lidar_*``,
``SparseEncoder``'s) keep flax's leaf names and layouts (``kernel`` [K, Cin,
Cout], ``bn/{scale, bias}``, ``bn/{mean, var}``), so their leaves map as they
are. The other lidar pieces (``nn/second.py``, ``nn/dla_vovnet.py``,
``nn/bev.py: DepthLSSTransform``) carry the flax names; SECONDFPN's
``deconv{i}`` is a flax ``ConvTranspose`` (below). The compat zoo's part II
(``nn/compat_heads2.py``, ``nn/lightweight.py``) carries the flax names too:
a ``_TokenConvModule`` (a flax module with a ``Dense_0`` and a
``BatchNorm_0`` child) maps them to ``fc1`` and ``norm`` (its batch stats
so only beside its params, where the ``Dense_0`` shows); the Encoding's
``scale`` is its ``weight``; ``codewords``, K-Net's ``kernels``,
Segmenter's ``cls_emb`` and CGNet's ``prelu`` keep their names; EMANet's
batch stat ``bases`` is the buffer ``bases`` (no ``num_batches_tracked``:
it is no BatchNorm). Part II-b/c (``nn/transformer_backbones.py``,
``nn/diffswin.py``, ``nn/necks.py``, ``nn/depth_heads.py``) carries the flax
names too, with two layouts of their own:

  - flax ``ConvTranspose`` (Feature2Pyramid's ``up4_a{i}``, ``up4_b{i}``,
    ``up2_{i}``, SECONDFPN's ``deconv{i}``; ``transpose_kernel=False``, SAME
    at k = s): flax
    computes out[s·i + j] = x[i]·w[k − 1 − j] where torch's
    ``ConvTranspose2d`` takes W[j], so the kernel [kh, kw, in, out] becomes
    [in, out, kh, kw] with both spatial axes reversed (a copy, not a view);
  - flax ``MultiHeadDotProductAttention`` (AdaBins' ``attn{i}``): the
    ``query``/``key``/``value`` kernels [E, H, D] -> weight [H·D, E], ``out``
    [H, D, E] -> [E, H·D], the biases [H, D] -> [H·D];

and the bare parameters BEiT's ``rel_pos_table``, ``gamma1``, ``gamma2``,
HAHI's ``level_embed``, the mViT's ``pos`` and BinsFormer's ``query_feat``
keep their names. Leaves are numpy arrays (or
anything ``np.asarray`` takes); the state_dict holds views of them, not
copies. A flax leaf with no rule raises.
"""
from __future__ import annotations

import re
import warnings
from typing import Any, Dict, Iterator, Mapping, Optional, Set, Tuple

import numpy as np
import torch
from torch import nn

# flax's automatic submodule names -> the port's attribute names
_MODULE_RENAMES = (
    (("GroupNorm32_0", "GroupNorm_0"), ("norm",)),
    (("BatchNorm_0", "BatchNorm_0"), ("norm",)),
    # a named BatchNorm wrapper (the BEV modules' ``down_bn0``, ``bn1``): its
    # flax BatchNorm child is the torch module itself
    (("BatchNorm_0",), ()),
    (("Conv_0",), ("conv",)),
    # a ConvModule's (or ConvWithTime's) LayerNorm (``norm="LN"``)
    (("LayerNorm_0",), ("norm",)),
    (("Dense_0",), ("fc1",)),
    (("Dense_1",), ("fc2",)),
    (("LearnedSinusoidalPosEmb_0",), ("pos_emb",)),
    # the ControlNet trainer's ControlLDM child: the port's trainer is the
    # ControlLDM itself
    (("ldm",), ()),
)
_AUTO_NAME = re.compile(r"^[A-Z]\w*_\d+$")
_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
                 "bias": "bias", "weights": "weights", "gamma": "gamma",
                 "relative_position_bias_table": "relative_position_bias_table",
                 "position_embedding": "position_embedding",
                 # bare parameters of the compat zoo: DAHead's gates, ViT's
                 # position embedding and class token
                 "pam_gamma": "pam_gamma", "cam_gamma": "cam_gamma",
                 "pos_embed": "pos_embed", "cls_token": "cls_token",
                 # part II: the Encoding's codewords, K-Net's kernels,
                 # Segmenter's class embedding, CGNet's PReLU slopes
                 "codewords": "codewords", "kernels": "kernels", "cls_emb": "cls_emb",
                 "prelu": "prelu",
                 # part II-b/c: BEiT's relative-position table and layer
                 # scales, HAHI's level embedding, the mViT's positions,
                 # BinsFormer's bin queries
                 "rel_pos_table": "rel_pos_table", "gamma1": "gamma1", "gamma2": "gamma2",
                 "level_embed": "level_embed", "pos": "pos", "query_feat": "query_feat"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var", "bases": "bases"}
_BN_STATS = ("mean", "var")
# the fusion model's sparse conv layers, found by name where only batch
# stats are given
_VERBATIM_PREFIX = "lidar_"
# flax ConvTranspose modules: Feature2Pyramid's and SECONDFPN's
_CONV_TRANSPOSE = re.compile(r"^(up(4_[ab]|2_)\d+|deconv\d+)$")
# flax MultiHeadDotProductAttention's DenseGeneral children
_MHA = ("query", "key", "value", "out")


def _walk(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def _token_convs(params: Mapping, prefix: Tuple[str, ...] = ()) -> Set[Tuple[str, ...]]:
    """The flax modules with a ``Dense_0`` and a ``BatchNorm_0`` child: the
    compat zoo's ``_TokenConvModule``s, whose BatchNorm is the port's
    ``norm`` (elsewhere a lone ``BatchNorm_0`` is a named wrapper's child,
    the torch module itself)."""
    found = {prefix} if "Dense_0" in params and "BatchNorm_0" in params else set()
    for k, v in params.items():
        if isinstance(v, Mapping):
            found |= _token_convs(v, prefix + (str(k),))
    return found


def _module_path(path: Tuple[str, ...], token_convs: Set[Tuple[str, ...]] = frozenset()
                 ) -> Tuple[str, ...]:
    out, i = [], 0
    while i < len(path):
        if (path[i] == "BatchNorm_0" and path[:i] in token_convs
                and path[i + 1:i + 2] != ("BatchNorm_0",)):
            out.append("norm")
            i += 1
            continue
        for src, dst in _MODULE_RENAMES:
            if path[i:i + len(src)] == src:
                out.extend(dst)
                i += len(src)
                break
        else:
            if _AUTO_NAME.match(path[i]):
                raise KeyError(f"no rule for flax module {'/'.join(path)}")
            out.append(path[i])
            i += 1
    return tuple(out)


def _to_torch(leaf_name: str, value, module: str = "") -> torch.Tensor:
    """A view of the (transposed) leaf of flax module ``module``;
    ``load_state_dict`` copies it."""
    a = np.asarray(value)
    if leaf_name == "kernel" and _CONV_TRANSPOSE.match(module):
        a = np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1))
    elif leaf_name == "kernel" and a.ndim == 3 and module in _MHA:
        a = (a.reshape(-1, a.shape[-1]) if module == "out" else a.reshape(a.shape[0], -1)).T
    elif leaf_name == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.T
    elif leaf_name == "bias" and a.ndim == 2 and module in _MHA:
        a = a.reshape(-1)
    with warnings.catch_warnings():
        # arrays from jax are read-only; the view is only ever read
        warnings.filterwarnings("ignore", message="The given NumPy array is not writable")
        return torch.from_numpy(a)


def _sparse_layers(params: Mapping, prefix: Tuple[str, ...] = ()) -> Set[Tuple[str, ...]]:
    """The flax sparse conv layers (``nn/sparse_conv.py: SparseConvLayer``:
    the fusion model's ``lidar_*``, ``SparseEncoder``'s ``conv_input``,
    ``enc*``, ``conv_out``): a module with a 3-D ``kernel`` [K, Cin, Cout]
    beside a ``bn`` child."""
    found = set()
    kernel = params.get("kernel")
    if kernel is not None and np.ndim(kernel) == 3 and isinstance(params.get("bn"), Mapping):
        found.add(prefix)
    for k, v in params.items():
        if isinstance(v, Mapping):
            found |= _sparse_layers(v, prefix + (str(k),))
    return found


def _verbatim(path: Tuple[str, ...], value, sparse: Set[Tuple[str, ...]]
              ) -> Optional[Tuple[str, torch.Tensor]]:
    """A leaf of a sparse conv layer (one of ``sparse``, or a top-level
    ``lidar_*`` module), which carries flax's names and layouts (``kernel``
    [K, Cin, Cout], ``bn/{scale, bias}``, batch stats ``bn/{mean, var}``):
    its dotted path and the leaf as it is; None for every other leaf."""
    if not (path[0].startswith(_VERBATIM_PREFIX) or path[:-1] in sparse
            or (path[-2:-1] == ("bn",) and path[:-2] in sparse)):
        return None
    return ".".join(path), _to_torch("", value)


def params_from_flax(params: Mapping, batch_stats: Optional[Mapping] = None
                     ) -> Dict[str, torch.Tensor]:
    """Flax ``params`` (+ ``batch_stats``) -> torch state_dict. Raises on any
    flax leaf that no rule maps."""
    sd: Dict[str, torch.Tensor] = {}
    token_convs = _token_convs(params)
    sparse = _sparse_layers(params)
    for path, value in _walk(params):
        same = _verbatim(path, value, sparse)
        if same is not None:
            sd[same[0]] = same[1]
            continue
        *mod, leaf = path
        if leaf not in _PARAM_LEAVES:
            raise KeyError(f"no rule for flax leaf {'/'.join(path)}")
        key = ".".join(_module_path(tuple(mod), token_convs) + (_PARAM_LEAVES[leaf],))
        sd[key] = _to_torch(leaf, value, mod[-1] if mod else "")
    for path, value in _walk(batch_stats or {}):
        same = _verbatim(path, value, sparse)
        if same is not None:
            sd[same[0]] = same[1]
            continue
        *mod, leaf = path
        if leaf not in _STAT_LEAVES:
            raise KeyError(f"no rule for flax batch stat {'/'.join(path)}")
        prefix = ".".join(_module_path(tuple(mod), token_convs))
        sd[f"{prefix}.{_STAT_LEAVES[leaf]}"] = _to_torch(leaf, value)
        if leaf in _BN_STATS:
            sd[f"{prefix}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return sd


def check_complete(model: nn.Module, sd: Mapping[str, torch.Tensor]) -> None:
    """Raise unless ``sd`` fills every entry of ``model.state_dict()`` with the
    right shape and holds nothing else."""
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    missing = sorted(set(want) - set(sd))
    extra = sorted(set(sd) - set(want))
    shapes = sorted(f"{k}: {tuple(sd[k].shape)} != {want[k]}"
                    for k in set(want) & set(sd) if tuple(sd[k].shape) != want[k])
    if missing or extra or shapes:
        raise KeyError(f"state_dict mismatch: unfilled torch entries {missing}, "
                       f"unmapped flax leaves {extra}, shape mismatches {shapes}")


def load_flax(model: nn.Module, params: Mapping,
              batch_stats: Optional[Mapping] = None) -> nn.Module:
    """Load a flax tree into ``model`` in place (strict: see check_complete)."""
    sd = params_from_flax(params, batch_stats)
    check_complete(model, sd)
    model.load_state_dict(sd)
    return model
