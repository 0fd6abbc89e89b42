"""Weights given as numpy arrays → the port's ModelWeights.

`weights_from_numpy` lets the port compute on exactly the parameters of
another implementation (the tests hand it the JAX package's ModelWeights,
converted to numpy) without importing that implementation. The tree is a
nested dict:

    {"embed": QL, "lm_head": QL, "output_norm": array,
     "rope_cos": array, "rope_sin": array,
     "layers": {field of LayerWeights: QL, array or None}}

where QL = {"dtype": "q8_0" | "bf16" | ..., "k": int, "n": int,
"planes": {name: array}}. Scale planes may be uint16 (f16 bits; kept as
int16 with the same bits) and float planes may be ml_dtypes bfloat16 numpy,
which torch.from_numpy refuses: they are viewed as uint16 and then as
torch.bfloat16, bit for bit.

`batched_kv_from_numpy` does the same for a batched cache (k, v and, for an
int8 cache, its S-minor scales ks, vs), so two implementations can start
from one mid-context cache.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.dtypes import DType
from ..ops.linear import QLinear
from .batched import BatchedKV
from .llama import Arch, LayerWeights, ModelWeights


def array_to_torch(a, device) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # views of another framework's buffers
        a = a.copy()
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).view(np.int16)) \
            .view(torch.bfloat16).to(device)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).to(device)
    return torch.from_numpy(a).to(device)


def _qlinear(tree: dict, device) -> QLinear:
    return QLinear(DType(tree["dtype"]), int(tree["k"]), int(tree["n"]),
                   {nm: array_to_torch(a, device)
                    for nm, a in tree["planes"].items()})


def _leaf(v, device):
    if v is None:
        return None
    if isinstance(v, dict):
        return _qlinear(v, device)
    return array_to_torch(v, device)


def weights_from_numpy(tree: dict, arch: Arch, device) -> ModelWeights:
    """The port's ModelWeights for `arch` from a numpy tree (see module
    docstring), placed on `device`."""
    layers = LayerWeights(**{f: _leaf(tree["layers"].get(f), device)
                             for f in LayerWeights.__dataclass_fields__})
    if layers.attn_norm.shape[0] != arch.n_layers:
        raise ValueError(f"tree holds {layers.attn_norm.shape[0]} layers, "
                         f"arch {arch.n_layers}")
    return ModelWeights(
        embed=_qlinear(tree["embed"], device), layers=layers,
        output_norm=array_to_torch(tree["output_norm"], device),
        lm_head=_qlinear(tree["lm_head"], device),
        rope_cos=array_to_torch(tree["rope_cos"], device),
        rope_sin=array_to_torch(tree["rope_sin"], device))


def batched_kv_from_numpy(k, v, ks=None, vs=None, *,
                          device) -> BatchedKV:
    """The port's BatchedKV from numpy arrays: k/v [L, B, Hkv, S, D] bf16
    (ml_dtypes) or int8 codes, ks/vs [L, B, Hkv, S] f32 scales for int8,
    placed on `device` (no default, as weights_from_numpy)."""
    conv = (lambda a: None if a is None else array_to_torch(a, device))
    return BatchedKV(conv(k), conv(v), conv(ks), conv(vs))
