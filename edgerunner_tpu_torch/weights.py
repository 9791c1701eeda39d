"""Weights of the port: the JAX package's parameter tree, or the
reference-format `.safetensors` file, into an LMM's state_dict.

The naming is the reference state_dict naming that
tools/export_reference_ckpt.py:export_lmm emits (:116-128, `_shape_opt`
:76-93, `_point_encoder` :58-74); this module keeps its own copy of that
mapping. Flax kernels are [in, out], torch weights [out, in].
"""

from __future__ import annotations

import json
import struct

import numpy as np
import torch

from edgerunner_tpu_torch.models.point_encoder import point_freq_basis


def _linear(sd, prefix, tree):
    sd[prefix + ".weight"] = np.asarray(tree["kernel"], np.float32).T
    if "bias" in tree:
        sd[prefix + ".bias"] = np.asarray(tree["bias"], np.float32)


def _layernorm(sd, prefix, tree):
    sd[prefix + ".weight"] = np.asarray(tree["scale"], np.float32)
    sd[prefix + ".bias"] = np.asarray(tree["bias"], np.float32)


def _embedding(sd, prefix, tree):
    sd[prefix + ".weight"] = np.asarray(tree["embedding"], np.float32)


def _point_encoder(sd, prefix, tree):
    _linear(sd, prefix + ".point_embed.mlp", tree["point_embed"]["mlp"])
    freq = np.shape(tree["point_embed"]["mlp"]["kernel"])[0] - 3
    sd[prefix + ".point_embed.basis"] = point_freq_basis(freq)
    _layernorm(sd, prefix + ".ln", tree["ln"])
    block, cross = prefix + ".cross_att", tree["cross_att"]
    _layernorm(sd, block + ".ln1", cross["ln1"])
    _layernorm(sd, block + ".ln2", cross["ln2"])
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _linear(sd, f"{block}.att.{name}", cross["att"][name])
    _linear(sd, block + ".mlp.net.0", cross["mlp"]["fc_in"])
    _linear(sd, block + ".mlp.net.2", cross["mlp"]["fc_out"])
    _linear(sd, prefix + ".linear", tree["linear"])
    sd[prefix + ".query_embed"] = np.asarray(tree["query_embed"], np.float32)


def _shape_opt(sd, prefix, tree):
    model = tree["model"]
    _embedding(sd, prefix + ".model.embd", model["embd"])
    _embedding(sd, prefix + ".model.embed_positions", model["embed_positions"])
    i = 0
    while f"layers_{i}" in model:
        lt, lp = model[f"layers_{i}"], f"{prefix}.model.layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{lp}.self_attn.{name}", lt["self_attn"][name])
        _layernorm(sd, lp + ".self_attn_layer_norm", lt["self_attn_layer_norm"])
        _linear(sd, lp + ".fc1", lt["fc1"])
        _linear(sd, lp + ".fc2", lt["fc2"])
        _layernorm(sd, lp + ".final_layer_norm", lt["final_layer_norm"])
        i += 1
    _linear(sd, prefix + ".lm_head", tree["lm_head"])


def state_dict_from_flax(tree) -> dict:
    """The JAX package's LMM parameter tree (numpy leaves, with or without
    the top-level 'params') -> {reference name: numpy array}."""
    params = tree.get("params", tree)
    sd: dict = {}
    if "point_encoder" in params:
        _point_encoder(sd, "point_encoder", params["point_encoder"])
    if "proj_cond" in params:
        _linear(sd, "proj_cond", params["proj_cond"])
        _layernorm(sd, "norm_cond", params["norm_cond"])
    if "embed_num_face" in params:
        _embedding(sd, "embed_num_face", params["embed_num_face"])
    _shape_opt(sd, "mesh_decoder", params["mesh_decoder"])
    return sd


_ST_DTYPES = {"F32": np.float32, "F16": np.float16, "F64": np.float64,
              "I64": np.int64, "I32": np.int32, "I16": np.int16, "I8": np.int8,
              "U8": np.uint8, "BOOL": np.bool_}


def read_safetensors(path: str) -> dict:
    """{name: numpy array} from a .safetensors file (bf16 widened to f32),
    without the `safetensors` package."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        data = f.read()
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        begin, end = info["data_offsets"]
        raw = data[begin:end]
        if info["dtype"] == "BF16":
            bits = np.frombuffer(raw, "<u2").astype(np.uint32) << 16
            arr = bits.view(np.float32)
        elif info["dtype"] in _ST_DTYPES:
            arr = np.frombuffer(raw, np.dtype(_ST_DTYPES[info["dtype"]]).newbyteorder("<"))
        else:
            raise ValueError(f"{path}: tensor {name} has unsupported dtype {info['dtype']}")
        out[name] = arr.reshape(info["shape"]).copy()
    return out


def load_state(model: torch.nn.Module, state: dict) -> torch.nn.Module:
    """Load {name: array} into the model with strict=True; each value is
    copied into the tensor it replaces, taking that tensor's dtype and device."""
    model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in state.items()},
                          strict=True)
    return model
