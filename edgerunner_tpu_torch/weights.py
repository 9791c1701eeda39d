"""Weights of the port: the JAX package's parameter tree, or the
reference-format `.safetensors` file, into an LMM's state_dict; and the
port's own weights out, in the same naming, to a `.safetensors` file that
loads back through `read_safetensors` + `load_state` (and into the JAX
package's tree through `flax_from_state_dict`).

The naming is the reference state_dict naming that
tools/export_reference_ckpt.py:export_lmm emits (:116-128, `_shape_opt`
:76-93, `_point_encoder` :58-74); this module keeps its own copy of that
mapping. Flax kernels are [in, out], torch weights [out, in].

`export_lmm` has no name for the multi-token-prediction draft heads
(`--mtp_heads`): the port names head k `mesh_decoder.mtp_{k}.weight` and
`.bias`, after the JAX module `mtp_{k}` beside `lm_head`, and carries them
both ways; a model with draft heads loads only weights that hold them
(strict=True).

A `w_quant` model loads as the JAX package loads one (serve.py:497-505,
infer.py:124-133): the exact weights cross over into the plain model and
its decoder projections are quantised after (`load_for_inference`).
"""

from __future__ import annotations

import json
import os
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
    k = 0
    while f"mtp_{k}" in tree:
        _linear(sd, f"{prefix}.mtp_{k}", tree[f"mtp_{k}"])
        k += 1


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


def load_for_inference(model: torch.nn.Module, opt) -> torch.nn.Module:
    """The exact weights into an LMM, from the `.safetensors` file
    `opt.resume` or drawn from `opt.seed`; then, with `opt.w_quant`, its
    decoder projections quantised to int8 in place. Returns it in eval mode."""
    from edgerunner_tpu_torch.models.lmm import init_weights
    from edgerunner_tpu_torch.ops.w_quant import quantize_lmm_params

    if opt.resume:
        load_state(model, read_safetensors(opt.resume))
    else:
        init_weights(model, opt.seed)
    if opt.w_quant:
        quantize_lmm_params(model)
    return model.eval()


def reference_state_dict(model: torch.nn.Module) -> dict:
    """The model's weights as {reference name: f32 numpy array}: the port's
    parameter names are the reference naming, so this is the state_dict that
    `state_dict_from_flax` would give for the same weights."""
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}


def _unlinear(tree, sd, prefix):
    tree["kernel"] = sd[prefix + ".weight"].T
    if prefix + ".bias" in sd:
        tree["bias"] = sd[prefix + ".bias"]
    return tree


def _unlayernorm(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def flax_from_state_dict(sd: dict) -> dict:
    """The inverse of `state_dict_from_flax`: {reference name: array} -> the
    JAX package's LMM parameter tree {'params': ...} (the point basis, a
    fixed table rather than a weight, has no place in it)."""
    params: dict = {}
    if "point_encoder.linear.weight" in sd:
        p, cross = "point_encoder", "point_encoder.cross_att"
        att = {n: _unlinear({}, sd, f"{cross}.att.{n}")
               for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
        params["point_encoder"] = {
            "point_embed": {"mlp": _unlinear({}, sd, p + ".point_embed.mlp")},
            "ln": _unlayernorm(sd, p + ".ln"),
            "cross_att": {"ln1": _unlayernorm(sd, cross + ".ln1"),
                          "ln2": _unlayernorm(sd, cross + ".ln2"), "att": att,
                          "mlp": {"fc_in": _unlinear({}, sd, cross + ".mlp.net.0"),
                                  "fc_out": _unlinear({}, sd, cross + ".mlp.net.2")}},
            "linear": _unlinear({}, sd, p + ".linear"),
            "query_embed": sd[p + ".query_embed"],
        }
    if "proj_cond.weight" in sd:
        params["proj_cond"] = _unlinear({}, sd, "proj_cond")
        params["norm_cond"] = _unlayernorm(sd, "norm_cond")
    if "embed_num_face.weight" in sd:
        params["embed_num_face"] = {"embedding": sd["embed_num_face.weight"]}
    m = "mesh_decoder.model"
    model = {"embd": {"embedding": sd[m + ".embd.weight"]},
             "embed_positions": {"embedding": sd[m + ".embed_positions.weight"]}}
    i = 0
    while f"{m}.layers.{i}.fc1.weight" in sd:
        lp = f"{m}.layers.{i}"
        model[f"layers_{i}"] = {
            "self_attn": {n: _unlinear({}, sd, f"{lp}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": _unlayernorm(sd, lp + ".self_attn_layer_norm"),
            "fc1": _unlinear({}, sd, lp + ".fc1"),
            "fc2": _unlinear({}, sd, lp + ".fc2"),
            "final_layer_norm": _unlayernorm(sd, lp + ".final_layer_norm"),
        }
        i += 1
    params["mesh_decoder"] = {"model": model,
                              "lm_head": _unlinear({}, sd, "mesh_decoder.lm_head")}
    k = 0
    while f"mesh_decoder.mtp_{k}.weight" in sd:
        params["mesh_decoder"][f"mtp_{k}"] = _unlinear({}, sd, f"mesh_decoder.mtp_{k}")
        k += 1
    return {"params": params}


def write_safetensors(path: str, tensors: dict):
    """Write {name: numpy array} as a .safetensors file, without the
    `safetensors` package; the file is written whole, then moved into place."""
    codes = {np.dtype(v): k for k, v in _ST_DTYPES.items()}
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        arr = np.ascontiguousarray(tensors[name])
        raw = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
        header[name] = {"dtype": codes[arr.dtype], "shape": list(arr.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        blobs.append(raw)
        offset += len(raw)
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(head)))
        f.write(head)
        for raw in blobs:
            f.write(raw)
    os.replace(tmp, path)
