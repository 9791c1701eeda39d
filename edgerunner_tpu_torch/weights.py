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
both ways; through `load_state` (strict=True) a model with draft heads
loads only weights that hold them, through `--resume` (`merge_checkpoint`)
it keeps the seed's heads where the file has none, as the JAX package's
merge does.

`export_lmm` has no names for the MoE decoder or the LoRA adapters either;
the port picks them after the JAX modules and carries them both ways:
layer i's routed MLP as `mesh_decoder.model.layers.{i}.moe.router.weight`
/ `.bias` (the router, [E, C] as any torch weight) and `.moe.w1`, `.b1`,
`.w2`, `.b2` (the stacked experts in the JAX layout, [E, C, F], [E, F],
[E, F, C], [E, C]) in place of fc1/fc2; an adapted projection's adapters
as `...q_proj.lora_a` [in, r] and `...q_proj.lora_b` [r, out] beside its
weight and bias (the JAX layout, not transposed). A dense checkpoint
merges into a LoRA model through `tolerant_merge`: the adapters stay at
the seed's values and are logged as missing.

A `w_quant` model loads as the JAX package loads one (serve.py:497-505,
infer.py:124-133): the exact weights cross over into the plain model and
its decoder projections are quantised after (`load_for_inference`).

The MDiT (image pipeline) crosses over the same way: `mdit_state_dict_from_flax`
takes export_mdit's names for `dit`, `proj_cond`, `norm_cond` and
`point_encoder` (tools/export_reference_ckpt.py:94-113, :131-140) and gives
the CLIP tower `image_encoder.` + HuggingFace CLIPVisionModel's names, the
inverse of the JAX package's `convert_hf_clip_params`; an image-conditioned
LMM's tower (cond_mode 'image') crosses over under the same names, both
ways. tools/export_reference_ckpt.py:export_lmm leaves the tower out, so a
JAX image checkpoint crosses over through `state_dict_from_flax` (which
keeps it), or gets its tower through `--resume2` (`overlay_checkpoint`).

The JAX package's stacked layer layout (`--scan_layers`, set by
`--pp_size` > 1: one `layers_scanned/layer` subtree of [L, ...] leaves in
place of `layers_{i}`) crosses over both ways too: `state_dict_from_flax`
reads either layout, and `flax_from_state_dict(sd, scan_layers=True)`
writes the stacked one, through the port's copies of the JAX converters
(`stack_layer_params`, `unstack_layer_params`, `normalize_layer_layout`,
edgerunner_tpu/parallel/pipeline.py:168-230), anchored, as there, on the
decoder's `embed_positions`, so that CLIP's and the DiT's `layers_{i}` are
left alone. The port's own files keep the per-layer naming at every pp.

`tolerant_merge` is the non-strict load (edgerunner_tpu/train/checkpoint.py:
99-130): it copies the entries whose name and shape match, realigns
position embeddings of another length by `--align_posemb`, keeps the
model's own value of every other entry, and logs every missing, mismatched
and unexpected entry. It takes `--resume` in `main`, `infer`, `infer_dit`
and `serve` (`merge_checkpoint`, over the weights the seed drew, as the JAX
package's main.py:117-126 and `load_params_for_inference`,
edgerunner_tpu/train/checkpoint.py:319-333, take it), and `main_dit`'s
`--resume` and `--resume2`. A point_latent LMM drops an ArAE checkpoint's
`point_encoder.*` entries first (it has no point encoder). So a JAX-trained
image checkpoint exported without its tower (export_lmm) loads, the tower
kept from the seed or taken from `--resume2`.
`overlay_checkpoint` is the ArAE's `--resume2` in `main` and `infer`
(edgerunner_tpu/train/checkpoint.py:334-342, main.py:142-149): a partial
file, such as a pretrained CLIP tower in HuggingFace naming, merged over
the weights that `--resume` or the seed gave. `load_state` stays strict: it
is the exact crossover of the parity tests and of `load_mdit`.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from edgerunner_tpu_torch.models.clip_vit import clip_state_from_hf, init_clip_tower
from edgerunner_tpu_torch.models.layers import normal_
from edgerunner_tpu_torch.models.moe import EXPERT_PARAMS
from edgerunner_tpu_torch.models.point_encoder import point_freq_basis


def _linear(sd, prefix, tree):
    sd[prefix + ".weight"] = np.asarray(tree["kernel"], np.float32).T
    for name in ("bias", "lora_a", "lora_b"):  # the adapters in the JAX layout
        if name in tree:
            sd[f"{prefix}.{name}"] = np.asarray(tree[name], np.float32)


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
    if "query_embed" in tree:  # the learned queries of 'embed'; 'downsample' has none
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
        if "moe" in lt:
            _linear(sd, lp + ".moe.router", lt["moe"]["router"])
            for name in EXPERT_PARAMS:
                sd[f"{lp}.moe.{name}"] = np.asarray(lt["moe"][name], np.float32)
        else:
            _linear(sd, lp + ".fc1", lt["fc1"])
            _linear(sd, lp + ".fc2", lt["fc2"])
        _layernorm(sd, lp + ".final_layer_norm", lt["final_layer_norm"])
        i += 1
    _linear(sd, prefix + ".lm_head", tree["lm_head"])
    k = 0
    while f"mtp_{k}" in tree:
        _linear(sd, f"{prefix}.mtp_{k}", tree[f"mtp_{k}"])
        k += 1


_SCANNED = "layers_scanned"


def _tree_map(fn, *trees):
    """fn over the leaves of nested dicts of one structure."""
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def _find_layer_parent(tree, key_sub: str):
    """(the decoder's dict holding `key_sub` entries, those keys), found
    depth first and anchored on its sibling 'embed_positions' entry (CLIP
    and the DiT name their blocks layers_{i} too); (None, []) if none."""
    if not isinstance(tree, dict):
        return None, []
    keys = [k for k in tree if k == key_sub or (key_sub == "layers_" and k.startswith(
        "layers_") and k[len("layers_"):].isdigit())]
    if keys and "embed_positions" in tree:
        return tree, keys
    for v in tree.values():
        parent, found = _find_layer_parent(v, key_sub)
        if parent is not None:
            return parent, found
    return None, []


def stack_layer_params(tree: dict) -> dict:
    """The per-layer `layers_{i}` subtrees -> one `layers_scanned/layer`
    subtree of stacked [L, ...] leaves; everything else as it is. A new
    tree (the leaves of the rest shared)."""
    tree = _tree_map(lambda x: x, tree)
    parent, keys = _find_layer_parent(tree, "layers_")
    if parent is None:
        raise ValueError("no layers_{i} subtrees found")
    subtrees = [parent.pop(k) for k in sorted(keys, key=lambda k: int(k.split("_")[-1]))]
    parent[_SCANNED] = {"layer": _tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]),
                                           *subtrees)}
    return tree


def unstack_layer_params(tree: dict) -> dict:
    """The stacked `layers_scanned/layer` subtree -> `layers_{i}` subtrees."""
    tree = _tree_map(lambda x: x, tree)
    parent, _ = _find_layer_parent(tree, _SCANNED)
    if parent is None:
        raise ValueError("no layers_scanned subtree found")
    stacked = parent.pop(_SCANNED)["layer"]
    first = stacked
    while isinstance(first, dict):
        first = next(iter(first.values()))
    for i in range(np.asarray(first).shape[0]):
        parent[f"layers_{i}"] = _tree_map(lambda x: np.asarray(x)[i], stacked)
    return tree


def has_scanned_layers(tree: dict) -> bool:
    return _find_layer_parent(tree, _SCANNED)[0] is not None


def normalize_layer_layout(tree: dict, scan_layers: bool) -> dict:
    """A parameter tree in the layout `scan_layers` asks for; the tree
    itself when it is in it already or holds no decoder layers (a partial
    checkpoint)."""
    if scan_layers and not has_scanned_layers(tree):
        parent, _ = _find_layer_parent(tree, "layers_")
        return stack_layer_params(tree) if parent is not None else tree
    if not scan_layers and has_scanned_layers(tree):
        return unstack_layer_params(tree)
    return tree


def state_dict_from_flax(tree) -> dict:
    """The JAX package's LMM parameter tree (numpy leaves, with or without
    the top-level 'params'; per-layer or stacked) -> {reference name: numpy
    array}."""
    params = normalize_layer_layout(tree.get("params", tree), False)
    sd: dict = {}
    if "image_encoder" in params:
        sd.update(clip_state_dict_from_flax(params["image_encoder"], "image_encoder."))
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


def merge_checkpoint(model: torch.nn.Module, state: dict, align_posemb: str = "right",
                     log=print) -> torch.nn.Module:
    """{name: array} merged over the model's own weights with
    `tolerant_merge` (every missing, mismatched and unexpected entry logged,
    position embeddings realigned), loaded in place."""
    return load_state(model, tolerant_merge(reference_state_dict(model), state,
                                            align_posemb=align_posemb, log=log))


def load_for_inference(model: torch.nn.Module, opt, overlay: Optional[str] = None
                       ) -> torch.nn.Module:
    """Weights into an LMM as the JAX package's `load_params_for_inference`
    gives them: drawn from `opt.seed`, then the `.safetensors` file
    `opt.resume` merged over them (`merge_checkpoint`; a point_latent LMM
    first drops the file's `point_encoder.*` entries); with `overlay`
    (infer's `--resume2`), that file merged over them (`overlay_checkpoint`);
    then, with `opt.w_quant`, its decoder projections quantised to int8 in
    place. Returns it in eval mode."""
    from edgerunner_tpu_torch.models.lmm import init_weights
    from edgerunner_tpu_torch.ops.w_quant import quantize_lmm_params

    init_weights(model, opt.seed)
    if opt.resume:
        state = read_safetensors(opt.resume)
        if opt.cond_mode == "point_latent":
            state = {k: v for k, v in state.items() if not k.startswith("point_encoder.")}
        merge_checkpoint(model, state, opt.align_posemb)
    if overlay:
        overlay_checkpoint(model, overlay, opt.align_posemb)
        print(f"[INFO] Merged secondary checkpoint from {overlay}")
    if opt.w_quant:
        quantize_lmm_params(model)
    return model.eval()


def reference_state_dict(model: torch.nn.Module) -> dict:
    """The model's weights as {reference name: f32 numpy array}: the port's
    parameter names are the reference naming, so this is the state_dict that
    `state_dict_from_flax` would give for the same weights."""
    return {k: v.detach().float().cpu().numpy() for k, v in model.state_dict().items()}


def _realign_posemb(ckpt_w: np.ndarray, model_w: np.ndarray, align: str) -> np.ndarray:
    """A loaded position-embedding table laid onto a table of another length,
    at its left or right end (reference: main.py:77-89)."""
    out = np.array(model_w)
    n_ckpt, n_model = ckpt_w.shape[0], model_w.shape[0]
    if n_model > n_ckpt:
        if align == "right":
            out[-n_ckpt:] = ckpt_w
        else:
            out[:n_ckpt] = ckpt_w
    else:
        out = ckpt_w[:n_model] if align == "left" else ckpt_w[-n_model:]
    return out


def tolerant_merge(model_state: dict, ckpt_state: dict, align_posemb: str = "right",
                   log=print) -> dict:
    """{name: array} of the model's entries, each taken from the checkpoint
    where the name and the shape match (in the model's dtype), an
    `embed_positions` table of another length realigned, every other entry
    kept; missing, mismatched and unexpected entries are logged."""
    merged = {}
    for key, mv in model_state.items():
        mv = np.asarray(mv)
        if key not in ckpt_state:
            log(f"[ckpt] missing param {key}: keeping init")
            merged[key] = mv
            continue
        cv = np.asarray(ckpt_state[key])
        if cv.shape == mv.shape:
            merged[key] = cv.astype(mv.dtype)
        elif "embed_positions" in key and cv.ndim == 2 and cv.shape[1] == mv.shape[1]:
            log(f"[ckpt] realigning position embeddings {cv.shape} -> {mv.shape} "
                f"({align_posemb})")
            merged[key] = _realign_posemb(cv, mv, align_posemb).astype(mv.dtype)
        else:
            log(f"[ckpt] shape mismatch for {key}: ckpt {cv.shape} != model {mv.shape}, "
                f"ignored")
            merged[key] = mv
    for key in ckpt_state:
        if key not in model_state:
            log(f"[ckpt] unexpected param {key}")
    return merged


def overlay_state(path: str) -> dict:
    """{name: array} of the `.safetensors` file `path` in the port's naming.
    Entries in HuggingFace CLIPVisionModel's naming (`vision_model.*`, e.g.
    the reference's laion/CLIP-ViT-H-14) are the tower's: they land under
    `image_encoder.`, without the entries the tower never reads."""
    ckpt = read_safetensors(path)
    hf = {k: v for k, v in ckpt.items() if k.startswith("vision_model.")}
    if hf:
        ckpt = {k: v for k, v in ckpt.items() if k not in hf}
        ckpt.update(clip_state_from_hf(hf, "image_encoder."))
    return ckpt


def overlay_checkpoint(model, path: str, align_posemb: str = "right", log=print):
    """Merge the `.safetensors` file `path` (`overlay_state`) over the
    model's weights with `tolerant_merge`, which logs every missing,
    mismatched and unexpected entry."""
    merge_checkpoint(model, overlay_state(path), align_posemb, log=log)


def _unlinear(tree, sd, prefix):
    tree["kernel"] = sd[prefix + ".weight"].T
    for name in ("bias", "lora_a", "lora_b"):
        if f"{prefix}.{name}" in sd:
            tree[name] = sd[f"{prefix}.{name}"]
    return tree


def _unlayernorm(sd, prefix):
    return {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]}


def _unpoint_encoder(sd, p):
    cross = p + ".cross_att"
    att = {n: _unlinear({}, sd, f"{cross}.att.{n}")
           for n in ("q_proj", "k_proj", "v_proj", "out_proj")}
    tree = {
        "point_embed": {"mlp": _unlinear({}, sd, p + ".point_embed.mlp")},
        "ln": _unlayernorm(sd, p + ".ln"),
        "cross_att": {"ln1": _unlayernorm(sd, cross + ".ln1"),
                      "ln2": _unlayernorm(sd, cross + ".ln2"), "att": att,
                      "mlp": {"fc_in": _unlinear({}, sd, cross + ".mlp.net.0"),
                              "fc_out": _unlinear({}, sd, cross + ".mlp.net.2")}},
        "linear": _unlinear({}, sd, p + ".linear"),
    }
    if p + ".query_embed" in sd:
        tree["query_embed"] = sd[p + ".query_embed"]
    return tree


def flax_from_state_dict(sd: dict, scan_layers: bool = False) -> dict:
    """The inverse of `state_dict_from_flax`: {reference name: array} -> the
    JAX package's LMM parameter tree {'params': ...} (the point basis, a
    fixed table rather than a weight, has no place in it), in the stacked
    layer layout with `scan_layers`."""
    params: dict = {}
    if "image_encoder.vision_model.pre_layrnorm.weight" in sd:
        params["image_encoder"] = flax_from_clip_state_dict(sd, "image_encoder.")
    if "point_encoder.linear.weight" in sd:
        params["point_encoder"] = _unpoint_encoder(sd, "point_encoder")
    if "proj_cond.weight" in sd:
        params["proj_cond"] = _unlinear({}, sd, "proj_cond")
        params["norm_cond"] = _unlayernorm(sd, "norm_cond")
    if "embed_num_face.weight" in sd:
        params["embed_num_face"] = {"embedding": sd["embed_num_face.weight"]}
    m = "mesh_decoder.model"
    model = {"embd": {"embedding": sd[m + ".embd.weight"]},
             "embed_positions": {"embedding": sd[m + ".embed_positions.weight"]}}
    i = 0
    while f"{m}.layers.{i}.final_layer_norm.weight" in sd:
        lp = f"{m}.layers.{i}"
        layer = {
            "self_attn": {n: _unlinear({}, sd, f"{lp}.self_attn.{n}")
                          for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "self_attn_layer_norm": _unlayernorm(sd, lp + ".self_attn_layer_norm"),
            "final_layer_norm": _unlayernorm(sd, lp + ".final_layer_norm"),
        }
        if f"{lp}.moe.w1" in sd:
            layer["moe"] = {"router": _unlinear({}, sd, lp + ".moe.router"),
                            **{n: sd[f"{lp}.moe.{n}"] for n in EXPERT_PARAMS}}
        else:
            layer["fc1"] = _unlinear({}, sd, lp + ".fc1")
            layer["fc2"] = _unlinear({}, sd, lp + ".fc2")
        model[f"layers_{i}"] = layer
        i += 1
    params["mesh_decoder"] = {"model": model,
                              "lm_head": _unlinear({}, sd, "mesh_decoder.lm_head")}
    k = 0
    while f"mesh_decoder.mtp_{k}.weight" in sd:
        params["mesh_decoder"][f"mtp_{k}"] = _unlinear({}, sd, f"mesh_decoder.mtp_{k}")
        k += 1
    return {"params": normalize_layer_layout(params, scan_layers)}


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


# ---------------------------------------------------------------- MDiT --

def _dit(sd, prefix, tree):
    _linear(sd, prefix + ".proj_in", tree["proj_in"])
    sd[prefix + ".pos_embed"] = np.asarray(tree["pos_embed"], np.float32)
    _linear(sd, prefix + ".timestep_proj.linear_1", tree["timestep_proj"]["linear_1"])
    _linear(sd, prefix + ".timestep_proj.linear_2", tree["timestep_proj"]["linear_2"])
    _linear(sd, prefix + ".adaln_linear", tree["adaln_linear"])
    sd[prefix + ".scale_shift_table"] = np.asarray(tree["scale_shift_table"], np.float32)
    _linear(sd, prefix + ".proj_out", tree["proj_out"])
    i = 0
    while f"layers_{i}" in tree:
        lt, lp = tree[f"layers_{i}"], f"{prefix}.layers.{i}"
        _linear(sd, lp + ".attn1.qkv_proj", lt["attn1"]["qkv_proj"])
        _linear(sd, lp + ".attn1.out_proj", lt["attn1"]["out_proj"])
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _linear(sd, f"{lp}.attn2.{name}", lt["attn2"][name])
        _linear(sd, lp + ".ff.net.0", lt["ff"]["fc_in"])
        _linear(sd, lp + ".ff.net.2", lt["ff"]["fc_out"])
        sd[lp + ".scale_shift_table"] = np.asarray(lt["scale_shift_table"], np.float32)
        i += 1


_CLIP_DENSE = (("self_attn.q_proj", "self_attn", "q_proj"),
               ("self_attn.k_proj", "self_attn", "k_proj"),
               ("self_attn.v_proj", "self_attn", "v_proj"),
               ("self_attn.out_proj", "self_attn", "out_proj"),
               ("mlp.fc1", None, "fc1"), ("mlp.fc2", None, "fc2"))


def clip_state_dict_from_flax(tree, prefix: str = "") -> dict:
    """The JAX package's CLIP tower tree -> HuggingFace CLIPVisionModel's
    names under `prefix` (the inverse of convert_hf_clip_params)."""
    sd: dict = {}
    p = prefix + "vision_model."
    # flax conv [kh, kw, in, out] -> torch [out, in, kh, kw]
    sd[p + "embeddings.patch_embedding.weight"] = np.asarray(
        tree["patch_embedding"]["kernel"], np.float32).transpose(3, 2, 0, 1)
    sd[p + "embeddings.class_embedding"] = np.asarray(tree["class_embedding"], np.float32)
    sd[p + "embeddings.position_embedding.weight"] = np.asarray(
        tree["position_embedding"], np.float32)
    _layernorm(sd, p + "pre_layrnorm", tree["pre_layrnorm"])
    i = 0
    while f"layers_{i}" in tree:
        lt, lp = tree[f"layers_{i}"], f"{p}encoder.layers.{i}."
        _layernorm(sd, lp + "layer_norm1", lt["layer_norm1"])
        _layernorm(sd, lp + "layer_norm2", lt["layer_norm2"])
        for name, group, key in _CLIP_DENSE:
            _linear(sd, lp + name, lt[group][key] if group else lt[key])
        i += 1
    return sd


def flax_from_clip_state_dict(sd: dict, prefix: str = "") -> dict:
    """The inverse of `clip_state_dict_from_flax`: the tower's entries under
    `prefix` -> the JAX package's CLIP tower tree."""
    p = prefix + "vision_model."
    clip = {"patch_embedding": {"kernel": sd[p + "embeddings.patch_embedding.weight"]
                                .transpose(2, 3, 1, 0)},
            "class_embedding": sd[p + "embeddings.class_embedding"],
            "position_embedding": sd[p + "embeddings.position_embedding.weight"],
            "pre_layrnorm": _unlayernorm(sd, p + "pre_layrnorm")}
    i = 0
    while f"{p}encoder.layers.{i}.layer_norm1.weight" in sd:
        lp = f"{p}encoder.layers.{i}."
        layer = {"layer_norm1": _unlayernorm(sd, lp + "layer_norm1"),
                 "layer_norm2": _unlayernorm(sd, lp + "layer_norm2"), "self_attn": {}}
        for name, group, key in _CLIP_DENSE:
            (layer[group] if group else layer)[key] = _unlinear({}, sd, lp + name)
        clip[f"layers_{i}"] = layer
        i += 1
    return clip


def mdit_state_dict_from_flax(tree) -> dict:
    """The JAX package's MDiT parameter tree (numpy leaves, with or without
    the top-level 'params') -> {port name: numpy array}."""
    params = tree.get("params", tree)
    sd: dict = {}
    _dit(sd, "dit", params["dit"])
    sd.update(clip_state_dict_from_flax(params["image_encoder"], "image_encoder."))
    _linear(sd, "proj_cond", params["proj_cond"])
    _layernorm(sd, "norm_cond", params["norm_cond"])
    _point_encoder(sd, "point_encoder", params["point_encoder"])
    return sd


def flax_from_mdit_state_dict(sd: dict) -> dict:
    """The inverse of `mdit_state_dict_from_flax`: {port name: array} -> the
    JAX package's MDiT parameter tree {'params': ...}."""
    d = "dit"
    dit = {"proj_in": _unlinear({}, sd, d + ".proj_in"), "pos_embed": sd[d + ".pos_embed"],
           "timestep_proj": {n: _unlinear({}, sd, f"{d}.timestep_proj.{n}")
                             for n in ("linear_1", "linear_2")},
           "adaln_linear": _unlinear({}, sd, d + ".adaln_linear"),
           "scale_shift_table": sd[d + ".scale_shift_table"],
           "proj_out": _unlinear({}, sd, d + ".proj_out")}
    i = 0
    while f"{d}.layers.{i}.scale_shift_table" in sd:
        lp = f"{d}.layers.{i}"
        dit[f"layers_{i}"] = {
            "scale_shift_table": sd[lp + ".scale_shift_table"],
            "attn1": {n: _unlinear({}, sd, f"{lp}.attn1.{n}") for n in ("qkv_proj", "out_proj")},
            "attn2": {n: _unlinear({}, sd, f"{lp}.attn2.{n}")
                      for n in ("q_proj", "k_proj", "v_proj", "out_proj")},
            "ff": {"fc_in": _unlinear({}, sd, lp + ".ff.net.0"),
                   "fc_out": _unlinear({}, sd, lp + ".ff.net.2")}}
        i += 1
    return {"params": {"dit": dit, "image_encoder": flax_from_clip_state_dict(sd, "image_encoder."),
                       "proj_cond": _unlinear({}, sd, "proj_cond"),
                       "norm_cond": _unlayernorm(sd, "norm_cond"),
                       "point_encoder": _unpoint_encoder(sd, "point_encoder")}}


@torch.no_grad()
def init_mdit_weights(model: torch.nn.Module, seed: int, draw_device=None) -> torch.nn.Module:
    """Random MDiT weights from `seed`, at the JAX initialisers' scales: the
    DiT's, proj_cond's and the point encoder's projections N(0, 0.02) (the
    package's Dense), the CLIP tower at flax's defaults (`init_clip_tower`),
    the DiT's pos_embed and scale_shift_tables N(0, dim^-0.5), the point
    queries N(0, hidden^-0.5), zero biases, unit LayerNorms. Draws on
    `draw_device` (default: the weights' own)."""
    device = draw_device or next(model.parameters()).device
    gen = torch.Generator(device=device).manual_seed(seed)
    for name, mod in model.named_modules():
        if name.startswith("image_encoder"):
            continue
        if isinstance(mod, torch.nn.Linear):
            normal_(mod.weight, 0.0, 0.02, gen)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, torch.nn.LayerNorm) and mod.weight is not None:
            mod.weight.fill_(1.0)
            mod.bias.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("pos_embed", "scale_shift_table", "query_embed")):
            normal_(p, 0.0, p.shape[-1] ** -0.5, gen)
    init_clip_tower(model.image_encoder, gen)
    return model


def load_mdit(model: torch.nn.Module, opt) -> torch.nn.Module:
    """The MDiT's weights from the `.safetensors` file `opt.resume2`
    (strict), or drawn from `opt.seed`. Returns it in eval mode."""
    if opt.resume2:
        load_state(model, read_safetensors(opt.resume2))
    else:
        init_mdit_weights(model, opt.seed)
    return model.eval()
