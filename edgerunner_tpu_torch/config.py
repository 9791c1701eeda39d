"""Options / config system of the PyTorch port.

The port's own copy of the JAX package's `Options`, its `default` and `ArAE`
presets, the DiT preset, the CLI parser and the vocabulary rules: the same
option surface and preset values (reference: core/options.py:17-213), so that
a command line means the same thing to both packages. `validate` also rejects
the options whose code paths the port does not run yet.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import typing
import urllib.parse
from dataclasses import dataclass
from typing import Dict, List, Literal, Optional, Tuple


@dataclass
class Options:
    ### tokenizer
    # coord discrete bins (also the number of basic tokens)
    discrete_bins: int = 512
    # enable metok (EdgeBreaker-family tokenizer); False = naive 9-coords/face
    use_meto: bool = True
    # metok backend
    meto_backend: Literal["LR", "LR_ABSCO", "CLERS"] = "LR_ABSCO"
    # special tokens
    bos_token_id: int = 1
    eos_token_id: int = 2
    pad_token_id: int = 0

    ### point vae
    point_num: int = 8192
    point_hidden_dim: int = 1024
    point_num_heads: int = 16
    point_latent_size: int = 2048
    point_latent_dim: int = 64
    point_num_layers: int = 24
    point_query_num: int = 81920
    point_encoder_mode: Literal["downsample", "embed"] = "embed"
    kl_weight: float = 1e-8

    ### image encoder (CLIP vision tower; defaults = ViT-H/14 as in the
    ### reference's laion/CLIP-ViT-H-14, models.py:41)
    clip_hidden_dim: int = 1280
    clip_intermediate_dim: int = 5120
    clip_num_layers: int = 32
    clip_num_heads: int = 16
    clip_image_size: int = 224
    clip_patch_size: int = 14

    ### dit
    dit_hidden_dim: int = 1024
    dit_num_heads: int = 16
    dit_num_layers: int = 24
    snr_gamma: Optional[float] = 5.0
    noise_scheduler_predtype: Literal["epsilon", "v_prediction"] = "v_prediction"

    ### lmm
    freeze_encoder: bool = True
    # max sequence length (excluding BOS, EOS and COND)
    max_seq_length: int = 10240
    hidden_dim: int = 1024
    intermediate_dim: Optional[int] = None
    num_layers: int = 24
    num_heads: int = 16
    cond_mode: Literal["none", "image", "point", "point_latent"] = "image"
    num_cond_tokens: int = 257
    generate_mode: Literal["greedy", "sample"] = "sample"
    # sampling knobs for generate_mode='sample' (the reference is fixed
    # top-k=10, models.py:299-301; temperature/top_p exceed it). top_p
    # filters to the smallest nucleus within the top-k candidates
    top_k: int = 10
    temperature: float = 1.0
    top_p: float = 1.0
    use_num_face_cond: bool = False
    nof_dropout_ratio: float = 0.2

    ### dataset
    max_face_length: int = 1000
    # synthetic-dataset size used when data_root is absent
    synthetic_size: int = 256
    # freeze the synthetic dataset across epochs (samples seeded by index
    # only, no per-epoch regeneration): memorization/overfit runs — e.g.
    # training draft heads to measurable acceptance on a fixed corpus
    synthetic_static: bool = False
    # max icosphere subdivision for synthetic meshes: 2 (default, <=320
    # faces) keeps the historical pinned (0,0,idx) test split byte-stable;
    # 3 adds ~1280-face spheres so synthetic-trained checkpoints exercise
    # the long-cache decode regime (spec-decode / quant benchmarks)
    synthetic_subdiv: int = 2
    dataset: Literal["obj", "objxl"] = "obj"
    # local data root holding mesh files (replaces the reference's S3 buckets)
    data_root: str = "./data"
    num_workers: int = 16
    testset_size: int = 32
    use_decimate_aug: bool = True
    use_scale_aug: bool = True
    # train-batch token-length bucket (pads each batch's length up to a
    # multiple of this so the train step compiles once per bucket, not once
    # per batch length — the reference pads to the exact batch max,
    # provider.py:477, which would recompile constantly under jit)
    collate_bucket: int = 512

    ### training
    workspace: str = "./workspace"
    resume: Optional[str] = None
    resume2: Optional[str] = None
    resume_step_ratio: float = 0
    align_posemb: Literal["left", "right"] = "right"
    # per-host batch size
    batch_size: int = 4
    gradient_accumulation_steps: int = 1
    num_epochs: int = 100
    gradient_clip: float = 1.0
    mixed_precision: Literal["no", "bf16"] = "bf16"
    lr: float = 1e-4
    # AdamW weight decay (reference: ArAE 0.01 main.py:133, DiT 0.1
    # main_dit.py:123 — the DiT preset overrides this)
    weight_decay: float = 0.01
    # rematerialization (gradient checkpointing) of decoder layers
    checkpointing: bool = True
    seed: int = 0
    eval_mode: Literal["none", "loss", "generate"] = "loss"
    debug_eval: bool = False
    warmup_ratio: float = 0.01
    # exponential moving average of the weights (0 = off): ema <- ema*d +
    # params*(1-d) after every optimizer step. Standard for diffusion
    # training (the reference has none); saved as an `ema/` tree next to
    # each checkpoint's `model/` — generate with --resume ws/ema. Typical:
    # 0.999 (DiT), 0.9999 for long runs.
    ema_decay: float = 0.0
    use_wandb: bool = False
    # persist optimizer state with each epoch checkpoint (resumable training;
    # disable on slow-transfer links where the upload dominates epoch time)
    save_optimizer_state: bool = True
    # async checkpointing: orbax serializes to disk on a background thread
    # while the next epoch trains; the latest/best bookkeeping is deferred
    # until the save commits (next save, or training end)
    async_checkpointing: bool = False
    # additionally checkpoint every N optimizer steps (0 = per-epoch only);
    # each save records the data loader's mid-epoch cursor
    save_every_steps: int = 0
    # checkpoint every Nth epoch instead of every epoch (the final epoch
    # always saves): short-epoch runs (small datasets) amortize the save +
    # best-copy overhead; resume granularity coarsens accordingly
    save_every_epochs: int = 1
    # with --resume pointing at a checkpoint that has a train_state.json:
    # restore optimizer state, LR-schedule step, and the data-pipeline cursor
    # (exact continuation). Off = weights-only resume (finetune semantics,
    # like the reference's --resume)
    resume_train_state: bool = False

    ### parallelism (the JAX package's mesh axes; the port runs dp and sp)
    # data-parallel axis size; -1 = all remaining devices (the port's main
    # and main_dit: the torchrun world / sp_size; infer and serve decode on
    # one device unless dp_size > 1, which makes a fleet of that many)
    dp_size: int = -1
    # tensor-parallel axis size (sharded attention heads / MLP)
    tp_size: int = 1
    # sequence-parallel axis size: activations sharded along the sequence,
    # attention runs as a ring over the axis (the port: sp_size ranks under
    # torchrun, one process each)
    sp_size: int = 1
    # pipeline-parallel axis size: the decoder layer stack is split into
    # contiguous stages (one per pp rank, weights sharded — a model pp_size
    # times larger than one chip trains); microbatches rotate through the
    # stages (GPipe schedule, see the JAX package's parallel/pipeline.py).
    # Requires num_layers % pp_size == 0 and sp_size == 1 (composes with
    # dp, tp and MoE/ep).
    pp_size: int = 1
    # GPipe microbatches per device batch (0 = pp_size). Bubble fraction is
    # (pp-1)/(M+pp-1): raise M to amortize; batch_size must divide by
    # (local dp share) * M
    pp_microbatches: int = 0
    # stacked [L, ...] decoder-layer param layout (nn.scan) — auto-enabled by
    # pp_size > 1; checkpoints convert losslessly either way on load
    scan_layers: bool = False
    # expert-parallel axis size: Mixture-of-Experts expert weights sharded
    # over 'ep' (requires moe_experts % ep_size == 0)
    ep_size: int = 1
    # Mixture-of-Experts decoder MLP: number of experts (0 = dense reference
    # MLP); top-k routing with capacity-bounded dispatch (models/moe.py) and
    # a Switch load-balance auxiliary loss
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    # weight of the Switch load-balance loss in the training objective
    moe_aux_weight: float = 0.01

    ### testing
    test_path: Optional[str] = None
    test_resume_tokens: Optional[str] = None
    test_repeat: int = 1
    test_num_face: Tuple[int, ...] = (1000,)
    test_max_seq_length: Optional[int] = None
    # decode-length bucket rounding (tokens): the budget and cache sizes
    decode_bucket: int = 1024
    # rows generated together (the reference decodes one at a time)
    test_batch_size: int = 1
    # eval_mode=generate: held-out samples scored per eval epoch (decoded in
    # chunks of test_batch_size; mean±std chamfer/F-score logged)
    eval_gen_samples: int = 16
    # int8 KV cache for decoding (halves cache traffic)
    kv_quant: bool = False
    # cache precision under kv_quant: 8 (int8) or 4 (packed nibbles, quarter
    # traffic; larger quantization error — check tools/kv_quant_quality.py
    # on your checkpoint before enabling)
    kv_bits: int = 8
    # int4 scale granularity in lanes per group (0 = one absmax scale per
    # row; 96 = one per attention head at the flagship head_dim) — tighter
    # int4 numerics at identical DMA traffic (the group scales ride the
    # same packed 128-lane plane)
    kv_group: int = 0
    # QuaRot-style per-head orthogonal rotation of K/V rows before cache
    # quantization (exactly invariant in the attention math; flattens
    # outlier lanes so int4/int8 absmax scales tighten — see
    # ops/kv_quant.py rotate_rows and tools/kv_quant_quality.py)
    kv_rotate: bool = False
    # int8 decoder projection weights for decoding (weight-only quantization,
    # per-output-column scales; halves the per-step weight traffic)
    w_quant: bool = False
    # LoRA fine-tuning: rank of the additive low-rank adapters on every
    # decoder projection (0 = off). With lora_rank > 0 the trainer updates
    # ONLY the adapters — the standard flow is --resume base.ckpt
    # --lora_rank 8, then tools/merge_lora.py to fold the adapters back
    # into the base weights for adapter-free (and quantizable) serving.
    lora_rank: int = 0
    # LoRA scaling numerator: the adapter delta is (xA)B * lora_alpha/rank
    lora_alpha: float = 16.0
    # Medusa-style multi-token-prediction draft heads: head k predicts token
    # t+2+k; enables speculative decoding (--spec_decode). 0 = off.
    mtp_heads: int = 0
    # weight of the draft heads' auxiliary CE during training
    mtp_loss_weight: float = 0.2
    # speculative decoding at inference: propose 1 + mtp_heads tokens per
    # decoder pass, verify in one multi-query pass, keep the accepted prefix
    # (greedy mode only; output is IDENTICAL to vanilla greedy decode)
    spec_decode: bool = False
    # gradient-checkpointing policy of the JAX trainer: 'full' recomputes
    # everything in backward, 'attn' saves the attention outputs
    remat_policy: str = "full"
    # JAX trainer: keep XLA from merging the remat replay into the forward
    remat_prevent_cse: bool = False


# named presets (reference: core/options.py:152-211)
config_defaults: Dict[str, Options] = {}
config_doc: Dict[str, str] = {}

config_doc["default"] = "the default settings"
config_defaults["default"] = Options()

config_doc["ArAE"] = "ArAE"
config_defaults["ArAE"] = Options(
    point_encoder_mode="embed",
    kl_weight=1e-8,
    discrete_bins=512,
    use_num_face_cond=True,
    use_decimate_aug=True,
    cond_mode="point",
    num_cond_tokens=2049,
    freeze_encoder=False,
    use_meto=True,
    meto_backend="LR_ABSCO",
    max_face_length=4000,
    max_seq_length=40960,
    align_posemb="right",
    batch_size=4,
    hidden_dim=1536,
    num_heads=16,
    num_layers=24,
    gradient_accumulation_steps=1,
    lr=1e-5,
    warmup_ratio=0,
    num_epochs=100,
    eval_mode="loss",
)

config_doc["DiT"] = "DiT"
config_defaults["DiT"] = Options(
    point_encoder_mode="embed",
    kl_weight=1e-8,
    max_face_length=8000,
    discrete_bins=512,
    use_num_face_cond=True,
    use_decimate_aug=False,
    cond_mode="point",
    num_cond_tokens=2049,
    freeze_encoder=False,
    use_meto=True,
    meto_backend="LR_ABSCO",
    max_seq_length=40960,
    hidden_dim=1536,
    num_heads=16,
    num_layers=24,
    dit_hidden_dim=1024,
    dit_num_heads=16,
    dit_num_layers=24,
    snr_gamma=5.0,
    noise_scheduler_predtype="v_prediction",
    batch_size=8,
    gradient_accumulation_steps=1,
    lr=1e-5,
    weight_decay=0.1,
    num_epochs=300,
    eval_mode="none",
)

_HINTS = None


def _field_type(name: str):
    global _HINTS
    if _HINTS is None:
        _HINTS = typing.get_type_hints(Options)
    return _HINTS[name]


def _add_field_arg(parser: argparse.ArgumentParser, f: dataclasses.Field, default):
    """Register one dataclass field as an argparse flag."""
    name = "--" + f.name
    ftype = _field_type(f.name)
    origin = typing.get_origin(ftype)
    args_ = typing.get_args(ftype)

    if ftype is bool:
        # accept --flag / --no_flag and --flag true/false
        parser.add_argument(
            name, nargs="?", const="true", default=None, metavar="BOOL",
            help=f"(bool, default {default})",
        )
        parser.add_argument("--no_" + f.name, action="store_true", default=False,
                            help=argparse.SUPPRESS)
        return

    if origin is Literal:
        parser.add_argument(name, type=str, choices=[str(a) for a in args_],
                            default=None, help=f"(default {default})")
        return

    if origin in (tuple, Tuple) or origin in (list, List):
        elem = args_[0] if args_ else str
        if elem is Ellipsis:
            elem = str
        parser.add_argument(name, nargs="+", type=elem, default=None,
                            help=f"(default {default})")
        return

    if origin is typing.Union:  # Optional[X]
        inner = [a for a in args_ if a is not type(None)]
        elem = inner[0] if inner else str
        parser.add_argument(name, type=elem, default=None,
                            help=f"(default {default})")
        return

    parser.add_argument(name, type=ftype if callable(ftype) else str, default=None,
                        help=f"(default {default})")


def _parse_bool(s: str) -> bool:
    if isinstance(s, bool):
        return s
    if s.lower() in ("1", "true", "yes", "on"):
        return True
    if s.lower() in ("0", "false", "no", "off"):
        return False
    raise ValueError(f"cannot parse bool from {s!r}")


def parse_cli(argv: Optional[List[str]] = None, prog: str = "edgerunner-tpu") -> Options:
    """Parse `<preset> [--flag value ...]` into an Options instance."""
    argv = list(sys.argv[1:] if argv is None else argv)

    top = argparse.ArgumentParser(prog=prog)
    sub = top.add_subparsers(dest="preset", required=True)
    parsers = {}
    for preset_name, preset in config_defaults.items():
        p = sub.add_parser(preset_name, help=config_doc.get(preset_name, ""))
        for f in dataclasses.fields(Options):
            _add_field_arg(p, f, getattr(preset, f.name))
        parsers[preset_name] = p

    ns = top.parse_args(argv)
    preset = config_defaults[ns.preset]
    opt = dataclasses.replace(preset)

    for f in dataclasses.fields(Options):
        if getattr(ns, "no_" + f.name, False):
            setattr(opt, f.name, False)
            continue
        val = getattr(ns, f.name, None)
        if val is None:
            continue
        ftype = _field_type(f.name)
        origin = typing.get_origin(ftype)
        if ftype is bool:
            setattr(opt, f.name, _parse_bool(val))
        elif origin in (tuple, Tuple):
            setattr(opt, f.name, tuple(val))
        else:
            setattr(opt, f.name, val)
    return opt


# options whose paths the port does not run yet, with the value that keeps
# them off
_NOT_PORTED = {
    "moe_experts": 0, "lora_rank": 0, "tp_size": 1,
    "pp_size": 1, "ep_size": 1, "scan_layers": False,
    "async_checkpointing": False, "use_wandb": False,
}


def validate(opt: Options) -> Options:
    """Cross-field validation (reference: main.py:38-39), plus a refusal of
    every option the port does not implement yet. `--resume2` is taken by
    every entry point: `main` and `infer` overlay it on the ArAE as the JAX
    package's tolerant merge does (e.g. a pretrained CLIP tower), the image
    pipeline's entry points (main_dit, infer_dit, serve) read an MDiT
    checkpoint from it."""
    if opt.cond_mode in ("point", "point_latent"):
        # 'point_latent' takes the latents that 'point' encodes: the same
        # condition tokens, and the DiT pipeline's frozen 'embed' encoder
        expected = opt.point_latent_size + (1 if opt.use_num_face_cond else 0)
        if opt.num_cond_tokens != expected:
            raise ValueError(
                f"num_cond_tokens ({opt.num_cond_tokens}) must equal "
                f"point_latent_size + use_num_face_cond ({expected}) in "
                f"{opt.cond_mode} cond mode")
        if opt.point_encoder_mode != "embed":
            raise ValueError("the port implements point_encoder_mode 'embed' only")
    elif opt.cond_mode == "image":
        # CLIP's patch tokens and its class token (edgerunner_tpu/config.py:421-427)
        patches = (opt.clip_image_size // opt.clip_patch_size) ** 2 + 1
        expected = patches + (1 if opt.use_num_face_cond else 0)
        if opt.num_cond_tokens != expected:
            raise ValueError(
                f"num_cond_tokens ({opt.num_cond_tokens}) must equal CLIP patch tokens "
                f"+ cls + use_num_face_cond ({expected}) in image cond mode")
    elif opt.cond_mode != "none":
        raise ValueError(f"the port does not implement cond_mode {opt.cond_mode!r}")
    for name, off in _NOT_PORTED.items():
        if getattr(opt, name) != off:
            raise ValueError(f"the port does not implement --{name} yet")
    # 'attn' saves each layer's attention output through the remat in the
    # JAX trainer; the port's checkpointing always recomputes everything
    # ('full'). remat_prevent_cse is XLA-only and changes nothing here.
    if opt.remat_policy != "full":
        raise ValueError(f"the port implements --remat_policy full only, got "
                         f"{opt.remat_policy!r}")
    if opt.kv_quant and opt.kv_bits not in (4, 8):
        raise ValueError(f"--kv_bits is 4 or 8, got {opt.kv_bits}")
    if opt.kv_quant and opt.kv_bits == 4 and opt.kv_group:
        # what the JAX package asserts (ops/kv_quant.py:145-148): the group
        # scales of K and V share the 128-lane plane, 64 lanes each
        hd, group = opt.hidden_dim, opt.kv_group
        if group < 0 or hd % group or hd % 2 or hd // group > 64:
            raise ValueError(f"--kv_group {group} must divide the even hidden width {hd} "
                             f"into at most 64 groups")
    if opt.mtp_heads < 0:
        raise ValueError(f"--mtp_heads must be >= 0, got {opt.mtp_heads}")
    if opt.sp_size < 1:
        raise ValueError(f"--sp_size must be >= 1, got {opt.sp_size}")
    if opt.dp_size == 0 or opt.dp_size < -1:
        raise ValueError(f"--dp_size is -1 (the world / sp) or >= 1, got {opt.dp_size}")
    if opt.eval_mode == "generate":
        raise ValueError("the port does not implement --eval_mode generate yet")
    if len(urllib.parse.urlparse(opt.data_root).scheme) > 1 or ":" in opt.data_root:
        raise ValueError("the port reads one local --data_root; remote and "
                         "multi-root data are not implemented yet")
    return opt


def vocab_size_for(opt: Options) -> int:
    """Vocabulary size rules (reference: core/models.py:77-84).

    CLERS: the reference never wires CLERS into its LMM (models.py handles
    LR/LR_ABSCO only); here it is a first-class backend. Its parallelogram
    residuals span (-2*bins, 2*bins) offset by +2*bins (ids reach 4*bins),
    plus 7 ops (C/L/E/R/S/BOM/EOM) + 3 specials. The reference's LR rule
    (2*bins+6) would clip the upper residual range out of the vocabulary.
    """
    if opt.use_meto:
        if opt.meto_backend == "CLERS":
            return 4 * opt.discrete_bins + 7 + 3
        if opt.meto_backend == "LR":
            return 2 * opt.discrete_bins + 3 + 3
        return opt.discrete_bins + 3 + 3  # LR_ABSCO
    return opt.discrete_bins + 3


AllConfigs = config_defaults  # alias mirroring the reference naming
