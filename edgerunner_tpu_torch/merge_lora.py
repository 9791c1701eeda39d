"""Fold trained LoRA adapters back into the base weights (the port of
tools/merge_lora.py).

    python -m edgerunner_tpu_torch.merge_lora --ckpt workspace/model.safetensors \\
        --out merged.safetensors --lora_alpha 16

`--ckpt` is a `.safetensors` weights file of the port (or a save directory
holding `model.safetensors`); `--out` the file to write (or a directory, in
which `model.safetensors` is written). The output is a plain (lora_rank 0)
checkpoint: load it with `--resume` and no `--lora_rank`, or quantise it
with `--w_quant`. Each adapted weight becomes W + (AB · α/r)ᵀ, computed in
f32 (models/layers.py `merge_lora_state`), so the adapted and the merged
model give the same logits up to one f32 product per projection. Pass the
`--lora_alpha` the adapters were trained with; the rank is read off each
`lora_a`. A file without adapters is written unchanged, with a warning.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

from edgerunner_tpu_torch.models.layers import merge_lora_state
from edgerunner_tpu_torch.train.checkpoint import MODEL_FILE
from edgerunner_tpu_torch.weights import read_safetensors, write_safetensors


def weights_path(path: str) -> str:
    """A weights file, or the `model.safetensors` inside a directory."""
    return os.path.join(path, MODEL_FILE) if os.path.isdir(path) else path


def main(argv: Optional[List[str]] = None) -> str:
    ap = argparse.ArgumentParser(prog="python -m edgerunner_tpu_torch.merge_lora",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--ckpt", required=True, help="weights with lora_a/lora_b entries")
    ap.add_argument("--out", required=True, help="output .safetensors file or directory")
    ap.add_argument("--lora_alpha", type=float, default=16.0,
                    help="the lora_alpha the adapters were trained with")
    args = ap.parse_args(argv)

    state = read_safetensors(weights_path(args.ckpt))
    merged = merge_lora_state(state, alpha=args.lora_alpha)
    n_before, n_after = len(state), len(merged)
    if n_before == n_after:
        print("[WARN] no lora_a/lora_b leaves found — nothing merged")
    else:
        print(f"[INFO] merged {(n_before - n_after) // 2} adapters "
              f"({n_before} -> {n_after} leaves)")
    out = args.out
    if not out.endswith(".safetensors"):
        os.makedirs(out, exist_ok=True)
        out = os.path.join(out, MODEL_FILE)
    write_safetensors(out, merged)
    print(f"[INFO] wrote {out}")
    return out


if __name__ == "__main__":
    main()
