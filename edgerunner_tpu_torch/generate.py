"""Autoregressive decode of the port (edgerunner_tpu/generate.py:31-453).

Prefill fills preallocated per-layer KV caches, then a decode loop takes one
token per step: the grammar mask, the greedy or sampled choice, the FSM
update and the decoder step all stay on the device. The loop ends, as the
JAX package's `lax.while_loop` does, once every row has emitted EOS, without
a host synchronisation per step: every DECODE_CHUNK steps it starts an
asynchronous copy of the device's "all rows ended" flag to the host and
reads the copy started one check earlier, which has long arrived. So it
stops at most 2 * DECODE_CHUNK steps after the last row's EOS. Rows that
ended emit PAD, which gives the same tokens as the JAX loop that stops
stepping them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from edgerunner_tpu_torch.config import vocab_size_for
from edgerunner_tpu_torch.models.lmm import LMM
from edgerunner_tpu_torch.ops import sampling as S

# steps between two reads of the EOS flags (tests widen it)
DECODE_CHUNK = 16


def round_up_bucket(n: int, bucket: int) -> int:
    return max(bucket, -(-n // bucket) * bucket)


def decode_shape(opt, prompt_len: int, num_faces: int,
                 max_new_tokens: Optional[int]) -> tuple:
    """(new-token budget, cache length) exactly as the JAX package sizes
    them: 5 tokens per face + 64, bucketed, and a cache rounded to 512."""
    limit = opt.max_seq_length if max_new_tokens is None else max_new_tokens
    budget = min(limit, num_faces * 5 + 64) if num_faces > 0 else limit
    num_new = min(round_up_bucket(budget, opt.decode_bucket),
                  round_up_bucket(limit, opt.decode_bucket))
    max_len = round_up_bucket(prompt_len + opt.num_cond_tokens + num_new, 512)
    return num_new, max_len


@torch.no_grad()
def generate_tokens(model: LMM, conds, *, num_faces: int = 1000,
                    resume_ids: Optional[np.ndarray] = None,
                    max_new_tokens: Optional[int] = None,
                    generator=None,
                    use_grammar: bool = True,
                    bench_no_eos: bool = False) -> np.ndarray:
    """Generate mesh token streams (reference: LMM.generate, models.py:204-303).

    conds: [B, N, 3] points (numpy array or tensor) for point conditioning.
    Returns np.ndarray [B, T] of generated tokens (BOS excluded), PAD after
    each row's EOS. `generator` drives sampling (generate_mode 'sample'): a
    generator seeded with `opt.seed` on the model's device when None, as the
    JAX package defaults to PRNGKey(opt.seed); or a list of B generators,
    one stream per row (the JAX package's batch of B keys); greedy decoding
    ignores it. The cache's kind (bf16 or, with `kv_quant`, int8) lives
    inside the model.
    `bench_no_eos` forbids EOS so that every row decodes the full budget.
    """
    opt = model.opt
    device = next(model.parameters()).device
    conds = torch.as_tensor(conds, device=device)
    B = conds.shape[0]
    vocab = vocab_size_for(opt)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(opt.seed)
    G = S.get_grammar(opt.meto_backend)

    prompt = np.full((B, 1), opt.bos_token_id, np.int64)
    if resume_ids is not None:
        prompt = np.concatenate([prompt, np.asarray(resume_ids, np.int64)], axis=1)
        state = S.grammar_replay(G, prompt[:, 1:], device)
    else:
        state = G.init(B, device)
    num_new, max_len = decode_shape(opt, prompt.shape[1], num_faces, max_new_tokens)

    nf = torch.full((B,), num_faces, dtype=torch.int64, device=device)
    logits, caches, plen = model.prefill(
        conds, nf, torch.as_tensor(prompt, device=device), max_len)

    tokens = torch.zeros((B, num_new), dtype=torch.int64, device=device)
    done = torch.zeros(B, dtype=torch.bool, device=device)
    no_eos = torch.arange(vocab, device=device)[None] != S.EOS_ID
    ended = None  # the host copy of done.all() in flight, and its event
    for i in range(num_new):
        step_logits = logits[:, 0].float()
        mask = (G.mask(state, vocab) if use_grammar
                else S.naive_grammar_mask(i, B, vocab, device))
        if bench_no_eos:
            mask = mask & no_eos
        step_logits = S.apply_mask(step_logits, mask)
        if opt.generate_mode == "greedy":
            nxt = S.greedy_token(step_logits)
        else:
            sample = (S.sample_token if isinstance(generator, torch.Generator)
                      else S.sample_token_per_row)
            nxt = sample(step_logits, generator, top_k=opt.top_k,
                         temperature=opt.temperature, top_p=opt.top_p)
        nxt = torch.where(done, S.PAD_ID, nxt)
        state = G.advance(state, nxt)
        done |= nxt == S.EOS_ID
        tokens[:, i] = nxt
        if i + 1 == num_new:
            break
        if (i + 1) % DECODE_CHUNK == 0:
            if ended is not None and arrived(ended):
                break
            ended = copy_to_host(done.all())
        logits = model.step(nxt[:, None], caches, plen + i)
    out = tokens.cpu().numpy()
    if resume_ids is not None:
        out = np.concatenate([np.asarray(resume_ids, np.int64), out], axis=1)
    return out


def copy_to_host(flag: torch.Tensor):
    """Start a copy of a device flag to the host; returns (host flag, event)."""
    if flag.device.type != "cuda":
        return flag.clone(), None
    host = torch.empty((), dtype=flag.dtype, pin_memory=True)
    host.copy_(flag, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


def arrived(copy) -> bool:
    """The value of a copy started by `copy_to_host` (waits for it)."""
    host, event = copy
    if event is not None:
        event.synchronize()
    return bool(host)


def trim_eos(tokens: np.ndarray, eos_id: int = S.EOS_ID) -> np.ndarray:
    """Cut a single row at its first EOS (reference: provider.py:42-45)."""
    idx = np.nonzero(tokens == eos_id)[0]
    return tokens[: idx[0]] if len(idx) else tokens
