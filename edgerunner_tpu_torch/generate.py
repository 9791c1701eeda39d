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

With `spec_decode`, `mtp_heads` > 0 and greedy grammar-constrained decoding,
the loop is speculative (generate.py:160-298): each pass proposes 1 +
mtp_heads grammar-chained tokens (the model's own next greedy token, then
one per draft head from the frontier's hidden state), verifies them all in
one `verify_step` at per-row positions, and keeps the longest prefix that
the model itself would have emitted, so the tokens are those of vanilla
greedy decoding (exactly so only in exact arithmetic: the verify pass sums
in another order than a one-token step). Rows advance by 1 to 1 +
mtp_heads tokens per pass at their own positions; the token buffer has
1 + mtp_heads columns of write headroom, and the EOS check runs every
DECODE_CHUNK passes as above. The JAX loop also stops accepting at its
segment boundaries (every 2048 tokens), which moves no token. Without
mtp_heads, or outside greedy mode, spec_decode warns and decodes vanilla,
as the JAX package does.

With `devices` the decode runs as the JAX package's fleet
(generate.py:300-350): the batch rows split evenly over the devices, one
replica of the model on each (`replicate_model`), one worker thread per
device with a CUDA stream of its own, and the rows come back in order.
"""

from __future__ import annotations

import contextlib
import copy
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

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
    them: 5 tokens per face + 64, bucketed, and a cache rounded to 512 with
    room for the 1 + mtp_heads rows a speculative pass may write past the
    budget (generate.py:425-429)."""
    limit = opt.max_seq_length if max_new_tokens is None else max_new_tokens
    budget = min(limit, num_faces * 5 + 64) if num_faces > 0 else limit
    num_new = min(round_up_bucket(budget, opt.decode_bucket),
                  round_up_bucket(limit, opt.decode_bucket))
    spec_margin = (1 + opt.mtp_heads) if opt.spec_decode else 0
    max_len = round_up_bucket(prompt_len + opt.num_cond_tokens + num_new + spec_margin, 512)
    return num_new, max_len


def spec_enabled(opt, use_grammar: bool = True) -> bool:
    """Whether `spec_decode` can run (generate.py:430-436): it needs draft
    heads, greedy mode and the grammar; otherwise a warning, and vanilla
    decoding."""
    spec = (opt.spec_decode and opt.mtp_heads > 0 and opt.generate_mode == "greedy"
            and use_grammar)
    if opt.spec_decode and not spec:
        print("[WARN] spec_decode needs mtp_heads > 0, greedy mode and the "
              "meto grammar; falling back to vanilla decode")
    return spec


@torch.no_grad()
def generate_tokens(model: LMM, conds, *, num_faces: int = 1000,
                    resume_ids: Optional[np.ndarray] = None,
                    max_new_tokens: Optional[int] = None,
                    generator=None,
                    use_grammar: bool = True,
                    bench_no_eos: bool = False,
                    devices: Optional[Sequence] = None) -> np.ndarray:
    """Generate mesh token streams (reference: LMM.generate, models.py:204-303).

    conds: [B, N, 3] points for point conditioning, or [B, L, D] latents
    (the DiT's, [B, 2048, 64] at full width) for point_latent conditioning;
    a numpy array or a tensor.
    Returns np.ndarray [B, T] of generated tokens (BOS excluded), PAD after
    each row's EOS. `generator` drives sampling (generate_mode 'sample'): a
    generator seeded with `opt.seed` on the model's device when None, as the
    JAX package defaults to PRNGKey(opt.seed); or a list of B generators,
    one stream per row (the JAX package's batch of B keys); greedy decoding
    ignores it. The cache's kind (bf16 or, with `kv_quant`, int8 or int4)
    lives inside the model; `opt.spec_decode` decodes speculatively (module
    docstring).
    `bench_no_eos` forbids EOS so that every row decodes the full budget.
    `devices` decodes as a fleet (`generate_fleet`); `model` may be one
    model or the list of its replicas that `replicate_model` made for
    those devices, and without `devices` a list decodes on its first
    replica, as the JAX package's replica list does.
    """
    if devices is not None:
        return generate_fleet(model, conds, devices, num_faces=num_faces,
                              resume_ids=resume_ids, max_new_tokens=max_new_tokens,
                              generator=generator, use_grammar=use_grammar,
                              bench_no_eos=bench_no_eos)
    if isinstance(model, (list, tuple)):
        model = model[0]
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
    spec = spec_enabled(opt, use_grammar)

    nf = torch.full((B,), num_faces, dtype=torch.int64, device=device)
    logits, caches, plen, *h_last = model.prefill(
        conds, nf, torch.as_tensor(prompt, device=device), max_len, with_hidden=spec)
    if spec:
        out = _spec_decode(model, G, vocab, logits, h_last[0], caches, plen, state,
                           num_new, bench_no_eos)
    else:
        out = _decode(model, opt, G, vocab, logits, caches, plen, state, num_new,
                      generator, use_grammar, bench_no_eos)
    if resume_ids is not None:
        out = np.concatenate([np.asarray(resume_ids, np.int64), out], axis=1)
    return out


def replicate_model(model: LMM, devices: Sequence) -> list:
    """One replica of `model` per entry of `devices`, made once (the JAX
    package's `replicate_params`, generate.py:300-306): the model itself for
    the first entry when it lives there, a copy for every other entry, so a
    device named twice holds two replicas."""
    own = next(model.parameters()).device
    reps = []
    for i, dev in enumerate(torch.device(d) for d in devices):
        reps.append(model if i == 0 and dev == own else copy.deepcopy(model).to(dev))
    return reps


def row_generators(generator, rows: int, devices: Sequence, seed: int) -> list:
    """One generator per row on the row's fleet device, seeded with the
    row's own draw from `generator` (or from a CPU generator seeded with
    `seed`), so that a row's sampled stream depends on its seed alone, not
    on where it is decoded (the JAX fleet's per-row keys, generate.py:330-335)."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    seeds = torch.randint(0, 2 ** 62, (rows,), generator=generator,
                          device=generator.device).tolist()
    per = rows // len(devices)
    return [torch.Generator(device=torch.device(devices[r // per])).manual_seed(s)
            for r, s in enumerate(seeds)]


def generate_fleet(model, conds, devices: Sequence, *, generator=None,
                   resume_ids: Optional[np.ndarray] = None, **kw) -> np.ndarray:
    """`generate_tokens` over a fleet of devices (generate.py:309-350): rows
    split evenly (a batch that does not divide raises), one replica each
    (`model` a list of replicas, or one model replicated for this call),
    one worker thread per device, which sets its card, decodes on a CUDA
    stream of its own and enters `torch.inference_mode()` itself (grad mode
    is thread-local); the results come back in row order. Greedy tokens of
    each replica's rows are those of one device decoding those rows alone
    (in bf16 a decode of all rows at once may round otherwise: the decode
    kernel divides its work by the batch). Sampling takes `generator` as a list of one
    generator per row, each on its row's device, or else draws one per row
    from it (`row_generators`)."""
    devices = [torch.device(d) for d in devices]
    reps = model if isinstance(model, (list, tuple)) else replicate_model(model, devices)
    if len(reps) != len(devices):
        raise ValueError(f"{len(reps)} replicas for {len(devices)} devices")
    conds = np.asarray(conds.cpu() if isinstance(conds, torch.Tensor) else conds)
    B, n = conds.shape[0], len(devices)
    if B % n:
        raise ValueError(f"fleet decode: the batch ({B} rows) must divide over the "
                         f"{n} devices")
    per = B // n
    if not isinstance(generator, (list, tuple)):
        generator = row_generators(generator, B, devices, reps[0].opt.seed)

    def run(i: int) -> np.ndarray:
        dev, rows = devices[i], slice(i * per, (i + 1) * per)
        stream = contextlib.nullcontext()
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            # the weights were written on the default stream
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.default_stream(dev))
            stream = torch.cuda.stream(side)
        with torch.inference_mode(), stream:
            return generate_tokens(
                reps[i], conds[rows], generator=list(generator[rows]),
                resume_ids=None if resume_ids is None else np.asarray(resume_ids)[rows],
                **kw)

    with ThreadPoolExecutor(n) as pool:
        outs = list(pool.map(run, range(n)))
    return np.concatenate(outs, axis=0)


def _decode(model, opt, G, vocab, logits, caches, plen, state, num_new, generator,
            use_grammar, bench_no_eos) -> np.ndarray:
    """The vanilla loop, one token per row and step (generate.py:31-157)."""
    B, device = logits.shape[0], logits.device
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
    return tokens.cpu().numpy()


def spec_pass(model, G, vocab: int, st: dict, pos, live, room, no_eos=None):
    """One speculative pass over every row (generate.py:196-290).

    st holds the frontier: "next_logits" [B, 1, V], "h_last" [B, 1, C],
    "gstate" and "caches". Proposes T = 1 + mtp_heads grammar-chained greedy
    tokens, verifies them in one `verify_step` whose rows start at positions
    pos (int32 [B] on the device), and accepts the longest prefix that the
    model itself would emit: at most `room` [B] tokens, none in rows that
    are not `live`. Updates the frontier in st to the last accepted token
    (rows that accept nothing keep theirs) and returns (P [B, T], PAD in
    rows not live; a [B], the accepted counts; whether the accepted prefix
    holds EOS [B]). `no_eos` [1, V] forbids EOS where given."""
    def choose(lg, gs):
        mask = G.mask(gs, vocab)
        if no_eos is not None:
            mask = mask & no_eos
        return S.greedy_token(S.apply_mask(lg.float(), mask))

    gstate = st["gstate"]
    chain = [gstate]
    props = [choose(st["next_logits"][:, 0], gstate)]
    chain.append(G.advance(gstate, props[0]))
    for draft in model.mtp_logits(st["h_last"]):
        props.append(choose(draft[:, 0], chain[-1]))
        chain.append(G.advance(chain[-1], props[-1]))
    P = torch.stack(props, dim=1)
    B, T = P.shape
    logits_v, h_v = model.verify_step(P, st["caches"], pos, with_hidden=True)

    acc = torch.ones(B, dtype=torch.bool, device=P.device)
    a = torch.ones(B, dtype=torch.int32, device=P.device)  # P[:, 0] always holds
    for t in range(1, T):
        acc = acc & (choose(logits_v[:, t - 1], chain[t]) == P[:, t]) & (P[:, t - 1] != S.EOS_ID)
        a = a + acc.int()
    a = torch.where(live, torch.minimum(a, room.int()), 0)

    rows = torch.arange(B, device=P.device)
    sel = (a - 1).clamp(min=0).long()
    keep = (a > 0)[:, None, None]
    st["next_logits"] = torch.where(keep, logits_v[rows, sel][:, None], st["next_logits"])
    st["h_last"] = torch.where(keep, h_v[rows, sel][:, None], st["h_last"])
    st["gstate"] = type(gstate)(*(torch.stack(xs)[a.long(), rows] for xs in zip(*chain)))
    eos = ((P == S.EOS_ID) & (torch.arange(T, device=P.device) < a[:, None])).any(dim=1)
    return torch.where(live[:, None], P, S.PAD_ID), a, eos


def _spec_decode(model, G, vocab, logits, h_last, caches, plen, state, num_new,
                 bench_no_eos) -> np.ndarray:
    """The speculative loop (generate.py:160-298): passes of `spec_pass`
    until every row has ended or reached its budget, read every
    DECODE_CHUNK passes without a per-pass synchronisation."""
    B, device = logits.shape[0], logits.device
    T = 1 + model.opt.mtp_heads
    st = {"next_logits": logits, "h_last": h_last, "gstate": state, "caches": caches}
    no_eos = (torch.arange(vocab, device=device)[None] != S.EOS_ID) if bench_no_eos else None
    tokens = torch.zeros((B, num_new + T), dtype=torch.int64, device=device)  # +T: headroom
    done = torch.zeros(B, dtype=torch.bool, device=device)
    n = torch.zeros(B, dtype=torch.int32, device=device)
    cols = torch.arange(T, device=device)
    ended = None
    for i in range(num_new):  # a pass advances every live row by at least one token
        P, a, eos = spec_pass(model, G, vocab, st, plen + n, ~done, num_new - n, no_eos)
        tokens.scatter_(1, n.long()[:, None] + cols, P)
        done |= eos
        n = n + a
        if (i + 1) % DECODE_CHUNK == 0:
            if ended is not None and arrived(ended):
                break
            ended = copy_to_host((done | (n >= num_new)).all())
    keep = torch.arange(num_new + T, device=device)[None] < n[:, None]
    return torch.where(keep, tokens, S.PAD_ID)[:, :num_new].cpu().numpy()


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
