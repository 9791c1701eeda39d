"""Grammar-constrained token selection on the device (edgerunner_tpu/ops/sampling.py).

The grammar FSMs are tensor code carried through the decode loop and turned
into a logit mask each step, so the host never waits on the device per token.

Token layout after the +3 special offset (reference: models.py:252):
    LR / LR_ABSCO: 0=PAD 1=BOS 2=EOS 3=L 4=R 5=BOM 6..V-1=coords
    CLERS:         C=3 L=4 E=5 R=6 S=7 BOM=8 EOM=9, residual coords >= 10
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

PAD_ID, BOS_ID, EOS_ID = 0, 1, 2
L_ID, R_ID, BOM_ID = 3, 4, 5
COORD_START = 6
NEG_INF = -1e30


class GrammarState(NamedTuple):
    """Counter FSM of LR / LR_ABSCO, one entry per batch row."""

    counter: torch.Tensor   # int32 [B]: coord tokens still owed
    is_first: torch.Tensor  # bool  [B]: next token is the first generated one


def grammar_init(batch: int, device=None) -> GrammarState:
    return GrammarState(torch.zeros(batch, dtype=torch.int32, device=device),
                        torch.ones(batch, dtype=torch.bool, device=device))


def grammar_advance(state: GrammarState, token: torch.Tensor) -> GrammarState:
    """Update after `token` [B] was emitted (reference: models.py:254-261)."""
    counter = torch.where(
        token == BOM_ID, 9,
        torch.where((token == L_ID) | (token == R_ID), 3,
                    torch.where(token >= COORD_START, state.counter - 1, state.counter)))
    return GrammarState(counter.to(torch.int32), torch.zeros_like(state.is_first))


def grammar_mask(state: GrammarState, vocab_size: int) -> torch.Tensor:
    """Allowed-token mask bool [B, V] for the next token (reference: models.py:262-268)."""
    ids = torch.arange(vocab_size, device=state.counter.device)[None]
    coords = ids >= COORD_START
    ops_or_eos = (ids == L_ID) | (ids == R_ID) | (ids == BOM_ID) | (ids == EOS_ID)
    mask = torch.where(state.counter[:, None] > 0, coords, ops_or_eos)
    return torch.where(state.is_first[:, None], ids == BOM_ID, mask)


# ------------------------------------------------------------- CLERS FSM --
# Per submesh the stream is  BOM c*9 op [c*3 op]* EOM  in pre-order; S forks
# a branch, E closes one. Two counters decide validity:
#   counter  coords still owed before the next op
#   pending  open branches (BOM -> 1, S -> +1, E -> -1; 0 after E -> EOM)
# phases: 0 = expect BOM (or EOS once something was generated)
#         1 = expect coords, 2 = expect an op (C/L/E/R/S), 3 = expect EOM

C_ID, CL_L_ID, CE_ID, CR_ID, CS_ID, CBOM_ID, CEOM_ID = 3, 4, 5, 6, 7, 8, 9
CLERS_COORD_START = 10


class CLERSState(NamedTuple):
    counter: torch.Tensor   # int32 [B]: coords still owed
    pending: torch.Tensor   # int32 [B]: open branches
    phase: torch.Tensor     # int32 [B]
    is_first: torch.Tensor  # bool  [B]


def clers_init(batch: int, device=None) -> CLERSState:
    z = dict(dtype=torch.int32, device=device)
    return CLERSState(torch.zeros(batch, **z), torch.zeros(batch, **z),
                      torch.zeros(batch, **z),
                      torch.ones(batch, dtype=torch.bool, device=device))


def clers_advance(state: CLERSState, t: torch.Tensor) -> CLERSState:
    is_coord = t >= CLERS_COORD_START
    is_op = (t >= C_ID) & (t <= CS_ID)
    is_s, is_e, is_bom = t == CS_ID, t == CE_ID, t == CBOM_ID
    counter = torch.where(is_bom, 9, torch.where(is_coord, state.counter - 1, state.counter))
    pending = torch.where(is_bom, 1, state.pending + is_s.int() - is_e.int())
    closes = is_e & (pending == 0)
    after_op_phase = torch.where(closes, 3, 1)
    phase = torch.where(
        is_bom, 1,
        torch.where(is_coord, torch.where(counter > 0, 1, 2),
                    torch.where(is_op, after_op_phase,
                                torch.where(t == CEOM_ID, 0, state.phase))))
    counter = torch.where(is_op, torch.where(closes, 0, 3), counter)
    return CLERSState(counter.to(torch.int32), pending.to(torch.int32),
                      phase.to(torch.int32), torch.zeros_like(state.is_first))


def clers_mask(state: CLERSState, vocab_size: int) -> torch.Tensor:
    ids = torch.arange(vocab_size, device=state.phase.device)[None]
    ph = state.phase[:, None]
    bom = ids == CBOM_ID
    mask = torch.where(ph == 1, ids >= CLERS_COORD_START,
                       torch.where(ph == 2, (ids >= C_ID) & (ids <= CS_ID),
                                   torch.where(ph == 3, ids == CEOM_ID,
                                               bom | (ids == EOS_ID))))
    return torch.where(state.is_first[:, None], bom, mask)


class Grammar(NamedTuple):
    init: callable
    advance: callable
    mask: callable


def get_grammar(backend: str) -> Grammar:
    """The FSM of a metok backend: LR / LR_ABSCO share the counter FSM,
    CLERS has the branch-counting one."""
    if backend == "CLERS":
        return Grammar(clers_init, clers_advance, clers_mask)
    return Grammar(grammar_init, grammar_advance, grammar_mask)


def grammar_replay(grammar: Grammar, tokens, device=None):
    """The FSM state after existing tokens [B, T] (resume_ids support)."""
    tokens = torch.as_tensor(np.asarray(tokens), device=device)
    state = grammar.init(tokens.shape[0], device)
    for t in range(tokens.shape[1]):
        state = grammar.advance(state, tokens[:, t])
    return state


def naive_grammar_mask(step_index: int, batch: int, vocab_size: int, device=None):
    """Naive (9 coords per face) tokenizer: coords always, EOS only when the
    sequence so far (BOS included) has length % 9 == 1 (reference: models.py:237-242)."""
    ids = torch.arange(vocab_size, device=device)[None].expand(batch, -1)
    return (ids >= 3) | ((ids == EOS_ID) & ((step_index + 1) % 9 == 1))


def apply_mask(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return torch.where(mask, logits, NEG_INF)


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def _shape_topk_vals(logits, top_k: int, temperature: float, top_p: float):
    """Top-k slice, temperature, then nucleus filtering inside the k
    candidates; returns (vals, idx) [B, k]."""
    vals, idx = torch.topk(logits, top_k, dim=-1)
    if temperature != 1.0:
        vals = vals / max(float(temperature), 1e-6)
    if top_p < 1.0:
        p = torch.softmax(vals, dim=-1)
        prefix = torch.cumsum(p, dim=-1) - p  # the argmax always stays
        vals = torch.where(prefix < top_p, vals, NEG_INF)
    return vals, idx


def sample_token(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                 *, top_k: int = 10, temperature: float = 1.0,
                 top_p: float = 1.0) -> torch.Tensor:
    """Top-k sampling with temperature and nucleus filtering inside the k
    candidates (reference: models.py:299-301). logits [B, V] -> [B]."""
    vals, idx = _shape_topk_vals(logits, top_k, temperature, top_p)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=generator)
    return torch.gather(idx, 1, choice)[:, 0]


def sample_token_per_row(logits: torch.Tensor, generators: Sequence[torch.Generator], *,
                         top_k: int = 10, temperature: float = 1.0,
                         top_p: float = 1.0) -> torch.Tensor:
    """`sample_token` with one generator per batch row
    (edgerunner_tpu/ops/sampling.py:224-234): row b draws from generators[b]
    alone, so a row's stream depends on its own seed and not on the rows
    batched with it; each row draws as `sample_token` does for a batch of
    one. logits [B, V] -> [B]."""
    vals, idx = _shape_topk_vals(logits, top_k, temperature, top_p)
    probs = torch.softmax(vals, dim=-1)
    choice = torch.cat([torch.multinomial(probs[b:b + 1], 1, generator=g)
                        for b, g in enumerate(generators)])
    return torch.gather(idx, 1, choice)[:, 0]
