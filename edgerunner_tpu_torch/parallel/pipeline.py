"""GPipe pipeline parallelism of the port (edgerunner_tpu/parallel/pipeline.py:43-156).

The decoder's L layers are split into S stages of L/S consecutive layers,
one per rank of the pp group (models/shape_opt.py builds only its stage's
layers), and the batch into M microbatches of rows. The JAX package runs
M + S - 1 ticks of one program in which stage s works on microbatch t - s
at tick t and `ppermute` passes the activations on. Here each stage is a
process: stage s takes microbatch m from stage s - 1 (stage 0 from the
input), runs its layers on it and sends the result to stage s + 1, for m
= 0 .. M - 1. So stage s runs microbatch m exactly when stage s - 1 has
finished it, which is the same schedule. The last stage's outputs, joined
into [B, T, D], are broadcast to every pp rank, which all compute the
loss (as JAX's `y[S - 1]` reaches every device).

Autograd does not cross processes, so the pipeline is one
`torch.autograd.Function` whose backward runs the same ticks in reverse:
stage s takes the gradient of its output for microbatch m from stage s + 1
(the last stage from its own loss: the other ranks' equal copies are not
added, so the loss is counted once), back-propagates it through its layers
and sends the input's gradient to stage s - 1, for m = M - 1 .. 0. Stage
0's input gradient is then broadcast to every pp rank, as the transpose of
JAX's replicated input sums the ranks' cotangents, of which only stage 0's
is not zero: so the parts outside the pipeline (the embeddings, the
condition encoder, `lm_head`) take the same whole gradient on every pp
rank. The stage's parameters are inputs of the Function, whose backward
returns their gradients summed over the microbatches.

With `remat` (`--checkpointing`) each stage's tick keeps only its input
and replays its layers in the backward pass, with the random state of its
first run (dropout draws alike), as `jax.checkpoint(run_stage)` does;
otherwise each tick's graph is kept until the backward pass.

Each stage returns the sum of its layers' MoE aux losses over its
microbatches (zero without MoE): every tick of the port's schedule is real
work, so no bubble tick has to be masked out (pipeline.py:125-128).
Activations cross between stages in the input's dtype (f32 under autocast,
whose LayerNorms return f32), as JAX's pipeline takes its input in f32.
`gpipe.bytes` counts what the stages send and broadcast.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch

from edgerunner_tpu_torch.parallel.collectives import _Sum, broadcast_, recv_, send_
from edgerunner_tpu_torch.parallel.mesh import PipelineParallel


def _rng_state(device: torch.device) -> tuple:
    cuda = torch.cuda.get_rng_state(device) if device.type == "cuda" else None
    return torch.get_rng_state(), cuda


def _set_rng_state(device: torch.device, state: tuple):
    torch.set_rng_state(state[0])
    if state[1] is not None:
        torch.cuda.set_rng_state(state[1], device)


def _autocast_state(device: torch.device) -> tuple:
    on = torch.is_autocast_enabled(device.type)
    return on, (torch.get_autocast_dtype(device.type) if on else None)


class _GPipe(torch.autograd.Function):

    @staticmethod
    def forward(ctx, run, pp, M, remat, grad, x, lengths, *params):
        S, s = pp.size, pp.rank
        B, T, D = x.shape
        mb = B // M
        dev = x.device
        lens = [None] * M if lengths is None else list(lengths.split(mb))
        saved, outs = [], []
        aux_total = torch.zeros((), dtype=torch.float32, device=dev)
        for m in range(M):
            inp = (x[m * mb:(m + 1) * mb] if s == 0
                   else recv_((mb, T, D), x.dtype, dev, s - 1, pp)).detach()
            if grad and not remat:
                inp.requires_grad_(True)
                with torch.enable_grad():
                    out, aux = run(inp, lens[m])
                saved.append((inp, out, aux))
            else:
                state = _rng_state(dev) if grad else None
                out, aux = run(inp, lens[m])
                saved.append((inp, state))
            aux_total += aux.detach().float()
            out = out.detach().to(x.dtype)
            if s < S - 1:
                send_(out, s + 1, pp)
                gpipe.bytes += out.numel() * out.element_size()
            else:
                outs.append(out)
        y = torch.cat(outs) if s == S - 1 else torch.empty_like(x)
        broadcast_([y], pp, src=S - 1)
        gpipe.bytes += y.numel() * y.element_size()
        ctx.run, ctx.pp, ctx.M, ctx.remat, ctx.mb = run, pp, M, remat, mb
        ctx.shape, ctx.dtype, ctx.lens = (B, T, D), x.dtype, lens
        ctx.saved, ctx.autocast = (saved if grad else None), _autocast_state(dev)
        ctx.params = params
        return y, aux_total

    @staticmethod
    def backward(ctx, dy, daux):
        pp, M, mb = ctx.pp, ctx.M, ctx.mb
        S, s = pp.size, pp.rank
        B, T, D = ctx.shape
        dev = dy.device
        params = [p for p in ctx.params]
        grads: List[Optional[torch.Tensor]] = [None] * len(params)
        dxs = [None] * M
        for m in reversed(range(M)):
            g = (dy[m * mb:(m + 1) * mb] if s == S - 1
                 else recv_((mb, T, D), ctx.dtype, dev, s + 1, pp))
            if ctx.remat:
                inp, state = ctx.saved[m]
                inp = inp.detach().requires_grad_(True)
                on, dtype = ctx.autocast
                cuda = [dev.index or 0] if dev.type == "cuda" else []
                with torch.random.fork_rng(devices=cuda), torch.enable_grad(), \
                        torch.autocast(dev.type, dtype=dtype, enabled=on):
                    _set_rng_state(dev, state)
                    out, aux = ctx.run(inp, ctx.lens[m])
            else:
                inp, out, aux = ctx.saved[m]
            outputs, cotangents = [out], [g.to(out.dtype)]
            if aux.requires_grad and daux is not None:
                outputs.append(aux)
                cotangents.append(daux.to(aux.dtype))
            res = torch.autograd.grad(outputs, [inp, *params], cotangents, allow_unused=True)
            for i, gp in enumerate(res[1:]):
                if gp is not None:
                    grads[i] = gp if grads[i] is None else grads[i] + gp
            din = res[0].to(ctx.dtype)
            if s > 0:
                send_(din, s - 1, pp)
                gpipe.bytes += din.numel() * din.element_size()
            else:
                dxs[m] = din
            ctx.saved[m] = None
        dx = torch.cat(dxs) if s == 0 else torch.empty((B, T, D), dtype=ctx.dtype, device=dev)
        broadcast_([dx], pp, src=0)
        gpipe.bytes += dx.numel() * dx.element_size()
        grads = [torch.zeros_like(p) if gp is None else gp for p, gp in zip(params, grads)]
        return (None, None, None, None, None, dx, None, *grads)


def gpipe(run: Callable, params: Sequence[torch.Tensor], x: torch.Tensor,
          lengths: Optional[torch.Tensor], pp: PipelineParallel, *, remat: bool = False):
    """This rank's stage of the GPipe schedule over `pp` (`pp.microbatches`
    microbatches; the batch must divide by it). `run(h [mb, T, D], lengths
    [mb] or None) -> (h, aux scalar)` applies the stage's layers, whose
    trainable parameters are `params`. x [B, T, D] is the pipeline's input
    on every pp rank (stage 0 reads it). Returns (y [B, T, D] on every pp
    rank, this stage's aux summed over its microbatches), both with their
    gradients: through the stage's layers to `params`, and to x on every
    rank (stage 0's input gradient, broadcast)."""
    M = pp.microbatches
    if x.shape[0] % M:
        raise ValueError(f"batch {x.shape[0]} does not divide into {M} microbatches "
                         "(--pp_microbatches)")
    params = [p for p in params if p.requires_grad]
    grad = torch.is_grad_enabled() and (x.requires_grad or bool(params))
    return _GPipe.apply(run, pp, M, remat, grad, x, lengths, *params)


gpipe.bytes = 0


def stage_sum(x: torch.Tensor, pp: PipelineParallel) -> torch.Tensor:
    """A per-stage scalar (a stage's MoE aux) summed over the pp group; each
    stage's gradient passes through to its own, as every rank computes the
    same loss from the sum. Counted in `gpipe.bytes`."""
    return _Sum.apply(x, pp, gpipe)
