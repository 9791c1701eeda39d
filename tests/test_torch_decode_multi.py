"""Kernel D's bf16/f32 kind (csrc/decode_attention_multi.cu, on the
persistent skeleton of csrc/decode_common.cuh) through its wrapper
`fused_decode_attention_multi`, on the CPU:

* the helpers that size its launch (queries per pass, scratch slot floats,
  tickets) against hand-worked values;
* the plain version against the JAX package's `fused_decode_attention_multi`
  (its Pallas kernel in interpret mode) at T 1, 3 and 8, bf16 and f32, with
  per-row positions 0, 255, 256 and L - T, under chip_smoke.py's tolerance
  rule (the bf16 rule covers q / sqrt(D) and p, which the Pallas kernel
  rounds to bf16 and the plain version keeps in f32);
* the plain version is f32 attention over either cache;
* the kernel's roundings (p to bf16 before PV, q / sqrt(D) kept f32, as in
  kernel B) hold the bf16 rule against the plain version on seeds where the
  Pallas kernel's (q / sqrt(D) rounded to bf16 as well) cross it;
* the wrapper on a CPU tensor runs the plain version and counts no launch;
  the kernel's path refuses what it does not take before it touches the
  library; and it launches once per call with its scratch and tickets kept
  for its configuration (a recording library stands in for the card's).
"""

import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import tolerance
from edgerunner_tpu.ops import decode_attention_pallas as JP
from edgerunner_tpu_torch.ops import _build
from edgerunner_tpu_torch.ops import decode_attention as DA
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


@pytest.mark.parametrize("T,passes,per_pass", [(1, 1, 1), (3, 1, 3), (4, 2, 2), (8, 3, 3)])
def test_query_passes_slot_floats_and_tickets(T, passes, per_pass):
    assert DA.query_passes(T) == (passes, per_pass)
    # per stream (a query of a pass): D sums, a max and a sum, padded to 16 bytes
    for D in (64, 96):
        assert DA.multi_slot_floats(D, T) == -(-per_pass * (D + 2) // 4) * 4
    assert DA.multi_tickets(8, 16, T) == 8 * passes * 16


def test_hand_worked_sizes():
    assert DA.multi_slot_floats(96, 1) == 100     # 98 floats, padded
    assert DA.multi_slot_floats(96, 3) == 296     # 3 x 98 = 294, padded
    assert DA.multi_slot_floats(64, 8) == 200     # 3 queries a pass: 3 x 66 = 198
    assert DA.multi_slot_floats(64, 4) == 132     # 2 queries a pass: 2 x 66
    assert DA.multi_tickets(8, 16, 3) == 128      # the engine's spec pass: one pass
    assert DA.multi_tickets(3, 2, 8) == 18        # three passes


def _rule(out, ref, dtype) -> bool:
    atol, rtol = tolerance(dtype, ref)
    return bool(torch.isfinite(out).all() and ((out - ref).abs() <= atol + rtol * ref.abs()).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 3, 8])
def test_plain_version_matches_pallas(T, dtype):
    B, L, H, D = 4, 512, 2, 96
    index = [0, 255, 256, L - T]
    r = np.random.default_rng(T)
    q, k, v = (r.normal(size=s).astype(np.float32)
               for s in ((B, T, H * D), (B, L, H * D), (B, L, H * D)))
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ref = JP.fused_decode_attention_multi(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                                          jnp.asarray(v, jdt), jnp.asarray(index, jnp.int32),
                                          num_heads=H, block=128)
    ref = torch.tensor(np.asarray(ref.astype(jnp.float32)))
    out = DA.fused_decode_attention_multi(*(torch.tensor(x).to(dtype) for x in (q, k, v)),
                                          torch.tensor(index, dtype=torch.int32), num_heads=H)
    assert out.shape == (B, T, H * D) and out.dtype == dtype
    assert _rule(out.float(), ref, dtype)
    # query t of row b sees rows [0, index[b] + t] only: row 0, position 0, one row
    if T == 1:
        torch.testing.assert_close(out[0, 0].float(), torch.tensor(v[0, 0]).to(dtype).float())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_version_is_f32_attention_over_either_cache(dtype):
    """The plain version is attention in f32 over the cache as it is stored,
    q unrounded and scaled by 1/sqrt(D), and returns q's dtype."""
    B, L, H, D, T = 2, 64, 2, 64, 2
    r = np.random.default_rng(3)
    q, k, v = (torch.tensor(r.normal(size=s).astype(np.float32)).to(dtype)
               for s in ((B, T, H * D), (B, L, H * D), (B, L, H * D)))
    index = torch.tensor([5, 40], dtype=torch.int32)
    got = DA.fused_decode_attention_multi_reference(q, k, v, index, num_heads=H)
    qh, kh, vh = (x.float().reshape(B, -1, H, D) for x in (q, k, v))
    logits = torch.einsum("bthd,bmhd->bhtm", qh, kh) / math.sqrt(D)
    keep = torch.arange(L)[None, None] <= (index[:, None] + torch.arange(T))[:, :, None]
    p = torch.softmax(logits.masked_fill(~keep[:, None], -1e30), -1)
    want = torch.einsum("bhtm,bmhd->bthd", p, vh).reshape(B, T, H * D)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.to(dtype).float(), rtol=1e-6, atol=1e-6)


def _kernel_roundings(q, k, v, index, H):
    """Kernel D's roundings over a bf16 cache, emulated: q / sqrt(D) in f32,
    p rounded to bf16 before PV, l summed from the unrounded p."""
    B, T, hd = q.shape
    D = hd // H
    qh, kh, vh = (x.float().reshape(B, -1, H, D) for x in (q, k, v))
    s = torch.einsum("bthd,bmhd->bhtm", qh * np.float32(1 / math.sqrt(D)), kh)
    keep = torch.arange(kh.shape[1])[None, None] <= (index[:, None] + torch.arange(T))[:, :, None]
    s = s.masked_fill(~keep[:, None], -float("inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhtm,bmhd->bthd", p.bfloat16().float(), vh)
    return (out / p.sum(-1).permute(0, 2, 1)[..., None]).reshape(B, T, hd).bfloat16()


@pytest.mark.parametrize("seed", range(6))
def test_rounding_p_alone_holds_the_bf16_rule_where_the_pallas_kernel_need_not(seed):
    """The Pallas kernel also rounds q / sqrt(D) to bf16 (its MXU operand):
    against the plain version, which keeps it f32, that second rounding
    carries its outputs past the bf16 rule on seeds 1 and 2 of these six at
    the engine's head shape. Kernel D keeps q / sqrt(D) in f32, as kernel B
    does, and its roundings stay within the rule on every seed."""
    B, L, H, D, T = 8, 1024, 16, 96, 1
    r = np.random.default_rng(seed)
    index = torch.tensor(np.linspace(L // 4, L - T, B).astype(np.int32))
    q, k, v = (torch.tensor(r.normal(size=s).astype(np.float32)).bfloat16()
               for s in ((B, T, H * D), (B, L, H * D), (B, L, H * D)))
    plain = DA.fused_decode_attention_multi_reference(q, k, v, index, num_heads=H).float()
    pallas = JP.fused_decode_attention_multi(
        *(jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (q, k, v)),
        jnp.asarray(index.numpy()), num_heads=H, block=128)
    pallas = torch.tensor(np.asarray(pallas.astype(jnp.float32)))
    assert _rule(_kernel_roundings(q, k, v, index, H).float(), plain, torch.bfloat16)
    assert _rule(pallas, plain, torch.bfloat16) == (seed not in (1, 2))


def test_cpu_tensors_take_the_plain_version():
    B, L, H, D, T = 2, 40, 2, 64, 3
    r = np.random.default_rng(5)
    q, k, v = (torch.tensor(r.normal(size=s).astype(np.float32))
               for s in ((B, T, H * D), (B, L, H * D), (B, L, H * D)))
    index = torch.tensor([0, L - T], dtype=torch.int32)
    before = DA.fused_decode_attention_multi.launches
    out = DA.fused_decode_attention_multi(q, k, v, index, num_heads=H)
    assert DA.fused_decode_attention_multi.launches == before
    torch.testing.assert_close(out, DA.fused_decode_attention_multi_reference(
        q, k, v, index, num_heads=H), rtol=0, atol=0)


@pytest.fixture
def fake_card(monkeypatch):
    """The kernel's path on CPU tensors: a library that records its calls
    and a stream of 0, so that the wrapper's checks, scratch and arguments
    can be seen without a card."""
    calls = []

    def warps(D, T, dtype):
        calls.append(("warps", D, T, dtype))
        return 528  # 132 SMs x 1 block x 4 warps

    def fwd(*args):
        calls.append(("fwd", *args))
        return 0

    lib = types.SimpleNamespace(decode_attention_multi_warps=warps,
                                decode_attention_multi_fwd=fwd)
    monkeypatch.setattr(_build, "load_library", lambda: lib)
    monkeypatch.setattr(DA, "_on_cuda", lambda name, q: True)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(DA, "_SCRATCH", {})
    return calls


@pytest.mark.parametrize("T,D", [(9, 96), (0, 96), (3, 32), (3, 80)])
def test_the_kernel_path_refuses_what_it_does_not_take(fake_card, T, D):
    H, L = 2, 64
    q = torch.zeros(2, T, H * D, dtype=torch.bfloat16)
    kv = torch.zeros(2, L, H * D, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        DA.fused_decode_attention_multi(q, kv, kv.clone(), torch.zeros(2, dtype=torch.int32),
                                        num_heads=H)
    assert fake_card == []  # refused before the library was asked anything


def test_the_kernel_path_refuses_mixed_dtypes(fake_card):
    q = torch.zeros(2, 1, 192, dtype=torch.float32)
    kv = torch.zeros(2, 16, 192, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        DA.fused_decode_attention_multi(q, kv, kv.clone(), torch.zeros(2, dtype=torch.int32),
                                        num_heads=2)
    assert fake_card == []


def test_one_launch_per_call_with_its_scratch_kept(fake_card):
    B, L, H, D, T = 8, 256, 16, 96, 3
    q = torch.zeros(B, T, H * D, dtype=torch.bfloat16)
    kv = torch.zeros(B, L, H * D, dtype=torch.bfloat16)
    index = torch.zeros(B, dtype=torch.int32)
    before = DA.fused_decode_attention_multi.launches
    for _ in range(3):
        DA.fused_decode_attention_multi(q, kv, kv.clone(), index, num_heads=H)
    assert DA.fused_decode_attention_multi.launches == before + 3
    assert [c[0] for c in fake_card] == ["warps", "fwd", "fwd", "fwd"]
    assert fake_card[0] == ("warps", D, T, 1)
    (scratch, ticket, warps), = DA._SCRATCH.values()
    assert warps == 528 and scratch.numel() == 528 * 2 * DA.multi_slot_floats(D, T)
    assert ticket.numel() == DA.multi_tickets(B, H, T) and not ticket.any()
    for call in fake_card[1:]:
        # q, k, v, index, out, scratch, ticket, warps, B, L, H, D, T, dtype, scale, stream
        assert call[6] == scratch.data_ptr() and call[7] == ticket.data_ptr()
        assert call[4] == index.data_ptr()  # the step's int32 vector, as it is
        assert call[8:] == (warps, B, L, H, D, T, 1, 1.0 / math.sqrt(D), 0)
