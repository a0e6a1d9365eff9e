"""The port's CUDA kernels against their plain versions, on a card.

Every test here needs a CUDA card (marker ``gpu``) and skips where there is
none; the card is looked for inside a fixture, never at import time. The
file imports nothing of JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_kernels.py
"""
import numpy as np
import pytest
import torch

from idunno_tpu_torch.config import EngineConfig
from idunno_tpu_torch.engine import data as data_lib
from idunno_tpu_torch.engine.inference import InferenceEngine
from idunno_tpu_torch.ops.preprocess_kernel import (preprocess_batch_kernel,
                                                    preprocess_batch_plain)


@pytest.fixture
def cuda_device():
    """The card, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    return torch.device("cuda")


# (batch, side, crop): the main path's shape; the ragged 240² batch of
# tests/test_pallas_ops.py, whose rows are not 16-byte aligned (the
# one-byte-per-thread kernel); an odd crop; a crop of the whole image
@pytest.mark.gpu
@pytest.mark.parametrize("batch,side,crop", [
    (256, 256, 224), (3, 240, 224), (2, 256, 225), (1, 224, 224)])
def test_preprocess_kernel_matches_plain_version(cuda_device, batch, side,
                                                 crop):
    rng = np.random.default_rng(side + crop)
    imgs = torch.from_numpy(rng.integers(
        0, 256, (batch, side, side, 3), dtype=np.uint8)).to(cuda_device)
    before = preprocess_batch_kernel.launches
    out = preprocess_batch_kernel(imgs, crop)
    torch.cuda.synchronize()
    assert preprocess_batch_kernel.launches == before + 1
    assert out.shape == (batch, crop, crop, 3) and out.dtype == torch.bfloat16
    ref = preprocess_batch_plain(imgs, crop)
    # the kernel forbids FMA contraction and rounds to nearest-even like
    # the plain version: bit for bit equal
    assert torch.equal(out.view(torch.int16), ref.view(torch.int16))


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["resnet", "alexnet"])
def test_kernel_mode_matches_plain_mode_on_card(cuda_device, name):
    cfg = dict(batch_size=8, image_size=224, resize_size=256)
    kern = InferenceEngine(EngineConfig(preprocess="kernel", **cfg))
    plain = InferenceEngine(EngineConfig(preprocess="plain", **cfg))
    _, images = data_lib.load_range(None, 0, 7)
    batch = torch.from_numpy(images).to(cuda_device)
    before = preprocess_batch_kernel.launches
    out = kern.logits(name, batch)
    assert preprocess_batch_kernel.launches == before + 1
    ref = plain.logits(name, batch)
    # plain mode normalizes in f32 (divide) and the model rounds to bf16;
    # the kernel multiplies and rounds: the bf16 inputs differ at most in
    # a few elements by one ulp, so the bf16 logits agree closely
    scale = float(ref.abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=2e-2 * scale)


# -- K2: flash attention forward --------------------------------------------

def _assert_within_bound(name, got, ref, q, k, v, causal, **bwd):
    """bf16 tensor-core output within its per-element bound
    (``ops/flash_attention.py:tensor_core_bound``)."""
    from idunno_tpu_torch.ops.flash_attention import tensor_core_bound
    bound = tensor_core_bound(name, got, ref, q, k, v, causal=causal, **bwd)
    ratio = float(((got.float() - ref.float()).abs().double() / bound).max())
    assert ratio <= 1.0, (name, ratio)


# (batch, seq, heads, head_dim, dtype, causal): the LM prefill shape of the
# full-width model, a ragged f32 shape whose last tile is partly past T,
# the tensor-core kernel's second head_dim and a ragged T in bf16, and
# ViT-S/16's attention (T = 197, non-causal: 5 live rows in the last tile)
@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal", [
    ((4, 1024, 16, 64), torch.bfloat16, True),
    ((2, 1000, 3, 32), torch.float32, False),
    ((2, 1000, 3, 32), torch.float32, True),
    ((2, 256, 4, 32), torch.bfloat16, False),
    ((2, 1000, 3, 64), torch.bfloat16, True),
    ((8, 197, 6, 64), torch.bfloat16, False)])
def test_flash_kernel_matches_plain_version(cuda_device, shape, dtype,
                                            causal):
    from idunno_tpu_torch.ops.flash_attention import (flash_attention_kernel,
                                                      flash_attention_plain)
    rng = np.random.default_rng(sum(shape))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
               .to(cuda_device, dtype) for _ in range(3))
    before = flash_attention_kernel.launches
    out, lse = flash_attention_kernel(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_kernel.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal)
    assert out.dtype == dtype and lse.shape == (shape[0], shape[2], shape[1])
    o, r = out.float(), ref.float()
    # bf16: the tensor-core kernel rounds p to bf16 before P.V, so each
    # element lies within the bound derived from that rounding; f32 (the
    # TPU kernel's arithmetic on the CUDA cores): 1e-5 of the largest output
    if dtype == torch.bfloat16:
        _assert_within_bound("out", out, ref, q, k, v, causal)
    else:
        torch.testing.assert_close(o, r, rtol=0,
                                   atol=1e-5 * float(r.abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=0,
                               atol=1e-3 if dtype == torch.bfloat16 else 1e-5)


# -- K3: paged decode attention ---------------------------------------------

def _paged_inputs(device, *, b, t, kvh, g, d, n, bs, c, page_dtype, seed,
                  nblocks=None):
    """Pages, tables and block-aligned lengths as the decode pool builds
    them: chains of ``nblocks`` blocks, by default 0..c (row 0 always
    empty), table entries of dead blocks 0, live entries distinct
    pages."""
    rng = np.random.default_rng(seed)
    q5 = torch.from_numpy(rng.standard_normal((b, t, kvh, g, d),
                                              dtype=np.float32)).to(device)
    shape = (n, bs, kvh, d)
    ks = vs = None
    if page_dtype == torch.int8:
        kp, vp = (torch.from_numpy(rng.integers(-127, 128, shape)
                                   .astype(np.int8)).to(device)
                  for _ in range(2))
        ks, vs = (torch.from_numpy(rng.uniform(0.001, 0.02, shape[:3])
                                   .astype(np.float32)).to(device)
                  for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                  .to(device, page_dtype) for _ in range(2))
    if nblocks is None:
        nblocks = rng.integers(0, c + 1, size=b)
        nblocks[0] = 0
    nblocks = np.asarray(nblocks)
    tables = np.zeros((b, c), np.int32)
    perm = rng.permutation(n)
    used = 0
    for r in range(b):
        tables[r, :nblocks[r]] = perm[used:used + nblocks[r]] % n
        used += nblocks[r]
    lengths = (nblocks * bs).astype(np.int32)
    return (q5, kp, vp, torch.from_numpy(tables).to(device),
            torch.from_numpy(lengths).to(device), ks, vs)


# the served decode shape (16 slots, 16 kv-heads, one row each, bs 16,
# chains of up to 3 blocks), a radix-hit prefill (one row, 64 query
# positions, GQA group 2) and chains of up to 9 blocks (more than the
# kernel's 4 warps); at head_dim 32 the default-size model's decode shape
# (4 kv-heads), GQA chains of up to 9 blocks, and blocks of 2 tokens (an
# int8 pass of 16 tokens then covers a block 8 times over); the
# speculative verify of draft_len 4 (16 rows x 5 query positions, a CTA's
# 4-row tile then holds a row's last position alone) at both head dims;
# each with f32, bf16 and int8 pages
@pytest.mark.gpu
@pytest.mark.parametrize("dims", [
    dict(b=16, t=1, kvh=16, g=1, d=64, n=68, bs=16, c=3),
    dict(b=16, t=5, kvh=16, g=1, d=64, n=68, bs=16, c=3),
    dict(b=16, t=5, kvh=4, g=1, d=32, n=68, bs=16, c=3),
    dict(b=1, t=64, kvh=8, g=2, d=64, n=20, bs=16, c=3),
    dict(b=4, t=1, kvh=4, g=2, d=64, n=40, bs=16, c=9),
    dict(b=16, t=1, kvh=4, g=1, d=32, n=68, bs=16, c=3),
    dict(b=4, t=1, kvh=2, g=2, d=32, n=40, bs=16, c=9),
    dict(b=4, t=2, kvh=4, g=1, d=32, n=40, bs=2, c=9)])
@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16,
                                        torch.int8])
def test_paged_kernel_matches_plain_version(cuda_device, dims, page_dtype):
    from idunno_tpu_torch.ops.paged_attention import (_paged_plain,
                                                      paged_attention_kernel)
    q5, kp, vp, tables, lengths, ks, vs = _paged_inputs(
        cuda_device, page_dtype=page_dtype, seed=dims["b"], **dims)
    if dims["b"] == 1:
        lengths.fill_(dims["c"] * dims["bs"])      # the hit covers the chain
        tables[0] = torch.arange(dims["c"], device=cuda_device)
    before = paged_attention_kernel.launches
    out, lse = paged_attention_kernel(q5, kp, vp, tables, lengths,
                                      k_scale_pages=ks, v_scale_pages=vs)
    torch.cuda.synchronize()
    assert paged_attention_kernel.launches == before + 1
    ref, ref_lse = _paged_plain(q5, kp, vp, tables, lengths,
                                k_scale_pages=ks, v_scale_pages=vs,
                                scale=1.0 / dims["d"] ** 0.5)
    # both compute in f32 and differ only in summation order: 1e-5
    # relative; empty chains are exactly (0, -1e30) in both
    torch.testing.assert_close(out, ref, rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
    empty = lengths == 0
    if bool(empty.any()):
        assert bool((out[empty] == 0).all())
        assert bool((lse[empty] == -1e30).all())


@pytest.mark.gpu
def test_paged_kernel_refuses_a_head_dim_it_was_not_built_for(cuda_device):
    """No quiet fallback: the error names the head dims K3 is built for."""
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    q5, kp, vp, tables, lengths, _, _ = _paged_inputs(
        cuda_device, b=2, t=1, kvh=2, g=1, d=16, n=8, bs=16, c=2,
        page_dtype=torch.float32, seed=0)
    with pytest.raises(ValueError, match=r"\(32, 64\)"):
        paged_attention_kernel(q5, kp, vp, tables, lengths)


@pytest.mark.gpu
@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8])
def test_paged_kernel_bad_entry_and_repeats(cuda_device, page_dtype):
    """A table entry outside [0, N) makes its row NaN and no other; two
    launches give the same bits (the warps' partials merge in a fixed
    order); misaligned pages are refused."""
    from idunno_tpu_torch.ops.paged_attention import (_paged_plain,
                                                      paged_attention_kernel)
    dims = dict(b=4, t=1, kvh=4, g=2, d=64, n=40, bs=16, c=9)
    q5, kp, vp, tables, lengths, ks, vs = _paged_inputs(
        cuda_device, page_dtype=page_dtype, seed=5, nblocks=[9, 0, 5, 2],
        **dims)
    args = (q5, kp, vp, tables, lengths)
    kw = dict(k_scale_pages=ks, v_scale_pages=vs)
    first, again = (paged_attention_kernel(*args, **kw) for _ in range(2))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    bad = tables.clone()
    bad[2, 3] = dims["n"]
    out, lse = paged_attention_kernel(q5, kp, vp, bad, lengths, **kw)
    torch.cuda.synchronize()
    assert bool(out[2].isnan().all()) and bool(lse[2].isnan().all())
    keep = torch.tensor([0, 1, 3], device=cuda_device)
    ref, ref_lse = _paged_plain(*args, scale=1.0 / dims["d"] ** 0.5, **kw)
    torch.testing.assert_close(out[keep], ref[keep], rtol=1e-5,
                               atol=1e-5 * float(ref.abs().max()))
    torch.testing.assert_close(lse[keep], ref_lse[keep], rtol=1e-5,
                               atol=1e-5)
    assert bool((out[1] == 0).all()) and bool((lse[1] == -1e30).all())
    # pages are read in 16-byte vectors: a store starting one element in
    # is refused before any launch
    flat = torch.zeros(kp.numel() + 1, dtype=kp.dtype, device=cuda_device)
    shifted = flat[1:].view(kp.shape)
    before = paged_attention_kernel.launches
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention_kernel(q5, shifted, shifted, tables, lengths, **kw)
    assert paged_attention_kernel.launches == before


# -- K4, K5: flash attention backward ----------------------------------------

def _bwd_inputs(device, shape, dtype, causal, seed):
    """q, k, v, dO from a seed, and the forward's out and lse from the
    plain version (both kernels and the plain backward read the same)."""
    from idunno_tpu_torch.ops.flash_attention import flash_attention_plain
    rng = np.random.default_rng(seed)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                   .to(device, dtype) for _ in range(4))
    out, lse = flash_attention_plain(q, k, v, causal=causal)
    return q, k, v, do, out, lse


def _assert_grad_close(got, want):
    """f32: 1e-5 of the reference's largest magnitude (the kernel and the
    plain version differ only in f32 summation order)."""
    torch.testing.assert_close(got, want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))


# the training shape of the full-width LM (bf16 [8, 1024, 16, 64]), f32
# causal and non-causal, a ragged T whose last tile is partly past T, and
# the tensor-core K5's second head_dim
@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal", [
    ((8, 1024, 16, 64), torch.bfloat16, True),
    ((2, 256, 4, 64), torch.float32, True),
    ((2, 256, 4, 32), torch.float32, False),
    ((2, 1000, 3, 32), torch.float32, True),
    ((2, 1000, 3, 64), torch.bfloat16, False),
    ((2, 256, 4, 32), torch.bfloat16, True)])
def test_flash_bwd_kernels_match_plain_version(cuda_device, shape, dtype,
                                               causal):
    from idunno_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_bwd_dkv_kernel,
        flash_attention_bwd_dq_kernel, flash_attention_bwd_plain)
    q, k, v, do, out, lse = _bwd_inputs(cuda_device, shape, dtype, causal,
                                        sum(shape) + causal)
    delta = attention_delta(out, do)
    n4 = flash_attention_bwd_dq_kernel.launches
    n5 = flash_attention_bwd_dkv_kernel.launches
    dq = flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, causal=causal)
    dk, dv = flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta,
                                            causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd_dq_kernel.launches == n4 + 1
    assert flash_attention_bwd_dkv_kernel.launches == n5 + 1
    ref = flash_attention_bwd_plain(q, k, v, out, do, lse, causal=causal)
    for got in (dq, dk, dv):
        assert got.dtype == dtype and got.shape == shape
    for name, got, want in zip(("dq", "dk", "dv"), (dq, dk, dv), ref):
        if dtype == torch.bfloat16:
            # K4 and K5 on the tensor cores round dS (and K5 P^T) to bf16
            # before their products: within the bound of that rounding
            _assert_within_bound(name, got, want, q, k, v, causal, do=do,
                                 lse=lse, delta=delta)
        else:
            _assert_grad_close(got, want)


# K4 on the tensor cores: the training shape, a ragged T whose last tile
# is partly past T at head_dim 32, and a single whole tile, not causal
@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", [
    ((8, 1024, 16, 64), True), ((2, 100, 4, 32), False),
    ((2, 64, 4, 64), False)])
def test_bf16_dq_kernel_within_bound_and_repeats(cuda_device, shape, causal):
    """bf16 dQ within ``tensor_core_bound("dq")`` of the plain dQ, and two
    launches bit-identical (no atomics: each element summed by one thread
    in a fixed order)."""
    from idunno_tpu_torch.ops.flash_attention import (
        _dq_plain, attention_delta, flash_attention_bwd_dq_kernel)
    q, k, v, do, out, lse = _bwd_inputs(cuda_device, shape, torch.bfloat16,
                                        causal, sum(shape) + 3)
    delta = attention_delta(out, do)
    dq, again = (flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta,
                                               causal=causal)
                 for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(dq.view(torch.int16), again.view(torch.int16))
    ref = _dq_plain(q, k, v, do, lse, delta, causal=causal)
    _assert_within_bound("dq", dq, ref, q, k, v, causal, do=do, lse=lse,
                         delta=delta)


@pytest.mark.gpu
def test_bf16_flash_kernels_refuse_misaligned_rows(cuda_device):
    """The tensor-core kernels copy 16-byte rows: a bf16 view whose rows
    start 2 bytes in and whose strides are 65 elements is refused by the
    K2, K4 and K5 wrappers, before any launch."""
    from idunno_tpu_torch.ops.flash_attention import (
        attention_delta, flash_attention_bwd_dkv_kernel,
        flash_attention_bwd_dq_kernel, flash_attention_kernel)
    rng = np.random.default_rng(11)
    wide = [torch.from_numpy(rng.standard_normal((2, 64, 2, 65),
                                                 dtype=np.float32))
            .to(cuda_device, torch.bfloat16) for _ in range(4)]
    q, k, v, do = (x[..., 1:] for x in wide)
    before = (flash_attention_kernel.launches,
              flash_attention_bwd_dkv_kernel.launches,
              flash_attention_bwd_dq_kernel.launches)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_kernel(q, k, v, causal=True)
    out, lse = flash_attention_kernel(*(x.contiguous() for x in (q, k, v)),
                                      causal=True)
    delta = attention_delta(out, do)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_dkv_kernel(q, k, v, do, lse, delta, causal=True)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd_dq_kernel(q, k, v, do, lse, delta, causal=True)
    assert (flash_attention_kernel.launches,
            flash_attention_bwd_dkv_kernel.launches,
            flash_attention_bwd_dq_kernel.launches) == (before[0] + 1,
                                                        before[1], before[2])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_autograd_on_card_matches_plain_backward(cuda_device, causal):
    """The autograd Function on the card (K2 forward, K4 and K5 backward)
    against the plain backward on the same forward outputs."""
    from idunno_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd_dkv_kernel,
        flash_attention_bwd_dq_kernel, flash_attention_bwd_plain,
        flash_attention_kernel)
    shape = (2, 300, 4, 64)
    rng = np.random.default_rng(7 + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
                   .to(cuda_device) for _ in range(4))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    n = (flash_attention_kernel.launches, flash_attention_bwd_dq_kernel.launches,
         flash_attention_bwd_dkv_kernel.launches)
    out = flash_attention(*leaves, causal=causal)
    out.backward(do)
    torch.cuda.synchronize()
    assert (flash_attention_kernel.launches, flash_attention_bwd_dq_kernel.launches,
            flash_attention_bwd_dkv_kernel.launches) == tuple(x + 1 for x in n)
    with torch.no_grad():
        _, lse = flash_attention_kernel(q, k, v, causal=causal)
    ref = flash_attention_bwd_plain(q, k, v, out.detach(), do, lse,
                                    causal=causal)
    for leaf, want in zip(leaves, ref):
        _assert_grad_close(leaf.grad, want)


# -- the decode dispatch replayed as one CUDA graph ---------------------------

def _small_lm(device, *, dim, heads, seed):
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.transformer import TransformerLM
    with torch.device(device):
        model = TransformerLM(vocab=257, dim=dim, depth=2, num_heads=heads)
    init_like_flax(model, torch.Generator(device=device).manual_seed(seed))
    return model.eval().requires_grad_(False)


# dense weights on a contiguous pool, int8 weights, the paged radix pool
# (K3), and a speculative paged pool (K3 at the verify shape); head_dim 32
@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dense", "int8", "paged", "speculative"])
def test_replayed_pool_matches_eager_pool(cuda_device, kind):
    """A ``decode_graph="graph"`` pool gives the greedy streams of an
    ``"eager"`` one, replays its dispatches after the first, and its K3
    count grows by the launches the capture recorded for each replay."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _small_lm(cuda_device, dim=128, heads=4, seed=3)
    rng = np.random.default_rng(4)
    head = [int(t) for t in rng.integers(1, 257, 12)]
    prompts = [head + [int(t) for t in rng.integers(1, 257, 4)]
               for _ in range(6)]
    kw = dict(slots=4, prompt_len=16, max_len=64, decode_steps=4,
              device="cuda")
    if kind != "dense":
        kw.update(kv_block_size=4, paged_kernel="kernel",
                  prompt_buckets=(4, 8, 16))
    if kind == "int8":
        kw["quantize"] = "int8"
    if kind == "speculative":
        kw.update(draft=(_small_lm(cuda_device, dim=64, heads=2, seed=5),
                         None), draft_len=4, decode_steps=2)
    streams, launches = {}, {}
    for mode in ("graph", "eager"):
        srv = DecodeServer(model, decode_graph=mode, **kw)
        torch.cuda.synchronize()
        before = paged_attention_kernel.launches
        ids = [srv.submit(p, max_new=20) for p in prompts]
        done = {c.id: c.tokens for c in srv.run_until_drained()}
        streams[mode] = [done[i] for i in ids]
        launches[mode] = paged_attention_kernel.launches - before
        g = srv.graph_stats()
        assert g["mode"] == mode
        if mode == "graph":
            assert g["replayed"] > 0 and g["eager"] == 1
            assert g["graph_pool_bytes"] > 0
        else:
            assert g["replayed"] == 0
    assert streams["graph"] == streams["eager"]
    if kind == "dense":
        assert launches["graph"] == launches["eager"] == 0
    else:
        assert launches["graph"] == launches["eager"] > 0


@pytest.mark.gpu
def test_replay_runs_the_k3_launches_it_counts(cuda_device):
    """One replayed paged dispatch runs on the card, under the profiler,
    as many K3 kernels as its capture recorded, which is what the server
    adds to K3's launch count for it."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.utils.tracing import trace
    model = _small_lm(cuda_device, dim=128, heads=4, seed=3)
    rng = np.random.default_rng(6)
    srv = DecodeServer(model, decode_graph="graph", slots=4, prompt_len=16,
                       max_len=64, decode_steps=4, kv_block_size=4,
                       paged_kernel="kernel", prompt_buckets=(4, 8, 16),
                       device="cuda")
    for _ in range(4):
        srv.submit([int(t) for t in rng.integers(1, 257, 16)], max_new=40)
    srv.step()                 # admissions, the eager dispatch, the capture
    srv.step()                 # the first replay
    torch.cuda.synchronize()
    before = paged_attention_kernel.launches
    replayed = srv.graph_stats()["replayed"]
    with trace(None) as prof:
        srv.step()
        torch.cuda.synchronize()
    g = srv.graph_stats()
    assert g["replayed"] == replayed + 1
    traced = sum(e.count for e in prof.key_averages()
                 if "paged_fwd" in e.key)
    recorded = g["launches_per_replay"]["paged_attention_kernel"]
    assert traced == paged_attention_kernel.launches - before == recorded > 0


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
def test_int8_dequantize_on_card_is_bit_equal(cuda_device, dtype):
    """The one-kernel int8 dequantize rounds ``q * scale`` computed in f32,
    bit for bit as the f32 product cast to the weight's dtype."""
    from idunno_tpu_torch.ops.quantize import quantize_leaf
    g = torch.Generator(device=cuda_device).manual_seed(0)
    w = torch.randn((384, 4, 64), generator=g, device=cuda_device)
    qt = quantize_leaf(w.to(dtype))
    want = (qt.q.view(qt.view).float() * qt.scale).to(dtype)
    assert torch.equal(qt.dequantize(dtype).view(torch.uint8),
                       want.view(torch.uint8))


@pytest.mark.gpu
def test_failed_capture_raises(cuda_device):
    """A dispatch that syncs the host cannot be recorded: the capture
    raises instead of running the dispatch eagerly."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    model = _small_lm(cuda_device, dim=64, heads=2, seed=1)
    srv = DecodeServer(model, slots=2, prompt_len=8, max_len=32,
                       device="cuda")
    dispatch = srv._dispatch

    def syncing(sampled):
        dispatch(sampled)
        return float(srv._cursors.sum())          # a host read

    srv._dispatch = syncing
    srv.submit([1, 2, 3], max_new=8)
    with pytest.raises(RuntimeError):
        srv.run_until_drained()
    assert srv.graph_stats()["replayed"] == 0


@pytest.mark.gpu
def test_sampling_on_the_card_after_a_failed_capture(cuda_device):
    """A failed capture leaves the process able to draw on the card
    (``engine/serve_lm.py:_abandon_capture``): the same pool then serves a
    sampled request eagerly, its stream equal to an eager pool's from the
    same seed, and ``torch.randn`` on the card draws; the current stream
    is the one the capture started from."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    model = _small_lm(cuda_device, dim=64, heads=2, seed=1)
    kw = dict(slots=2, prompt_len=8, max_len=48, device="cuda")
    srv = DecodeServer(model, decode_graph="graph", **kw)
    dispatch = srv._dispatch

    def syncing(sampled):
        dispatch(sampled)
        return float(srv._cursors.sum())          # a host read

    srv._dispatch = syncing
    stream = torch.cuda.current_stream()
    srv.submit([1, 2, 3], max_new=8)
    with pytest.raises(RuntimeError):
        srv.run_until_drained()
    assert torch.cuda.current_stream() == stream
    rid = srv.submit([4, 5, 6, 7], max_new=24, temperature=0.9, seed=11)
    got = {c.id: c.tokens for c in srv.run_until_drained()}[rid]
    ref = DecodeServer(model, decode_graph="eager", **kw)
    ref_id = ref.submit([4, 5, 6, 7], max_new=24, temperature=0.9, seed=11)
    want = {c.id: c.tokens for c in ref.run_until_drained()}[ref_id]
    assert got == want and len(got) == 4 + 24
    draw = torch.randn(4096, device=cuda_device)
    assert bool(torch.isfinite(draw).all()) and float(draw.std()) > 0.5


@pytest.mark.gpu
def test_device_timed_waits_for_the_card(cuda_device):
    """``device_timed`` covers the card's work on its result, not the
    enqueue: a chain of matmuls timed by it takes at least the CUDA-event
    time of the same chain (and a step returning no tensor waits too)."""
    from idunno_tpu_torch.utils.tracing import device_timed

    # drawn on the CPU: a failed capture earlier in the process
    # (test_failed_capture_raises) leaves the card's generators unusable
    x = torch.randn(4096, 4096,
                    generator=torch.Generator().manual_seed(0)).to(cuda_device)

    def chain(a):
        for _ in range(20):
            a = a @ x / 64.0
        return {"out": [a]}

    timed = device_timed(chain)
    _, first = timed(x)
    assert not first.compiled
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    chain(x)
    end.record()
    torch.cuda.synchronize()
    event_s = start.elapsed_time(end) / 1e3
    _, warm = timed(x)
    assert warm.compiled and warm.seconds >= 0.9 * event_s > 0
    _, none = device_timed(lambda: chain(x) and None)()
    assert none.seconds >= 0.9 * event_s


@pytest.mark.gpu
def test_trace_holds_k3_kernels_of_another_thread(cuda_device, tmp_path):
    """A ``trace`` started on one thread records the K3 kernels a paged
    pool launches from another (CUPTI is process-wide) into its Chrome
    trace. The pool runs eagerly: a failed capture earlier in the process
    (test_failed_capture_raises) leaves the card's generators in capture
    state; the replayed kernels in a trace are the other tests' and
    ``chip_smoke.py``'s."""
    import gzip
    import json
    import threading

    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.transformer import TransformerLM
    from idunno_tpu_torch.utils.tracing import trace
    # seeded on the CPU, as in test_device_timed_waits_for_the_card
    model = TransformerLM(vocab=257, dim=128, depth=2, num_heads=4)
    init_like_flax(model, torch.Generator().manual_seed(4))
    model = model.to(cuda_device).eval().requires_grad_(False)
    srv = DecodeServer(model, slots=4, prompt_len=16, max_len=64,
                       decode_steps=4, kv_block_size=4, paged_kernel="kernel",
                       decode_graph="eager", device="cuda")
    rng = np.random.default_rng(8)
    for _ in range(4):
        srv.submit([int(t) for t in rng.integers(1, 257, 16)], max_new=40)
    started, done = threading.Event(), threading.Event()

    def serve():
        started.wait(30)
        srv.run_until_drained()
        torch.cuda.synchronize()
        done.set()

    th = threading.Thread(target=serve)
    th.start()
    with trace(str(tmp_path)):
        started.set()
        assert done.wait(120)
    th.join(30)
    assert not th.is_alive()
    (path,) = list(tmp_path.glob("*.pt.trace.json.gz"))
    with gzip.open(path, "rt") as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" and "paged_fwd" in e.get("name", "")
               for e in events)


@pytest.mark.gpu
@pytest.mark.parametrize("pool", ["contiguous", "gathered"])
def test_routed_replayed_pool_matches_eager_pool(cuda_device, pool):
    """A routed LM (``models/moe.py``, every block routed, f32) replays its
    all-greedy dispatches as CUDA graphs: the routing reads nothing back
    to the host, and the streams equal an eager pool's."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.moe import MoETransformerLM
    with torch.device(cuda_device):
        model = MoETransformerLM(vocab=257, dim=64, depth=2, num_heads=2,
                                 n_experts=4)
    init_like_flax(model, torch.Generator(device=cuda_device).manual_seed(3))
    model.eval().requires_grad_(False)
    kw = dict(slots=4, prompt_len=16, max_len=64, decode_steps=4,
              device="cuda")
    if pool == "gathered":
        kw.update(kv_block_size=4, prompt_buckets=(4, 8, 16))
    rng = np.random.default_rng(5)
    head = [int(t) for t in rng.integers(1, 257, 12)]
    prompts = [head + [int(t) for t in rng.integers(1, 257, 4)]
               for _ in range(8)]
    streams, graphs = {}, {}
    for mode in ("graph", "eager"):
        srv = DecodeServer(model, decode_graph=mode, **kw)
        ids = [srv.submit(p, max_new=24) for p in prompts]
        done = {c.id: c.tokens for c in srv.run_until_drained()}
        streams[mode] = [done[i] for i in ids]
        graphs[mode] = srv.graph_stats()
    assert graphs["graph"]["replayed"] > 0
    assert streams["graph"] == streams["eager"]


# tensor-parallel decode: one model shard's page store holds 16 / n_model
# of the 16 KV heads (engine/kv_blocks.py under a mesh), and K3 runs once
# per shard on it
@pytest.mark.gpu
@pytest.mark.parametrize("n_model", [2, 4])
@pytest.mark.parametrize("page_dtype", [torch.bfloat16, torch.int8])
def test_paged_kernel_on_a_head_sharded_store(cuda_device, n_model,
                                              page_dtype):
    """K3 on each shard's own contiguous cut of the KV heads matches its
    plain version there, and the shards' outputs side by side are the
    plain version over all 16 heads."""
    from idunno_tpu_torch.ops.paged_attention import (_paged_plain,
                                                      paged_attention_kernel)
    dims = dict(b=16, t=1, kvh=16, g=1, d=64, n=68, bs=16, c=3)
    q5, kp, vp, tables, lengths, ks, vs = _paged_inputs(
        cuda_device, page_dtype=page_dtype, seed=7, **dims)
    whole, whole_lse = _paged_plain(q5, kp, vp, tables, lengths,
                                    k_scale_pages=ks, v_scale_pages=vs,
                                    scale=1.0 / 8.0)
    per = 16 // n_model
    outs, lses = [], []
    for m in range(n_model):
        heads = slice(m * per, (m + 1) * per)

        def cut(x, heads=heads):
            return None if x is None else x[:, :, heads].contiguous()

        q = q5[:, :, heads].contiguous()
        before = paged_attention_kernel.launches
        out, lse = paged_attention_kernel(q, cut(kp), cut(vp), tables,
                                          lengths, k_scale_pages=cut(ks),
                                          v_scale_pages=cut(vs))
        torch.cuda.synchronize()
        assert paged_attention_kernel.launches == before + 1
        ref, ref_lse = _paged_plain(q, cut(kp), cut(vp), tables, lengths,
                                    k_scale_pages=cut(ks),
                                    v_scale_pages=cut(vs), scale=1.0 / 8.0)
        torch.testing.assert_close(out, ref, rtol=1e-5,
                                   atol=1e-5 * float(ref.abs().max()))
        torch.testing.assert_close(lse, ref_lse, rtol=1e-5, atol=1e-5)
        outs.append(out)
        lses.append(lse)
    torch.testing.assert_close(torch.cat(outs, dim=2), whole, rtol=1e-5,
                               atol=1e-5 * float(whole.abs().max()))
    torch.testing.assert_close(torch.cat(lses, dim=2),
                               whole_lse, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_pool_on_the_card_matches_n_model_one(cuda_device, n_model):
    """A tensor-parallel paged pool on a virtual mesh of the card (K3 per
    shard, replayed) serves the n_model 1 pool's greedy streams, f32,
    with n_model times its K3 launches."""
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.parallel.mesh import virtual_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _small_lm(cuda_device, dim=256, heads=4, seed=3)
    rng = np.random.default_rng(4)
    head = [int(t) for t in rng.integers(1, 257, 12)]
    prompts = [head + [int(t) for t in rng.integers(1, 257, 4)]
               for _ in range(6)]
    kw = dict(slots=4, prompt_len=16, max_len=64, decode_steps=4,
              kv_block_size=4, paged_kernel="kernel",
              prompt_buckets=(4, 8, 16), device="cuda")
    streams, launches = {}, {}
    for n in (1, n_model):
        mesh = None if n == 1 else virtual_mesh(1, n, "cuda:0")
        srv = DecodeServer(model, mesh=mesh, **kw)
        torch.cuda.synchronize()
        before = paged_attention_kernel.launches
        ids = [srv.submit(p, max_new=20) for p in prompts]
        done = {c.id: c.tokens for c in srv.run_until_drained()}
        streams[n] = [done[i] for i in ids]
        launches[n] = paged_attention_kernel.launches - before
        assert srv.graph_stats()["replayed"] > 0
    assert streams[n_model] == streams[1]
    assert launches[n_model] == n_model * launches[1] > 0


# -- data parallelism: K1 per data group ---------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("n_data", [2, 4])
def test_preprocess_kernel_per_group_of_a_virtual_mesh(cuda_device, n_data,
                                                       monkeypatch):
    """The engine over a virtual mesh of the card: each data group's slice
    of a batch goes through K1 on ``cuda:0`` (one launch a group), bit for
    bit the plain version of that slice, and the groups' top-1 equal the
    one-group engine's (f32 compute, TF32 off)."""
    from idunno_tpu_torch.parallel.mesh import virtual_mesh

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = dict(batch_size=16, image_size=224, resize_size=256,
               compute_dtype="float32", preprocess="kernel")
    mesh = virtual_mesh(n_data, 1, "cuda:0")
    eng = InferenceEngine(EngineConfig(**cfg), mesh=mesh)
    one = InferenceEngine(EngineConfig(**cfg))
    eng.load("resnet")
    one.load("resnet", state_dict=eng._models["resnet"].state_dict())
    _, images = data_lib.load_range(None, 0, 15)
    parts = eng._to_groups(images)
    assert len(parts) == n_data
    for part in parts:
        assert part.device == torch.device("cuda", 0)
        out = preprocess_batch_kernel(part, 224)
        ref = preprocess_batch_plain(part, 224)
        assert torch.equal(out.view(torch.int16), ref.view(torch.int16))
    before = preprocess_batch_kernel.launches
    idx, prob = eng.infer_batch("resnet", images)
    assert preprocess_batch_kernel.launches == before + n_data
    want_idx, want_prob = one.infer_batch("resnet", images)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_allclose(prob, want_prob, rtol=0, atol=1e-5)


# -- sequence parallelism: the ring's K2, K4 and K5 ---------------------------

def _ring_counts():
    from idunno_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv_kernel, flash_attention_bwd_dq_kernel,
        flash_attention_kernel)
    return (flash_attention_kernel.launches,
            flash_attention_bwd_dq_kernel.launches,
            flash_attention_bwd_dkv_kernel.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,causal", [((2, 1024, 4, 64), True),
                                          ((2, 512, 4, 32), False)])
def test_f32_ring_on_card_matches_plain_ring(cuda_device, shape, causal):
    """A 4-group ring of a virtual mesh of the card in f32 (K2 per live
    pair forward, K4 and K5 per live pair backward: p(p+1)/2 each causal,
    p² otherwise) against the same ring on the CPU, where every call is
    the plain version: output and q/k/v gradients within 1e-5 of the
    reference's largest magnitude."""
    from idunno_tpu_torch.parallel.mesh import virtual_mesh
    from idunno_tpu_torch.parallel.ring_attention import (ring_attention,
                                                          ring_pairs)
    rng = np.random.default_rng(sum(shape) + causal)
    host = [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32))
            for _ in range(4)]
    results = {}
    for dev in ("cpu", cuda_device):
        q, k, v = (x.to(dev, copy=True).requires_grad_() for x in host[:3])
        before = _ring_counts()
        out = ring_attention(q, k, v, virtual_mesh(4, 1, dev), causal=causal)
        out.backward(host[3].to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            pairs = len(list(ring_pairs(4, causal)))
            assert _ring_counts() == tuple(n + pairs for n in before)
        results[str(dev)] = [x.detach().cpu() for x in
                             (out, q.grad, k.grad, v.grad)]
    for got, want in zip(results[str(cuda_device)], results["cpu"]):
        _assert_grad_close(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_ring_pairs_on_card_within_bound(cuda_device, causal):
    """The bf16 ring of the sequence-parallel phase (4 groups, [2, 1024,
    16, 64]): its output within ``tensor_core_bound("out")`` of the f32
    attention over the whole sequence plus one bf16 ulp of max|v| (each
    pair's partial is rounded to bf16 before the f32 merge, and a partial
    is a convex combination of rows of v); every live pair's K4 and K5
    from the ring's merged lse and delta within their bounds of the plain
    dQ, dK and dV of that pair."""
    from idunno_tpu_torch.ops.flash_attention import (
        _dkv_plain, _dq_plain, attention_delta, bf16_ulp,
        flash_attention_bwd_dkv_kernel, flash_attention_bwd_dq_kernel,
        flash_attention_plain)
    from idunno_tpu_torch.parallel import ring_attention as ring_lib
    from idunno_tpu_torch.parallel.mesh import virtual_mesh
    shape, p = (2, 1024, 16, 64), 4
    rng = np.random.default_rng(31 + causal)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape,
                                                        dtype=np.float32))
                   .to(cuda_device, torch.bfloat16) for _ in range(4))
    out = ring_lib.ring_attention(q, k, v, virtual_mesh(p, 1, cuda_device),
                                  causal=causal)
    ref, _ = flash_attention_plain(q.float(), k.float(), v.float(),
                                   causal=causal)
    from idunno_tpu_torch.ops.flash_attention import tensor_core_bound
    bound = (tensor_core_bound("out", out, ref, q, k, v, causal=causal)
             + float(bf16_ulp(v.float().abs().max())))
    assert float(((out.float() - ref).abs().double() / bound).max()) <= 1.0
    cells = virtual_mesh(p, 1, cuda_device).along("data")
    qs, ks, vs, dos = (ring_lib._blocks(x, cells) for x in (q, k, v, do))
    outs, lses = ring_lib._ring_forward(qs, ks, vs, cells, causal)
    deltas = [attention_delta(o, g) for o, g in zip(outs, dos)]
    for _, my, src, diag in ring_lib.ring_pairs(p, causal):
        args = (qs[my], ks[src], vs[src], dos[my], lses[my], deltas[my])
        dq = flash_attention_bwd_dq_kernel(*args, causal=diag)
        dk, dv = flash_attention_bwd_dkv_kernel(*args, causal=diag)
        want_dq = _dq_plain(*args, causal=diag)
        want_dk, want_dv = _dkv_plain(*args, causal=diag)
        for name, got, want in (("dq", dq, want_dq), ("dk", dk, want_dk),
                                ("dv", dv, want_dv)):
            _assert_within_bound(name, got, want, qs[my], ks[src], vs[src],
                                 diag, do=dos[my], lse=lses[my],
                                 delta=deltas[my])


# -- speculative pools under TP: K3 per shard in the verify chunk ---------------

@pytest.mark.gpu
@pytest.mark.parametrize("n_model", [2, 4])
def test_tp_speculative_verify_runs_k3_per_shard(cuda_device, n_model):
    """A speculative paged pool on a virtual mesh of the card, its draft
    sharded beside the target (f32, TF32 off, eager so every round is
    logged, ``chip_smoke.py:record_rounds``): the n_model 1 pool's
    greedy streams, proposals and accepted counts, and n_model times its
    K3 launches (every verify chunk and suffix prefill runs K3 once a
    layer and model shard)."""
    from chip_smoke import record_rounds
    from idunno_tpu_torch.engine.serve_lm import DecodeServer
    from idunno_tpu_torch.models.transformer import ShardedLM
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.parallel.mesh import virtual_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    model = _small_lm(cuda_device, dim=256, heads=4, seed=3)
    draft = _small_lm(cuda_device, dim=64, heads=4, seed=5)
    rng = np.random.default_rng(6)
    head = [int(t) for t in rng.integers(1, 257, 12)]
    prompts = [head + [int(t) for t in rng.integers(1, 257, 4)]
               for _ in range(6)]
    kw = dict(slots=4, prompt_len=16, max_len=64, decode_steps=2,
              kv_block_size=4, paged_kernel="kernel", decode_graph="eager",
              prompt_buckets=(4, 8, 16), draft=(draft, None), draft_len=3,
              device="cuda")
    streams, launches, logs = {}, {}, {}
    for n in (1, n_model):
        mesh = None if n == 1 else virtual_mesh(1, n, "cuda:0")
        srv = DecodeServer(model, mesh=mesh, **kw)
        assert n == 1 or isinstance(srv._draft_dec, ShardedLM)
        logs[n] = []
        torch.cuda.synchronize()
        before = paged_attention_kernel.launches
        with record_rounds(srv, logs[n]):
            ids = [srv.submit(p, max_new=16) for p in prompts]
            done = {c.id: c.tokens for c in srv.run_until_drained()}
        streams[n] = [done[i] for i in ids]
        launches[n] = paged_attention_kernel.launches - before
    assert streams[n_model] == streams[1]
    assert launches[n_model] == n_model * launches[1] > 0
    assert len(logs[n_model]) == len(logs[1])
    for (pa, aa, act), (pb, ab, bct) in zip(logs[n_model], logs[1]):
        assert torch.equal(act, bct)
        assert torch.equal(pa[act], pb[act]) and torch.equal(aa[act], ab[act])


# -- expert parallelism: K2/K4/K5 in an EP train step ----------------------------

def _routed_lm(device, mesh, seed):
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.moe import MoETransformerLM
    from idunno_tpu_torch.models.transformer import make_attn_fn
    with torch.device(device):
        model = MoETransformerLM(vocab=256, dim=256, depth=2, num_heads=4,
                                 n_experts=4, capacity_factor=4.0,
                                 attn_fn=make_attn_fn("flash"), mesh=mesh,
                                 compute_dtype=torch.bfloat16)
    init_like_flax(model, torch.Generator(device=device).manual_seed(seed))
    return model


@pytest.mark.gpu
@pytest.mark.parametrize("p", [2, 4])
def test_expert_parallel_train_step_runs_k2_k4_k5(cuda_device, p):
    """An expert-parallel routed LM (experts over a virtual expert mesh of
    the card, no-drop capacity, bf16 compute over f32 parameters) takes
    one fused-AdamW step through the flash kernels: K2 once a block
    forward, K4 and K5 once a block backward; its loss equals the dense
    model's on the same seeded weights within 1e-3, and the experts'
    gradients are finite and nonzero."""
    from idunno_tpu_torch.engine.train import TrainState, adamw, flat_tx
    from idunno_tpu_torch.engine.train_lm import make_lm_train_step
    from idunno_tpu_torch.ops.flash_attention import (
        flash_attention_bwd_dkv_kernel, flash_attention_bwd_dq_kernel,
        flash_attention_kernel)
    from idunno_tpu_torch.parallel.mesh import EXPERT_AXIS, virtual_mesh
    kernels = (flash_attention_kernel, flash_attention_bwd_dq_kernel,
               flash_attention_bwd_dkv_kernel)
    tokens = torch.from_numpy(np.random.default_rng(p).integers(
        0, 256, (2, 256))).to(cuda_device)
    losses = {}
    for name, mesh in (("dense", None),
                       ("ep", virtual_mesh(1, p, "cuda:0",
                                           axis=EXPERT_AXIS))):
        model = _routed_lm(cuda_device, mesh, seed=11)
        state = TrainState(0, model, flat_tx(adamw(1e-3))(model.parameters()))
        torch.cuda.synchronize()
        before = [k.launches for k in kernels]
        metrics = make_lm_train_step(model, state.optimizer)(state, tokens)
        torch.cuda.synchronize()
        assert [k.launches - b for k, b in zip(kernels, before)] == [2, 2, 2]
        losses[name] = float(metrics["loss"])
        if mesh is not None:
            g = model.blocks[1].ffn.shards[p - 1].w1.grad
            assert bool(torch.isfinite(g).all()) and float(g.abs().sum()) > 0
    assert abs(losses["ep"] - losses["dense"]) <= 1e-3 * abs(losses["dense"])


@pytest.mark.gpu
def test_expert_shards_on_two_devices(cuda_device):
    """An expert mesh of two distinct devices, the CPU and the card: each
    shard's weights stay on its device when the model moves to the card,
    the move allocating on the card only for what goes there, the
    exchanges copy between them, and the forward equals the dense model's
    on the card (f32, TF32 off) within 1e-5 of the largest."""
    from idunno_tpu_torch.models.convert import expert_parallel_state_dict
    from idunno_tpu_torch.models.init import init_like_flax
    from idunno_tpu_torch.models.moe import ExpertShard, MoETransformerLM
    from idunno_tpu_torch.parallel.mesh import EXPERT_AXIS, make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    kw = dict(vocab=128, dim=64, depth=2, num_heads=4, n_experts=4,
              capacity_factor=4.0)
    dense = MoETransformerLM(**kw)
    init_like_flax(dense, torch.Generator().manual_seed(2))
    mesh = make_mesh(1, 2, devices=["cpu", "cuda:0"], axis=EXPERT_AXIS)
    ep = MoETransformerLM(**kw, mesh=mesh)
    ep.load_state_dict(expert_parallel_state_dict(dense.state_dict(), 2))
    dense.to(cuda_device)
    # the move allocates on the card for the tensors that go there and
    # nothing for the CPU shards: none passes through the card
    kept = {id(t) for m in ep.modules() if isinstance(m, ExpertShard)
            and m.placed.type == "cpu" for t in m.parameters()}
    moving = sum(1 for t in [*ep.parameters(), *ep.buffers()]
                 if t.device.type == "cpu" and id(t) not in kept)
    made = torch.cuda.memory_stats(cuda_device)["allocation.all.allocated"]
    ep.to(cuda_device)
    made = torch.cuda.memory_stats(cuda_device)[
        "allocation.all.allocated"] - made
    assert kept and made == moving
    shards = ep.blocks[1].ffn.shards
    assert shards[0].w1.device.type == "cpu"
    assert shards[1].w1.device.type == "cuda"
    assert ep.blocks[1].ffn.router.weight.device.type == "cuda"
    tokens = torch.randint(0, 128, (2, 32), device=cuda_device)
    with torch.no_grad():
        want, got = dense(tokens), ep(tokens)
    assert got.device.type == "cuda"
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# -- entry() and the sweep's K3 shapes (the tools' slice) ----------------------

@pytest.mark.gpu
def test_entry_launches_k1_once_a_call(cuda_device):
    """``entry()`` runs on the card by default: each forward launches K1
    exactly once, and its top-1 equals the plain preprocess route's
    (``ops/preprocess.py``, f32) on the same weights."""
    from idunno_tpu_torch.entry import entry
    from idunno_tpu_torch.ops.classify import top1_from_logits
    from idunno_tpu_torch.ops.preprocess import preprocess_batch

    forward, (model, images) = entry()
    assert images.device.type == "cuda" and images.shape == (8, 256, 256, 3)
    batch = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (8, 256, 256, 3), dtype=np.uint8)).to(cuda_device)
    for x in (images, batch):
        before = preprocess_batch_kernel.launches
        idx, _ = forward(model, x)
        torch.cuda.synchronize()
        assert preprocess_batch_kernel.launches == before + 1
    with torch.inference_mode():
        ref = model(preprocess_batch(batch, crop=224).permute(0, 3, 1, 2))
    assert idx.tolist() == top1_from_logits(ref)[0].tolist()


@pytest.mark.gpu
@pytest.mark.parametrize("label", [
    "paged_bf16_bs32_kv4096_q1", "paged_bf16_bs64_kv4096_q8",
    "paged_bf16_bs64_kv512_q1", "paged_int8_bs64_kv4096_q1",
    "paged_int8_bs32_kv512_q1"])
def test_paged_kernel_at_the_sweeps_long_chains(cuda_device, label):
    """K3 at block sizes 32 and 64 and 4,096-token chains (64-128 blocks
    a row, split over the CTA's warps) within chip_smoke.py's tolerance
    of its plain version."""
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.tools import flash_sweep

    v = next(v for v in flash_sweep.paged_variants()
             if v["variant"] == label)
    q5, kp, vp, ks, vs, tables, lengths = flash_sweep.paged_inputs(
        v, cuda_device, seed=11)
    scales = () if ks is None else (ks[0], vs[0])
    out, lse = paged_attention_kernel(
        q5, kp[0], vp[0], tables, lengths,
        **({} if ks is None else dict(k_scale_pages=ks[0],
                                      v_scale_pages=vs[0])))
    ref, ref_lse = flash_sweep.k3_plain(q5, kp[0], vp[0], tables, lengths,
                                        *scales)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) <= (
        flash_sweep.K3_TOL * float(ref.abs().max()))
    assert float(((lse - ref_lse).abs() / ref_lse.abs().clamp_min(1.0))
                 .max()) <= flash_sweep.K3_TOL


@pytest.mark.gpu
def test_trace_keeps_every_kernel_of_the_region(cuda_device, tmp_path):
    """A ``trace`` opens with its spin kernels (the profiler may lose the
    first kernels of a window), so the region's kernels are all in the
    Chrome trace; ``tools/parse_trace.py`` leaves the spin kernels out."""
    from idunno_tpu_torch.tools.parse_trace import apportion
    from idunno_tpu_torch.utils.tracing import WARMUP_KERNELS, trace

    x = torch.zeros(1024, device=cuda_device)
    for attempt in range(5):
        where = tmp_path / str(attempt)
        with trace(str(where)):
            for _ in range(300):
                x.mul_(1.0)
        rep = apportion(str(where))
        assert 0 < rep["warmup_kernels"] <= WARMUP_KERNELS
        assert sum(r["count"] for r in rep["ops"]) == 300


@pytest.mark.gpu
def test_cross_process_parallelism_on_the_card(cuda_device):
    """``dryrun.py:cross_process_check()`` on the card: two processes of
    two groups share it over gloo (NCCL refuses two ranks on one card);
    ring and Ulysses attention, the sequence-parallel step, the pipelined
    LM (and PP x DP) and the routed LM over an expert axis across the two
    hold the record's gates against the in-process axis of 4 (outputs
    equal where the arithmetic is the same, K2/K4/K5 launched once a live
    pair, group or stage block of each process), and every CUDA tensor
    that crossed went through the host (bytes staged)."""
    from idunno_tpu_torch.dryrun import cross_process_check

    recs = cross_process_check()
    for r in recs:
        assert r["ok"] and r["backend"] == "gloo", r["failed"]
        assert r["ring_attention"]["out_equal"]
        assert r["stage_step"]["transport"]["bytes_staged"] > 0
        assert r["sp_timed"]["launches"]["flash_attention"] == \
            r["sp_timed"]["kernel_calls_expected"]
