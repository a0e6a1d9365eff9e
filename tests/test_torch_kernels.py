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
