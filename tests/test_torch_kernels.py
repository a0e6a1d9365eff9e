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
# full-width model, a ragged f32 shape whose last tile is partly past T, and
# the tensor-core kernel's second head_dim and a ragged T in bf16
@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,causal", [
    ((4, 1024, 16, 64), torch.bfloat16, True),
    ((2, 1000, 3, 32), torch.float32, False),
    ((2, 1000, 3, 32), torch.float32, True),
    ((2, 256, 4, 32), torch.bfloat16, False),
    ((2, 1000, 3, 64), torch.bfloat16, True)])
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
# kernel's 4 warps), each with f32, bf16 and int8 pages
@pytest.mark.gpu
@pytest.mark.parametrize("dims", [
    dict(b=16, t=1, kvh=16, g=1, d=64, n=68, bs=16, c=3),
    dict(b=1, t=64, kvh=8, g=2, d=64, n=20, bs=16, c=3),
    dict(b=4, t=1, kvh=4, g=2, d=64, n=40, bs=16, c=9)])
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
