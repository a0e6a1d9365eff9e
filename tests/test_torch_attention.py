"""Parity of the port's attention ops with the JAX package, on the CPU.

The same numpy inputs (f32, from a seed) go through the JAX function and
its counterpart in ``idunno_tpu_torch``. On CPU tensors the port's kernel
wrappers run their plain versions, so these tests hold the plain versions
against the JAX package's Pallas kernels (interpret mode); the card-only
tests (``tests/test_torch_kernels.py``) hold the CUDA kernels against the
plain versions.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from idunno_tpu.ops import flash_attention as jax_flash
from idunno_tpu.ops import paged_attention as jax_paged
from idunno_tpu.parallel.ring_attention import full_attention as jax_full
from idunno_tpu_torch.models.transformer import auto_attention, make_attn_fn
from idunno_tpu_torch.ops.attention import full_attention
from idunno_tpu_torch.ops.flash_attention import (
    NEG_INF, check_tensor_core_alignment, flash_attention,
    flash_attention_kernel, flash_attention_plain, resolve_blocks,
    tensor_core_bound)
from idunno_tpu_torch.ops.paged_attention import (PagedContext,
                                                  merge_attention,
                                                  paged_attention,
                                                  paged_attention_grouped,
                                                  paged_attention_kernel,
                                                  resolve_paged_kernel)

TOL = 1e-5     # f32 on both sides; only the summation order differs


def qkv(seed, b=2, t=16, h=3, d=8):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, t, h, d)).astype(np.float32)
                 for _ in range(3))


def jax_flash_with_lse(q, k, v, causal, block=8):
    """The JAX package's flash forward through `_flash_core` (interpret
    mode), padded and laid out as `flash_attention` does; returns
    (out [B, T, H, D], lse [B, H, T])."""
    b, t, h, d = q.shape
    bq, bk, t_pad = jax_flash.resolve_blocks(t, block, block)

    def bh(x):
        x = np.pad(x, ((0, 0), (0, t_pad - t), (0, 0), (0, 0)))
        return jnp.asarray(x.transpose(0, 2, 1, 3).reshape(b * h, t_pad, d))

    out, lse = jax_flash._flash_core(bh(q), bh(k), bh(v), causal, bq, bk, t,
                                     True)
    out = np.asarray(out).reshape(b, h, t_pad, d).transpose(0, 2, 1, 3)[:, :t]
    return out, np.asarray(lse).reshape(b, h, t_pad)[:, :, :t]


def assert_close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    scale = max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("causal", [True, False])
def test_full_attention_matches_jax(causal):
    q, k, v = qkv(0)
    want = np.asarray(jax_full(*map(jnp.asarray, (q, k, v)), causal=causal))
    got = full_attention(*map(torch.from_numpy, (q, k, v)), causal=causal)
    assert_close(got, want)


@pytest.mark.parametrize("t", [16, 37])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_jax_kernel(t, causal):
    """out and lse of the port's plain flash against the Pallas kernel in
    interpret mode, with 8 x 8 blocks so T = 37 is padded and masked;
    tolerance 1e-5 of the largest |value|."""
    q, k, v = qkv(t + causal, t=t)
    want_out, want_lse = jax_flash_with_lse(q, k, v, causal)
    out, lse = flash_attention_plain(*map(torch.from_numpy, (q, k, v)),
                                     causal=causal)
    assert out.shape == q.shape and lse.shape == (2, 3, t)
    assert_close(out, want_out)
    assert_close(lse, want_lse)
    # the public entry point on a CPU tensor is the plain version
    assert_close(flash_attention(*map(torch.from_numpy, (q, k, v)),
                                 causal=causal), want_out)


def test_flash_kernel_wrapper_runs_plain_on_cpu():
    q, k, v = map(torch.from_numpy, qkv(3, t=9))
    before = flash_attention_kernel.launches
    out, lse = flash_attention_kernel(q, k, v, causal=True)
    ref, ref_lse = flash_attention_plain(q, k, v, causal=True)
    assert flash_attention_kernel.launches == before   # no launch on CPU
    assert torch.equal(out, ref) and torch.equal(lse, ref_lse)


def test_flash_bf16_keeps_dtype_and_f32_lse():
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in qkv(4))
    out, lse = flash_attention_plain(q, k, v, causal=True)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32


def test_flash_returns_gradients():
    """flash_attention is differentiable (the plain backward on the CPU),
    and under no_grad it returns the forward kernel's output unchanged."""
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in qkv(5))
    out = flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.square().sum().backward()
    assert all(x.grad is not None and x.grad.shape == x.shape
               and bool(torch.isfinite(x.grad).all()) and x.grad.abs().sum() > 0
               for x in (q, k, v))
    with torch.no_grad():
        plain = flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())


def test_flash_rejects_bad_inputs():
    q, k, v = map(torch.from_numpy, qkv(6))
    with pytest.raises(ValueError):
        flash_attention_kernel(q, k[:, :4], v)
    with pytest.raises(TypeError):
        flash_attention_kernel(q, k.double(), v)


def tensor_core_forward(q, k, v, causal, tile=64):
    """Emulation of K2's bf16 tensor-core arithmetic
    (``csrc/flash_attention.cu:flash_fwd_tc``) in torch: bf16 inputs whose
    products are exact in f32, 64-key tiles, an online softmax, p rounded
    to bf16 before P·V while l sums the unrounded f32 p, out rounded to
    bf16. Tiles wholly above the causal diagonal, which the kernel skips,
    add exact zeros here."""
    b, t, h, d = q.shape
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k, v))
    scale = 1.0 / d ** 0.5
    rows = torch.arange(t)[:, None]
    m = torch.full((b, h, t, 1), NEG_INF)
    l = torch.zeros((b, h, t, 1))
    acc = torch.zeros((b, h, t, d))
    for k0 in range(0, t, tile):
        kt, vt = kf[:, :, k0:k0 + tile], vf[:, :, k0:k0 + tile]
        s = (qf @ kt.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = s.masked_fill(cols > rows, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + p.bfloat16().float() @ vt
        m = m_new
    return (acc / l).transpose(1, 2).bfloat16(), (m + torch.log(l))[..., 0]


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("t", [64, 100])
@pytest.mark.parametrize("causal", [True, False])
def test_tensor_core_forward_within_bound_of_jax(causal, t, d):
    """The bf16 tensor-core forward's arithmetic (emulated) against the JAX
    package's Pallas flash forward in f32 (interpret mode) on the same
    bf16-representable inputs: each out element within
    ``tensor_core_bound``, the bound the card checks hold K2 to; lse
    within 1e-3, as on the card."""
    rng = np.random.default_rng(100 + t + d + causal)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, t, 2, d),
                                                    dtype=np.float32))
               .bfloat16() for _ in range(3))
    want = jax_flash.flash_attention(
        *(jnp.asarray(x.float().numpy()) for x in (q, k, v)), causal=causal,
        block_q=32, block_k=32, interpret=True)
    want = torch.from_numpy(np.array(want))
    out, lse = tensor_core_forward(q, k, v, causal)
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    bound = tensor_core_bound("out", out, want, q, k, v, causal=causal)
    ratio = float(((out.float() - want).abs().double() / bound).max())
    assert ratio <= 1.0, ratio
    _, ref_lse = flash_attention_plain(q.float(), k.float(), v.float(),
                                       causal=causal)
    assert float((lse - ref_lse).abs().max()) <= 1e-3


def test_tensor_core_alignment_check():
    """The bf16 tensor-core kernels copy 16-byte rows; the check reads
    only pointers and strides, so it runs on CPU tensors."""
    # a [B, T, H·D] Dense output viewed as [B, T, H, D], as the model does
    check_tensor_core_alignment(torch.zeros((2, 8, 128),
                                            dtype=torch.bfloat16)
                                .view(2, 8, 2, 64))
    wide = torch.zeros((2, 8, 2, 65), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        check_tensor_core_alignment(wide[..., 1:])       # strides of 65
    flat = torch.zeros(2 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
    check_tensor_core_alignment(flat[8:].view(2, 8, 2, 64))   # 16 bytes in
    with pytest.raises(ValueError, match="16-byte"):
        check_tensor_core_alignment(flat[4:4 + 2048].view(2, 8, 2, 64))
    check_tensor_core_alignment(wide[..., 1:].float())  # f32: CUDA cores


@pytest.mark.parametrize("t", [1, 37, 256, 1100])
def test_resolve_blocks_matches_jax(t):
    assert resolve_blocks(t) == jax_flash.resolve_blocks(t)


def test_make_attn_fn_kinds():
    q, k, v = map(torch.from_numpy, qkv(7))
    assert make_attn_fn("full") is full_attention
    assert make_attn_fn("flash") is flash_attention
    fn = make_attn_fn("auto")
    assert fn is auto_attention
    assert torch.equal(fn(q, k, v, causal=True),
                       full_attention(q, k, v, causal=True))   # CPU → full
    for kind in ("ring", "ulysses"):
        with pytest.raises(ValueError, match="ROADMAP"):
            make_attn_fn(kind)
    with pytest.raises(ValueError):
        make_attn_fn("nope")
    with pytest.raises(TypeError):
        make_attn_fn("flash", block_q=128)


# -- paged decode attention -------------------------------------------------

BS, C = 2, 3


def paged_case(seed, kvh, g, *, b=3, t=2, d=8, n=10, int8=False):
    """Pages, tables and lengths as the decode pool builds them: distinct
    physical blocks out of order, full / partial / EMPTY chains, dead
    table entries 0."""
    rng = np.random.default_rng(seed)
    q5 = rng.standard_normal((b, t, kvh, g, d)).astype(np.float32)
    shape = (n, BS, kvh, d)
    ks = vs = None
    if int8:
        kp = rng.integers(-127, 128, shape).astype(np.int8)
        vp = rng.integers(-127, 128, shape).astype(np.int8)
        ks = rng.uniform(0.005, 0.05, shape[:3]).astype(np.float32)
        vs = rng.uniform(0.005, 0.05, shape[:3]).astype(np.float32)
    else:
        kp = rng.standard_normal(shape).astype(np.float32)
        vp = rng.standard_normal(shape).astype(np.float32)
    tables = np.array([[5, 2, 7], [1, 0, 0], [0, 0, 0]], np.int32)[:b]
    lengths = np.array([3 * BS, BS, 0], np.int32)[:b]
    return q5, kp, vp, tables, lengths, ks, vs


def jax_paged_grouped(q5, kp, vp, tables, lengths, ks, vs):
    out, lse = jax_paged.paged_attention_grouped(
        *map(jnp.asarray, (q5, kp, vp, tables, lengths)),
        k_scale_pages=None if ks is None else jnp.asarray(ks),
        v_scale_pages=None if vs is None else jnp.asarray(vs),
        kernel="pallas", interpret=True)
    return np.asarray(out), np.asarray(lse)


def to_t(x):
    return None if x is None else torch.from_numpy(x)


@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 2)])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_plain_matches_jax_kernel(kvh, g, int8):
    """The port's paged attention (plain on the CPU, selected by "auto")
    against the Pallas kernel in interpret mode: GQA groupings, an empty
    chain, int8 pages with per-token scales; tolerance 1e-5."""
    case = paged_case(kvh * 10 + g, kvh, g, int8=int8)
    want_out, want_lse = jax_paged_grouped(*case)
    q5, kp, vp, tables, lengths, ks, vs = map(to_t, case)
    kernel = resolve_paged_kernel("auto", "cpu")
    out, lse = paged_attention_grouped(q5, kp, vp, tables, lengths,
                                       k_scale_pages=ks, v_scale_pages=vs,
                                       kernel=kernel)
    assert_close(out, want_out)
    np.testing.assert_allclose(lse.numpy()[:2], want_lse[:2], rtol=TOL,
                               atol=TOL)
    # the empty chain: exactly (0, -1e30), as the Pallas kernel writes
    assert bool((out[2] == 0).all()) and bool((lse[2] == -1e30).all())
    assert bool((want_lse[2] == np.float32(-1e30)).all())


def split_chain_paged(q5, kp, vp, tables, lengths, ks=None, vs=None,
                      warps=4):
    """Emulation of K3's split chain (``csrc/paged_attention.cu:
    paged_fwd``) in torch f32: warp w runs an online softmax over blocks
    w, w + warps, ... of its row's live chain, keeping its own (m, l, acc)
    from (-1e30, 0, 0); the partials merge in warp order,
    M = max m_w, L = Σ l_w·e^(m_w − M), out = Σ acc_w·e^(m_w − M) / L
    (L = 0 divides by 1), lse = M + log L."""
    b, t, kvh, g, d = q5.shape
    bs = kp.shape[1]
    scale = 1.0 / d ** 0.5
    q = q5.permute(0, 2, 1, 3, 4).reshape(b, kvh, t * g, d).float()
    out = torch.zeros_like(q)
    lse = torch.zeros(q.shape[:3])
    for r in range(b):
        n_live = min(tables.shape[1], -(-int(lengths[r]) // bs))
        parts = []
        for w in range(warps):
            m = torch.full((kvh, t * g, 1), NEG_INF)
            l = torch.zeros((kvh, t * g, 1))
            acc = torch.zeros((kvh, t * g, d))
            for j in range(w, n_live, warps):
                page = int(tables[r, j])
                n = min(bs, int(lengths[r]) - j * bs)
                k = kp[page, :n].float().transpose(0, 1)      # [KVH, n, D]
                v = vp[page, :n].float().transpose(0, 1)
                if ks is not None:
                    k = k * ks[page, :n].float().T[..., None]
                    v = v * vs[page, :n].float().T[..., None]
                s = q[r] @ k.transpose(-1, -2) * scale
                m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new)
                l = l * alpha + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + p @ v
                m = m_new
            parts.append((m, l, acc))
        mx = torch.stack([m for m, _, _ in parts]).amax(dim=0)
        total = torch.zeros_like(mx)
        o = torch.zeros_like(q[r])
        for m, l, acc in parts:
            wgt = torch.exp(m - mx)
            total = total + l * wgt
            o = o + acc * wgt
        safe = torch.where(total == 0, torch.ones_like(total), total)
        out[r] = o / safe
        lse[r] = (mx + torch.log(safe))[..., 0]
    return (out.reshape(b, kvh, t, g, d).permute(0, 2, 1, 3, 4),
            lse.reshape(b, kvh, t, g).permute(0, 2, 1, 3))


@pytest.mark.parametrize("kvh,g", [(1, 4), (2, 2)])
@pytest.mark.parametrize("int8", [False, True])
def test_split_chain_paged_matches_jax_kernel(kvh, g, int8):
    """K3's split-chain arithmetic (emulated) against the Pallas kernel in
    interpret mode: bf16-valued or int8 pages, GQA groupings, chains of
    9 blocks (more than the 4 warps), 1 block and 0 blocks; 1e-5, and the
    empty chain exactly (0, -1e30)."""
    rng = np.random.default_rng(400 + 10 * kvh + g + int8)
    b, t, d, n = 3, 2, 8, 16
    q5 = rng.standard_normal((b, t, kvh, g, d)).astype(np.float32)
    shape = (n, BS, kvh, d)
    ks = vs = None
    if int8:
        kp, vp = (rng.integers(-127, 128, shape).astype(np.int8)
                  for _ in range(2))
        ks, vs = (rng.uniform(0.005, 0.05, shape[:3]).astype(np.float32)
                  for _ in range(2))
    else:
        kp, vp = (torch.from_numpy(rng.standard_normal(shape)
                                   .astype(np.float32))
                  .bfloat16().float().numpy() for _ in range(2))
    perm = rng.permutation(n).astype(np.int32)
    tables = np.zeros((b, 9), np.int32)
    tables[0] = perm[:9]
    tables[1, 0] = perm[9]
    lengths = np.array([9 * BS, BS, 0], np.int32)
    case = (q5, kp, vp, tables, lengths, ks, vs)
    want_out, want_lse = jax_paged_grouped(*case)
    out, lse = split_chain_paged(*map(to_t, case))
    assert_close(out, want_out)
    np.testing.assert_allclose(lse.numpy()[:2], want_lse[:2], rtol=TOL,
                               atol=TOL)
    assert bool((out[2] == 0).all()) and bool((lse[2] == -1e30).all())


def test_paged_kernel_wrapper_runs_plain_on_cpu():
    q5, kp, vp, tables, lengths, _, _ = map(to_t, paged_case(1, 2, 2))
    before = paged_attention_kernel.launches
    got = paged_attention_grouped(q5, kp, vp, tables, lengths, kernel="kernel")
    want = paged_attention_grouped(q5, kp, vp, tables, lengths, kernel="plain")
    assert paged_attention_kernel.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_paged_empty_table_needs_no_kernel():
    q5 = torch.zeros((2, 1, 2, 1, 8))
    pages = torch.zeros((4, BS, 2, 8))
    out, lse = paged_attention_grouped(
        q5, pages, pages, torch.zeros((2, 0), dtype=torch.int32),
        torch.zeros((2,), dtype=torch.int32), kernel="kernel")
    assert bool((out == 0).all()) and bool((lse == -1e30).all())


def test_paged_flat_wrapper_matches_jax():
    q5, kp, vp, tables, lengths, _, _ = paged_case(2, 2, 2)
    b, t, kvh, g, d = q5.shape
    q = q5.reshape(b, t, kvh * g, d)
    want_o, want_l = jax_paged.paged_attention(
        *map(jnp.asarray, (q, kp, vp, tables, lengths)), kernel="xla")
    got_o, got_l = paged_attention(*map(torch.from_numpy,
                                        (q, kp, vp, tables, lengths)))
    assert_close(got_o, np.asarray(want_o))
    assert_close(got_l, np.asarray(want_l))
    with pytest.raises(ValueError, match="multiple"):
        paged_attention(torch.zeros((1, 1, 3, d)), *map(
            torch.from_numpy, (kp, vp, tables[:1], lengths[:1])))


def test_merge_attention_matches_jax_and_empty_partial_is_exact():
    rng = np.random.default_rng(9)
    o_a, o_b = (rng.standard_normal((3, 2, 4, 8)).astype(np.float32)
                for _ in range(2))
    lse_a, lse_b = (rng.standard_normal((3, 2, 4)).astype(np.float32)
                    for _ in range(2))
    want = np.asarray(jax_paged.merge_attention(
        *map(jnp.asarray, (o_a, lse_a, o_b, lse_b))))
    got = merge_attention(*map(torch.from_numpy, (o_a, lse_a, o_b, lse_b)))
    assert_close(got, want)
    # an lse of -1e30 contributes weight exactly 0: bit-for-bit no-op
    empty = merge_attention(torch.from_numpy(o_a), torch.from_numpy(lse_a),
                            torch.zeros(3, 2, 4, 8),
                            torch.full((3, 2, 4), -1e30))
    assert torch.equal(empty, torch.from_numpy(o_a))


def test_resolve_paged_kernel():
    assert resolve_paged_kernel("auto", "cpu") == "plain"
    assert resolve_paged_kernel("auto", "cuda") == "kernel"
    assert resolve_paged_kernel("kernel", "cpu") == "kernel"
    assert resolve_paged_kernel("plain", "cuda") == "plain"
    with pytest.raises(ValueError):
        resolve_paged_kernel("pallas")


def test_paged_context_layer_slices_stacked_pages():
    pages = torch.arange(2 * 3 * BS * 1 * 4.0).reshape(2, 3, BS, 1, 4)
    ctx = PagedContext(pages, pages + 1, torch.zeros((1, 1), dtype=torch.int32),
                       torch.zeros((1,), dtype=torch.int32))
    layer = ctx.layer(1)
    assert torch.equal(layer.k_pages, pages[1])
    assert layer.k_scale_pages is None and layer.tables is ctx.tables
