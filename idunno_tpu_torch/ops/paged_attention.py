"""Block-native paged decode attention: the CUDA kernel (K3) and its plain
version.

Queries attend over K/V blocks addressed *through the block table* — no
contiguous prefix is ever materialized (vLLM's PagedAttention). Two
interchangeable backends behind one signature:

- ``kernel="kernel"``: the CUDA kernel (``csrc/paged_attention.cu``), which
  replaces the TPU kernel ``idunno_tpu/ops/paged_attention.py:_paged_kernel``.
  Each CTA reads its row's table once, splits the chain across its warps
  (each keeps its own online-softmax partial, merged in warp order at the
  end) and reads the live pages straight from the store in 16-byte
  vectors. On a CPU tensor the wrapper runs the plain version.
- ``kernel="plain"``: gather + masked softmax in tensor ops
  (``_paged_xla`` of the JAX package).

Both take int8 pages with their per-token f32 ``k_scale``/``v_scale``
pages (``[N, bs, KVH]``) and dequantize them themselves. Both return
*normalized* per-(query, kv-head, group) outputs plus the log-sum-exp of
their softmax, so the caller can merge with the slot-local attention via
`merge_attention` — exact because the merged result is
(o_a·Z_a + o_b·Z_b)/(Z_a+Z_b) with Z=exp(lse). A row with an empty chain
yields out 0 and lse -1e30, whose merge weight underflows to exactly 0.0
in f32: zero-hit rows reproduce the dense result bit for bit.

``resolve_paged_kernel("auto")`` is ``kernel`` on a CUDA device and
``plain`` on the CPU, as the CNN path's ``preprocess="auto"`` is.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Any

import torch

from idunno_tpu_torch.ops.flash_attention import NEG_INF

# the variants the kernel compiles: the LM's pages in its f32 or bf16 dtype
# or int8 with f32 scales, at D = 64 (the served 0.2 B model) and D = 32
# (the default-size model, dim 128 over 4 heads)
_PAGE_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 3}
_HEAD_DIMS = (32, 64)


def resolve_paged_kernel(kind: str, device: torch.device | str | None = None
                         ) -> str:
    """``auto`` → ``kernel`` on a CUDA device, ``plain`` elsewhere;
    ``kernel`` and ``plain`` pass through."""
    if kind not in ("auto", "kernel", "plain"):
        raise ValueError(f"paged_kernel must be auto|kernel|plain, got {kind!r}")
    if kind == "auto":
        dev = torch.device("cuda" if device is None else device)
        return "kernel" if dev.type == "cuda" else "plain"
    return kind


@dataclasses.dataclass
class PagedContext:
    """Everything the decode step needs to attend over paged KV.

    Depth-stacked (``[L, N, bs, ...]``) or per-layer (``[N, bs, ...]``)
    page stores, the per-row block table ``tables [S, C]`` (int32, dead
    entries 0), block-aligned paged lengths ``lengths [S]`` (int32),
    ``start`` (absolute cache position where the paged region begins —
    the static-prefix length) and ``kernel`` (``kernel`` or ``plain``)."""

    k_pages: Any
    v_pages: Any
    tables: Any
    lengths: Any
    k_scale_pages: Any = None
    v_scale_pages: Any = None
    start: int = 0
    kernel: str = "plain"

    def layer(self, i: int) -> "PagedContext":
        """Layer ``i`` of depth-stacked page stores."""
        def pick(x):
            return None if x is None else x[i]
        return dataclasses.replace(
            self, k_pages=self.k_pages[i], v_pages=self.v_pages[i],
            k_scale_pages=pick(self.k_scale_pages),
            v_scale_pages=pick(self.v_scale_pages))


def _paged_plain(q5, k_pages, v_pages, tables, lengths, *,
                 k_scale_pages=None, v_scale_pages=None, scale: float):
    b, t, kvh, g, d = q5.shape
    bs = k_pages.shape[1]
    c = tables.shape[1]
    tab = tables.long()
    k = k_pages[tab].float()                  # [B, C, bs, KVH, D]
    v = v_pages[tab].float()
    if k_scale_pages is not None:
        k = k * k_scale_pages[tab].float()[..., None]
        v = v * v_scale_pages[tab].float()[..., None]
    k = k.permute(0, 3, 1, 2, 4).reshape(b, kvh, c * bs, d)
    v = v.permute(0, 3, 1, 2, 4).reshape(b, kvh, c * bs, d)
    q = q5.permute(0, 2, 1, 3, 4).float()     # [B, KVH, T, G, D]
    s = torch.einsum("bhtgd,bhsd->bhtgs", q, k) * scale
    live = (torch.arange(c * bs, device=q5.device)[None, :]
            < lengths.long()[:, None])        # [B, C*bs]
    s = torch.where(live[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhtgs,bhsd->bhtgd", p / l_safe, v)
    lse = (m + torch.log(l_safe))[..., 0]
    # a fully masked row degenerates to a uniform softmax over garbage;
    # pin the kernel's (zeros, -1e30) contract instead
    dead = lengths == 0
    o = torch.where(dead[:, None, None, None, None], torch.zeros_like(o), o)
    lse = torch.where(dead[:, None, None, None],
                      torch.full_like(lse, NEG_INF), lse)
    return o.permute(0, 2, 1, 3, 4), lse.permute(0, 2, 1, 3)


def _kernel_lib() -> ctypes.CDLL:
    from idunno_tpu_torch.ops import cuda_build

    lib = cuda_build.load("paged_attention")
    fn = lib.idunno_paged_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _check(q5, k_pages, v_pages, tables, lengths, k_scale_pages,
           v_scale_pages) -> None:
    if q5.dim() != 5:
        raise ValueError(f"q5 must be [B, T, KVH, G, D], got {tuple(q5.shape)}")
    b, _, kvh, _, d = q5.shape
    if (k_pages.dim() != 4 or v_pages.shape != k_pages.shape
            or k_pages.shape[2] != kvh or k_pages.shape[3] != d):
        raise ValueError(f"pages must be [N, bs, {kvh}, {d}], got "
                         f"{tuple(k_pages.shape)}, {tuple(v_pages.shape)}")
    if tables.dim() != 2 or tables.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"tables must be [{b}, C] and lengths [{b}], got "
                         f"{tuple(tables.shape)}, {tuple(lengths.shape)}")
    if (k_scale_pages is None) != (v_scale_pages is None):
        raise ValueError("pass both scale pages or neither")
    if k_scale_pages is not None and (
            k_scale_pages.shape != k_pages.shape[:3]
            or v_scale_pages.shape != k_pages.shape[:3]):
        raise ValueError(f"scale pages must be {tuple(k_pages.shape[:3])}")


def paged_attention_kernel(q5, k_pages, v_pages, tables, lengths, *,
                           k_scale_pages=None, v_scale_pages=None):
    """The paged attention of ``paged_attention_grouped`` through the CUDA
    kernel on CUDA tensors (one launch on the current stream, no
    synchronize; raises on a bad input or a refused launch), through the
    plain version on CPU tensors. ``paged_attention_kernel.launches``
    counts the kernel's launches."""
    _check(q5, k_pages, v_pages, tables, lengths, k_scale_pages,
           v_scale_pages)
    b, t, kvh, g, d = q5.shape
    scale = 1.0 / (d ** 0.5)
    if q5.device.type == "cpu":
        return _paged_plain(q5, k_pages, v_pages, tables, lengths,
                            k_scale_pages=k_scale_pages,
                            v_scale_pages=v_scale_pages, scale=scale)
    if q5.device.type != "cuda":
        raise ValueError(f"paged attention runs on cuda or cpu tensors, "
                         f"got {q5.device}")
    quant = k_pages.dtype == torch.int8
    if k_pages.dtype not in _PAGE_DTYPES or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"paged kernel takes pages in "
                        f"{sorted(map(str, _PAGE_DTYPES))}, got "
                        f"{k_pages.dtype}, {v_pages.dtype}")
    if quant != (k_scale_pages is not None):
        raise ValueError("int8 pages need scale pages, and only they take them")
    if d not in _HEAD_DIMS:
        raise ValueError(f"paged kernel takes head_dim in {_HEAD_DIMS}, got {d}")
    operands = [q5, k_pages, v_pages, tables, lengths]
    if quant:
        operands += [k_scale_pages, v_scale_pages]
    for x in operands:
        if x.device != q5.device:
            raise ValueError("paged attention operands lie on different devices")
        if not x.is_contiguous():
            raise ValueError("paged kernel takes contiguous operands")
    if k_pages.data_ptr() % 16 or v_pages.data_ptr() % 16:
        raise ValueError("paged kernel reads pages in 16-byte vectors: "
                         "their data pointers must be 16-byte aligned")
    if q5.dtype != torch.float32:
        raise TypeError(f"paged kernel takes f32 queries, got {q5.dtype}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged kernel takes int32 tables and lengths")
    if quant and (k_scale_pages.dtype != torch.float32
                  or v_scale_pages.dtype != torch.float32):
        raise TypeError("paged kernel takes f32 scale pages")
    out = torch.empty_like(q5)
    lse = torch.empty((b, t, kvh, g), dtype=torch.float32, device=q5.device)
    if out.numel() == 0:
        return out, lse
    fn = _kernel_lib().idunno_paged_attention_fwd
    with torch.cuda.device(q5.device):
        stream = torch.cuda.current_stream().cuda_stream
    n, bs = k_pages.shape[0], k_pages.shape[1]
    rc = fn(q5.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            k_scale_pages.data_ptr() if quant else None,
            v_scale_pages.data_ptr() if quant else None,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            lse.data_ptr(), b, t, kvh, g, d, n, bs, tables.shape[1],
            _PAGE_DTYPES[k_pages.dtype], scale, stream)
    if rc != 0:
        raise RuntimeError(f"paged attention kernel launch failed: "
                           f"cudaError {rc}")
    paged_attention_kernel.launches += 1
    return out, lse


paged_attention_kernel.launches = 0


def paged_attention_grouped(q5, k_pages, v_pages, tables, lengths, *,
                            k_scale_pages=None, v_scale_pages=None,
                            kernel: str = "plain"):
    """Grouped-query paged attention.

    q5 ``[B, T, KVH, G, D]`` (the transformer's head-grouping order:
    ``q.reshape(b, t, kv_heads, heads // kv_heads, d)``); pages
    ``[N, bs, KVH, D]``; tables ``[B, C]`` int32 (dead entries 0);
    lengths ``[B]`` int32 block multiples. Returns normalized outputs
    ``[B, T, KVH, G, D]`` f32 and lse ``[B, T, KVH, G]`` f32 — out 0 and
    lse -1e30 on empty chains (merge weight underflows to exactly 0).
    ``kernel`` is ``kernel`` or ``plain`` (`resolve_paged_kernel`)."""
    d = q5.shape[-1]
    c = tables.shape[1]
    if c == 0:
        b, t, kvh, g, _ = q5.shape
        return (torch.zeros((b, t, kvh, g, d), dtype=torch.float32,
                            device=q5.device),
                torch.full((b, t, kvh, g), NEG_INF, dtype=torch.float32,
                           device=q5.device))
    if kernel == "kernel":
        return paged_attention_kernel(q5, k_pages, v_pages, tables, lengths,
                                      k_scale_pages=k_scale_pages,
                                      v_scale_pages=v_scale_pages)
    if kernel != "plain":
        raise ValueError(f"paged kernel {kernel!r}: want kernel|plain")
    return _paged_plain(q5, k_pages, v_pages, tables, lengths,
                        k_scale_pages=k_scale_pages,
                        v_scale_pages=v_scale_pages, scale=1.0 / (d ** 0.5))


def paged_attention(q, k_pages, v_pages, tables, lengths, *,
                    k_scale_pages=None, v_scale_pages=None,
                    kernel: str = "plain"):
    """Flat-head convenience wrapper: q ``[B, T, H, D]`` → out
    ``[B, T, H, D]`` f32 + lse ``[B, T, H]``. H must be a multiple of
    the page store's KVH (standard GQA grouping)."""
    b, t, h, d = q.shape
    kvh = k_pages.shape[2]
    if h % kvh:
        raise ValueError(f"heads {h} not a multiple of kv_heads {kvh}")
    q5 = q.reshape(b, t, kvh, h // kvh, d)
    o5, lse5 = paged_attention_grouped(
        q5, k_pages, v_pages, tables, lengths,
        k_scale_pages=k_scale_pages, v_scale_pages=v_scale_pages,
        kernel=kernel)
    return o5.reshape(b, t, h, d), lse5.reshape(b, t, h)


def merge_attention(o_a, lse_a, o_b, lse_b):
    """Merge two normalized attention partials over disjoint key sets.

    Exact: with Z=exp(lse) the softmax over the union is
    (o_a·Z_a + o_b·Z_b)/(Z_a+Z_b). lse inputs broadcast against o with
    a trailing feature axis. An lse of -1e30 contributes weight exactly
    0.0 (f32 underflow), so an empty partial is a no-op."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    return (o_a * wa + o_b * wb) / (wa + wb)
