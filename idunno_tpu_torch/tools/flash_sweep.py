"""K2 (flash forward) and K3 (paged attention) over the shapes the LM's
paths give them, each variant held against its plain version, then timed.

The port's counterpart of ``tools/flash_sweep.py``. The JAX sweep varies
the Pallas flash kernel's block sizes; K2 has fixed 64 x 64 tiles, so
this sweep varies shapes instead:

- K2 forward, bf16, 16 heads: batch x sequence 4 x 1024 (the LM bench's
  prefill), 8 x 1024 (its training batch), 4 x 4096 (the JAX sweep's
  long sequence) and 2 x 4096, head_dim 32 and 64, causal and not. K2
  and ``torch.nn.functional.scaled_dot_product_attention`` (the library
  yardstick, which the port never calls) are timed by CUDA-graph replay,
  the plain version by CUDA events;
- K3 over bf16 pages, the JAX sweep's paged grid (``PAGED_GRID``: q_len 1
  and 8 x KV 512 and 4096 x block sizes 16, 32 and 64) at the LM bench's
  decode shape (16 slots, 16 kv-heads, head_dim 64, every slot's chain
  full), and over int8 pages with f32 per-token scales (``INT8_GRID``:
  q_len 1); K3 by graph replay against the plain gather version by CUDA
  events.

Before it is timed, each variant is held against its plain version at
the tolerance ``chip_smoke.py`` holds that kernel to: K2's output within
``ops/flash_attention.py:tensor_core_bound`` and its lse within 1e-3;
K3's output within 1e-5 of the largest |output| and its lse within 1e-5
relative. A variant that fails is recorded with its error and the sweep
goes on; the run then exits non-zero. ``bound_ms`` is the larger of the
bytes moved (each input read once, each output written once) at 3.35
TB/s and the operations at the H100's peak for their type (989 TFLOP/s
bf16 for K2's tensor-core products, 67 TFLOP/s f32 for K3's). The pages
of a K3 variant rotate over enough copies to pass 150 MB, three times
the 50 MB L2, so each launch reads its pages from device memory.

The record is written after every variant, to
``chiprun_out/flash_sweep_torch.json`` unless ``--out`` says otherwise:

    python -m idunno_tpu_torch.tools.flash_sweep           # the card
    python -m idunno_tpu_torch.tools.flash_sweep --cpu     # the machinery

With ``--cpu`` the same grid runs at tiny widths (2 heads, 2 slots, 2
kv-heads; K2 at 2 x 64 and 1 x 128) through the plain versions alone:
no kernel arm, no time.
"""
from __future__ import annotations

import math
import sys

import torch

HEADS = 16
K2_SHAPES = ((4, 1024), (8, 1024), (4, 4096), (2, 4096))
K2_HEAD_DIMS = (32, 64)
# the JAX sweep's paged grid (``tools/flash_sweep.py``): block size x KV
# length x query rows, in its order
PAGED_GRID = tuple((bs, kv, q) for bs in (32, 16, 64) for kv in (512, 4096)
                   for q in (1, 8))
INT8_GRID = tuple((bs, kv, 1) for bs in (32, 16, 64) for kv in (512, 4096))
SLOTS, KV_HEADS, HEAD_DIM = 16, 16, 64
CPU = {"heads": 2, "k2_shapes": ((2, 64), (1, 128)), "slots": 2,
       "kv_heads": 2}

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
F32_FLOPS_PER_S = 67e12          # H100 SXM f32 outside the tensor cores
L2_PASS_BYTES = 150e6            # three times the 50 MB L2
K2_LSE_TOL = 1e-3
K3_TOL = 1e-5


def k2_variants(cpu: bool = False) -> list[dict]:
    shapes = CPU["k2_shapes"] if cpu else K2_SHAPES
    heads = CPU["heads"] if cpu else HEADS
    return [{"kernel": "K2", "variant": f"flash_b{b}_t{t}_d{d}_"
                                        f"{'causal' if c else 'full'}",
             "batch": b, "seq": t, "heads": heads, "head_dim": d,
             "causal": c}
            for b, t in shapes for d in K2_HEAD_DIMS for c in (True, False)]


def paged_variants(cpu: bool = False) -> list[dict]:
    slots = CPU["slots"] if cpu else SLOTS
    kvh = CPU["kv_heads"] if cpu else KV_HEADS
    out = []
    for pages, grid in (("bf16", PAGED_GRID), ("int8", INT8_GRID)):
        for bs, kv, q in grid:
            out.append({"kernel": "K3", "pages": pages,
                        "variant": f"paged_{pages}_bs{bs}_kv{kv}_q{q}",
                        "block_size": bs, "kv_len": kv, "q_len": q,
                        "slots": slots, "kv_heads": kvh,
                        "head_dim": HEAD_DIM})
    return out


def k2_inputs(v: dict, dev, seed: int):
    """bf16 q, k, v [B, T, H, D] of a K2 variant."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = (v["batch"], v["seq"], v["heads"], v["head_dim"])
    return tuple(torch.randn(shape, generator=g, device=dev)
                 .to(torch.bfloat16) for _ in range(3))


def paged_inputs(v: dict, dev, seed: int, copies: int = 1):
    """f32 queries q5 [slots, q_len, kv_heads, 1, head_dim]; ``copies``
    stores of pages [N, bs, kv_heads, head_dim] (bf16, or int8 with f32
    per-token scales [N, bs, kv_heads], else None), each slot's table a
    distinct permutation of pages, every chain full (``kv_len`` live
    tokens a slot)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    slots, kvh, d, bs = v["slots"], v["kv_heads"], v["head_dim"], \
        v["block_size"]
    nb = v["kv_len"] // bs
    n = slots * nb
    q5 = torch.randn((slots, v["q_len"], kvh, 1, d), generator=g, device=dev)
    shape = (copies, n, bs, kvh, d)
    if v["pages"] == "int8":
        kp, vp = (torch.randint(-127, 128, shape, generator=g, device=dev,
                                dtype=torch.int8) for _ in range(2))
        ks, vs = (torch.rand(shape[:-1], generator=g, device=dev) * 0.02
                  + 0.001 for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(2))
        ks = vs = None
    perm = torch.randperm(n, generator=torch.Generator().manual_seed(seed))
    tables = perm.reshape(slots, nb).to(torch.int32).to(dev)
    lengths = torch.full((slots,), v["kv_len"], dtype=torch.int32,
                         device=dev)
    return q5, kp, vp, ks, vs, tables, lengths


def k2_plain(q, k, v, causal: bool):
    from idunno_tpu_torch.ops.flash_attention import flash_attention_plain
    return flash_attention_plain(q, k, v, causal=causal)


def k3_plain(q5, kp, vp, tables, lengths, ks=None, vs=None):
    from idunno_tpu_torch.ops.paged_attention import _paged_plain
    return _paged_plain(q5, kp, vp, tables, lengths, k_scale_pages=ks,
                        v_scale_pages=vs, scale=1.0 / q5.shape[-1] ** 0.5)


def _bound(nbytes: float, flops: float, peak: float) -> dict:
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / peak * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes": nbytes, "flops": flops}


def k2_bound(v: dict) -> dict:
    """q, k, v read once and out written once (bf16) and the lse (f32);
    two D-long products a live (query, key) pair."""
    b, t, h, d = v["batch"], v["seq"], v["heads"], v["head_dim"]
    pairs = t * (t + 1) // 2 if v["causal"] else t * t
    return _bound(4 * b * t * h * d * 2 + b * h * t * 4,
                  2 * 2 * b * h * d * pairs, BF16_FLOPS_PER_S)


def k3_bound(v: dict) -> dict:
    """The live K and V pages (and their scales) read once, the queries,
    out and lse (f32), the tables and lengths; two D-long products a live
    key and query row."""
    slots, kvh, d, t = v["slots"], v["kv_heads"], v["head_dim"], v["q_len"]
    live = slots * v["kv_len"]
    page_bytes = 1 if v["pages"] == "int8" else 2
    nbytes = (2 * live * kvh * d * page_bytes
              + (2 * live * kvh * 4 if v["pages"] == "int8" else 0)
              + 2 * slots * t * kvh * d * 4 + slots * t * kvh * 4
              + slots * (v["kv_len"] // v["block_size"]) * 4 + slots * 4)
    return _bound(nbytes, 2 * 2 * live * kvh * d * t, F32_FLOPS_PER_S)


def measure_k2(v: dict, dev) -> dict:
    """Hold K2 against plain at variant ``v``, then time K2, the plain
    version and SDPA (card); the plain arm alone on the CPU."""
    import torch.nn.functional as F

    from idunno_tpu_torch.ops.flash_attention import (flash_attention_kernel,
                                                      tensor_core_bound)
    from idunno_tpu_torch.utils.tracing import cuda_ms, graph_ms

    q, k, w = k2_inputs(v, dev, seed=100 + v["seq"] + v["head_dim"])
    causal = v["causal"]
    ref, ref_lse = k2_plain(q, k, w, causal)
    if dev.type == "cpu":
        return {"arms": ["plain"], "out_shape": list(ref.shape)}
    out, lse = flash_attention_kernel(q, k, w, causal=causal)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    ratio = float((diff.double() / tensor_core_bound(
        "out", out, ref, q, k, w, causal=causal)).max())
    lse_err = float((lse - ref_lse).abs().max())
    row = {"max_abs_err": float(diff.max()),
           "max_err_over_tolerance": ratio, "lse_max_abs_err": lse_err,
           "lse_tolerance": K2_LSE_TOL}
    if not (ratio <= 1.0 and lse_err <= K2_LSE_TOL):
        raise AssertionError(f"K2 off its plain version: out at {ratio} of "
                             f"its tolerance, lse {lse_err}")
    del out, lse, ref, ref_lse, diff
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, w))
    row.update(arms=["kernel", "plain", "library"],
               ms=graph_ms(lambda: flash_attention_kernel(
                   q, k, w, causal=causal), 20),
               plain_ms=cuda_ms(lambda: k2_plain(q, k, w, causal), 3),
               library_ms=graph_ms(lambda: F.scaled_dot_product_attention(
                   qt, kt, vt, is_causal=causal), 20),
               timed_by="kernel and library by cuda graph replay, plain "
                        "by cuda events",
               **k2_bound(v))
    row["achieved_tflops"] = row["flops"] / (row["ms"] * 1e-3) / 1e12
    return row


def measure_k3(v: dict, dev) -> dict:
    """Hold K3 against plain at variant ``v``, then time K3 and the plain
    gather version (card); the plain arm alone on the CPU."""
    from idunno_tpu_torch.ops.paged_attention import paged_attention_kernel
    from idunno_tpu_torch.utils.tracing import cuda_ms, graph_ms

    cpu = dev.type == "cpu"
    seed = v["block_size"] + v["kv_len"] + v["q_len"]
    one = paged_inputs(v, dev, seed)
    page_bytes = one[1][0].numel() * one[1].element_size() * 2
    copies = 1 if cpu else max(1, math.ceil(L2_PASS_BYTES / page_bytes))
    q5, kp, vp, ks, vs, tables, lengths = (
        one if copies == 1 else paged_inputs(v, dev, seed, copies))
    del one

    def at(i):
        return (kp[i], vp[i], None if ks is None else ks[i],
                None if vs is None else vs[i])

    k0, v0, ks0, vs0 = at(0)
    ref, ref_lse = k3_plain(q5, k0, v0, tables, lengths, ks0, vs0)
    if cpu:
        return {"arms": ["plain"], "out_shape": list(ref.shape)}
    out, lse = paged_attention_kernel(q5, k0, v0, tables, lengths,
                                      k_scale_pages=ks0, v_scale_pages=vs0)
    torch.cuda.synchronize()
    diff = float((out - ref).abs().max())
    tol = K3_TOL * float(ref.abs().max())
    lse_err = float(((lse - ref_lse).abs()
                     / ref_lse.abs().clamp_min(1.0)).max())
    row = {"max_abs_err": diff, "tolerance": tol, "lse_max_rel_err": lse_err,
           "lse_tolerance": K3_TOL, "page_copies": copies}
    if not (diff <= tol and lse_err <= K3_TOL):
        raise AssertionError(f"K3 off its plain version: out {diff} > {tol} "
                             f"or lse {lse_err}")
    del out, lse, ref, ref_lse
    turn = iter(range(10 ** 9))

    def kernel():
        kk, vv, kss, vss = at(next(turn) % copies)
        return paged_attention_kernel(q5, kk, vv, tables, lengths,
                                      k_scale_pages=kss, v_scale_pages=vss)

    row.update(arms=["kernel", "plain"], ms=graph_ms(kernel, 100),
               plain_ms=cuda_ms(lambda: k3_plain(q5, k0, v0, tables,
                                                 lengths, ks0, vs0), 3),
               library_ms=None,
               timed_by="kernel by cuda graph replay, plain by cuda events",
               **k3_bound(v))
    row["kv_gb_per_s"] = row["bytes"] / (row["ms"] * 1e-3) / 1e9
    return row


def sweep(variants: list[dict], dev, rec: dict, out: str | None) -> dict:
    """Hold and time each of ``variants`` in turn into ``rec["variants"]``
    (a failed variant records its error), writing ``rec`` to ``out``
    after every variant; ``rec["failed"]`` names the failures."""
    from idunno_tpu_torch.tools import write

    rows = rec.setdefault("variants", [])
    failed = rec.setdefault("failed", [])
    for v in variants:
        row = dict(v)
        try:
            row.update((measure_k2 if v["kernel"] == "K2" else measure_k3)(
                v, dev))
        except (AssertionError, RuntimeError, ValueError) as e:
            row["error"] = f"{type(e).__name__}: {e}"
            failed.append(v["variant"])
        rows.append(row)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if out is not None:
            write(rec, out)
    return rec


def main(argv: list[str] | None = None) -> int:
    import json

    from idunno_tpu_torch.tools import device, parser, stamp, write

    ap = parser(__doc__.splitlines()[0], out="flash_sweep_torch.json")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    if dev is None:
        return 2
    variants = k2_variants(args.cpu) + paged_variants(args.cpu)
    rec = stamp({"tool": "flash_sweep", "variants": [], "failed": []}, dev)
    if dev.type == "cuda":
        from idunno_tpu_torch.ops import cuda_build
        cuda_build.build(["flash_attention", "paged_attention"])
    write(rec, args.out)
    sweep(variants, dev, rec, args.out)
    rec["ok"] = not rec["failed"]
    write(rec, args.out)
    print(json.dumps({"out": args.out, "device": rec["device"],
                      "variants": len(rec["variants"]),
                      "failed": rec["failed"], "ok": rec["ok"]}))
    return 0 if rec["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
