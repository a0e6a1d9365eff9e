"""Per-layer roofline of the bench CNNs on the H100, beside the card's
measured forward.

The port's counterpart of ``tools/mfu_roofline.py``, which models a v5e
(197 TFLOP/s, 819 GB/s, a 128 x 128 MXU). The layer geometry
(``conv_layer``, ``resnet18_layers``, ``alexnet_layers``) is that tool's,
kept as it is. The chip model is the H100 SXM's (NVIDIA's data sheet):
989 TFLOP/s dense bf16 on the tensor cores and 3.35 TB/s of device
memory. In place of the MXU's 128-wide fill, a layer's shape ceiling is
its fill of the tensor cores' instruction tile: a convolution is an
implicit GEMM of M = batch x output positions rows, N = output channels
and K = input channels x kernel taps, and a warpgroup's ``wgmma`` works
on tiles of 64 rows, N a multiple of 8 and K a multiple of 16 (bf16), so
a dimension that is not a multiple of its tile leaves part of the last
tile idle (``TILE``). For every conv and fc layer, at a batch size: its
FLOPs, the bytes it moves (activations in and out and weights, bf16), its
arithmetic intensity, and its compute, shape and bandwidth bounds.

On the card it also times the model's forward (bf16, channels-last,
seeded weights, eval) at the same batch by CUDA events and reports the
measured MFU beside the ceiling: the subject is the ``cnn`` suite's
ResNet-18 MFU (13.7% at batch 1024 staged, PERF.md §5).

    python -m idunno_tpu_torch.tools.mfu_roofline [--model resnet18|alexnet]
        [--batch 1024] [--full] [--cpu]

With ``--cpu`` it prints the analytic rows alone (no measured arm).
"""
from __future__ import annotations

import math
import sys

PEAK_FLOPS = 989e12              # H100 SXM bf16 tensor cores, dense
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
# the tensor cores' instruction tile (wgmma, bf16): rows, columns, depth
TILE = {"m": 64, "n": 8, "k": 16}


def conv_layer(name, h, w, cin, cout, k, stride, pad=None):
    if pad is None:
        pad = k // 2
    oh = (h + 2 * pad - k) // stride + 1
    ow = (w + 2 * pad - k) // stride + 1
    return {"name": name, "oh": oh, "ow": ow, "cin": cin, "cout": cout,
            "k": k, "in_hw": (h, w)}


def resnet18_layers():
    out = [conv_layer("conv1", 224, 224, 3, 64, 7, 2, 3)]
    h = w = 56
    cin = 64
    for stage, planes in enumerate((64, 128, 256, 512)):
        for block in range(2):
            stride = 2 if stage > 0 and block == 0 else 1
            out.append(conv_layer(f"s{stage}b{block}c0", h, w, cin,
                                  planes, 3, stride))
            h, w = out[-1]["oh"], out[-1]["ow"]
            out.append(conv_layer(f"s{stage}b{block}c1", h, w, planes,
                                  planes, 3, 1))
            if stride != 1 or cin != planes:
                out.append(conv_layer(f"s{stage}b{block}ds",
                                      h * stride, w * stride, cin,
                                      planes, 1, stride, 0))
            cin = planes
    out.append({"name": "fc", "oh": 1, "ow": 1, "cin": 512, "cout": 1000,
                "k": 1, "in_hw": (1, 1)})
    return out


def alexnet_layers():
    return [
        conv_layer("conv1", 224, 224, 3, 64, 11, 4, 2),
        conv_layer("conv2", 27, 27, 64, 192, 5, 1, 2),
        conv_layer("conv3", 13, 13, 192, 384, 3, 1, 1),
        conv_layer("conv4", 13, 13, 384, 256, 3, 1, 1),
        conv_layer("conv5", 13, 13, 256, 256, 3, 1, 1),
        {"name": "fc1", "oh": 1, "ow": 1, "cin": 9216, "cout": 4096,
         "k": 1, "in_hw": (1, 1)},
        {"name": "fc2", "oh": 1, "ow": 1, "cin": 4096, "cout": 4096,
         "k": 1, "in_hw": (1, 1)},
        {"name": "fc3", "oh": 1, "ow": 1, "cin": 4096, "cout": 1000,
         "k": 1, "in_hw": (1, 1)},
    ]


def _fill(n: int, tile: int) -> float:
    """The used share of ``n`` rounded up to whole tiles."""
    return n / (math.ceil(n / tile) * tile)


def analyze(layers, batch):
    rows, t_comp_total, t_bw_total, flops_total = [], 0.0, 0.0, 0.0
    t_shape_total = 0.0
    for l in layers:
        contraction = l["cin"] * l["k"] * l["k"]
        m = batch * l["oh"] * l["ow"]
        flops = 2.0 * m * l["cout"] * contraction
        act_in = batch * l["in_hw"][0] * l["in_hw"][1] * l["cin"] * 2.0
        act_out = batch * l["oh"] * l["ow"] * l["cout"] * 2.0
        weights = contraction * l["cout"] * 2.0
        bytes_ = act_in + act_out + weights
        fill = (_fill(m, TILE["m"]) * _fill(l["cout"], TILE["n"])
                * _fill(contraction, TILE["k"]))
        t_comp = flops / PEAK_FLOPS
        t_shape = flops / (PEAK_FLOPS * fill)
        t_bw = bytes_ / HBM_BYTES_PER_S
        rows.append({
            "layer": l["name"], "flops": flops, "bytes": bytes_,
            "intensity_flops_per_byte": flops / bytes_,
            "tile_fill": fill,
            "bound": ("bw" if t_bw > t_shape else "tile-shape"
                      if fill < 0.99 else "compute"),
            "t_us_compute": t_comp * 1e6,
            "t_us_shape_ceiling": t_shape * 1e6,
            "t_us_bandwidth": t_bw * 1e6,
        })
        flops_total += flops
        t_comp_total += t_comp
        t_bw_total += t_bw
        t_shape_total += max(t_shape, t_bw)
    return {"batch": batch, "total_flops": flops_total,
            "ideal_time_us": t_comp_total * 1e6,
            "achievable_time_us": t_shape_total * 1e6,
            "mfu_ceiling_from_shape_and_bw": t_comp_total / t_shape_total,
            "implied_images_per_s_at_ceiling": batch / t_shape_total,
            "layers": rows}


def measure(model: str, batch: int, flops: float) -> dict:
    """The model's forward on the card at ``batch`` (bf16 compute,
    channels-last, seeded weights, eval), by CUDA events: ms, images/s
    and MFU against ``PEAK_FLOPS``."""
    import torch

    from idunno_tpu_torch.models import create_model
    from idunno_tpu_torch.utils.tracing import cuda_ms

    net = create_model("resnet" if model == "resnet18" else model,
                       compute_dtype=torch.bfloat16)
    net.init_weights(torch.Generator().manual_seed(0))
    net = net.to("cuda", memory_format=torch.channels_last).eval()
    x = torch.randn((batch, 3, 224, 224), device="cuda").to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    with torch.inference_mode():
        ms = cuda_ms(lambda: net(x), 10)
    return {"forward_ms": ms, "images_per_s": batch / (ms * 1e-3),
            "measured_mfu": flops / (ms * 1e-3) / PEAK_FLOPS,
            "timed_by": "cuda events, 10 forwards after 3"}


def main(argv: list[str] | None = None) -> int:
    import json

    from idunno_tpu_torch.tools import device, parser, stamp

    ap = parser(__doc__.splitlines()[0])
    ap.add_argument("--model", default="resnet18",
                    choices=["resnet18", "alexnet"])
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--full", action="store_true",
                    help="print per-layer rows, not just the summary")
    args = ap.parse_args(argv)
    dev = device(args.cpu)
    if dev is None:
        return 2
    layers = (resnet18_layers() if args.model == "resnet18"
              else alexnet_layers())
    rep = analyze(layers, args.batch)
    if dev.type == "cuda":
        rep["measured"] = measure(args.model, args.batch,
                                  rep["total_flops"])
    if not args.full:
        rep = {k: v for k, v in rep.items() if k != "layers"}
    print(json.dumps(stamp({"model": args.model, **rep}, dev)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
