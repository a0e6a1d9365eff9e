"""Published peaks of the cards the benchmark knows, by a substring of
``torch.cuda.get_device_name()``.

NVIDIA's H100 SXM data sheet, dense rates without sparsity, at the full
700 W power limit: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in
f32 outside them, 3.35 TB/s of HBM3. A card run below 700 W is still held
against these; the run records its power limit beside the shares.
"""
from __future__ import annotations

PEAKS = {
    "H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                       "hbm_bytes_per_s": 3.35e12},
    "H100 SXM": {"bf16_flops": 989e12, "f32_flops": 67e12,
                 "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name: str) -> dict | None:
    """The peaks of the card named ``device_name``; None for a card not in
    the table (its shares are then left out, never guessed)."""
    for key, val in PEAKS.items():
        if key.lower() in device_name.lower():
            return val
    return None


def least_seconds(flops: float, nbytes: float, peaks: dict) -> float:
    """The least time the card could take for ``flops`` operations (on the
    bf16 tensor cores) and ``nbytes`` of HBM traffic: the larger of the
    two bounds."""
    return max(flops / peaks["bf16_flops"], nbytes / peaks["hbm_bytes_per_s"])
