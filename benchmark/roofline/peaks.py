"""Published peaks by card (NVIDIA's data sheets, dense rates, no
sparsity), keyed by ``torch.cuda.get_device_name()``. They assume the
card's full power limit; a run prints the limit it found beside them."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {  # SXM5, 700 W
        "f32_flops": 67e12,
        "tf32_flops": 495e12,
        "bf16_flops": 989e12,
        "hbm_bytes_per_s": 3.35e12,
    },
    "NVIDIA H100 PCIe": {  # 350 W
        "f32_flops": 51e12,
        "tf32_flops": 378e12,
        "bf16_flops": 756e12,
        "hbm_bytes_per_s": 2.0e12,
    },
}


def peak(kind: str, what: str):
    """A card's peak, or None for a card the table does not know."""
    return PEAKS.get(kind, {}).get(what)
