"""The card's published peaks, by ``torch.cuda.get_device_name()``.

NVIDIA's H100 SXM data sheet, dense rates, at the full 700 W power
limit: a card set below it runs slower under load, so every result
carries its card's limit beside these. A card not in the table has no
roofline: its readers read nothing.
"""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_s": 3.35e12,
        "bf16_flop_s": 989e12,
        "int8_op_s": 1979e12,
    },
}


def peaks(kind: str) -> "dict | None":
    return PEAKS.get(kind)
