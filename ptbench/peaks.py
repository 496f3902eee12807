"""Published peaks of the chips the benchmark runs on (NVIDIA's data
sheet, SXM part, dense rates without sparsity).  A roofline or `mfu`
share is taken against these, with the card's power limit printed beside
the run."""

H100 = {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}


def peaks(device_name: str) -> dict | None:
    """The peak table of a card by `torch.cuda.get_device_name()`, or None
    for a card the table does not hold (its shares are then not
    reported)."""
    return H100 if "H100" in device_name else None
