"""Published dense peaks of the cards the benchmark knows, by a substring
of ``torch.cuda.get_device_name()`` (NVIDIA's data sheets, without
sparsity, at the full power limit).  One yardstick for every precision:
the bf16 tensor-core rate, which no f32 work can reach either."""

PEAKS = {
    "H100": {"flops": 989e12, "bytes_per_s": 3.35e12},  # SXM, bf16 dense
}


def peak_of(device_name: str) -> dict:
    """The peaks of the card ``device_name``; raises for an unknown card
    (no default would mean anything)."""
    for key, peak in PEAKS.items():
        if key.lower() in device_name.lower():
            return peak
    raise ValueError(f"no published peak for {device_name!r} in "
                     f"portbench/peaks.py")
