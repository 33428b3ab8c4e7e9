"""The table of peaks and the byte arithmetic of a roofline share.

The least time a call can take is its bytes over the card's memory
bandwidth, counting each input byte read once and each output byte written
once: for a compress the input and the frame it became, for a decompress
the frame and the decoded bytes. It counts bytes of the cell's data only,
never instructions of today's kernels (chip_smoke.py's encode_bound and
decode_bound add an integer-op term per byte, which moves with the kernel
it measures), so a kernel that does the same work another way is held to
the same yardstick.
"""

# bytes per second of HBM, by torch.cuda.get_device_name(); NVIDIA's data
# sheet of the H100 SXM (80 GB HBM3, 3.35 TB/s)
HBM_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}


def least_seconds(read_bytes: int, written_bytes: int, device_kind: str):
    """The least time the card can move these bytes in, or None for a card
    the table does not hold."""
    bw = HBM_BYTES_PER_S.get(device_kind)
    if bw is None:
        return None
    return (read_bytes + written_bytes) / bw


def share_pct(read_bytes: int, written_bytes: int, device_kind: str,
              kernel_s: float):
    """The roofline share in %: least time over the time the card spent in
    kernels; None when either is unknown or no kernel ran."""
    least = least_seconds(read_bytes, written_bytes, device_kind)
    if least is None or not kernel_s:
        return None
    return 100.0 * least / kernel_s
