"""Published peaks of one NVIDIA H100 SXM (data sheet, dense rates, at the
700 W power limit). A card set below 700 W runs slower under load: the run
records the card's power limit beside every share of these peaks."""

FLOPS = {
    "float32": 67e12,   # outside the tensor cores: float32 with TF32 off
    "tf32": 495e12,
    "bfloat16": 989e12,
    "fp8": 1979e12,
}
HBM_BYTES_PER_S = 3.35e12
#: NVLink of one H100 SXM in one direction (900 GB/s both ways): every
#: reduced byte of an all-reduce has to arrive at each rank over it
NVLINK_BYTES_PER_S = 450e9


def least_seconds(ops) -> float:
    """The least time the card could take over `ops` (from `_flops.step_ops`):
    for each, the larger of its operations over the peak of its dtype and
    its bytes over the memory bandwidth."""
    return sum(max(o["flops"] / FLOPS[o["dtype"]], o["bytes"] / HBM_BYTES_PER_S) for o in ops)
