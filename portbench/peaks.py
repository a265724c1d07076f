"""The chip's peaks, the one place the benchmark takes them from.

Published dense rates of one NVIDIA H100 SXM at its 700 W power limit
(NVIDIA's data sheet). Every roofline share and ``mfu`` reading divides by
these; the card's power limit is printed beside them, since a card held
below 700 W runs slower under load.

float32 work is held against 495 TFLOP/s, the TF32 tensor-core rate. No
way of computing a float32 product on this card runs faster: 3xTF32 (three
TF32 products per float32 one, as the port's kernels do it) runs at a third
of that, a bf16 split at half of the bf16 rate or less, and the CUDA cores'
FFMA at 67 TFLOP/s. So no correct float32 kernel can read over 100%, which
a peak taken from one implementation's rate (3xTF32's 165, FFMA's 67) would
allow.
"""

FLOPS = {"float32": 495e12, "bfloat16": 989e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(flops: float, nbytes: float, precision: str) -> float:
    """The least time the chip could take: the larger of operations over
    the peak rate and bytes over the memory bandwidth."""
    return max(flops / FLOPS[precision], nbytes / HBM_BYTES_PER_S)
