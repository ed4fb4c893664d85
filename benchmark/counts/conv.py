"""A 2D convolution: its operations and its output size."""


def out_size(size: int, stride: int) -> int:
    """Output side of a "SAME" (or k // 2 padded, odd k) window of ``stride``."""
    return -(-size // stride)


def flops(batch: int, c_in: int, c_out: int, k: int, out_hw: int) -> int:
    """2 x multiply-adds: each output element sums c_in * k * k products."""
    return 2 * batch * c_out * out_hw * out_hw * c_in * k * k
