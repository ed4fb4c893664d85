"""A dense layer (a matmul of rows by a weight): operations and bytes."""


def flops(rows: int, n_in: int, n_out: int) -> int:
    return 2 * rows * n_in * n_out


def nbytes(rows: int, n_in: int, n_out: int, es: int) -> int:
    """The input rows and the weight read once, the output written once."""
    return (rows * n_in + n_in * n_out + rows * n_out) * es
