"""A normalization (LayerNorm, GroupNorm) over ``elements`` values: bound by
its bytes (the input, an optional residual, read once; the output written
once); its few operations an element are not counted."""


def nbytes(elements: int, es: int, residual: bool = False) -> int:
    return (3 if residual else 2) * elements * es
