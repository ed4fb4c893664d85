"""Softmax attention of ``groups`` independent sets of ``S`` queries over
``S`` keys of head dim ``d``: the score and the mixing products."""


def flops(groups: int, S: int, d: int) -> int:
    return 4 * groups * S * S * d


def nbytes(groups: int, S: int, d: int, es: int) -> int:
    """q, k and v read once, the output written once."""
    return 4 * groups * S * d * es
