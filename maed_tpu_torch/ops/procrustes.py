"""Batched orthogonal-Procrustes / similarity alignment on the device.

Port of ``maed_tpu/ops/procrustes.py``: one batched SVD of the (B, 3, 3)
cross-covariances, so PA-MPJPE runs wholly on the card. The 3x3 products are
plain f32 (or f64) products; callers keep TF32 off
(``torch.backends.cuda.matmul.allow_tf32``, False by default), as the JAX
package pins them to ``Precision.HIGHEST``.
"""

from __future__ import annotations

import torch


def batch_similarity_transform(S1: torch.Tensor, S2: torch.Tensor) -> torch.Tensor:
    """Aligns S1 to S2 with the optimal similarity transform (s, R, t).

    S1, S2: (B, N, 3) point sets. Returns S1_hat (B, N, 3) = s*R@S1 + t.
    A constant S1 (zero variance) gives NaN, as in the JAX package.
    """
    # Work in (B, 3, N) like the classic formulation.
    X1 = S1.transpose(-1, -2)
    X2 = S2.transpose(-1, -2)

    mu1 = X1.mean(dim=-1, keepdim=True)
    mu2 = X2.mean(dim=-1, keepdim=True)
    X1c = X1 - mu1
    X2c = X2 - mu2

    var1 = (X1c ** 2).sum(dim=(-2, -1))

    K = torch.matmul(X1c, X2c.transpose(-1, -2))  # (B, 3, 3)

    # U and V come with other signs than LAPACK's from another backend; R does
    # not depend on them while the singular values are distinct.
    U, _, Vh = torch.linalg.svd(K)
    V = Vh.transpose(-1, -2)

    # Fix orientation so det(R) = +1: the sign goes on the last diagonal entry.
    Z = torch.eye(3, dtype=S1.dtype, device=S1.device).expand(K.shape).clone()
    Z[..., -1, -1] = torch.sign(torch.linalg.det(torch.matmul(U, Vh)))

    R = torch.matmul(V, torch.matmul(Z, U.transpose(-1, -2)))

    scale = torch.matmul(R, K).diagonal(dim1=-2, dim2=-1).sum(-1) / var1
    t = mu2 - scale[..., None, None] * torch.matmul(R, mu1)

    S1_hat = scale[..., None, None] * torch.matmul(R, X1) + t
    return S1_hat.transpose(-1, -2)
