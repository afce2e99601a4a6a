"""Batched alternating least squares for comparison-matrix factorization.

Frozen copy of the plain PyTorch version in ``md_rdm_tpu_torch``, the
port of ``md_rdm_tpu/ops/als.py``.  The factors p, q are rank-1 vectors, so
each ridge solve ``(F^T F + 0.05)^{-1}`` is a scalar reciprocal and an ALS
step is one batched matrix-vector product.  The loop is a Python loop of
tensor operations with no host synchronisation inside: the best iterate is
carried as a running (best_p, best_rmse) pair, chosen with ``torch.where``
on device tensors (first minimum, strict ``<``, as the reference).

Faithful quirks kept:

* the q-step uses ``sparse.reshape(n, w, h)``, a reshape and not a
  transpose;
* the result is normalized by ``exp(sum(log p) / h^2)``
  (:func:`_quick_gm_pow`), the reference's exponent for an h-entry vector.

The RMSE that selects the iterate is pooled per *group* of matrices
(:func:`als_factorize_grouped`); the plain entry points pool over the whole
batch, which is one group.  The group sums come from a product with a
one-hot (groups, matrices) matrix: deterministic on the card, where a
scatter-add would sum in a different order from run to run and could move
the choice between iterates whose RMSE ties.
"""
from __future__ import annotations

import torch


def _als_step(ratings: torch.Tensor, fixed: torch.Tensor,
              reg: float = 0.05) -> torch.Tensor:
    """One ridge update: (ratings @ fixed) / (fixed^T fixed + reg).
    ratings (B, R, C), fixed (B, C, 1) -> (B, R, 1)."""
    denom = (fixed * fixed).sum(dim=(1, 2), keepdim=True) + reg
    return torch.matmul(ratings, fixed) / denom


def _quick_gm_pow(p: torch.Tensor, rc: int) -> torch.Tensor:
    """exp(sum(log p) / rc^2) over axis 1: the reference's quick_gm."""
    return torch.exp(torch.log(p).sum(dim=1, keepdim=True) / (rc * rc))


def als_factorize_grouped(sparse: torch.Tensor, out_size: int,
                          num_iters: int, group_ids: torch.Tensor,
                          num_groups: int) -> torch.Tensor:
    """ALS over (N, H, W) matrices from several decoders in one loop; the
    best iterate is chosen per group, with the RMSE pooled over the
    group's matrices.  ``group_ids`` (N,) int in [0, num_groups).  Returns
    (N, 1, out_size, out_size) maps."""
    n, h, w = sparse.shape
    sparse = sparse.float()
    sparse_r = sparse.reshape(n, w, h)          # faithful reshape
    gid = torch.as_tensor(group_ids, device=sparse.device).long()
    onehot = (gid[None, :] == torch.arange(
        num_groups, device=sparse.device)[:, None]).float()   # (G, N)
    denom = onehot.sum(1) * (h * w)

    def group_rmse(pred):
        sq = ((pred - sparse) ** 2).sum(dim=(1, 2))
        return torch.sqrt((onehot @ sq) / denom)

    p = torch.ones((n, h, 1), device=sparse.device)
    q = torch.ones((n, w, 1), device=sparse.device)
    best_p = p
    best_r = group_rmse(torch.matmul(p, q.reshape(n, 1, w)))
    for _ in range(num_iters):
        p = _als_step(sparse, q)
        r = group_rmse(torch.matmul(p, q.reshape(n, 1, w)))
        take = r < best_r                                   # (G,)
        best_p = torch.where(take[gid][:, None, None], p, best_p)
        best_r = torch.where(take, r, best_r)
        q = _als_step(sparse_r, p)
    best_p = best_p / _quick_gm_pow(best_p, h)
    return best_p.reshape(n, 1, out_size, out_size)


def als_factorize(sparse: torch.Tensor, out_size: int,
                  num_iters: int) -> torch.Tensor:
    """ALS over (B, H, W) matrices with the RMSE pooled over the batch ->
    (B, 1, out, out) maps; square (quadratic) or rectangular."""
    gid = torch.zeros(sparse.shape[0], dtype=torch.long, device=sparse.device)
    return als_factorize_grouped(sparse, out_size, num_iters, gid, 1)


def quadratic_als(sparse: torch.Tensor, n: int = 3,
                  num_iters: int = 30) -> torch.Tensor:
    """Square ALS: (B, 4^n, 4^n) -> (B, 1, 2^n, 2^n)."""
    return als_factorize(sparse, 2 ** n, num_iters)


def alternating_least_squares(sparse: torch.Tensor, n: int = 4,
                              num_iters: int = 100) -> torch.Tensor:
    """Rectangular ALS: (B, 4^n, 4^(n-1)) -> (B, 1, 2^n, 2^n)."""
    return als_factorize(sparse, 2 ** n, num_iters)
