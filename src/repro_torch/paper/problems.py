"""Small strongly convex decentralized instances with a known optimum.

The port's copy of ``tests/problems.py::ridge_problem``: the data comes
from one seeded numpy generator, so it is the reference's array for array;
the gradients are written for all nodes and batches at once.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.oracles import FiniteSumProblem


def ridge_problem(n=8, m=5, bs=4, p=20, lam2=0.1, het=0.3, noise=0.01,
                  seed=0, *, device="cpu", dtype=torch.float64):
    """Heterogeneous decentralized ridge regression with a closed-form
    optimum.  Returns (problem, xstar (p,) numpy, mu, L, X0 (n, p))."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, m, bs, p))
    A = A + rng.normal(size=(n, 1, 1, p)) * het      # non-iid nodes
    xtrue = rng.normal(size=(p,))
    b = np.einsum("nmbp,p->nmb", A, xtrue) + noise * rng.normal(size=(n, m, bs))
    data = {"A": torch.as_tensor(A, dtype=dtype, device=device),
            "b": torch.as_tensor(b, dtype=dtype, device=device)}

    def residual(X, batch):                           # (n, k, bs)
        return (batch["A"] @ X[:, None, :, None])[..., 0] - batch["b"]

    def grad_batches(X, batch):                       # (n, k, p)
        r = residual(X, batch)
        return (batch["A"].transpose(-1, -2) @ r[..., None])[..., 0] / bs \
            + lam2 * X[:, None]

    def loss_batches(X, batch):                       # (n, k)
        r = residual(X, batch)
        return 0.5 * (r ** 2).sum(-1) / bs \
            + 0.5 * lam2 * (X ** 2).sum(-1)[:, None]

    prob = FiniteSumProblem(grad_batches, data, n, m, loss_batches)

    AA = np.einsum("nmbp,nmbq->pq", A, A) / (m * bs) / n + lam2 * np.eye(p)
    Ab = np.einsum("nmbp,nmb->p", A, b) / (m * bs) / n
    xstar = np.linalg.solve(AA, Ab)

    Ls = [float(np.linalg.eigvalsh(
        np.einsum("mbp,mbq->pq", A[i], A[i]) / (m * bs)).max()) + lam2
        for i in range(n)]
    return prob, xstar, lam2, max(Ls), torch.zeros((n, p), dtype=dtype,
                                                  device=device)
