"""The paper's experiment data: non-iid multinomial logistic regression.

``make_logreg_data`` is the reference's numpy generator, copied, so a seed
gives the same arrays in both packages.  The problems put the data on the
run's device in the run's dtype and compute gradients in closed form for
all nodes and batches at once (the reference differentiates per node and
vmaps):

    f_ij(X) = CE(softmax(A_ij X), Y_ij) + lam2 ||X||^2,   X: (p, C)
    grad    = A_ij^T (softmax(A_ij X) - Y_ij) / bs + 2 lam2 X

(Y one-hot, so sum_c Y = 1).  The l1 term goes through the prox.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch import registry
from repro_torch.core.oracles import FiniteSumProblem


def make_logreg_data(n_nodes: int = 8, n_per_node: int = 750,
                     n_features: int = 784, n_classes: int = 10,
                     n_batches: int = 15, seed: int = 0,
                     noniid: bool = True) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic MNIST-like data: class-conditional Gaussians on a random
    low-dim manifold, SORTED BY LABEL across nodes (each node sees only
    ~1-2 classes).  Returns A (n, m, bs, p) and one-hot Y (n, m, bs, C)."""
    rng = np.random.default_rng(seed)
    total = n_nodes * n_per_node
    latent = 32
    protos = rng.normal(size=(n_classes, latent)) * 2.0
    lift = rng.normal(size=(latent, n_features)) / np.sqrt(latent)
    labels = rng.integers(0, n_classes, size=total)
    z = protos[labels] + rng.normal(size=(total, latent)) * 0.8
    X = z @ lift + rng.normal(size=(total, n_features)) * 0.3
    X = X / np.linalg.norm(X, axis=1, keepdims=True)

    if noniid:
        order = np.argsort(labels, kind="stable")    # label-sorted split
    else:
        order = rng.permutation(total)
    X, labels = X[order], labels[order]

    bs = n_per_node // n_batches
    A = X.reshape(n_nodes, n_batches, bs, n_features)
    Y = np.eye(n_classes)[labels].reshape(n_nodes, n_batches, bs, n_classes)
    return A, Y


def logreg_problem(*, device, dtype: torch.dtype, lam2: float = 0.005,
                   **kw) -> FiniteSumProblem:
    """FiniteSumProblem for the paper's l2-regularized logistic regression.
    Iterates may be (n, p, C) or flattened (n, p*C); gradients take the
    iterate's shape."""
    A, Y = make_logreg_data(**kw)
    n, m, _, p = A.shape
    C = Y.shape[-1]
    data = {"A": torch.as_tensor(A, dtype=dtype, device=device),
            "Y": torch.as_tensor(Y, dtype=dtype, device=device)}

    def weights(X):
        return X.reshape(X.shape[0], 1, p, C)        # (n, 1, p, C)

    def grad_batches(X, batch):
        Xw, Ab = weights(X), batch["A"]
        P = torch.softmax(Ab @ Xw, dim=-1)           # (n, k, bs, C)
        G = Ab.transpose(-1, -2) @ (P - batch["Y"]) / Ab.shape[-2] \
            + 2 * lam2 * Xw                          # (n, k, p, C)
        return G.reshape(G.shape[:2] + X.shape[1:])

    def loss_batches(X, batch):
        Xw = weights(X)
        logp = torch.log_softmax(batch["A"] @ Xw, dim=-1)
        ce = -(batch["Y"] * logp).sum(-1).mean(-1)   # (n, k)
        return ce + lam2 * (Xw ** 2).sum(dim=(-2, -1))

    return FiniteSumProblem(grad_batches, data, n, m, loss_batches)


# Registered problem factories (api.OracleSpec.problem).  Contract:
# factory(n_nodes, device, dtype, **params) -> (FiniteSumProblem, X0) with
# X0 the stacked zero iterate the runners start from.

@registry.register_problem("logreg")
def _logreg_flat_problem(n_nodes: int = 8, n_features: int = 784,
                         n_classes: int = 10, n_per_node: int = 150,
                         n_batches: int = 15, lam2: float = 0.005,
                         seed: int = 0, noniid: bool = True, *,
                         device="cpu", dtype=torch.float32):
    """Paper §5 logistic regression over FLATTENED (p*C,) parameters, the
    shape every dense example runs."""
    prob = logreg_problem(device=device, dtype=dtype, lam2=lam2,
                          n_nodes=n_nodes, n_per_node=n_per_node,
                          n_features=n_features, n_classes=n_classes,
                          n_batches=n_batches, seed=seed, noniid=noniid)
    X0 = torch.zeros((n_nodes, n_features * n_classes), dtype=dtype,
                     device=device)
    return prob, X0


@registry.register_problem("logreg2d")
def _logreg_2d_problem(n_nodes: int = 8, n_features: int = 50,
                       n_classes: int = 5, n_per_node: int = 40,
                       n_batches: int = 5, lam2: float = 0.05,
                       seed: int = 0, noniid: bool = True, *,
                       device="cpu", dtype=torch.float32):
    """Logistic regression with natural (p, C) iterates (blockwise
    quantization runs along the class axis)."""
    prob = logreg_problem(device=device, dtype=dtype, lam2=lam2,
                          n_nodes=n_nodes, n_per_node=n_per_node,
                          n_features=n_features, n_classes=n_classes,
                          n_batches=n_batches, seed=seed, noniid=noniid)
    X0 = torch.zeros((n_nodes, n_features, n_classes), dtype=dtype,
                     device=device)
    return prob, X0
