"""Plain reference of decentralized training with Prox-LEAD (Li, Liu and
Tang, "Decentralized Composite Optimization with Compression",
arXiv:2108.04448, Algorithm 1) and b-bit QInf compression (its eq. 21).

N nodes each hold a copy X_i of the model, a dual D_i and a compression
state H_i; W_k is the mixing matrix of round k (k = 1, 2, ..., round k of
a cycle of T matrices is W_{k mod T}).  One step, on every leaf:

    Z    = X - eta G - eta D           G: each node's gradient
    Q    = C(Z - H)                    C: QInf, per node, in row blocks
    Zh   = H + Q,   Zh_w = W_k Zh
    H    = H + alpha Q
    D    = D + gamma / (2 eta) (Zh - Zh_w)
    X    = prox_{eta r}(Z - gamma / 2 (Zh - Zh_w))

The prox of r = lam ||x||_1 is soft thresholding at eta lam.  QInf:
a leaf's last dim is cut into blocks of ``block`` (the last dim itself
where it is even and narrower), zero-padded; in each block with
max |x| = m, code = sign(x) min(floor(2^(b-1) |x| / m + u), 2^(b-1)) for a
uniform u, and Q = code m / 2^(b-1).  Each node's block ships its codes in
b + 1 bits (a nibble up to 3 bits, else a byte) and a 4-byte scale.

Everything here is float32 with the products of the model in the
``Precision`` asked for; nothing of the program is imported.
"""
from __future__ import annotations

from typing import Callable, List, Sequence

import numpy as np
import torch

from perfbench.reference import common as C


# ----------------------------------------------------------------- graphs

def ring(n: int) -> np.ndarray:
    """Each node averages itself and its two ring neighbours, 1/3 each."""
    W = np.zeros((n, n))
    for i in range(n):
        for j in (i - 1, i, i + 1):
            W[i, j % n] = 1.0 / 3.0
    return W


def exponential(n: int) -> np.ndarray:
    """Node i linked to i +- 2^j (mod n), Metropolis-Hastings weights
    1 / (1 + max(deg_i, deg_j))."""
    A = np.zeros((n, n))
    s = 1
    while s < n:
        for i in range(n):
            A[i, (i + s) % n] = A[(i + s) % n, i] = 1.0
        s *= 2
    deg = A.sum(1)
    W = np.where(A > 0, 1.0 / (1 + np.maximum(deg[:, None], deg[None, :])),
                 0.0)
    W[np.diag_indices(n)] = 1.0 - W.sum(1)
    return W


GRAPHS = {"ring": ring, "exponential": exponential}


def mixing_cycle(graphs: Sequence[str], n: int) -> np.ndarray:
    """(T, n, n): the matrices of one cycle of the schedule."""
    return np.stack([GRAPHS[g](n) for g in graphs])


# ------------------------------------------------------------------ QInf

def block_of(last: int, block: int) -> int:
    return last if last % 2 == 0 and last < block else block


def noise_shape(n: int, shape, block: int):
    """The uniforms a node-stacked leaf of per-node ``shape`` takes:
    (n, *shape[:-1], blocks a row, block)."""
    shape = tuple(shape) or (1,)
    blk = block_of(shape[-1], block)
    return (n,) + shape[:-1] + (-(-shape[-1] // blk), blk)


def qinf(x: torch.Tensor, u: torch.Tensor, bits: int) -> torch.Tensor:
    """Q of every node's leaf ``x`` (n, ...) with uniforms ``u``
    (:func:`noise_shape`) -> the dequantized leaf."""
    blk = u.shape[-1]
    last = x.shape[-1] if x.dim() > 1 else 1
    xs = x.reshape(x.shape[0], -1, last) if x.dim() > 1 else x[:, None, None]
    pad = u.shape[-2] * blk - last
    if pad:
        xs = torch.nn.functional.pad(xs, (0, pad))
    xb = xs.reshape(u.shape)
    levels = float(2 ** (bits - 1))
    m = xb.abs().amax(-1, keepdim=True)
    safe = torch.where(m > 0, m, torch.ones_like(m))
    mag = torch.minimum(torch.floor(levels * xb.abs() / safe + u),
                        torch.tensor(levels, device=x.device))
    q = torch.sign(xb) * mag * (m / levels)
    q = q.reshape(x.shape[0], -1, u.shape[-2] * blk)[..., :last]
    return q.reshape(x.shape)


def payload_bits(shapes, bits: int, block: int) -> int:
    """Exact bits one node sends a neighbour in one hop: every block's
    packed codes and its 4-byte scale, over leaves of per-node
    ``shapes``."""
    per_code = 4 if bits + 1 <= 4 else 8
    total = 0
    for shape in shapes:
        shape = tuple(shape) or (1,)
        blk = block_of(shape[-1], block)
        rows = int(np.prod(shape[:-1], dtype=np.int64)) * -(-shape[-1] // blk)
        total += rows * (blk * per_code // 8 + 4)
    return 8 * total


# --------------------------------------------------------------- training

class Trainer:
    """The reference run: ``model`` a family module of
    :mod:`perfbench.reference` (``leaves``, ``node_loss``), ``cfg`` its
    configuration, ``X0`` one replica's leaves in the family's order,
    copied to every node."""

    def __init__(self, model, cfg: dict, X0: List[torch.Tensor], *,
                 n_nodes: int, eta: float, alpha: float, gamma: float,
                 lam: float, bits: int, block: int, graphs: Sequence[str],
                 precision: C.Precision) -> None:
        self.model, self.cfg, self.prec = model, cfg, precision
        self.paths = [p for p, _ in model.leaves(cfg)]
        self.N, self.eta, self.alpha, self.gamma = n_nodes, eta, alpha, gamma
        self.lam, self.bits, self.block = lam, bits, block
        dev = X0[0].device
        self.W = torch.as_tensor(mixing_cycle(graphs, n_nodes),
                                 dtype=torch.float32, device=dev)
        self.X = [x[None].repeat((n_nodes,) + (1,) * x.dim()) for x in X0]
        self.D = [torch.zeros_like(x) for x in self.X]
        self.H = [torch.zeros_like(x) for x in self.X]
        self.k = 1

    def grads(self, batch: dict):
        """(each node's loss (N,), each leaf's gradient (N, ...)):
        node by node, each its own loss's gradient."""
        losses, per_node = [], []
        for n in range(self.N):
            p = {path: x[n].detach().requires_grad_(True)
                 for path, x in zip(self.paths, self.X)}
            b = {k: v[n] for k, v in batch.items()}
            with torch.enable_grad():
                loss = self.model.node_loss(self.cfg, self.prec, p, b)
                g = torch.autograd.grad(loss, list(p.values()),
                                        allow_unused=True)
            per_node.append([torch.zeros_like(x) if gi is None else gi
                             for gi, x in zip(g, p.values())])
            losses.append(loss.detach())
            del p, loss, g
        G = [torch.stack([per_node[n][j] for n in range(self.N)])
             for j in range(len(self.paths))]
        return torch.stack(losses), G

    def step(self, batch: dict, noise: Callable[[int, tuple], torch.Tensor]):
        """One step on ``batch`` (each input (N, ...)); ``noise(j,
        shape)`` gives leaf j's uniforms.  -> (mean loss, each node's and
        leaf's gradient norm (N, leaves))."""
        losses, G = self.grads(batch)
        gnorm = torch.stack([g.flatten(1).norm(dim=1) for g in G], 1)
        W = self.W[self.k % self.W.shape[0]]
        eta, alpha, gamma = self.eta, self.alpha, self.gamma
        for j, path in enumerate(self.paths):
            x, d, h = self.X[j], self.D[j], self.H[j]
            z = x - eta * G[j] - eta * d
            G[j] = None
            u = noise(j, noise_shape(self.N, x.shape[1:], self.block))
            q = qinf(z - h, u, self.bits)
            del u
            zh = h + q
            zh_w = torch.einsum("nm,m...->n...", W, zh)
            e = zh - zh_w
            del zh, zh_w
            self.H[j] = h + alpha * q
            self.D[j] = d + gamma / (2 * eta) * e
            v = z - gamma / 2 * e
            self.X[j] = torch.sign(v) * torch.clamp(v.abs() - eta * self.lam,
                                                    min=0.0)
            del z, q, e, v
        self.k += 1
        return losses.mean(), gnorm

    def change_norms(self, X0: List[torch.Tensor]) -> torch.Tensor:
        """||X_i - X0|| of each node i and leaf -> (N, leaves)."""
        return torch.stack([(x - x0[None]).flatten(1).norm(dim=1)
                            for x, x0 in zip(self.X, X0)], 1)

    def l1_norms(self) -> torch.Tensor:
        """||X_i||_1 of each node i and leaf, summed in float64 ->
        (N, leaves)."""
        return torch.stack([torch.stack([x[i].abs().sum(dtype=torch.float64)
                                         for i in range(self.N)])
                            for x in self.X], 1)

    def state_norms(self) -> List[torch.Tensor]:
        """||D_i||, ||H_i|| and, for each matrix W_t of the cycle,
        ||(W_t H)_i|| of each node i and leaf -> [(N, leaves)]."""
        def norms(leaves):
            return torch.stack([x.flatten(1).norm(dim=1) for x in leaves], 1)
        return [norms(self.D), norms(self.H)] + [
            norms(torch.einsum("nm,m...->n...", W, h) for h in self.H)
            for W in self.W]
