"""Convex copy-number balancing: the port of ``coral_tpu/graph/cn_solver.py``.

The program (reference ``src/breakpoint_graph.py:495-606``) is

    minimize    f(x) = sum_i wlrseg_i / x_i + wcn_i * x_i - wlncn_i * log x_i
    subject to  A x = 0,  x > 0

with x = CN/2 per edge and A the per-node flow-balance matrix, solved by
the damped-Newton KKT iteration of the JAX package.  Engines:

* ``numpy``: float64 on the host, re-homed unchanged (the JAX module
  imports JAX when it loads);
* ``torch``: the same iteration in float64 on an explicit device.  The
  JAX module's f32-LU + refinement solve (``_kkt_solve(mixed=True)``)
  exists because the TPU has no f64 LU; CUDA does, so it is not ported.

``auto`` resolves to ``numpy``: amplicon systems are tens to hundreds of
edges, which the host solves in microseconds.  A batched device engine is
later work.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device


def _newton_numpy(wlrseg, wcn, wlncn, A, max_iters=1000, tol=1e-9):
    """float64 host implementation of the damped-Newton KKT iteration
    (``coral_tpu.graph.cn_solver._newton_numpy``)."""
    n = len(wcn)
    m = A.shape[0]

    def grad(x):
        return wcn - wlncn / x - wlrseg / (x * x)

    def residual(x, y):
        return np.concatenate([grad(x) + A.T @ y, A @ x])

    x = np.ones(n)
    y = np.zeros(m)
    r_prev = np.inf
    for _ in range(max_iters):
        r = np.linalg.norm(residual(x, y))
        # absolute tol, or residual plateau: coverage-scale systems bottom
        # out at ~1e-17 relative, far above an absolute 1e-9
        if r <= tol or r >= r_prev * (1 - 1e-4):
            break
        r_prev = r
        h = np.maximum(wlncn / x ** 2 + 2.0 * wlrseg / x ** 3, 1e-8)
        K = np.zeros((n + m, n + m))
        K[:n, :n] = np.diag(h)
        K[:n, n:] = A.T
        K[n:, :n] = A
        K[n:, n:] = -1e-10 * np.eye(m)
        rhs = np.concatenate([-grad(x), -(A @ x)])
        sol = np.linalg.solve(K, rhs)
        dx, y_new = sol[:n], sol[n:]
        t = 1.0
        while t > 1e-12:
            x_t = x + t * dx
            if np.min(x_t) > 0 and np.linalg.norm(residual(x_t, y_new)) \
                    <= (1 - 0.01 * t) * r + tol:
                break
            t *= 0.5
        if t <= 1e-12:
            break
        x = x + t * dx
        y = y_new
    return x


def _newton_torch(wlrseg, wcn, wlncn, A, max_iters=1000, tol=1e-9, *,
                  device):
    """:func:`_newton_numpy` in torch float64 on ``device``: the same
    iteration, stopping rules and line search step for step.  The dense
    LU solve and the norms sum in another order than numpy's, so results
    agree to rounding, not bit for bit."""
    dev = resolve_device(device)
    f64 = torch.float64
    wlrseg, wcn, wlncn, A = (torch.as_tensor(a, dtype=f64, device=dev)
                             for a in (wlrseg, wcn, wlncn, A))
    n = wcn.shape[0]
    m = A.shape[0]

    def grad(x):
        return wcn - wlncn / x - wlrseg / (x * x)

    def residual(x, y):
        return torch.cat([grad(x) + A.T @ y, A @ x])

    K = torch.zeros((n + m, n + m), dtype=f64, device=dev)
    K[:n, n:] = A.T
    K[n:, :n] = A
    K[n:, n:] = -1e-10 * torch.eye(m, dtype=f64, device=dev)
    x = torch.ones(n, dtype=f64, device=dev)
    y = torch.zeros(m, dtype=f64, device=dev)
    r_prev = float("inf")
    for _ in range(max_iters):
        r = float(torch.linalg.norm(residual(x, y)))
        if r <= tol or r >= r_prev * (1 - 1e-4):
            break
        r_prev = r
        h = torch.clamp(wlncn / x ** 2 + 2.0 * wlrseg / x ** 3, min=1e-8)
        K[:n, :n] = torch.diag(h)
        rhs = torch.cat([-grad(x), -(A @ x)])
        sol = torch.linalg.solve(K, rhs)
        dx, y_new = sol[:n], sol[n:]
        t = 1.0
        while t > 1e-12:
            x_t = x + t * dx
            if float(x_t.min()) > 0 and float(torch.linalg.norm(
                    residual(x_t, y_new))) <= (1 - 0.01 * t) * r + tol:
                break
            t *= 0.5
        if t <= 1e-12:
            break
        x = x + t * dx
        y = y_new
    return x.cpu().numpy()


def resolve_cn_engine(engine: str) -> str:
    """``auto`` -> ``numpy`` (tiny systems; see the module docstring);
    any other engine is returned as given."""
    return "numpy" if engine == "auto" else engine


def solve_cn_balance(wlrseg, wcn, wlncn, A, max_iters: int = 1000,
                     engine: str = "auto", *, device) -> np.ndarray:
    """Solve the balance program; returns x (CN/2 per edge).  ``engine``:
    ``numpy`` (f64 host), ``torch`` (f64 on ``device``) or ``auto``."""
    wlrseg = np.asarray(wlrseg, np.float64)
    wcn = np.asarray(wcn, np.float64)
    wlncn = np.asarray(wlncn, np.float64)
    A = np.asarray(A, np.float64).reshape(-1, len(wcn))
    engine = resolve_cn_engine(engine)
    if engine == "numpy":
        return _newton_numpy(wlrseg, wcn, wlncn, A, max_iters)
    if engine == "torch":
        return _newton_torch(wlrseg, wcn, wlncn, A, max_iters, device=device)
    raise ValueError(f"unknown CN engine {engine!r} (auto, numpy, torch)")


def _balance_matrix(g, nvars: int):
    """Per-node flow-balance matrix (None when no non-end nodes exist)."""
    lseq = len(g.sequence_edges)
    lc = len(g.concordant_edges)
    ld = len(g.discordant_edges)
    balance_nodes = [nd for nd in g.nodes if nd not in g.endnodes]
    if not balance_nodes:
        assert lc == 0 and ld == 0 and len(g.source_edges) == 0
        return None
    A = np.zeros((len(balance_nodes), nvars))
    for ci, nd in enumerate(balance_nodes):
        adj = g.nodes[nd]
        for si in adj[0]:
            A[ci][si] = 1
        for eci in adj[1]:
            A[ci][lseq + eci] = -1
        for edi in adj[2]:
            A[ci][lseq + lc + edi] = -1
        for srci in adj[3]:
            A[ci][lseq + lc + ld + srci] = -1
    return A


def _write_cn(g, x) -> None:
    """Write a solution x (CN/2 per edge) back onto the graph's edges."""
    lseq = len(g.sequence_edges)
    lc = len(g.concordant_edges)
    ld = len(g.discordant_edges)
    for i, e in enumerate(g.sequence_edges):
        e.cn = float(x[i] * 2)
        g.max_cn = max(g.max_cn, e.cn)
    for i, e in enumerate(g.concordant_edges):
        e.cn = float(x[lseq + i] * 2)
        g.max_cn = max(g.max_cn, e.cn)
    for i, e in enumerate(g.discordant_edges):
        scale = 1 if e.is_self_loop() else 2
        e.cn = float(x[lseq + lc + i] * scale)
        g.max_cn = max(g.max_cn, e.cn)
    for i, e in enumerate(g.source_edges):
        e.cn = float(x[lseq + lc + ld + i] * 2)
        g.max_cn = max(g.max_cn, e.cn)
    g.max_cn += 1.0


def _assign_solution(g, wlrseg, wcn, wlncn, max_iters, engine: str = "auto",
                     *, device) -> bool:
    """Build the balance matrix, solve, write CNs back.  Returns False when
    there are no balance constraints (the caller applies its raw-coverage
    fallback)."""
    A = _balance_matrix(g, len(wcn))
    if A is None:
        return False
    x = solve_cn_balance(wlrseg, wcn, wlncn, A, max_iters, engine=engine,
                         device=device)
    _write_cn(g, x)
    return True


def _lr_weights(g, normal_cov: float):
    """Long-read NLL weights (reference ``breakpoint_graph.py:511-525``)."""
    lseq = len(g.sequence_edges)
    lc = len(g.concordant_edges)
    ld = len(g.discordant_edges)
    lsrc = len(g.source_edges)
    wcn = ([0.5 * normal_cov * e.size for e in g.sequence_edges]
           + [normal_cov] * lc + [normal_cov] * ld
           + [0.5 * normal_cov] * lsrc)
    wlncn = ([-0.5] * lseq
             + [float(e.lr_count) for e in g.concordant_edges]
             + [float(e.lr_count) for e in g.discordant_edges]
             + [-0.5] * lsrc)
    wlrseg = ([0.5 * e.lr_nc ** 2 / (normal_cov * e.size)
               for e in g.sequence_edges]
              + [0.0] * lc + [0.0] * ld
              + [0.5 * e.cn ** 2 / normal_cov for e in g.source_edges])
    return wlrseg, wcn, wlncn


def _raw_coverage_fallback(g, normal_cov: float) -> None:
    # no balance constraints: raw-coverage CN per segment (ref :597-605)
    for e in g.sequence_edges:
        e.cn = e.lr_nc * 2.0 / (normal_cov * e.size)
        g.max_cn = max(g.max_cn, e.cn)
    g.max_cn += 1.0


def compute_cn(g, normal_cov: float, max_iters: int = 1000,
               engine: str = "auto", *, device) -> None:
    """Estimate CN for every edge of a BreakpointGraph in place
    (reference ``compute_cn_lr``, ``breakpoint_graph.py:495-606``).
    Self-loop discordant edges are NOT doubled (ref :583-592)."""
    wlrseg, wcn, wlncn = _lr_weights(g, normal_cov)
    if not _assign_solution(g, wlrseg, wcn, wlncn, max_iters, engine=engine,
                            device=device):
        _raw_coverage_fallback(g, normal_cov)
