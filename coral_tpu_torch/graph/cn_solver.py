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
  exists because the TPU has no f64 LU; CUDA does, so it is not ported;
* ``batch``: every amplicon's system padded to one shape and solved
  together in float64 on an explicit device (:func:`compute_cn_batch`),
  the program the JAX module's vmapped ``_solve_kkt_newton`` runs.

``auto`` resolves to ``batch`` from ``batch_threshold`` amplicons up and
to ``numpy`` below (:func:`resolve_cn_engine`): amplicon systems are tens
to hundreds of edges, which the host solves in microseconds each.
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


CN_ENGINES = ("auto", "numpy", "torch", "batch")


def resolve_cn_engine(engine: str, n_graphs: int,
                      batch_threshold: int = 32) -> str:
    """``auto`` -> ``batch`` for ``n_graphs >= batch_threshold`` amplicons,
    ``numpy`` below (the JAX module's rule on a backend with an f64 LU,
    which the CPU and the card both are); any other engine of
    :data:`CN_ENGINES` is returned as given, and an unknown one raises."""
    if engine not in CN_ENGINES:
        raise ValueError(f"unknown CN engine {engine!r} "
                         f"({', '.join(CN_ENGINES)})")
    if engine != "auto":
        return engine
    return "batch" if n_graphs >= batch_threshold else "numpy"


def solve_cn_balance(wlrseg, wcn, wlncn, A, max_iters: int = 1000,
                     engine: str = "auto", *, device) -> np.ndarray:
    """Solve the balance program; returns x (CN/2 per edge).  ``engine``:
    ``numpy`` (f64 host), ``torch`` (f64 on ``device``) or ``auto``."""
    wlrseg = np.asarray(wlrseg, np.float64)
    wcn = np.asarray(wcn, np.float64)
    wlncn = np.asarray(wlncn, np.float64)
    A = np.asarray(A, np.float64).reshape(-1, len(wcn))
    engine = resolve_cn_engine(engine, 1)
    if engine == "numpy":
        return _newton_numpy(wlrseg, wcn, wlncn, A, max_iters)
    if engine == "torch":
        return _newton_torch(wlrseg, wcn, wlncn, A, max_iters, device=device)
    raise ValueError(f"CN engine {engine!r} does not solve one system "
                     "(numpy, torch; batch is compute_cn_batch)")


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


# the line search's steps t = 2^-k, k = 0..39: every t > 1e-12 of the
# halving from 1
_LS_STEPS = 40


def _newton_batch(wlrseg, wcn, wlncn, A, max_iters: int, tol: float = 1e-9):
    """The JAX module's ``_solve_kkt_newton`` vmapped over a batch:
    (B, n) weights and (B, m, n) constraints, float64 tensors on one
    device -> x (B, n).

    Each system runs that program, not :func:`_newton_numpy`: it starts
    from ``res0 = |r(x0, y0)| + 1`` and ``res_prev = inf``, steps while
    ``res > tol`` and ``res < res_prev * (1 - 1e-4)`` (``res_prev`` the
    residual at the start of the step), and when no step ``t > 1e-12``
    passes the line search it keeps x, takes ``y_new`` and goes on to the
    test.  A system freezes when its own test fails, as a batched
    ``while_loop`` freezes it, so its answer does not depend on its
    batch-mates; the loop ends when none is active.  The 40 candidate
    steps are tried at once and the first that passes is taken, which is
    what halving one at a time finds.  One host read a step: whether any
    system is still active.

    Points are (B, k, n): k = 1 for the iterate, k = 40 for the line
    search's candidates."""
    B, n = wcn.shape
    m = A.shape[1]
    dev, f64 = wcn.device, torch.float64
    w2, w1, w0 = (w[:, None, :] for w in (wlrseg, wcn, wlncn))
    At = A.transpose(1, 2)

    def grad(x):
        return w1 - w0 / x - w2 / (x * x)

    def res_norm(x, y):
        """|r(x, y)| for points x (B, k, n) and multipliers y (B, 1, m)
        -> (B, k)."""
        r = torch.cat([grad(x) + y @ A, x @ At], dim=2)
        return torch.linalg.vector_norm(r, dim=2)

    K = torch.zeros((B, n + m, n + m), dtype=f64, device=dev)
    K[:, :n, n:] = At
    K[:, n:, :n] = A
    K[:, n:, n:] = -1e-10 * torch.eye(m, dtype=f64, device=dev)
    diag = K.diagonal(dim1=1, dim2=2)[:, :n]
    ts = torch.pow(torch.tensor(0.5, dtype=f64, device=dev),
                   torch.arange(_LS_STEPS, dtype=f64, device=dev))[:, None]
    x = torch.ones((B, 1, n), dtype=f64, device=dev)
    y = torch.zeros((B, 1, m), dtype=f64, device=dev)
    res0 = res_norm(x, y) + 1.0
    active = (res0 > tol) & (res0 < torch.inf)
    for _ in range(max_iters):
        if not bool(active.any()):
            break
        diag.copy_(torch.clamp(w0 / (x * x) + 2.0 * w2 / (x * x * x),
                               min=1e-8)[:, 0])
        rhs = torch.cat([-grad(x), -(x @ At)], dim=2)
        sol = torch.linalg.solve_ex(K, rhs.transpose(1, 2),
                                    check_errors=False).result.transpose(1, 2)
        dx, y_new = sol[:, :, :n], sol[:, :, n:]
        r0 = res_norm(x, y)
        x_t = x + ts * dx
        ok = (x_t.amin(dim=2) > 0) & (
            res_norm(x_t, y_new) <= (1 - 0.01 * ts.T) * r0 + tol)
        found = ok.any(dim=1, keepdim=True)
        t = ts[ok.to(torch.int8).argmax(dim=1)]
        x_new = torch.where(found[:, :, None], x + t[:, :, None] * dx, x)
        res = res_norm(x_new, y_new)
        x = torch.where(active[:, :, None], x_new, x)
        y = torch.where(active[:, :, None], y_new, y)
        active = active & (res > tol) & (res < r0 * (1 - 1e-4))
    return x[:, 0]


def solve_cn_balance_batch(systems, max_iters: int = 1000, *, device):
    """Solve many balance programs together on ``device`` (the JAX
    module's ``solve_cn_balance_batch``, without its ``mesh``).

    ``systems``: a list of ``(wlrseg, wcn, wlncn, A)`` of ragged sizes.
    They are padded to one ``(n_max, m_max)``: padded variables get
    ``(wlrseg, wcn, wlncn) = (0, 1, 1)`` (optimum x = 1, unit Hessian) and
    no constraint, and padded rows of A are zero, held by the KKT
    system's ``-1e-10 I`` block, so the real solutions do not change.
    The solve is :func:`_newton_batch` in float64 with
    ``torch.linalg.solve_ex`` on the (B, N, N) stack, N = n_max + m_max.

    Memory: the KKT stack and its LU factors take 2 * B * N^2 * 8 bytes
    and the line search B * 40 * N * 8 more: 1.5 GB at B = 256 and
    N = 600, so an 80 GB card holds a batch up to B * N^2 of about 4e9.

    Returns a list of x arrays (numpy float64) trimmed to each system."""
    if not systems:
        return []
    dev = resolve_device(device)
    n_max = max(len(s[1]) for s in systems)
    m_max = max(np.asarray(s[3]).shape[0] for s in systems)
    B = len(systems)
    wlrseg = np.zeros((B, n_max))
    wcn = np.ones((B, n_max))
    wlncn = np.ones((B, n_max))
    A = np.zeros((B, m_max, n_max))
    for b, (w2, w1, w0, Ab) in enumerate(systems):
        n = len(w1)
        Ab = np.asarray(Ab, np.float64).reshape(-1, n)
        wlrseg[b, :n] = w2
        wcn[b, :n] = w1
        wlncn[b, :n] = w0
        A[b, :Ab.shape[0], :n] = Ab
    xs = _newton_batch(*(torch.from_numpy(a).to(dev)
                         for a in (wlrseg, wcn, wlncn, A)),
                       max_iters).cpu().numpy()
    return [xs[b, :len(s[1])] for b, s in enumerate(systems)]


def compute_cn_batch(graphs, normal_cov: float, max_iters: int = 1000, *,
                     device) -> None:
    """:func:`compute_cn` over many amplicon graphs in one batched solve on
    ``device`` (the JAX module's ``compute_cn_batch``, without its
    ``mesh``).  A graph with no balance constraint takes the raw-coverage
    CN, as there."""
    systems = []
    solvable = []
    for g in graphs:
        wlrseg, wcn, wlncn = _lr_weights(g, normal_cov)
        A = _balance_matrix(g, len(wcn))
        if A is None:
            _raw_coverage_fallback(g, normal_cov)
            continue
        systems.append((np.asarray(wlrseg, np.float64),
                        np.asarray(wcn, np.float64),
                        np.asarray(wlncn, np.float64), A))
        solvable.append(g)
    xs = solve_cn_balance_batch(systems, max_iters, device=device)
    for g, x in zip(solvable, xs):
        _write_cn(g, x)
