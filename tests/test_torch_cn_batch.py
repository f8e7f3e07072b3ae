"""The port's batched CN engine (``coral_tpu_torch.graph.cn_solver``:
``solve_cn_balance_batch``, ``compute_cn_batch``, ``resolve_cn_engine``)
against the JAX package's vmapped Newton solve.

Tolerances: both run the same float64 iteration, but the LU solves and
the norms sum in other orders, so x is held to rtol 1e-9 (atol 1e-9 for x
near 0) and to every digit a graph file writes (``"%f" % (2*x)``).  A
system solved in a batch against the same system alone in the port:
rtol 1e-12, since only the padding differs.  Graph files: byte for byte.

The tests marked ``cuda`` hold the card's batch against the port's on the
CPU, which the other tests tie to the JAX package.  This module imports
JAX only inside the tests that need it, so that on a machine with a card
and no JAX ``python -m pytest --noconftest tests/test_torch_cn_batch.py
-m cuda`` runs the card tests.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from coral_tpu_torch.config import DEFAULT_CONFIG as PORT_CONFIG
from coral_tpu_torch.graph import cn_solver as tc
from coral_tpu_torch.reconstruct import reconstruct_graphs as port_reconstruct


def _random_system(rng, k):
    """A k-segment chain, as ``tests/test_cn_solver.py`` builds it."""
    n = 2 * k - 1
    wcn = np.abs(rng.normal(50, 10, n)) + 5
    wlncn = np.concatenate([np.full(k, -0.5),
                            np.abs(rng.normal(300, 50, k - 1))])
    wlrseg = np.concatenate([np.abs(rng.normal(5e4, 1e4, k)),
                             np.zeros(k - 1)])
    A = np.zeros((2 * (k - 1), n))
    for j in range(k - 1):
        A[2 * j][j] = 1
        A[2 * j][k + j] = -1
        A[2 * j + 1][j + 1] = 1
        A[2 * j + 1][k + j] = -1
    return wlrseg, wcn, wlncn, A


def _digits(x):
    return ["%f" % (2 * v) for v in np.asarray(x)]


# the ragged sets of tests/test_cn_solver.py
RAGGED = [(3, (3, 5, 8, 4)), (17, (3, 7, 12, 5, 9))]


def _three_ways():
    """One batch, three ways for a system to stop at max_iters=3:
    already at its optimum (x = 1, stops after step 1); a concave pair
    whose line search finds no step at step 2, after which its residual
    test stops it; a chain that needs more than 3 steps."""
    A = np.array([[1.0, -1.0]])
    at_optimum = (np.zeros(2), np.ones(2), np.ones(2), A)
    ls_failure = (np.array([0.0, 0.03509478412884679]),
                  np.array([2.4021384005454984, 0.9290030485923059]),
                  np.array([-0.36374928225746417, -0.4423354288687705]), A)
    long_chain = _random_system(np.random.default_rng(5), 8)
    return [at_optimum, ls_failure, long_chain]


def _jax_batch(systems, **kw):
    from coral_tpu.graph import cn_solver as jc

    return jc.solve_cn_balance_batch(systems, **kw)


def _port_cpu_batch(systems, **kw):
    return tc.solve_cn_balance_batch(systems, device="cpu", **kw)


def _check_ragged(seed, ks, device, reference):
    rng = np.random.default_rng(seed)
    systems = [_random_system(rng, k) for k in ks]
    want = reference(systems)
    got = tc.solve_cn_balance_batch(systems, device=device)
    assert len(got) == len(systems)
    for (_, w1, _, _), x, x_ref in zip(systems, got, want):
        assert x.shape == (len(w1),) and x.dtype == np.float64
        np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-9)
        assert _digits(x) == _digits(x_ref)


def _check_three_ways(device, reference):
    systems = _three_ways()
    want = reference(systems, max_iters=3)
    got = tc.solve_cn_balance_batch(systems, max_iters=3, device=device)
    for s, x, x_ref in zip(systems, got, want):
        alone = tc.solve_cn_balance_batch([s], max_iters=3, device=device)[0]
        np.testing.assert_allclose(x, alone, rtol=1e-12)
        np.testing.assert_allclose(x, x_ref, rtol=1e-9, atol=1e-9)
    at_optimum, ls_failure, long_chain = got
    np.testing.assert_array_equal(at_optimum, np.ones(2))
    # the failed step leaves x where step 1 put it, and nothing moves it
    one_step = tc.solve_cn_balance_batch([systems[1]], max_iters=1,
                                         device=device)[0]
    np.testing.assert_array_equal(ls_failure, one_step)
    np.testing.assert_array_equal(
        tc.solve_cn_balance_batch([systems[1]], device=device)[0], one_step)
    # the chain was cut: with room it goes on to another answer
    full = tc.solve_cn_balance_batch([systems[2]], device=device)[0]
    assert not np.allclose(long_chain, full, rtol=1e-12, atol=0)


@pytest.mark.parametrize("seed,ks", RAGGED)
def test_batch_matches_jax_batch(seed, ks):
    _check_ragged(seed, ks, "cpu", _jax_batch)


def test_batch_systems_stop_on_their_own():
    _check_three_ways("cpu", _jax_batch)


def test_empty_batch():
    assert tc.solve_cn_balance_batch([], device="cpu") == []


def _graph_files(d, prefix):
    return sorted(f[len(prefix):] for f in os.listdir(d)
                  if f.startswith(prefix) and f.endswith("_graph.txt"))


def test_compute_cn_batch_graph_files(tmp_path):
    """Reconstruct of the mixed sample (ecDNA, BFB, translocation) with
    the batch CN engine: the port's graph files, byte for byte, equal the
    JAX package's batch engine and the port's numpy engine."""
    from coral_tpu.config import DEFAULT_CONFIG as JAX_CONFIG
    from coral_tpu.reconstruct import reconstruct_graphs as jax_reconstruct
    from coral_tpu.sim import simulate_mixed_sample

    d = str(tmp_path)
    bam, cns, seeds = simulate_mixed_sample(d, seed=3)
    jcfg = JAX_CONFIG.replace(engine=dataclasses.replace(
        JAX_CONFIG.engine, engine="numpy", cn_engine="batch"))
    jax_reconstruct(bam, seeds, cns, os.path.join(d, "jax"),
                    cfg=jcfg).bam.close()
    for cn_engine in ("batch", "numpy"):
        cfg = PORT_CONFIG.replace(engine=dataclasses.replace(
            PORT_CONFIG.engine, engine="numpy", cn_engine=cn_engine))
        port_reconstruct(bam, seeds, cns, os.path.join(d, cn_engine),
                         cfg=cfg, device="cpu").bam.close()
    names = _graph_files(d, "jax")
    assert len(names) == 3
    for other in ("batch", "numpy"):
        assert _graph_files(d, other) == names
    for n in names:
        with open(os.path.join(d, "jax" + n), "rb") as fh:
            want = fh.read()
        for other in ("batch", "numpy"):
            with open(os.path.join(d, other + n), "rb") as fh:
                assert fh.read() == want, (other, n)


def test_resolver():
    assert tc.resolve_cn_engine("auto", 31) == "numpy"
    assert tc.resolve_cn_engine("auto", 32) == "batch"
    assert tc.resolve_cn_engine("auto", 4, batch_threshold=4) == "batch"
    for engine in ("numpy", "torch", "batch"):
        assert tc.resolve_cn_engine(engine, 1) == engine
        assert tc.resolve_cn_engine(engine, 100) == engine
    with pytest.raises(ValueError, match="unknown CN engine"):
        tc.resolve_cn_engine("jax", 1)


def test_reconstruct_logs_the_route(tmp_path, caplog, monkeypatch):
    """``Reconstruction.compute_cn`` resolves with the config's threshold
    and logs the route it took."""
    import logging

    from coral_tpu_torch.sim import simulate_ecdna

    # the CLI run by an earlier test in this process may have stopped the
    # package logger's propagation (tracing.setup_file_logging)
    monkeypatch.setattr(logging.getLogger("coral_tpu_torch"), "propagate",
                        True)

    d = str(tmp_path)
    bam, cns, seeds = simulate_ecdna(d, jitter=0)
    cfg = PORT_CONFIG.replace(engine=dataclasses.replace(
        PORT_CONFIG.engine, engine="numpy", cn_batch_threshold=1))
    with caplog.at_level(logging.INFO, logger="coral_tpu_torch"):
        port_reconstruct(bam, seeds, cns, os.path.join(d, "p"), cfg=cfg,
                         device="cpu").bam.close()
    assert any("CN balance route: engine=batch" in r.getMessage()
               for r in caplog.records)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tc.solve_cn_balance_batch(_three_ways(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("seed,ks", RAGGED)
def test_batch_on_the_card(cuda, seed, ks):
    _check_ragged(seed, ks, cuda, _port_cpu_batch)


@pytest.mark.cuda
def test_batch_systems_stop_on_their_own_on_the_card(cuda):
    _check_three_ways(cuda, _port_cpu_batch)
