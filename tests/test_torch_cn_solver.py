"""The port's CN balance (``coral_tpu_torch.graph.cn_solver``) against the
JAX package's.

Tolerances: the re-homed numpy engine is the same float64 code, so it is
held to the emitted digits (``"%f" % (2*x)``, as graph files write CN)
and to exact equality.  The torch float64 engine runs the same iteration,
but its LU solve and norms sum in another order than numpy's, so it is
held to rtol 1e-9 (plus atol 1e-9 for x near 0): rounding differences of
~1e-16 relative that Newton's quadratic convergence does not amplify.
"""
import numpy as np
import pytest

from coral_tpu.graph import cn_solver as jc
from coral_tpu_torch.graph import cn_solver as tc


def _chain_system(rng, k, scale=5e4):
    """A k-segment chain (sequence + concordant edges), as the JAX
    package's CN tests build it; ``scale`` sets wlrseg (up to ~1e9 for
    the ill-conditioned cases: the KKT diagonal spans many decades)."""
    n = 2 * k - 1
    wcn = np.abs(rng.normal(50, 10, n)) + 5
    wlncn = np.concatenate([np.full(k, -0.5),
                            np.abs(rng.normal(300, 50, k - 1))])
    wlrseg = np.concatenate([np.abs(rng.normal(scale, scale / 5, k)),
                             np.zeros(k - 1)])
    A = np.zeros((2 * (k - 1), n))
    for j in range(k - 1):
        A[2 * j][j] = 1
        A[2 * j][k + j] = -1
        A[2 * j + 1][j + 1] = 1
        A[2 * j + 1][k + j] = -1
    return wlrseg, wcn, wlncn, A


CASES = [(k, 5e4, 11) for k in (3, 5, 8, 12)] + \
    [(6, s, 42) for s in (1e2, 1e6, 1e9)]


def _digits(x):
    return ["%f" % (2 * v) for v in np.asarray(x)]


@pytest.mark.parametrize("k,scale,seed", CASES)
def test_numpy_engine_digit_exact(k, scale, seed):
    sys_ = _chain_system(np.random.default_rng(seed), k, scale)
    want = jc.solve_cn_balance(*sys_, engine="numpy")
    got = tc.solve_cn_balance(*sys_, engine="numpy", device="cpu")
    assert _digits(got) == _digits(want)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k,scale,seed", CASES)
def test_torch_engine_matches_numpy(k, scale, seed):
    sys_ = _chain_system(np.random.default_rng(seed), k, scale)
    want = tc.solve_cn_balance(*sys_, engine="numpy", device="cpu")
    got = tc.solve_cn_balance(*sys_, engine="torch", device="cpu")
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)


def test_engines_resolve_and_reject():
    assert tc.resolve_cn_engine("auto", 1) == "numpy"
    assert tc.resolve_cn_engine("auto", 32) == "batch"
    assert tc.resolve_cn_engine("torch", 32) == "torch"
    with pytest.raises(ValueError):
        tc.resolve_cn_engine("jax", 1)
    sys_ = _chain_system(np.random.default_rng(0), 3)
    # batch solves many systems (compute_cn_batch), not one
    with pytest.raises(ValueError):
        tc.solve_cn_balance(*sys_, engine="batch", device="cpu")


@pytest.mark.parametrize("engine", ["numpy", "torch"])
def test_compute_cn_on_reconstructed_graphs(tmp_path, engine):
    """compute_cn on real breakpoint graphs (the simulated ecDNA sample's,
    before CN) writes the JAX package's numpy-engine CNs: identical for
    numpy, rtol 1e-9 for torch."""
    import copy

    from coral_tpu.io.bam import BamFile
    from coral_tpu.reconstruct import Reconstruction
    from coral_tpu.sim import simulate_ecdna

    bam, cns, seeds = simulate_ecdna(str(tmp_path), jitter=0)
    rec = Reconstruction(BamFile(bam), seeds)
    rec.read_cns(cns)
    rec.collect()
    rec.hash_to_segments()
    rec.find_amplicon_intervals()
    rec.find_smalldel_breakpoints()
    rec.find_breakpoints()
    rec.build_graph()
    rec.assign_cov()
    rec.bam.close()
    assert rec.graphs
    for g in rec.graphs:
        g_ref, g_port = copy.deepcopy(g), copy.deepcopy(g)
        jc.compute_cn(g_ref, rec.normal_cov, engine="numpy")
        tc.compute_cn(g_port, rec.normal_cov, engine=engine, device="cpu")
        edges = ("sequence_edges", "concordant_edges", "discordant_edges",
                 "source_edges")
        want = [e.cn for k in edges for e in getattr(g_ref, k)]
        got = [e.cn for k in edges for e in getattr(g_port, k)]
        if engine == "numpy":
            assert got == want and g_port.max_cn == g_ref.max_cn
        else:
            np.testing.assert_allclose(got, want, rtol=1e-9)
            np.testing.assert_allclose(g_port.max_cn, g_ref.max_cn,
                                       rtol=1e-9)
