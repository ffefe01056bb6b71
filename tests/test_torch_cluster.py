"""The port's MinHash clustering against catch_tpu's, on the CPU.

The twins of the minhash_caps kernel's four entry points are held
against the JAX programs they replace (catch_tpu/utils/cluster.py
_row_dists_kernel, _block_dists_kernel, _block_codes_kernel,
_pair_caps_jit and _assign_to_reps_jit), and the twin of minhash_sig
against catch_tpu/utils/lsh.py's signature program; then the three
clustering methods end to end.  The tolerance is exact equality
throughout: integers equal, float32 distances equal bit for bit, the
same clusters in the same order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catch_tpu.utils import cluster as jcluster
from catch_tpu.utils import lsh as jlsh
from catch_tpu_torch import convert
from catch_tpu_torch.ops import minhash as mh
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.utils import cluster as tcluster
from catch_tpu_torch.utils import lsh as tlsh

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins run many small tensor ops; with test workers sharing the
    host's cores, one intra-op thread keeps each op from stalling."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _signatures(seed, n, N, hi):
    """n ascending signature rows of width N from [0, hi): a small hi
    puts duplicates inside rows and ties between pairs."""
    rng = np.random.default_rng(seed)
    return np.sort(rng.integers(0, hi, size=(n, N)), axis=1).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _shapes(N):
    """Query and representative counts that are not multiples of the
    kernel's 16-row tiles; fewer rows at N = 300 keep the scans short."""
    return (37, 29) if N <= 100 else (19, 17)


@pytest.mark.parametrize("N,hi", [(1, 3), (40, 60), (100, 150),
                                  (100, 2**31 - 1), (300, 400)],
                         ids=["N1", "N40", "N100", "N100_wide", "N300"])
def test_dists_and_row_twins_equal_jax(N, hi):
    Q, R = _shapes(N)
    qs, rs = _signatures(1, Q, N, hi), _signatures(2, R, N, hi)
    both = jnp.asarray(np.concatenate([qs, rs]))
    want = np.asarray(jcluster._block_dists_kernel(both, jnp.int32(0), N=N,
                                                   B=len(qs)))[:, len(qs):]
    got = mh.minhash_dists(_t(qs), _t(rs)).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    for j in (0, 5, Q - 1):
        row = np.asarray(jcluster._row_dists_kernel(both, jnp.int32(j), N=N))
        got = mh.minhash_dists(_t(qs[j:j + 1]), _t(np.asarray(both)))[0]
        assert np.array_equal(got.numpy().view(np.uint32),
                              row.view(np.uint32))


@pytest.mark.parametrize("N", [1, 40, 100, 300])
def test_every_distance_step_equals_jax(N):
    """Rows that give every cap in 0..N: all N + 1 float32 distances."""
    A = np.arange(N, dtype=np.int32)
    rows = [np.sort(np.concatenate([np.arange(N - c, N),
                                    np.arange(10**6, 10**6 + N - c)]))
            for c in range(N + 1)]
    sigs = np.stack([A] + rows).astype(np.int32)
    want = np.asarray(jcluster._block_dists_kernel(
        jnp.asarray(sigs), jnp.int32(0), N=N, B=1))[0, 1:]
    got = mh.minhash_dists(_t(sigs[:1]), _t(sigs[1:]))[0].numpy()
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    caps = mh.minhash_caps(_t(sigs[:1]), _t(sigs[1:]))[0].numpy()
    assert sorted(caps.tolist()) == list(range(N + 1))


@pytest.mark.parametrize("N,hi", [(1, 3), (40, 60), (100, 150),
                                  (300, 400)])
def test_codes_and_caps_twins_equal_jax(N, hi):
    Q, R = _shapes(N)
    qs, rs = _signatures(3, Q, N, hi), _signatures(4, R, N, hi)
    both = np.concatenate([qs, rs])
    # thresholds that land exactly on a cap/N step, and between steps
    for thr, early in ((1.0 - 7 / 40, 1.0 - 13 / 40), (0.6, 0.2),
                       (1.0 - 1 / N, 0.0)):
        cap_thr = tcluster._min_cap(N, thr)
        cap_early = tcluster._min_cap(N, early)
        assert (cap_thr, cap_early) == (jcluster._min_cap(N, thr),
                                        jcluster._min_cap(N, early))
        want = np.asarray(jcluster._block_codes_kernel(
            jnp.asarray(both), jnp.int32(0), jnp.int32(cap_thr),
            jnp.int32(cap_early), N=N, B=len(both)))[:len(qs), len(qs):]
        got = mh.minhash_codes(_t(qs), _t(rs), cap_thr, cap_early).numpy()
        assert got.dtype == want.dtype and np.array_equal(got, want)
    want = np.asarray(jcluster._pair_caps_jit(jnp.asarray(qs),
                                              jnp.asarray(rs), N=N))
    got = mh.minhash_caps(_t(qs), _t(rs)).numpy()
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("N,hi", [(1, 3), (40, 60), (100, 150),
                                  (300, 400)])
def test_assign_twin_equals_jax(N, hi):
    Q, R = _shapes(N)
    qs, rs = _signatures(5, Q, N, hi), _signatures(6, R, N, hi)
    # copies of one row: every query ties between them
    rs[10:14] = rs[9]
    cap_thr = tcluster._min_cap(N, 0.5)
    for n_reps in (1, 13, R - 7, R):
        b_j, ok_j = jcluster._assign_to_reps_jit(
            jnp.asarray(qs), jnp.asarray(rs), jnp.int32(n_reps),
            jnp.int32(cap_thr), N=N)
        b_t, ok_t = mh.minhash_assign(_t(qs), _t(rs), n_reps, cap_thr)
        assert np.array_equal(b_t.numpy(), np.asarray(b_j))
        assert np.array_equal(ok_t.numpy(), np.asarray(ok_j))
    best, ok = mh.minhash_assign(_t(qs), _t(rs), 0, cap_thr)
    assert not best.any() and not ok.any()


def test_sig_twin_equals_jax():
    """Codes near 2^31 - 2 and a near 2^31 - 1: the TPU program's limb
    arithmetic and the twin's int64 product agree bit for bit."""
    rng = np.random.default_rng(7)
    p = mh.MERSENNE_P
    codes = np.concatenate([rng.integers(0, p, size=(40, 91)),
                            rng.integers(p - 50, p, size=(40, 91))])
    codes[0, :5] = p - 1 - np.arange(5)
    ab = np.stack([np.concatenate([rng.integers(1, p + 1, size=50),
                                   p - np.arange(25)]),
                   rng.integers(0, p + 1, size=75)], 1)
    want = np.asarray(jlsh._minhash_sig_kernel_factory()(
        jnp.asarray(codes.astype(np.uint32)),
        jnp.asarray(ab.astype(np.uint32)))).T
    got = mh.minhash_sig(_t(codes.astype(np.int32)),
                         _t(ab.astype(np.int32))).numpy()
    assert np.array_equal(got.astype(np.int64), want.astype(np.int64))


def test_signature_matrix_and_minhash_params():
    rng = np.random.default_rng(8)
    seqs = {i: "".join(rng.choice(list("ACGT"), size=300)) for i in range(6)}
    jsigs = jcluster.make_signatures_with_minhash(
        jlsh.MinHashFamily(12, N=40), seqs)
    tsigs = tcluster.make_signatures_with_minhash(
        tlsh.MinHashFamily(12, N=40), seqs)
    assert jsigs == tsigs
    m = convert.signature_matrix([jsigs[i] for i in seqs], CPU)
    assert m.dtype == torch.int32 and m.shape == (6, 40)
    assert np.array_equal(m.numpy(), np.asarray([jsigs[i] for i in seqs]))
    with pytest.raises(ValueError):
        convert.signature_matrix([(0, 2**31 - 1)], CPU)
    # the draw order of the near-duplicate filter's (a, b) table
    fam = jlsh.MinHashFamily(10, rng=np.random.default_rng(3))
    ab = convert.minhash_params(fam, 75)
    draw = np.random.default_rng(3)
    p = mh.MERSENNE_P
    for a, b in ab[:4]:
        assert (a, b) == (draw.integers(1, p + 1), draw.integers(0, p + 1))


def _family_seqs(rng, n_families, copies, length, family_mut=0.35,
                 copy_mut=0.01):
    bases = np.array(list("ACGT"))
    seqs = {}
    for f in range(n_families):
        base = rng.choice(bases, size=length)
        for c in range(copies):
            s = base.copy()
            m = rng.random(length) < copy_mut
            s[m] = rng.choice(bases, size=int(m.sum()))
            seqs[f"f{f}c{c}"] = "".join(s)
    return seqs


def _both(seqs, **kw):
    want = jcluster.cluster_with_minhash_signatures(dict(seqs), **kw)
    got = tcluster.cluster_with_minhash_signatures(dict(seqs), device=CPU,
                                                   **kw)
    return got, want


@pytest.mark.parametrize("method,threshold", [
    ("simple", 0.15), ("simple", 0.01), ("hierarchical", 0.15),
    ("hierarchical", 0.3), ("greedy", 0.15)])
def test_cluster_methods_equal_catch_tpu(method, threshold):
    rng = np.random.default_rng(31)
    seqs = _family_seqs(rng, 5, 9, 900, copy_mut=0.03)
    got, want = _both(seqs, threshold=threshold, cluster_method=method)
    assert got == want
    assert sum(len(c) for c in got) == len(seqs)


@pytest.mark.parametrize("wave", [3, 8, 64])
def test_greedy_waves_equal_catch_tpu(monkeypatch, wave):
    """Small waves put borderline queries on wave boundaries; _WAVE is
    semantic, so both packages must agree at every width."""
    monkeypatch.setattr(jcluster, "_WAVE", wave)
    monkeypatch.setattr(tcluster, "_WAVE", wave)
    rng = np.random.default_rng(33)
    seqs = _family_seqs(rng, 4, 9, 800, family_mut=0.12, copy_mut=0.04)
    got, want = _both(seqs, threshold=0.15, cluster_method="greedy")
    assert got == want


def test_auto_switch_to_greedy_equals_catch_tpu(monkeypatch):
    monkeypatch.setattr(jcluster, "_ALL_PAIRS_MAX", 20)
    monkeypatch.setattr(tcluster, "_ALL_PAIRS_MAX", 20)
    monkeypatch.setattr(jcluster, "_WAVE", 8)
    monkeypatch.setattr(tcluster, "_WAVE", 8)
    rng = np.random.default_rng(37)
    seqs = _family_seqs(rng, 3, 9, 700)
    for method in ("simple", "hierarchical"):
        got, want = _both(seqs, threshold=0.15, cluster_method=method)
        assert got == want and len(got) == 3


def test_single_sequence_and_empty():
    for method in ("simple", "hierarchical", "greedy"):
        got, want = _both({"only": "ACGT" * 50}, threshold=0.1,
                          cluster_method=method)
        assert got == want
    assert tcluster.cluster_with_minhash_signatures(
        {}, threshold=0.1, cluster_method="greedy", device=CPU) == []


def test_short_sequences_tile_their_signatures():
    """Sequences with fewer k-mers than N give signatures with repeated
    values; the estimator must count them as catch_tpu does."""
    rng = np.random.default_rng(41)
    base = "".join(rng.choice(list("ACGT"), size=60))
    seqs = {i: base[:40 + 3 * i] for i in range(8)}
    seqs.update({10 + i: "".join(rng.choice(list("ACGT"), size=50))
                 for i in range(4)})
    for method in ("simple", "hierarchical", "greedy"):
        got, want = _both(seqs, threshold=0.2, cluster_method=method)
        assert got == want


def test_kernel_wrappers_register_and_cpu_takes_the_twins():
    assert {"minhash_dists", "minhash_codes", "minhash_caps",
            "minhash_assign", "minhash_sig"} <= set(si.KERNELS)
    si.reset_launches()
    s = _t(_signatures(9, 5, 10, 30))
    mh.minhash_dists(s, s)
    mh.minhash_codes(s, s, 3, 5)
    mh.minhash_caps(s, s)
    mh.minhash_assign(s, s, 5, 3)
    mh.minhash_sig(s, _t(np.array([[1, 2]], dtype=np.int32)))
    assert all(fn.launches == 0 for fn in si.KERNELS.values())
