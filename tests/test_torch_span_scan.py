"""The span scan (catch_tpu_torch/ops/scan_sparse.py) against catch_tpu.

The twins of the two span kernels, expand_join and verify_spans, are
held against the JAX programs they replace (catch_tpu/ops/scan_sparse.py
_expand_join_jit and _verify_chunk) on the same inputs, and
ProbeSearcher.find_probe_covers_flat against catch_tpu's batched and
per-sequence paths.  Every comparison is exact: spans and counts are
integers.  Inputs are made from numpy seeds; the corpora are those of
tests/test_cover.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from catch_tpu.filters.candidates import (
    make_candidate_probes_from_sequences)
from catch_tpu.filters.duplicate import DuplicateFilter
from catch_tpu.ops import cover as jcover
from catch_tpu.ops import scan_sparse as jss
from catch_tpu_torch import _build, convert
from catch_tpu_torch.ops import cover as tcover
from catch_tpu_torch.ops import scan_instance as si
from catch_tpu_torch.ops import scan_sparse as tss
from catch_tpu_torch.probe import Probe as TProbe

CPU = torch.device("cpu")


def _corpus(seed, n_seqs=6, lo=150, hi=900):
    """Sequences mutated from one shared base (tests/test_cover.py)."""
    rng = np.random.RandomState(seed)
    base = "".join(rng.choice(list("ACGT"), size=hi))
    seqs = []
    for _ in range(n_seqs):
        n = int(rng.randint(lo, hi))
        s = list(base[:n])
        for _ in range(n // 40):
            s[rng.randint(n)] = rng.choice(list("ACGT"))
        seqs.append("".join(s))
    return seqs


def _slab_corpus():
    """Four random 3 kb sequences (tests/test_cover.py
    TestJoinSlabBoundary)."""
    rng = np.random.default_rng(99)
    bases = np.array(list("ACGT"))
    return ["".join(rng.choice(bases, size=3000)) for _ in range(4)]


# name: (corpus, model, probe length, stride, kmer_probe_map_k)
CASES = {
    "mismatch": (lambda: _corpus(1), dict(mismatches=2, lcf_thres=40),
                 60, 25, 20),
    "fast_path": (lambda: _corpus(2), dict(mismatches=2, lcf_thres=60),
                  60, 25, 20),
    "exact": (lambda: _corpus(3), dict(mismatches=0, lcf_thres=30),
              60, 25, 20),
    "island": (lambda: _corpus(4), dict(mismatches=2, lcf_thres=40,
                                        island_of_exact_match=25),
               60, 25, 20),
    "short_and_empty": (lambda: _corpus(5) + ["ACGT", ""],
                        dict(mismatches=1, lcf_thres=40), 60, 25, 20),
    "w1_k10": (lambda: _corpus(6), dict(mismatches=2, lcf_thres=40),
               60, 25, 10),
}


def _searchers(case):
    """(sequences, catch_tpu searcher, port searcher on the CPU)."""
    make, model_kw, pl, ps, k = CASES[case]
    seqs = make()
    probes = DuplicateFilter().filter(make_candidate_probes_from_sequences(
        [s for s in seqs if len(s) >= pl], probe_length=pl,
        probe_stride=ps))
    j = jcover.ProbeSearcher(probes, jcover.CoverModel(**model_kw),
                             kmer_probe_map_k=k)
    t = tcover.ProbeSearcher([TProbe(p.seq_str) for p in probes],
                             tcover.CoverModel(**model_kw),
                             kmer_probe_map_k=k, device=CPU)
    return seqs, j, t


def _pad32(x, n):
    out = np.zeros(n, dtype=np.int32)
    out[:len(x)] = x
    return jnp.asarray(out)


def _pow2(x):
    return 1 if x <= 1 else 1 << int(x - 1).bit_length()


def _spans(flat):
    return sorted(zip(*(np.asarray(x).tolist() for x in flat)))


def _join(t, seqs):
    mega, starts, ends, total = tss.corpus_codes(t, seqs)
    lo, cnt, pos = tss.join_runs(t, mega[:total])
    return mega, starts, ends, lo, cnt, pos


@pytest.mark.parametrize("case", ["mismatch", "w1_k10"])
def test_expand_join_twin_matches_jax(case):
    """K5's twin equals _expand_join_jit's valid prefix, with minimizers
    (w = 9) and without them (k_seed = 10, w = 1)."""
    seqs, _, t = _searchers(case)
    _, _, _, lo, cnt, pos = _join(t, seqs)
    assert t._join_kw[1] == (1 if case == "w1_k10" else 9)
    total = int(cnt.sum())
    assert total > 1000
    jp, jpos = tss.join_table(t, CPU)
    p, a = tss.expand_join(*(torch.from_numpy(x) for x in (lo, cnt, pos)),
                           jp, jpos, t.Lmax)
    S, T = _pow2(len(lo)), _pow2(total)
    pj, aj, ok, n = jss._expand_join_jit(
        _pad32(lo, S), _pad32(cnt, S), _pad32(pos, S), jnp.int32(total),
        jnp.asarray(t._join_p.astype(np.int32)),
        jnp.asarray(t._join_pos.astype(np.int32)), T=T, S=S, cap=T)
    n = int(n)
    assert n == p.numel() > 100
    assert np.array_equal(np.asarray(pj[:n]), p.numpy())
    assert np.array_equal(np.asarray(aj[:n]), a.numpy())


@pytest.mark.parametrize("case", ["mismatch", "fast_path", "exact",
                                  "island", "short_and_empty"])
def test_verify_spans_twin_matches_jax(case):
    """K6's twin equals _verify_chunk's valid prefix, in order."""
    seqs, _, t = _searchers(case)
    mega, starts, ends, lo, cnt, pos = _join(t, seqs)
    p, a = tss._device_join(t, lo, cnt, pos, CPU)
    cand = tss.keep_candidates(t, p, a, torch.from_numpy(starts),
                               torch.from_numpy(ends))
    vargs = tss.verify_args(t)
    assert vargs["fast_ok"] == (case == "fast_path")
    got = tss.verify_spans(torch.from_numpy(mega),
                           torch.from_numpy(t.probe_codes), *cand, **vargs)
    C = _pow2(max(cand[0].numel(), 1 << 10))
    cap = 2 * C
    sp_p, sp_s, sp_e, ok, nq = jss._verify_chunk(
        jnp.asarray(mega), jnp.asarray(t.probe_codes),
        *[_pad32(x.numpy(), C) for x in cand], jnp.int32(vargs["k_seed"]),
        L=t.Lmax, K=vargs["K"], C=C, cap=cap, seed_req=vargs["seed_req"],
        fast_ok=vargs["fast_ok"])
    nq = int(nq)
    assert nq <= cap
    assert nq == got[0].numel() > 0
    for g, w in zip(got, (sp_p, sp_s, sp_e)):
        assert np.array_equal(g.numpy(), np.asarray(w[:nq]))


@pytest.mark.parametrize("case", list(CASES))
def test_find_probe_covers_flat_matches_catch_tpu(case):
    """Equal to catch_tpu's batched and per-sequence paths span for span,
    and the candidate count equals the batched path's."""
    seqs, j, t = _searchers(case)
    want = j.find_probe_covers_flat(seqs, force_batch=True)
    n_cand = j.stats["candidates"]
    j2 = jcover.ProbeSearcher(j.probes, j.model,
                              kmer_probe_map_k=CASES[case][4])
    host = j2.find_probe_covers_flat(seqs, force_batch=False)
    got = t.find_probe_covers_flat(seqs)
    assert all(x.dtype == np.int64 for x in got)
    assert _spans(got) == _spans(want) == _spans(host)
    assert len(got[0]) > 0
    assert t.stats["candidates"] == n_cand


def test_cross_slab_expansion(monkeypatch):
    """Expansion slabs of 256 hits give the unslabbed spans (the final
    unique removes pairs found in two slabs)."""
    seqs, j, t = _searchers("mismatch")
    want = _spans(j.find_probe_covers_flat(seqs, force_batch=True))
    calls = []
    expand = tss.expand_join
    monkeypatch.setattr(tss, "expand_join",
                        lambda *a: calls.append(1) or expand(*a))
    monkeypatch.setattr(tss, "_EXPAND_SLAB", 1 << 8)
    assert _spans(t.find_probe_covers_flat(seqs)) == want
    assert len(calls) > 5


def test_join_slab_boundary(monkeypatch):
    """Hash slabs of 997 positions lose no pair at their boundaries."""
    seqs = _slab_corpus()
    probes = make_candidate_probes_from_sequences(
        seqs, probe_length=100, probe_stride=50)
    j = jcover.ProbeSearcher(probes, jcover.CoverModel(2, 60))
    t = tcover.ProbeSearcher([TProbe(p.seq_str) for p in probes],
                             tcover.CoverModel(2, 60), device=CPU)
    want = _spans(jss.scan_corpus_sparse(j, seqs))
    monkeypatch.setattr(tss, "_JOIN_SLAB", 997)
    assert _spans(t.find_probe_covers_flat(seqs)) == want
    assert len(want) > 0


@pytest.mark.parametrize("merge", [True, False])
def test_find_probe_covers_matches_catch_tpu(merge):
    seqs, j, t = _searchers("mismatch")
    want = j.find_probe_covers(seqs[0], merge_overlapping=merge)
    got = t.find_probe_covers(seqs[0], merge_overlapping=merge)
    assert {p.seq_str: v for p, v in got.items()} == {
        p.seq_str: v for p, v in want.items()}
    assert len(want) > 10


def test_converted_searcher_joins_identically():
    """searcher_from_reference carries catch_tpu's join table, so the
    port joins against exactly the same table and finds the same
    spans."""
    seqs, j, _ = _searchers("island")
    ref = convert.reference_arrays(j)
    assert ref["join_params"] == (12, 9) and len(ref["join_h"]) > 100
    t = convert.searcher_from_reference(ref, device=CPU)
    for f in ("_join_h", "_join_p", "_join_pos"):
        assert np.array_equal(getattr(t, f), getattr(j, f)), f
    assert t._join_kw == j._join_params()
    assert _spans(t.find_probe_covers_flat(seqs)) == _spans(
        j.find_probe_covers_flat(seqs, force_batch=True))


def test_span_scan_boundaries(monkeypatch):
    """No device, K above the ring, or a key overflow raise; empty inputs
    give empty spans."""
    seqs, _, t = _searchers("exact")
    no_dev = tcover.ProbeSearcher(
        [TProbe("ACGT" * 15)], tcover.CoverModel(0, 60))
    with pytest.raises(ValueError, match="device"):
        no_dev.find_probe_covers_flat(seqs)
    e = torch.zeros(1, dtype=torch.int64)
    with pytest.raises(ValueError, match="K=63"):
        tss.verify_spans(torch.zeros(8, dtype=torch.uint8),
                         torch.zeros((1, 4), dtype=torch.uint8),
                         e, e, e, e, e, e, K=63, k_seed=2, seed_req=2,
                         fast_ok=False)
    e2 = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="equal lengths"):
        tss.verify_spans(torch.zeros(8, dtype=torch.uint8),
                         torch.zeros((1, 4), dtype=torch.uint8),
                         e, e2, e, e, e, e, K=2, k_seed=2, seed_req=2,
                         fast_ok=False)
    with pytest.raises(ValueError, match="equal lengths"):
        tss.expand_join(e, e2, e, e, e, 60)
    assert all(len(x) == 0 for x in t.find_probe_covers_flat([]))
    assert all(len(x) == 0 for x in t.find_probe_covers_flat(["A" * 50]))
    monkeypatch.setattr(tss, "_KEY_SHIFT", 10)
    with pytest.raises(ValueError, match="packed 64-bit pair key"):
        t.find_probe_covers_flat(seqs)


def test_span_kernels_take_twins_on_cpu(monkeypatch):
    """CPU tensors never reach the kernel library, and the two span
    kernels' launch counts stay at zero."""
    def no_library():
        raise AssertionError("a CPU tensor reached the kernel library")
    monkeypatch.setattr(_build, "library", no_library)
    si.reset_launches()
    seqs, _, t = _searchers("fast_path")
    assert len(t.find_probe_covers_flat(seqs)[0]) > 0
    assert {"expand_join", "verify_spans"} <= set(si.KERNELS)
    assert all(fn.launches == 0 for fn in si.KERNELS.values())
