"""The instances that reach K13's and K18's piece-limit routes, on the CPU.

Past set_cover._K12_PIECE_LIMIT pieces, K13's routes
(set_cover._solve_device_steps, _solve_device) and K18's
(parallel/set_cover.solve_instance_sharded) return the host lazy
solver's picks.  Those equal catch_tpu's device and sharded solvers'
picks on an instance in the constructors' order: pairs in set-major
order, one pair for each (set, universe), the intervals grouped by pair,
and the intervals of a pair disjoint.  Out of that order they part (the
card tests' shuffled_instance and overlapping_instance).

The tests show that no constructor of either package makes an instance
out of that order (build_instance in both modes,
build_instance_from_cover_arrays on shuffled, overlapping and repeated
spans, scan_instance.instance_to_host, and the instances SetCoverFilter
solves on its default and custom-model routes, duplicate candidates and
rank tiers included), and that the order is enough: the out-of-order
instances, put in order, give the lazy solver catch_tpu's sharded
solver's picks at 1, 2 and 4 places and _solve_jit_padded's, also past
a piece limit patched low.
"""

import numpy as np
import pytest

from catch_tpu.filters.set_cover_filter import SetCoverFilter as JFilter
from catch_tpu.genome import Genome as JGenome
from catch_tpu.ops import set_cover as jsc
from catch_tpu.parallel import make_mesh as jmake_mesh
from catch_tpu.parallel import solve_instance_sharded as jsolve_sharded
from catch_tpu.probe import Probe as JProbe
from catch_tpu.utils.intervals import IntervalSet as JIntervalSet
from catch_tpu_torch import convert
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter as TFilter
from catch_tpu_torch.genome import Genome as TGenome
from catch_tpu_torch.ops import set_cover as tsc
from catch_tpu_torch.parallel import make_mesh, solve_instance_sharded
from catch_tpu_torch.probe import Probe as TProbe
from catch_tpu_torch.utils.intervals import IntervalSet as TIntervalSet
from test_torch_cuda import overlapping_instance, shuffled_instance
from test_torch_custom_cover import ANCHORED, _corpus, _fn_file, _set_system
from test_torch_parallel import _random_instances
from test_torch_scan_instance import (  # noqa: F401 (fixture)
    _both_instances, _scan_inputs, small_shapes)
from test_torch_scan_instance import _corpus as _genomes

PACKAGES = {"catch_tpu": jsc, "catch_tpu_torch": tsc}


def _in_order(inst):
    """Whether `inst` is in the constructors' order."""
    sop = np.asarray(inst.set_of_pair, dtype=np.int64)
    key = sop * inst.n_universes + np.asarray(inst.univ_of_pair)
    poi = np.asarray(inst.pair_of_ivl, dtype=np.int64)
    start = np.asarray(inst.ivl_start, dtype=np.int64)
    end = np.asarray(inst.ivl_end, dtype=np.int64)
    same_pair = poi[1:] == poi[:-1]
    return bool(np.all(np.diff(sop) >= 0)
                and len(np.unique(key)) == len(key)
                and np.all(np.diff(poi) >= 0)
                and np.all(end[:-1][same_pair] <= start[1:][same_pair]))


def _put_in_order(inst):
    """`inst` in the constructors' order: each (set, universe)'s
    intervals merged, as build_instance_from_cover_arrays merges them."""
    nU = inst.n_universes
    key = (np.asarray(inst.set_of_pair, dtype=np.int64) * nU
           + inst.univ_of_pair)[inst.pair_of_ivl]
    start = np.asarray(inst.ivl_start, dtype=np.int64)
    end = np.asarray(inst.ivl_end, dtype=np.int64)
    held = end > start
    k, s, e = tsc._merge_by_group(key[held], start[held], end[held])
    pair_ids, pair_of_ivl = np.unique(k, return_inverse=True)
    fields = dict(inst.__dict__)
    fields.update(ivl_start=s, ivl_end=e,
                  pair_of_ivl=pair_of_ivl.astype(np.int32),
                  set_of_pair=(pair_ids // nU).astype(np.int32),
                  univ_of_pair=(pair_ids % nU).astype(np.int32))
    return type(inst)(**fields)


OUT_OF_ORDER = {
    "shuffled": lambda: shuffled_instance(_random_instances(1)[0], 5),
    "overlap1": lambda: overlapping_instance(1),
    "overlap2": lambda: overlapping_instance(2),
}


@pytest.mark.parametrize("case", list(OUT_OF_ORDER))
def test_the_order_is_enough(monkeypatch, case):
    """Out of order, the lazy solver parts from catch_tpu's sharded and
    device solvers; put in order, it gives their picks, and so do the
    port's K13 and K18 routes past a piece limit patched to 1."""
    inst = OUT_OF_ORDER[case]()
    assert not _in_order(inst)
    t_inst = (inst if isinstance(inst, tsc.SetCoverInstance)
              else convert.instance_from_reference(inst))
    assert (tsc._solve_host_lazy(t_inst).tolist()
            != jsolve_sharded(inst, mesh=jmake_mesh(4)).tolist())
    ordered = _put_in_order(t_inst)
    assert _in_order(ordered)
    want = jsc._solve_device(ordered)
    assert len(want) > 0
    for n in (1, 2, 4):
        assert np.array_equal(
            jsolve_sharded(ordered, mesh=jmake_mesh(n)), want)
    assert np.array_equal(tsc._solve_host_lazy(ordered), want)
    monkeypatch.setenv("CATCH_TPU_VIRTUAL_DEVICES", "4")
    monkeypatch.setattr(tsc, "_K12_PIECE_LIMIT", 1)
    for got in (solve_instance_sharded(ordered, mesh=make_mesh(4, "cpu")),
                tsc._solve_device(ordered, "cpu"),
                tsc.solve_instance(ordered, force_device=True,
                                   device="cpu")):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("package", list(PACKAGES))
@pytest.mark.parametrize("mode", ["elements", "tuples", "intervalsets"])
@pytest.mark.parametrize("seed", range(4))
def test_build_instance_gives_the_order(package, mode, seed):
    sc = PACKAGES[package]
    sets, p, ranks, costs = _set_system(seed)
    if mode == "tuples":
        sets = {s: {u: (min(v), max(v) + 1) for u, v in d.items() if v}
                for s, d in sets.items()}
    elif mode == "intervalsets":
        # overlapping and touching intervals, merged by IntervalSet
        cls = JIntervalSet if package == "catch_tpu" else TIntervalSet
        sets = {s: {u: cls([(x, x + 3) for x in sorted(v)]) for u, v in
                    d.items() if v} for s, d in sets.items()}
    inst, _ = sc.build_instance(sets, costs=costs, universe_p=p, ranks=ranks,
                                use_intervalsets=mode != "elements")
    assert len(inst.ivl_start) > 0 and _in_order(inst)


@pytest.mark.parametrize("package", list(PACKAGES))
@pytest.mark.parametrize("seed", range(3))
def test_build_instance_from_cover_arrays_gives_the_order(package, seed):
    """Spans in random order, overlapping, repeated and empty, several a
    (set, universe)."""
    rng = np.random.default_rng(seed)
    n, n_sets, nU = 500, 50, 4
    start = rng.integers(0, 2000, size=n)
    end = start + rng.integers(0, 120, size=n)
    sid, univ = rng.integers(0, 40, size=n), rng.integers(0, nU, size=n)
    start[:50], end[:50], sid[:50], univ[:50] = (
        start[50:100], end[50:100], sid[50:100], univ[50:100])
    order = rng.permutation(n)
    inst = PACKAGES[package].build_instance_from_cover_arrays(
        sid[order], univ[order], start[order], end[order], n_sets, nU,
        np.array([1.0, 0.9, 0.5, 1.0]), ranks=rng.integers(1, 3, n_sets))
    assert len(inst.ivl_start) > 0 and _in_order(inst)


@pytest.mark.parametrize("ranks", [False, True])
def test_instance_to_host_gives_the_order(small_shapes, ranks):
    """Both packages' scan instances (read back from the merged rows),
    on two chromosomes a genome and partial coverage."""
    rng = np.random.default_rng(29)
    genomes = _genomes(rng, 5, 1500, n_chrs=2)
    model = dict(mismatches=2, lcf_thres=60)
    rank_of = None
    if ranks:
        n_probes = _scan_inputs(genomes, model)["n_probes"]
        rank_of = rng.integers(0, 3, size=n_probes).astype(np.int64)
    for inst in _both_instances(genomes, model, 20,
                                universe_p=np.array([1, .8, .5, 1, .9]),
                                ranks=rank_of):
        assert len(inst.ivl_start) > 0 and _in_order(inst)


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
def test_set_cover_filter_solves_instances_in_order(tmp_path, monkeypatch,
                                                    custom):
    """Every instance the filters of both packages hand their solver, on
    duplicate candidates with identification's rank tiers; `custom`
    takes the custom model's route (build_instance_from_cover_arrays)."""
    seen = []
    for sc in PACKAGES.values():
        real = sc.solve_instance

        def spy(inst, *args, real=real, **kwargs):
            seen.append(inst)
            return real(inst, *args, **kwargs)

        monkeypatch.setattr(sc, "solve_instance", spy)
    seqs = _corpus(13, length=500)
    cands = [s[i:i + 60] for s in seqs[:5] for i in range(0, 400, 40)]
    cands += cands[:7]
    kw = dict(mismatches=3, lcf_thres=60, identify=True, coverage=0.9,
              cover_extension=10)
    if custom:
        kw["custom_cover_range_fn"] = (_fn_file(tmp_path, ANCHORED),
                                       "anchored")
    for P, G, F, dev in ((JProbe, JGenome, JFilter, {}),
                         (TProbe, TGenome, TFilter, {"device": "cpu"})):
        groups = [[G.from_one_seq(s) for s in seqs[:3]],
                  [G.from_one_seq(s) for s in seqs[3:]]]
        probes = [[P.from_str(s) for s in cands[:30]],
                  [P.from_str(s) for s in cands[25:]]]
        F(**kw, **dev).filter(probes, groups, input_is_grouped=True)
    assert len(seen) == 4
    for inst in seen:
        assert len(inst.ivl_start) > 0 and _in_order(inst)
        assert len(np.unique(inst.rank_idx)) > 1


def test_random_instances_in_order():
    """The random instances the sharded tests solve are in order."""
    assert all(_in_order(i) for i in _random_instances())
