"""The mesh across processes (parallel/distributed.py) against catch_tpu.

Two gloo ranks on 127.0.0.1, each with two virtual CPU places
(CATCH_TPU_VIRTUAL_DEVICES=2), make a global mesh of 4 places, as
tests/test_distributed.py runs two jax.distributed processes with two
CPU devices each.  In one run the ranks design catch_tpu's 4 Ebola
genomes (-pl 80, stride 40, 1 mismatch, lcf_thres 80, extension 20)
through ProbeDesigner and SetCoverFilter(mesh=), solve instances with
solve_instance_sharded (K18's twin, exchanging every step) and verify
spans with verify_spans_sharded (exchanging the spans); the pytest
process holds every rank's results against the port on one process and
against catch_tpu on its virtual CPU devices, exactly.  The CLI runs in
two ranks under both launch styles, and a lone rank raises within its
timeout.  The ranks import no jax.
"""

import hashlib
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from catch_tpu.designer import ProbeDesigner as JDesigner
from catch_tpu.filters.duplicate import DuplicateFilter as JDuplicate
from catch_tpu.filters.set_cover_filter import SetCoverFilter as JFilter
from catch_tpu.ops import scan_sparse as jss
from catch_tpu.ops import set_cover as jsc
from catch_tpu.parallel import make_mesh as jmake_mesh
from catch_tpu.parallel import solve_instance_sharded as jsolve_sharded
from catch_tpu.utils import seq_io as jseq_io
from catch_tpu_torch import convert
from catch_tpu_torch.designer import ProbeDesigner as TDesigner
from catch_tpu_torch.filters.duplicate import DuplicateFilter as TDuplicate
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter as TFilter
from catch_tpu_torch.ops import scan_sparse as tss
from catch_tpu_torch.parallel import distributed
from catch_tpu_torch.parallel.mesh import Mesh
from catch_tpu_torch.utils import seq_io as tseq_io
from test_torch_cuda import _cover_instance
from test_torch_parallel import (
    _cli, _records, _span_candidates, _subset, _random_instances)
from test_torch_span_scan import _pad32, _pow2
from torch_ranks import python_script, rank_envs, run_ranks

FIXTURE = "tests/data/zaire_ebolavirus.fasta.gz"

# One rank of the main run: reads the job from argv[1], writes its
# results to argv[2] % rank.
_JOB = r"""
import hashlib, pickle, sys
import torch
torch.set_num_threads(1)
from catch_tpu_torch.designer import ProbeDesigner
from catch_tpu_torch.filters.duplicate import DuplicateFilter
from catch_tpu_torch.filters.set_cover_filter import SetCoverFilter
from catch_tpu_torch.ops import scan_sparse as tss
from catch_tpu_torch.parallel import distributed, make_mesh
from catch_tpu_torch.parallel import set_cover as psc
from catch_tpu_torch.utils import seq_io

assert distributed.maybe_initialize(), "the group was not initialized"
assert distributed.process_count() == 2
rank = distributed.process_index()
mesh = make_mesh(device="cpu")
with open(sys.argv[1], "rb") as f:
    job = pickle.load(f)
out = dict(size=mesh.size, own=mesh.own, ranks=mesh.ranks)

genomes = seq_io.read_genomes_from_fasta(
    "tests/data/zaire_ebolavirus.fasta.gz")[:4]
scf = SetCoverFilter(mismatches=1, lcf_thres=80, cover_extension=20,
                     device="cpu", mesh=mesh)
d = ProbeDesigner([genomes], [DuplicateFilter(), scf], probe_length=80,
                  probe_stride=40, device="cpu")
d.design()
ps = sorted(p.seq_str for p in d.final_probes)
out["hash"] = "HASH %d %s" % (
    len(ps), hashlib.sha224("".join(ps).encode()).hexdigest())
out["by_place"] = sorted(scf.last_run_stats["launches_by_place"])

out["solve"] = {}
for name, inst in job["instances"].items():
    e0 = psc.greedy_steps_sharded.exchanges
    order = psc.solve_instance_sharded(inst, mesh=mesh)
    out["solve"][name] = (order, psc.greedy_steps_sharded.exchanges - e0)

out["spans"] = {}
for name, (mega, codes, cand, vargs) in job["spans"].items():
    reps = [(torch.from_numpy(mega), torch.from_numpy(codes))
            for _ in mesh.own]
    got = tss.verify_spans_sharded(
        reps, *[torch.from_numpy(c) for c in cand], mesh=mesh, **vargs)
    out["spans"][name] = [g.numpy() for g in got]
with open(sys.argv[2] % rank, "wb") as f:
    pickle.dump(out, f)
"""

SOLVE_CASES = {
    "random0": lambda: _random_instances()[0],
    "random1": lambda: _random_instances()[1],
    "ties": lambda: _cover_instance("ties"),
}
SPAN_CASES = {"mismatch": None, "three": 3}


def _span_job(case):
    t, mega, cand = _span_candidates("mismatch")
    keep = SPAN_CASES[case]
    if keep is not None:
        cand = tuple(x[:keep].contiguous() for x in cand)
    return (mega, t.probe_codes, tuple(c.numpy() for c in cand),
            tss.verify_args(t)), t


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results of _JOB, and the job."""
    tmp = tmp_path_factory.mktemp("ranks")
    job = dict(instances={}, spans={})
    for name, make in SOLVE_CASES.items():
        inst = make()
        job["instances"][name] = (
            inst if type(inst).__module__.startswith("catch_tpu_torch")
            else convert.instance_from_reference(inst))
    for name in SPAN_CASES:
        job["spans"][name] = _span_job(name)[0]
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    out = str(tmp / "out%d.pkl")
    run_ranks([python_script(_JOB) + [str(tmp / "job.pkl"), out]] * 2,
              rank_envs(2, 2), timeout=600)
    results = []
    for rank in range(2):
        with open(out % rank, "rb") as f:
            results.append(pickle.load(f))
    return results, job


def _hash(probes):
    ps = sorted(p.seq_str for p in probes)
    return "HASH %d %s" % (len(ps),
                           hashlib.sha224("".join(ps).encode()).hexdigest())


def test_without_variables_nothing_happens(monkeypatch):
    for var in ("CATCH_TPU_COORDINATOR", "CATCH_TPU_MULTIHOST"):
        monkeypatch.delenv(var, raising=False)
    assert distributed.maybe_initialize() is False
    assert not distributed.is_initialized()
    assert distributed.process_index() == 0
    assert distributed.process_count() == 1


def test_mesh_of_ranks():
    """A mesh's view of its places across ranks, built without a group;
    a mesh of places of one process is its own as before.  A set-cover
    filter on a mesh across ranks is not group-local."""
    cpu = torch.device("cpu")
    mesh = Mesh(["cpu"] * 4, ranks=[0, 0, 1, 1], rank=1)
    assert mesh.size == 4 and mesh.own == (2, 3) and mesh.spans_ranks
    assert mesh.local_places == (cpu, cpu) and mesh.lead == cpu
    assert mesh.counts() == [2, 2]
    assert "rank 1: cpu" in repr(mesh)
    one = Mesh(["cpu"] * 3)
    assert one.own == (0, 1, 2) and not one.spans_ranks
    assert repr(one) == "Mesh(cpu, cpu, cpu)"
    # the span scans exchange across ranks in one order: no group
    # pipeline on such a mesh
    avoid = dict(mismatches=1, lcf_thres=80, device="cpu",
                 avoided_genomes=["bg.fasta"])
    assert TFilter(**avoid, mesh=one).group_local
    assert not TFilter(**avoid, mesh=mesh).group_local
    with pytest.raises(ValueError, match="rank order"):
        Mesh(["cpu"] * 2, ranks=[1, 0])
    with pytest.raises(ValueError, match="without a place of rank 2"):
        Mesh(["cpu"] * 2, ranks=[0, 1], rank=2)


def test_two_rank_design_matches_single_process(two_ranks):
    """The counterpart of tests/test_distributed.py: the probe hash on
    both ranks equals the port's single-process one and catch_tpu's; each
    rank scans on its own two places."""
    results, _ = two_ranks
    for r, res in enumerate(results):
        assert res["size"] == 4 and res["ranks"] == (0, 0, 1, 1)
        assert res["own"] == (2 * r, 2 * r + 1)
        assert res["by_place"] == [0, 1]
    assert results[0]["hash"] == results[1]["hash"]
    genomes = tseq_io.read_genomes_from_fasta(FIXTURE)[:4]
    d = TDesigner([genomes], [TDuplicate(), TFilter(
        mismatches=1, lcf_thres=80, cover_extension=20, device="cpu")],
        probe_length=80, probe_stride=40, device="cpu")
    d.design()
    assert results[0]["hash"] == _hash(d.final_probes)
    genomes = jseq_io.read_genomes_from_fasta(FIXTURE)[:4]
    d = JDesigner([genomes], [JDuplicate(), JFilter(
        mismatches=1, lcf_thres=80, cover_extension=20)], probe_length=80,
        probe_stride=40)
    d.design()
    assert results[0]["hash"] == _hash(d.final_probes)


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_two_rank_sharded_solve_matches_catch_tpu(two_ranks, case):
    """The pick order on both ranks equals catch_tpu's sharded solver at
    4 places and the host solver's; the steps exchanged across ranks."""
    results, job = two_ranks
    inst = job["instances"][case]
    want = jsolve_sharded(inst, mesh=jmake_mesh(4))
    assert len(want) > 0
    assert np.array_equal(want, jsc.solve_instance(inst, force_device=False))
    for res in results:
        order, exchanges = res["solve"][case]
        assert order.dtype == np.int32 and np.array_equal(order, want)
        # two a step, and at least one step a pick
        assert exchanges >= 2 * len(want)


@pytest.mark.parametrize("case", list(SPAN_CASES))
def test_two_rank_verify_spans_matches_catch_tpu(two_ranks, case):
    """Both ranks' spans equal single-place verify_spans and catch_tpu's
    _verify_chunk_sharded at 4 devices joined in shard order ('three':
    fewer candidates than places, so some blocks and a rank's are
    empty)."""
    results, job = two_ranks
    mega, codes, cand, vargs = job["spans"][case]
    want = tss.verify_spans(torch.from_numpy(mega), torch.from_numpy(codes),
                            *[torch.from_numpy(c) for c in cand], **vargs)
    assert want[0].numel() > 0
    for res in results:
        for g, w in zip(res["spans"][case], want):
            assert g.dtype == np.int64 and np.array_equal(g, w.numpy())
    n = 4
    C_loc = max(1 << 10, _pow2(-(-len(cand[0]) // n)))
    _, t = _span_job(case)
    out = jss._verify_chunk_sharded(
        jnp.asarray(mega), jnp.asarray(codes),
        *[_pad32(x, C_loc * n) for x in cand],
        jnp.int32(vargs["k_seed"]), mesh=jmake_mesh(n), L=t.Lmax,
        K=vargs["K"], C_loc=C_loc, cap_loc=2 * C_loc,
        seed_req=vargs["seed_req"], fast_ok=vargs["fast_ok"])
    sp, nq = [np.asarray(x) for x in out[:3]], np.asarray(out[4]).reshape(-1)
    for g, x in zip(results[0]["spans"][case], sp):
        assert np.array_equal(
            g, np.concatenate([x[d, :nq[d]] for d in range(n)]))


_CLI = r"""
import runpy, sys
from catch_tpu_torch.parallel import distributed
calls = []
gather = distributed.all_gather_rows
distributed.all_gather_rows = lambda *a: (calls.append(1), gather(*a))[1]
sys.argv = ["design"] + sys.argv[1:]
runpy.run_module("catch_tpu_torch.cli.design", run_name="__main__")
assert distributed.is_initialized() and distributed.process_count() == 2
print("EXCHANGES", len(calls))
"""


@pytest.mark.parametrize("launcher", ["coordinator", "multihost"])
def test_cli_in_two_ranks(tmp_path, monkeypatch, launcher):
    """The design CLI in two ranks (CATCH_TPU_COORDINATOR, or
    CATCH_TPU_MULTIHOST=1 with the env:// variables), two datasets with
    avoided genomes, so each group's span scan exchanges across ranks
    (the groups one after another): each rank writes its own output,
    equal to the single-process run."""
    a, b = _subset(tmp_path, 2), _subset(tmp_path, 4)
    # a background holding pieces of the 4th genome, between random bases
    seq = tseq_io.read_genomes_from_fasta(b)[3].seqs[0]
    rng = np.random.default_rng(1)
    bg = "".join(rng.choice(list("ACGT"), 3000)) + seq[2000:2600] + "".join(
        rng.choice(list("ACGT"), 3000)) + seq[9000:9300]
    (tmp_path / "bg.fasta").write_text(f">bg\n{bg}\n")
    flags = [a, b, "-pl", "100", "-m", "1", "-l", "80", "-e", "10",
             "--avoid-genomes", str(tmp_path / "bg.fasta"), "--device", "cpu"]
    outs = [str(tmp_path / f"rank{r}.fasta") for r in range(2)]
    logs = run_ranks(
        [python_script(_CLI) + flags + ["-o", o, "--num-devices", "4"]
         for o in outs], rank_envs(2, 2, launcher), timeout=600)
    for log in logs:
        # two a span scan: the counts, then the spans
        assert int(log.split("EXCHANGES")[-1]) >= 4
    monkeypatch.delenv("CATCH_TPU_VIRTUAL_DEVICES", raising=False)
    want = str(tmp_path / "one.fasta")
    _cli(flags + ["-o", want])
    assert len(_records(want)) > 0
    for o in outs:
        assert _records(o) == _records(want)


_LONE = r"""
import datetime, sys
from catch_tpu_torch.parallel import distributed
try:
    distributed.maybe_initialize(timeout=datetime.timedelta(seconds=5))
except Exception as e:
    print("RAISED", type(e).__name__, flush=True)
else:
    sys.exit("a lone rank initialized")
"""


@pytest.mark.parametrize("rank", [0, 1])
def test_a_lone_rank_raises(rank):
    """CATCH_TPU_NUM_PROCESSES=2 with one rank started: rank 0 waits for
    the other at its own store, rank 1 for a store nobody holds; each
    raises within its 5 s timeout and does not hang."""
    env = rank_envs(2, 1)[rank]
    out, = run_ranks([python_script(_LONE)], [env], timeout=120)
    assert out.startswith("RAISED")
