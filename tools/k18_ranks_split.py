#!/usr/bin/env python3
"""Where K18 greedy_sharded's time goes across two ranks on one NVIDIA GPU.

Run from the root of a checkout:  python3 tools/k18_ranks_split.py

Two ranks (chip_smoke.run_two_ranks: a gloo group on 127.0.0.1, two
virtual places each, so a mesh of 4 places across the processes, both
on the one card) take ebola175's host instance (-pl 100 -m 2 -l 60 -e
50, read back from instance_to_host in a design on the card) and time
one 64-step dispatch from the initial states, host clock to a
synchronised end, median [min, max] of 5 after a warm-up that keeps the
regrouping:
  one_process_ms             all 4 places in one rank (Mesh of its own),
                             while the other rank waits at a barrier;
  one_process_both_ranks_ms  the same in both ranks at once: two CUDA
                             contexts sharing the card, no exchange;
  across_ranks_ms            the mesh across the ranks, exchanging;
then the exchanges of 5 more dispatches across the ranks, each part's
host seconds summed and given a step: `wait` (the synchronize before
the copy to the host: the card finishing the phase's kernels), `to_host`
(the copy into pinned memory), `gather` (gloo's all_gather),
`back` (the join and the copy of the gathered rows to the card) and
`unpack` (the rows written into the card's buffers, to a synchronised
end); and gloo's all_gather alone on host tensors of the slot exchange's
and the row exchange's shapes (`gloo_ms`, median of 200).  One JSON
line a rank, with the card's name and power limit.
"""

import contextlib
import importlib.util
import json
import os
import pickle
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK_SPLIT = r"""
import json, os, pickle, statistics, sys, time
import torch
import torch.distributed as dist
from catch_tpu_torch.ops import set_cover as sct
from catch_tpu_torch.parallel import distributed, make_mesh
from catch_tpu_torch.parallel import set_cover as psc
from catch_tpu_torch.parallel.mesh import Mesh

work = sys.argv[1]
assert distributed.maybe_initialize()
rank = distributed.process_index()
with open(os.path.join(work, "instance.pkl"), "rb") as f:
    inst = pickle.load(f)
mesh = make_mesh(4, "cuda")
N, REPS = sct._STEPS_PER_DISPATCH, 5


def setup(m):
    part = psc.place_partition(psc.partition_instance(inst, 4),
                               inst.can_uncover, m)
    consts, u_size = sct._instance_consts(inst, m.lead)
    states0 = psc.initial_states(sct.init_covered(
        consts["ivl_start"], consts["ivl_end"], inst.u_len), u_size, part)
    return part, states0


def clone(states0):
    return [{k: v.clone() for k, v in s.items()} for s in states0]


def dispatch_ms(part, states0, reps=REPS):
    times = []
    for _ in range(reps):
        s = clone(states0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        psc.greedy_steps_sharded(s, part, N)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return [statistics.median(times), min(times), max(times)]


out = dict(rank=rank, steps=N)
lpart, lstates0 = setup(Mesh([mesh.lead] * 4))
for r in range(2):
    if r == rank:
        psc.greedy_steps_sharded(clone(lstates0), lpart, N)
        out["one_process_ms"] = dispatch_ms(lpart, lstates0)
    dist.barrier()
out["one_process_both_ranks_ms"] = dispatch_ms(lpart, lstates0)
dist.barrier()
part, states0 = setup(mesh)
psc.greedy_steps_sharded(clone(states0), part, N)
out["across_ranks_ms"] = dispatch_ms(part, states0)

took = dict(wait=0.0, to_host=0.0, gather=0.0, back=0.0, unpack=0.0)
shapes = {}


def gather_rows(x, counts):
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    host = distributed._to_host(x)
    t2 = time.perf_counter()
    sent = torch.zeros((max(counts), *x.shape[1:]), dtype=x.dtype)
    sent[:x.shape[0]] = host
    got = [torch.empty_like(sent) for _ in counts]
    dist.all_gather(got, sent)
    t3 = time.perf_counter()
    rows = torch.cat([g[:c] for g, c in zip(got, counts)]).to(x.device)
    torch.cuda.synchronize()
    t4 = time.perf_counter()
    took["wait"] += t1 - t0
    took["to_host"] += t2 - t1
    took["gather"] += t3 - t2
    took["back"] += t4 - t3
    shapes[tuple(sent.shape)] = shapes.get(tuple(sent.shape), 0) + 1
    return rows


unpack = psc._unpack


def unpack_timed(t, names, rows):
    t0 = time.perf_counter()
    unpack(t, names, rows)
    torch.cuda.synchronize()
    took["unpack"] += time.perf_counter() - t0


psc.distributed.all_gather_rows = gather_rows
psc._unpack = unpack_timed
e0 = psc.greedy_steps_sharded.exchanges
instrumented = dispatch_ms(part, states0)
steps = REPS * N
out["instrumented_ms"] = instrumented
out["exchanges_per_step"] = (psc.greedy_steps_sharded.exchanges - e0) / steps
out["exchange_ms_per_step"] = {k: 1e3 * v / steps for k, v in took.items()}
out["exchange_shapes"] = {str(k): v for k, v in shapes.items()}
gloo = {}
for shape in shapes:
    sent = torch.zeros(shape, dtype=torch.int32)
    got = [torch.empty_like(sent) for _ in range(2)]
    times = []
    for _ in range(200):
        t0 = time.perf_counter()
        dist.all_gather(got, sent)
        times.append(1e3 * (time.perf_counter() - t0))
    gloo[str(shape)] = statistics.median(times)
out["gloo_ms"] = gloo
with open(os.path.join(work, f"split{rank}.json"), "w") as f:
    json.dump(out, f)
"""


def main():
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        sys.exit("k18_ranks_split: torch.cuda is not available")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    from catch_tpu_torch.ops import scan_instance as si

    card = chip_smoke.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"]).splitlines()[0]
    work = os.path.join(chip_smoke.WORK, "k18_ranks")
    os.makedirs(work, exist_ok=True)
    kept = []
    with contextlib.redirect_stdout(sys.stderr), chip_smoke.recording(
            si, "instance_to_host", lambda a, k, r: kept.append(r)):
        chip_smoke.design([chip_smoke.write_subset(175), "-o",
                           os.path.join(work, "ebola175.fasta"), "-pl",
                           "100", "-m", "2", "-l", "60", "-e", "50",
                           "--device", "cuda"])
    inst, = kept
    with open(os.path.join(work, "instance.pkl"), "wb") as f:
        pickle.dump(inst, f)
    chip_smoke.run_two_ranks(RANK_SPLIT, [work], timeout=600)
    for rank in range(2):
        with open(os.path.join(work, f"split{rank}.json")) as f:
            print(json.dumps(dict(card=card, **json.load(f))), flush=True)


if __name__ == "__main__":
    main()
