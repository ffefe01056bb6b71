#!/usr/bin/env python3
"""Ablation of K10 assemble and K11 init_covered on one NVIDIA GPU: what
each part of the single-pass designs costs.

Run from the root of a checkout:  python3 tools/k10_k11_ablation.py

Each variant is the checkout's own csrc/assemble.cu or
csrc/init_covered.cu with one part cut out by a textual edit (the edit
must apply exactly once), built by nvcc into build/k10_k11_ablation/:
  K10: "whole"; "no look-back" (every tile's carry is the identity);
       "no pair writes" (no univ_of_pair, pair_bounds, set_bounds or
       maxima); both cut;
  K11: "whole"; "scan only" (no reach atomics: the memset and the
       max-scan); "scan only, no look-back".
A variant with a part cut computes wrong arrays; only its time is read.
Each C entry point (memset and kernels, no Python wrapper) is timed with
CUDA events over 3 x 30 calls (min and max of the 3 means, us), on
inputs of ebola175's stage E shape (3,209,031 rows, one a pair, 175
universes, 18,730 sets, 3,303,209 positions) and of the solver
instance's (399,635 rows, 128 universes, 100,000 sets, 1,044,655
positions), keys drawn from default_rng(1).  A copy of the 24 bytes a
row that K10 reads (torch's copy_, read and write) is timed beside them
as the card's rate on these shapes.
"""

import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from catch_tpu_torch import _build  # noqa: E402
from catch_tpu_torch.ops import scan_instance, set_cover  # noqa: E402

CSRC = os.path.join(ROOT, "catch_tpu_torch", "csrc")
OUT = os.path.join(ROOT, "build", "k10_k11_ablation")

NO_LOOKBACK = ("""    if (tile > 0) {
        carry = st.exclusive(tile, op);""", """    if (false) {
        carry = st.exclusive(tile, op);""")
NO_PAIR_WRITES = ("""        if (f0[j]) { univ_of_pair[p0]""",
                  """        if (r < 0) {
        if (f0[j]) { univ_of_pair[p0]"""), ("""            ws[1] = P;
        }
    }""", """            ws[1] = P;
        }
        }
    }""")
SCAN_ONLY = ("""    if (M > 0)
        ic_reach_kernel""", """    if (false)
        ic_reach_kernel""")
SCAN_NO_LOOKBACK = ("""    if (tile > 0) {
        run = st.exclusive""", """    if (false) {
        run = st.exclusive""")
VARIANTS = {
    "K10 whole": ("assemble.cu", ()),
    "K10 no look-back": ("assemble.cu", (NO_LOOKBACK,)),
    "K10 no pair writes": ("assemble.cu", NO_PAIR_WRITES),
    "K10 neither": ("assemble.cu", (NO_LOOKBACK,) + NO_PAIR_WRITES),
    "K11 whole": ("init_covered.cu", ()),
    "K11 scan only": ("init_covered.cu", (SCAN_ONLY,)),
    "K11 scan only, no look-back": ("init_covered.cu",
                                    (SCAN_ONLY, SCAN_NO_LOOKBACK)),
}


def build(item):
    """The variant's shared library, from an edited copy of its source."""
    i, (name, (src, edits)) = item
    text = open(os.path.join(CSRC, src)).read()
    for old, new in edits:
        if text.count(old) != 1:
            sys.exit(f"k10_k11_ablation: the edit for {name!r} does not "
                     f"apply to {src} exactly once")
        text = text.replace(old, new)
    path = os.path.join(OUT, f"v{i}_{src}")
    with open(path, "w") as f:
        f.write(text)
    lib = os.path.join(OUT, f"v{i}.so")
    subprocess.run([_build._nvcc()] + _build.NVCC_FLAGS
                   + ["-shared", "-I", CSRC, "-o", lib, path], check=True)
    return name, lib


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("k10_k11_ablation: torch.cuda is not available")
    os.makedirs(OUT, exist_ok=True)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:
        libs = dict(pool.map(build, enumerate(VARIANTS.items())))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    rng = np.random.default_rng(1)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    def us(fn, reps=30):
        fn()
        torch.cuda.synchronize()
        means = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            torch.cuda.synchronize()
            means.append(1e3 * a.elapsed_time(b) / reps)
        return min(means), max(means)

    for shape, n, nU, S, U in (("ebola175", 3209031, 175, 18730, 3303209),
                               ("solver instance", 399635, 128, 100000,
                                1044655)):
        if shape == "ebola175":
            key = np.sort(rng.choice(S * nU, size=n, replace=False))
        else:
            key = np.sort(rng.integers(0, S * nU, size=n))
        u_len = U // nU
        start = rng.integers(0, u_len - 300, size=n)
        end = start + rng.integers(1, 300, size=n)
        offsets = np.arange(nU + 1, dtype=np.int64) * u_len
        k, s, e, off = (torch.from_numpy(x.astype(np.int64)).to(dev)
                        for x in (key, start, end, offsets))
        gs, ge = (torch.from_numpy((x + offsets[key % nU]).astype(np.int32))
                  .to(dev) for x in (start, end))
        outs = [torch.empty(n + 4, dtype=torch.int32, device=dev)
                for _ in range(4)]
        sb = torch.empty(S + 1, dtype=torch.int32, device=dev)
        ws10 = torch.empty(4 + 7 * -(-n // scan_instance._ASSEMBLE_TILE),
                           dtype=torch.int32, device=dev)
        n_tiles = -(-U // set_cover._IC_TILE)
        reach_off = -(-(1 + 3 * n_tiles) // 4) * 4
        ws11 = torch.empty(reach_off + U, dtype=torch.int32, device=dev)
        cov = torch.empty(U, dtype=torch.bool, device=dev)
        print(f"== {shape}: {n} rows, {S} sets, {U} positions", flush=True)
        for name, path in libs.items():
            lib = ctypes.CDLL(path)
            if name.startswith("K10"):
                fn = lib.ct_assemble
                fn.argtypes = _build._SIGNATURES["ct_assemble"]
                args = (ptr(k), ptr(s), ptr(e), n, ptr(off), nU, S, 1,
                        *map(ptr, outs), ptr(sb), ptr(ws10), stream)
            else:
                fn = lib.ct_init_covered
                fn.argtypes = _build._SIGNATURES["ct_init_covered"]
                args = (ptr(gs), ptr(ge), n, 1, U, ptr(ws11), ws11.numel(),
                        reach_off, ptr(cov), stream)
            lo, hi = us(lambda: fn(*args))
            print(f"{name}: {lo:.1f}-{hi:.1f} us", flush=True)
        x = torch.empty(3 * n, dtype=torch.int64, device=dev)
        y = torch.empty_like(x)
        lo, hi = us(lambda: y.copy_(x))
        print(f"copy of 24 bytes a row: {lo:.1f}-{hi:.1f} us", flush=True)


if __name__ == "__main__":
    main()
