#!/usr/bin/env python3
"""Make the pool goldens of chip_smoke.py phase 25 with catch_tpu (the
JAX reference) on the CPU.

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python tests/data/golden/make_pool_goldens.py

Runs catch_tpu.cli.pool in a child process (chip_smoke.pool_command:
numpy's global generator seeded with 1 after the import) on each of
chip_smoke.pool_cases():

  pool_vwafr_90000_round_1_10.tsv  num-probes.V-WAfr.201506.tsv 90000
                                   --round-params 1 10
  pool_vwafr_90000_nd.tsv          the same grid and budget, --use-nd
                                   --loss-coeffs 1 0.01
  pool_vall60.tsv                  the 60-dataset V-All slice (written
                                   by chip_smoke.vall_slice under
                                   build/chip_smoke/) at 70945 probes

Each prints the CLI's output and its wall seconds (about 10, 10 and 45 s
on one CPU core).
"""

import os
import subprocess
import sys
import time

GOLDEN = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(GOLDEN)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def main():
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    for name, before, after in chip_smoke.pool_cases():
        argv, env = chip_smoke.pool_command(
            "catch_tpu", before + [os.path.join(GOLDEN, name)] + after)
        env["JAX_PLATFORMS"] = "cpu"
        t0 = time.time()
        out = subprocess.run(argv, env=env, capture_output=True, text=True,
                             check=True).stdout
        print(f"{name}: {out.strip()!r}; {time.time() - t0:.1f} s",
              flush=True)


if __name__ == "__main__":
    main()
