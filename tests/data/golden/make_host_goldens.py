#!/usr/bin/env python3
"""Make the goldens of chip_smoke.py phase 24 with catch_tpu (the JAX
reference) on the CPU.

Run from the root of a checkout:

    JAX_PLATFORMS=cpu python tests/data/golden/make_host_goldens.py [adapters] [custom] [naive]

adapters: catch_tpu.cli.design on the first 175 ebola genomes with
          -pl 100 -m 2 -l 60 -e 50 --add-adapters
          --add-reverse-complements.  Writes ebola175_m2_adapters_rc.fasta.
custom:   catch_tpu.cli.design on the first 5 ebola genomes with -pl 100
          and --custom-hybridization-fn on chip_smoke.CUSTOM_FN_SRC.
          Writes ebola5_custom_fn.fasta.
naive:    catch_tpu.cli.design_naively on the first 5 ebola genomes with
          -nrf 2 60 and with -dsf 2 60, each with --print-analysis, in a
          child process made by chip_smoke.naive_command (numpy's global
          generator seeded, PYTHONHASHSEED fixed, run in
          build/chip_smoke/ with the dataset named ebola5.fasta).  Writes
          ebola5_naive_nrf_2_60.txt and ebola5_naive_dsf_2_60.txt.

Inputs go under build/chip_smoke/, the same files chip_smoke.py makes.
Each step prints its wall seconds.
"""

import os
import subprocess
import sys
import time

GOLDEN = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(GOLDEN)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


def design(argv):
    from catch_tpu.cli import design as cli
    cli.main(cli.init_and_parse_args("basic", argv))


def make_adapters():
    design([chip_smoke.write_subset(175), "-o",
            os.path.join(GOLDEN, "ebola175_m2_adapters_rc.fasta"),
            "-pl", "100", "-m", "2", "-l", "60", "-e", "50",
            "--add-adapters", "--add-reverse-complements"])


def make_custom():
    design([chip_smoke.write_subset(5), "-o",
            os.path.join(GOLDEN, "ebola5_custom_fn.fasta"), "-pl", "100",
            "--custom-hybridization-fn", chip_smoke.write_custom_fn(),
            chip_smoke.CUSTOM_FN_NAME])


def make_naive():
    in5 = os.path.basename(chip_smoke.write_subset(5))
    for flag in ("-nrf", "-dsf"):
        argv, env = chip_smoke.naive_command(
            "catch_tpu", [in5, flag, "2", "60", "--print-analysis"])
        env["JAX_PLATFORMS"] = "cpu"
        out = subprocess.run(argv, env=env, cwd=chip_smoke.WORK,
                             capture_output=True, text=True,
                             check=True).stdout
        name = f"ebola5_naive_{flag[1:]}_2_60.txt"
        with open(os.path.join(GOLDEN, name), "w") as f:
            f.write(out)


def main():
    os.makedirs(chip_smoke.WORK, exist_ok=True)
    steps = {"adapters": make_adapters, "custom": make_custom,
             "naive": make_naive}
    for name in sys.argv[1:] or list(steps):
        t0 = time.time()
        steps[name]()
        print(f"{name}: {time.time() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main()
