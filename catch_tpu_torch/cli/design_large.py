#!/usr/bin/env python3
# Copied from catch_tpu/cli/design_large.py.
"""Design probes with defaults for large, highly diverse input.

Thin wrapper around the design program with args_type='large':
-m 5 -e 50, MinHash clustering at 0.15 over fragments of 50,000 nt, and
the MinHash near-duplicate filter at 0.6.  `--device` defaults to `cuda`.

Run as ``python -m catch_tpu_torch.cli.design_large``.
"""

from catch_tpu_torch.cli import design


def run():
    design.main(design.init_and_parse_args(args_type="large"))


if __name__ == "__main__":
    run()
