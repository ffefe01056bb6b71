"""The harness's parts that belong to one name, each a file of its own
that the harness finds by that name: bench_port/<folder>/<name>.py.

- metrics/<metric>.py: read(ctx), one metric of BENCHMARK.json;
- generators/<generator>.py: make(spec, rng, job_dir), named by a
  traffic file's "generator";
- checks/<check>.py: numbers(config, job, device), named by a
  configuration's "check";
- entries/<entry>.py: run(config, job, extra, device), named by a
  configuration's "entry".

A later cell adds such files and edits none of the harness.
"""
import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))
_loaded = {}


def load(folder, name):
    """The module bench_port/<folder>/<name>.py, loaded once."""
    key = (folder, name)
    if key not in _loaded:
        path = os.path.join(HERE, folder, name + ".py")
        if not os.path.isfile(path):
            raise ValueError(f"no {folder} file {name!r} ({path})")
        spec = importlib.util.spec_from_file_location(
            "bench_port_" + folder + "_" +
            name.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _loaded[key] = mod
    return _loaded[key]
