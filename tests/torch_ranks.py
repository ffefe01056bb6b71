"""Local ranks of catch_tpu_torch for the tests, without JAX.

run_ranks starts one Python process a rank on this host, joined by a
gloo group over 127.0.0.1 (parallel/distributed.py), and waits for all
of them: if one fails or the time runs out, every rank is killed, and
the failure names each rank's exit code and the tail of its stderr.
The ranks get PYTHONPATH set to the repo, one intra-op thread and no
CATCH_TPU_* or launcher variables but the ones given here.
"""

import os
import socket
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# Appended to every rank's script: the port imports no jax.
NO_JAX = "\nimport sys\nassert 'jax' not in sys.modules, 'a rank imported jax'\n"
_LAUNCHER_VARS = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                  "LOCAL_RANK")


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_envs(n_ranks, virtual, launcher="coordinator", **extra):
    """One environment a rank: `virtual` places each
    (CATCH_TPU_VIRTUAL_DEVICES), the group's address through
    CATCH_TPU_COORDINATOR ("coordinator") or through the env://
    variables with CATCH_TPU_MULTIHOST=1 ("multihost"), and `extra`."""
    port = free_port()
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("CATCH_TPU_") and k not in _LAUNCHER_VARS}
    base.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                CATCH_TPU_VIRTUAL_DEVICES=str(virtual), **extra)
    envs = []
    for rank in range(n_ranks):
        env = dict(base)
        if launcher == "coordinator":
            env.update(CATCH_TPU_COORDINATOR=f"127.0.0.1:{port}",
                       CATCH_TPU_NUM_PROCESSES=str(n_ranks),
                       CATCH_TPU_PROCESS_ID=str(rank))
        else:
            env.update(CATCH_TPU_MULTIHOST="1", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), RANK=str(rank),
                       WORLD_SIZE=str(n_ranks))
        envs.append(env)
    return envs


def python_script(script):
    """The command that runs `script` in a fresh interpreter, then checks
    that it imported no jax."""
    return [sys.executable, "-c", script + NO_JAX]


def run_ranks(cmds, envs, timeout):
    """Run cmds[r] in envs[r] for every rank r, from the repo's root;
    returns their stdouts.  Raises AssertionError when a rank fails or
    `timeout` seconds pass, after killing every rank still running."""
    with tempfile.TemporaryDirectory() as tmp:
        procs, logs = [], []
        for r, (cmd, env) in enumerate(zip(cmds, envs)):
            out = open(os.path.join(tmp, f"{r}.out"), "w+")
            err = open(os.path.join(tmp, f"{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(cmd, env=env, cwd=REPO,
                                          stdout=out, stderr=err))
        deadline = time.monotonic() + timeout
        try:
            while any(p.poll() is None for p in procs):
                if (time.monotonic() > deadline
                        or any(p.returncode for p in procs)):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait(timeout=60)
        texts = []
        for out, err in logs:
            out.seek(0)
            err.seek(0)
            texts.append((out.read(), err.read()))
            out.close()
            err.close()
    codes = [p.returncode for p in procs]
    if any(codes):
        raise AssertionError("\n".join(
            f"rank {r} exited with {c} (timeout {timeout} s); stderr "
            f"tail:\n{err[-3000:]}"
            for r, (c, (_, err)) in enumerate(zip(codes, texts))))
    return [out for out, _ in texts]
