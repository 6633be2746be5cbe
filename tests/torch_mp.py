"""Start N processes of `torch_mp_worker.py` joined in one gloo group and
read their results: the multi-process mesh tests of `test_torch_mesh.py`
and `test_torch_lm_mesh.py` (numpy and the standard library only, so
that importing it starts nothing).

Each process gets the launch environment a user sets by hand
(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID), with a `file://`
coordinator under the test's temporary directory, so that test workers
never share a TCP port."""
import os
import pickle
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def run_processes(tmp_path, scenario: str, inputs=None, n: int = 4, timeout: float = 300):
    """Run `scenario` of the worker in `n` processes -> [{name: array}]
    one dict a process, in rank order. `inputs` (any picklable object) is
    handed to every process. A process that fails fails the call, with
    its error output."""
    tmp = str(tmp_path)
    with open(os.path.join(tmp, "mp_inputs.pkl"), "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(HERE, "..", "src"), HERE]),
               COORDINATOR_ADDRESS=f"file://{tmp}/mp_store", NUM_PROCESSES=str(n),
               OMP_NUM_THREADS="2")
    logs = [open(os.path.join(tmp, f"mp_{scenario}.{r}.log"), "w+") for r in range(n)]
    procs = [subprocess.Popen([sys.executable, os.path.join(HERE, "torch_mp_worker.py"),
                               scenario, tmp], env=dict(env, PROCESS_ID=str(r)),
                              stdout=log, stderr=subprocess.STDOUT)
             for r, log in enumerate(logs)]
    deadline = time.monotonic() + timeout
    try:  # a failed process stops the others, which would wait for it
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            if any(p.poll() for p in procs):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    errors = []
    for r, (p, log) in enumerate(zip(procs, logs)):
        log.seek(0)
        if p.returncode:
            errors.append(f"process {r} exited {p.returncode}:\n{log.read()[-4000:]}")
        log.close()
    assert not errors, "\n".join(errors)
    out = []
    for r in range(n):
        with np.load(os.path.join(tmp, f"mp_{scenario}.{r}.npz")) as z:
            out.append(dict(z))
    return out
