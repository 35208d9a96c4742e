"""Two-process jax.distributed smoke test.

Executes `parallel.mesh.initialize_multihost` for real: a coordinator +
worker process pair over localhost, each a single-CPU-device JAX process,
verifying process discovery (process_count == 2), the global device view
(2 devices), and a cross-process collective (process_allgather).  This is
the pod entry path (`jax.distributed.initialize`) that every virtual-mesh
test bypasses.
"""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils
from unirec.parallel.mesh import initialize_multihost

pid, port = int(sys.argv[1]), sys.argv[2]
n = initialize_multihost(f"localhost:{port}", 2, pid)
assert n == 2, f"process_count {n}"
assert jax.process_index() == pid
local = jax.local_device_count()
devs = jax.devices()
assert len(devs) == 2 * local, f"global {len(devs)} != 2 x {local}"
x = jnp.ones((4,)) * (pid + 1)
g = multihost_utils.process_allgather(x)
print(f"RESULT pid={pid} n={n} sum={float(np.asarray(g).sum())}", flush=True)
"""


def test_two_process_distributed_init():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]

    procs = [
        subprocess.Popen(
            [sys.executable, "-c", _WORKER, str(pid), str(port)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env={**os.environ,
                 "XLA_FLAGS": "--xla_force_host_platform_device_count=1"},
        )
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=150)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        # allgather of [1,1,1,1] and [2,2,2,2] -> global sum 12
        assert f"RESULT pid={pid} n=2 sum=12.0" in out, out
