"""Multi-process (2-host analogue) distributed tests on CPU.

Multi-HOST paths are validated with JAX's multi-controller runtime on
CPU: two OS processes, 2 virtual devices each, cross-process collectives
over the gloo transport (``parallel.distributed.init_distributed``).  The
code paths are identical on GPU hosts — only the platform and the
collective transport differ.  This is the regression test of the
multi-host bootstrap.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_dist_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_cpu_cluster():
    """Two processes x two devices: dp over DCN + tp over a flat 4-device
    mesh both converge with cross-process collectives."""
    port = _free_port()
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)          # worker sets its own device count
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(port), str(i), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out[-4000:]}"
        assert "DIST_WORKER_OK" in out, f"worker {i} no OK marker:\n{out[-2000:]}"


def test_make_hybrid_mesh_single_process():
    """Single-process fallback: a 2-D mesh over local devices."""
    from ccqppy_jax.parallel.distributed import make_hybrid_mesh
    mesh = make_hybrid_mesh(ici_size=4)
    assert dict(mesh.shape) == {"batch": len(jax.devices()) // 4, "model": 4}
    with pytest.raises(ValueError):
        make_hybrid_mesh(ici_size=3)


def test_scaling_probe_smoke():
    """The weak-scaling probe runs on the virtual CPU mesh and reports
    sane efficiency numbers."""
    from ccqppy_jax.parallel.distributed import scaling_probe
    import jax.numpy as jnp
    # The CPU has no entry in the peak table; give the guard a peak.
    rows = scaling_probe(n_devices_list=[1, 2], batch_per_device=4, n=32,
                         max_matvecs=2000, reps=1, tol=1e-8,
                         dtype=jnp.float64, peak_bytes_per_s=1e12)
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["converged"] == 1.0 for r in rows)
    assert rows[0]["efficiency_vs_first"] == 1.0
    assert rows[1]["efficiency_vs_first"] > 0.05   # smoke: tiny problems
