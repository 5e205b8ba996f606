"""Worker process for the 2-process CPU distributed test.

Run as: python tests/_dist_worker.py <port> <process_id> <num_processes>

Each process owns 2 virtual CPU devices; the pair forms a 2x2 (dcn x ici)
hybrid mesh.  The worker runs (a) a scenario-batched solve sharded over the
dcn axis (collective-free) and (b) a single QP row-sharded over BOTH axes'
devices via a flat model mesh (cross-process collectives over the gloo
transport).  Exits 0 and prints DIST_WORKER_OK on success.
"""
import os
import sys

port, pid, nproc = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PSpec  # noqa: E402

import ccqppy_jax as cq  # noqa: E402
from ccqppy_jax.models import BBPGDConfig, MPRGPBBConfig  # noqa: E402
from ccqppy_jax.parallel import solve_batched_sharded, solve_sharded  # noqa: E402
from ccqppy_jax.parallel.distributed import (init_distributed,  # noqa: E402
                                             make_hybrid_mesh)

idx, count = init_distributed(f"127.0.0.1:{port}", nproc, pid)
assert count == nproc and jax.device_count() == 2 * nproc, (
    idx, count, jax.device_count())

mesh = make_hybrid_mesh()          # (dcn=nproc, ici=2) -> ("batch", "model")
assert dict(mesh.shape) == {"batch": nproc, "model": 2}, mesh.shape


def global_array(np_arr, mesh, spec):
    sh = NamedSharding(mesh, spec)
    return jax.make_array_from_callback(np_arr.shape, sh,
                                        lambda i: np_arr[i])


def local_ok(flags):
    return all(bool(np.asarray(s.data).all())
               for s in flags.addressable_shards)


# --- dp leg: scenario batch over the DCN axis (collective-free) ------------
B, n = 2 * nproc, 16
rng = np.random.default_rng(0)
G = rng.standard_normal((B, n, n))
As_np = G @ np.transpose(G, (0, 2, 1)) + n * np.eye(n)
bs_np = -np.einsum("bij,bj->bi", As_np, rng.uniform(-1, 1, (B, n)))
As = global_array(As_np, mesh, PSpec("batch"))
bs = global_array(bs_np, mesh, PSpec("batch"))
proj = cq.box(-np.ones(n), np.ones(n), jnp.float64)
r = solve_batched_sharded("bbpgd", As, bs, mesh, axis="batch", proj=proj,
                          config=BBPGDConfig(tol=1e-8, max_matvecs=2000))
jax.block_until_ready(r.x)
assert local_ok(r.converged), "dp leg lane(s) unconverged"

# --- tp leg: one QP row-sharded over ALL devices (all-gather/psum cross
# DCN — exercises the gloo transport) ----------------------------------------
flat = Mesh(np.asarray(jax.devices()).reshape(-1), ("model",))
n_big = 16 * 2 * nproc
G1 = np.random.default_rng(1).standard_normal((n_big, n_big))
A1_np = G1 @ G1.T + n_big * np.eye(n_big)
x_exact = np.random.default_rng(2).uniform(-0.5, 0.5, n_big)
b1_np = -A1_np @ x_exact
A1 = global_array(A1_np, flat, PSpec("model", None))
b1 = global_array(b1_np, flat, PSpec("model"))
lb = global_array(-np.ones(n_big), flat, PSpec("model"))
ub = global_array(np.ones(n_big), flat, PSpec("model"))
r1 = solve_sharded("mprgp_bb", A1, b1, flat, axis="model",
                   proj=cq.BoxProj(lb, ub),
                   config=MPRGPBBConfig(tol=1e-8, max_matvecs=2000))
jax.block_until_ready(r1.x)
assert local_ok(r1.converged), "tp leg unconverged"
for s in r1.x.addressable_shards:
    np.testing.assert_allclose(np.asarray(s.data), x_exact[s.index],
                               atol=1e-5)

print(f"DIST_WORKER_OK pid={idx}/{count}", flush=True)
