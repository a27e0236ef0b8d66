"""Run-to-run determinism of the rings on the inputs of
``tests/test_torch_ring.py::test_ring_attention_matches_jax[8-*]``.

Calls the JAX ring (``"rdma_interpret"``, the Pallas kernel under the
interpreter, and ``"xla"``) and the port's rings (``"xla"``, ``"rdma"``) at
n = 8 on the test's ``[2,2,64,16]`` inputs ``reps`` times a dtype, and
writes for each call the digest of every output, its largest difference
from the oracle ``multi_head_attention`` and the count of elements outside
the test's tolerance against the ``"xla"`` ring. Not a test (pytest does not
collect it): run several at once to load the machine, e.g.

    for i in 1 2 3 4 5 6; do python tests/ring_determinism_probe.py 12 out$i.json & done; wait

then compare the digests across calls and processes.
"""

import hashlib
import json
import os
import sys
from pathlib import Path

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deepcoro_clip_tpu.ops.attention import multi_head_attention  # noqa: E402
from deepcoro_clip_tpu.parallel import MeshSpec as JMeshSpec  # noqa: E402
from deepcoro_clip_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from deepcoro_clip_tpu.parallel.ring_attention import ring_attention as jring  # noqa: E402

from deepcoro_clip_tpu_torch.parallel import MeshSpec, make_mesh, ring_attention  # noqa: E402

N = 8
TOL = {"float32": (2e-5, 2e-4), "bfloat16": (4e-3, 1e-2)}  # the test's (atol, rtol)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(a.tobytes()).hexdigest()[:12]


def probe(reps: int) -> dict:
    r = np.random.default_rng(N)  # the test's seed at n = 8
    q, k, v = [r.normal(size=(2, 2, 64, 16)).astype(np.float32) for _ in range(3)]
    mesh = jmake_mesh(JMeshSpec(data=1, model=N), devices=jax.devices()[:N])
    tmesh = make_mesh(MeshSpec(data=1, model=N), devices=["cpu"] * N)
    out = {}
    for dtype, (atol, rtol) in TOL.items():
        args = [jnp.asarray(x, jnp.bfloat16 if dtype == "bfloat16" else jnp.float32)
                for x in (q, k, v)]
        oracle = np.asarray(multi_head_attention(*args), np.float32)
        xla = np.asarray(jring(*args, mesh, axis="model", backend="xla"), np.float32)
        tq, tk, tv = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (q, k, v))
        for _ in range(reps):
            runs = {
                "jax_rdma_interpret": np.asarray(
                    jring(*args, mesh, axis="model", backend="rdma_interpret"), np.float32),
                "jax_xla": xla,
                "port_xla": ring_attention(tq, tk, tv, tmesh, backend="xla").float().numpy(),
                "port_rdma": ring_attention(tq, tk, tv, tmesh, backend="rdma").float().numpy(),
            }
            rec = {}
            for name, a in runs.items():
                rec[name] = _digest(a)
                rec[f"{name}_max_abs_vs_oracle"] = float(np.abs(a - oracle).max())
                rec[f"{name}_off_vs_jax_xla"] = int((np.abs(a - xla)
                                                     > atol + rtol * np.abs(xla)).sum())
            out.setdefault(dtype, []).append(rec)
    return out


if __name__ == "__main__":
    reps, path = int(sys.argv[1]), sys.argv[2]
    Path(path).write_text(json.dumps(probe(reps), indent=1))
    print(f"wrote {path}")
