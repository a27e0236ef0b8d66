"""The ring across processes: the port's ring attention over the ranks of a
process group, and the ring train step on a ``(data, model)`` grid of
ranks, against the JAX package on meshes of the conftest's CPU devices.

The ranks are ``torch.multiprocessing`` children on ``gloo``
(``tests/test_torch_ring_workers.py`` through
``tests/test_torch_ddp_workers.start``), two launches started together by
one module-scoped fixture while the JAX side computes: four ranks (the
rings at n = 2 on the grid ``(2, 2)`` and at n = 4 on ``(1, 4)``, the step
at ``(2, 2)``, runs through ``main`` at ``(2, 2)``) and two (the step at
``(1, 2)``, the config's raises).

- The ring (``"xla"``, and ``"rdma"``: K6's plain version on the CPU, the
  slot protocol with the exchanges over gloo) at n = 2 and 4, fp32 and
  bf16, ``[2, 2, 64, 16]``: the chunks' outputs against the oracle the
  JAX ring tests use (``multi_head_attention`` over the whole sequence)
  and bit-equal to the port's one-process ``"xla"`` ring on n CPU shards
  (the same updates in the same order); the gradients of the chunks
  against ``jax.vjp`` of the JAX ``"xla"`` ring on an n-device mesh. fp32:
  ``2e-5 + 2e-4|ref|``, the JAX ring tests' own. bf16 outputs: ``4e-3 +
  1e-2|ref|`` (``tests/test_torch_ring.py``'s). bf16 gradients: 2^-6 of
  the leaf's largest magnitude: the port's backward forms the
  probabilities once in fp32 from the final row statistics where the JAX
  vjp goes back through each step's bf16 probabilities, so an element may
  differ by a few bf16 steps of the largest. No K6 launch on the CPU.
- One CLIP step with ``use_ring_attention`` (every backbone block takes
  the ring: no CLS token, 8 tokens) at ``(data=1, model=2)`` and
  ``(data=2, model=2)`` against the JAX step on ``MeshSpec`` of the same
  shape, on a 3-row batch (padded to 4 at data 2): the loss (rtol 1e-4),
  every gradient leaf (1e-4 of its largest magnitude), the metrics (rtol
  1e-4) and the parameters after the update (atol 3e-5 where the gradient
  is resolved, the key bias's middle third left out): the bars of
  ``tests/test_torch_distributed.py``. Loss, gradients, metrics and
  parameters are bit-equal across all the ranks of a grid.
- ``set_device_info_in_place``: a ``mesh_model`` that does not divide the
  world, a wrong ``mesh_data`` and a batch the data axis does not divide
  raise; ``mesh_model`` 2 makes the grid with the ring and without it
  (tensor parallelism), and at world 1 raises without the ring only.
- ``main`` at ``(data=2, model=2)`` with the ring, dropout 0.1: every rank
  the same history, rank 0 alone writes, the checkpoint holds one
  generator a data index, and a run cut after epoch 0 and resumed ends
  with the uninterrupted run's epoch-1 loss and parameters, bit for bit.
"""

import dataclasses
import functools
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from deepcoro_clip_tpu.configs.clip import ClipConfig as JaxClipConfig
from deepcoro_clip_tpu.ops.attention import multi_head_attention as jax_mha
from deepcoro_clip_tpu.parallel import MeshSpec as JMeshSpec
from deepcoro_clip_tpu.parallel import make_mesh as jmake_mesh
from deepcoro_clip_tpu.parallel.ring_attention import ring_attention as jring
from deepcoro_clip_tpu.registry import register_all
from deepcoro_clip_tpu.train import clip as jclip

from deepcoro_clip_tpu_torch import convert
from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
from deepcoro_clip_tpu_torch.flagship import tiny_config
from deepcoro_clip_tpu_torch.parallel import MeshSpec, distributed, make_mesh
from deepcoro_clip_tpu_torch.parallel.ring_attention import ring_attention

from tests import test_torch_ddp_workers as workers
from tests import test_torch_ring_workers as ring_workers

register_all()

F32_TOL = dict(atol=2e-5, rtol=2e-4)
BF16_TOL = dict(atol=4e-3, rtol=1e-2)
BF16_GRAD_REL = 2.0 ** -6
FP32 = dict(rtol=1e-4, atol=1e-5)
PARAM_ATOL = 3e-5
SHAPE = (2, 2, 64, 16)
RING_CASES = [(n, dt, be) for n in (2, 4) for dt in ("fp32", "bf16") for be in ("xla", "rdma")]
GRIDS = {"data1_model2": (1, 2), "data2_model2": (2, 2)}
REPO = Path(__file__).resolve().parents[1]
QUALITY_YAML = REPO / "config/quality/flagship_quality_train.yaml"

STEP = dict(
    frames=4, resize=32, batch_size=4, multi_video=False, num_videos=1,
    vit_dim=32, vit_depth=2, vit_heads=1, vit_patch=[2, 16, 16], use_cls_token=False,
    text_dim=32, text_depth=1, text_heads=2, text_vocab_size=256, max_text_length=8,
    embedding_dim=16, num_heads=2, aggregator_depth=1, dropout=0.0, lr=1e-3,
    precision="fp32", scheduler_name="cosine", epochs=2, temperature=0.1,
    loss_name="clip", label_smoothing=0.1, use_ring_attention=True, mesh_model=2,
)


def _case_name(n, dt, be):
    return f"n{n}_{dt}_{be}"


def _ring_inputs(n):
    r = np.random.default_rng(40 + n)
    return [r.normal(size=SHAPE).astype(np.float32) for _ in range(4)]


def _step_batch(seed=0):
    r = np.random.default_rng(seed)
    B, L = 3, STEP["max_text_length"]
    att = np.ones((B, L), np.int32)
    att[1, 5:] = 0
    return {"videos": r.normal(size=(B, 1, 4, 32, 32, 3)).astype(np.float32),
            "video_mask": np.ones((B, 1), bool),
            "input_ids": r.integers(0, 256, (B, L)).astype(np.int32),
            "attention_mask": att}


def _flat(tree):
    return convert.flatten_tree(jax.tree_util.tree_map(np.asarray, tree))


def _jax_step(grid, batch):
    data, model = grid
    jcfg = JaxClipConfig.from_dict(dict(STEP, use_pallas_attention=False, mesh_data=data))
    mesh = jmake_mesh(JMeshSpec(data=data, model=model), devices=jax.devices()[:data * model])
    bundle, state = jclip.build_clip_bundle(jcfg, mesh, jax.random.PRNGKey(0),
                                            steps_per_epoch=4)
    bundle = bundle._replace(text_model=bundle.text_model.clone(proj_dropout=0.0))
    init = jax.tree_util.tree_map(np.array, state.params)
    jb = bundle.batch_sharding_fn(batch)

    def loss_fn(params):
        out = jclip.compute_loss(bundle, params, jb, {"dropout": jax.random.PRNGKey(1)},
                                 deterministic=False)
        return out["loss"], out

    def compute():
        (loss, _), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            jax.tree_util.tree_map(jnp.asarray, init))
        after, metrics = jclip.make_train_step(bundle)(state, jb, jax.random.PRNGKey(1),
                                                       0.0, 0.0, -1.0)
        return {"loss": float(loss), "grads": _flat(grads),
                "metrics": {k: float(v) for k, v in metrics.items()},
                "params": _flat(after.params)}

    return init, compute


def _workspace(root: Path) -> None:
    r = np.random.default_rng(0)
    rows = []
    for i in range(12):
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(8, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p), "Report": f"left main stenosis {i % 3} report",
                     "StudyInstanceUID": f"S{i}", "Split": "train" if i < 8 else "val"})
    write_csv(root / "data.csv", ["FileName", "Report", "StudyInstanceUID", "Split"], rows)


def _main_yaml(root: Path, name: str, **over) -> str:
    """``config/quality/flagship_quality_train.yaml`` on the workspace at tiny
    widths, fp32, with the ring on a grid of ``mesh_model`` 2."""
    cfg = yaml.safe_load(QUALITY_YAML.read_text())
    cfg.update(
        data_filename=str(root / "data.csv"), output_dir=str(root / "runs" / name), epochs=2,
        batch_size=4, frames=4, resize=32, num_workers=1, vit_dim=32, vit_depth=1,
        vit_heads=1, vit_pool_stages=[], use_cls_token=False, text_dim=32, text_depth=1,
        text_heads=2, max_text_length=16, embedding_dim=16, num_heads=2,
        aggregator_depth=1, dropout=0.1, precision="fp32", use_pallas_attention=False,
        use_ring_attention=True, mesh_model=2, device="cpu")
    cfg.update(over)
    path = root / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX step results, the 4-rank launch's results, the 2-rank launch's
    results, the ring inputs)."""
    root = tmp_path_factory.mktemp("ring_processes")
    inputs = {n: _ring_inputs(n) for n in (2, 4)}
    rings = [dict(name=_case_name(n, dt, be), n=n, dtype=dt, backend=be,
                  **dict(zip(("q", "k", "v", "do"), inputs[n])))
             for n, dt, be in RING_CASES]
    batch = _step_batch()
    compute, steps = {}, {}
    for name, grid in GRIDS.items():
        init, compute[name] = _jax_step(grid, batch)
        steps[name] = {"config": dict(STEP, use_pallas_attention=True, mesh_data=grid[0]),
                       "init": init, "batch": batch}
    _workspace(root)
    mains = [{"argv": ["--base_config", _main_yaml(root, "full")]},
             {"argv": ["--base_config", _main_yaml(root, "cut")], "cut": True},
             {"argv": ["--base_config", _main_yaml(root, "cut")], "resume_from": 1}]
    base = dict(STEP, use_pallas_attention=False)
    errors = [dict(base, use_ring_attention=False),  # tensor parallelism: the grid
              dict(base, mesh_model=3),  # does not divide 2 ranks
              dict(base, mesh_data=2),  # the data axis is 1
              dict(base, batch_size=3, mesh_model=1),  # 2 data ranks, batch 3
              base]  # the grid (1, 2)
    specs = {4: {"rings": rings, "steps": {"data2_model2": steps["data2_model2"]},
                 "mains": mains, "audit_root": str(root / "runs")},
             2: {"steps": {"data1_model2": steps["data1_model2"]}, "errors": errors}}
    waits = {}
    for world, spec in specs.items():
        out = root / f"world{world}"
        out.mkdir()
        with open(out / "spec.pkl", "wb") as f:
            pickle.dump(spec, f)
        waits[world] = workers.start(ring_workers.job, world, out, str(out / "spec.pkl"))
    want = {name: fn() for name, fn in compute.items()}
    return want, waits[4](), waits[2](), inputs


# --------------------------------------------------------------------------- #
# the ring


def _assemble(ranks, name, n):
    """The full output and gradients from the chunks of data index 0's ranks;
    every other data index's chunks equal to them bit for bit."""
    full = {}
    for r in ranks:
        e = r["rings"][name]
        key = (e["chunk"],)
        if key in full:
            assert all(np.array_equal(a, b) for a, b in
                       zip([e["out"]] + e["grads"], full[key])), name
        else:
            full[key] = [e["out"]] + e["grads"]
    assert sorted(full) == [(m,) for m in range(n)]
    return [np.concatenate([full[(m,)][i] for m in range(n)], axis=2) for i in range(4)]


@pytest.mark.parametrize("n,dtype,backend", RING_CASES)
def test_process_ring_output_matches_jax(runs, n, dtype, backend):
    """The chunks' outputs against the oracle, and bit-equal to the port's
    one-process ``"xla"`` ring on n CPU shards."""
    _, four, _, inputs = runs
    name = _case_name(n, dtype, backend)
    out, *_ = _assemble(four, name, n)
    q, k, v, _ = inputs[n]
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ref = np.asarray(jax_mha(*(jnp.asarray(x, jdt) for x in (q, k, v))), np.float32)
    np.testing.assert_allclose(out, ref, **(BF16_TOL if dtype == "bf16" else F32_TOL))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    one = ring_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                         make_mesh(MeshSpec(1, n), devices=["cpu"] * n), backend="xla")
    np.testing.assert_array_equal(out, one.float().numpy())
    assert all(r["rings"][name]["dtype"] == str(tdt) for r in four)


@functools.lru_cache(maxsize=None)
def _jax_ring_grads(n, dtype):
    """dq, dk, dv of the JAX ``"xla"`` ring on an n-device mesh (``jax.vjp``
    under one jit), for the inputs of ``_ring_inputs(n)``."""
    q, k, v, do = _ring_inputs(n)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    mesh = jmake_mesh(JMeshSpec(data=1, model=n), devices=jax.devices()[:n])

    def grads(q, k, v, do):
        _, vjp = jax.vjp(lambda a, b, c: jring(a, b, c, mesh, axis="model", backend="xla"),
                         q, k, v)
        return vjp(do)

    out = jax.jit(grads)(*(jnp.asarray(x, jdt) for x in (q, k, v, do)))
    return [np.asarray(g, np.float32) for g in out]


@pytest.mark.parametrize("n,dtype,backend", RING_CASES)
def test_process_ring_gradients_match_jax(runs, n, dtype, backend):
    """dq, dk, dv of the chunks against ``jax.vjp`` of the JAX ``"xla"``
    ring on an n-device mesh."""
    _, four, _, _ = runs
    _, *grads = _assemble(four, _case_name(n, dtype, backend), n)
    for name, got, ref in zip("qkv", grads, _jax_ring_grads(n, dtype)):
        if dtype == "bf16":
            np.testing.assert_allclose(got, ref, atol=BF16_GRAD_REL * np.abs(ref).max(),
                                       rtol=0, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, **F32_TOL, err_msg=name)


def test_no_kernel_launch_on_the_cpu(runs):
    _, four, _, _ = runs
    assert [r["rings"]["launches"] for r in four] == [0, 0, 0, 0]


# --------------------------------------------------------------------------- #
# the ring train step on a grid


def _results(runs, grid):
    _, four, two, _ = runs
    return [r["steps"][grid] for r in (four if grid == "data2_model2" else two)]


@pytest.mark.parametrize("grid", GRIDS)
def test_ring_step_runs_the_ring_on_the_grid(runs, grid):
    """Every rank on its cell of the grid, every backbone block through the
    process ring, each data index with its rows (2 of the padded 4 at data
    2)."""
    data, model = GRIDS[grid]
    ranks = _results(runs, grid)
    assert [r["index"] for r in ranks] == [{"data": i // model, "model": i % model}
                                          for i in range(data * model)]
    assert all(r["grid"] == {"data": data, "model": model} for r in ranks)
    assert all(r["ring_calls"] == STEP["vit_depth"] for r in ranks)
    assert all(r["rows"] == (3 if data == 1 else 2) for r in ranks)


@pytest.mark.parametrize("grid", GRIDS)
def test_ring_step_loss_and_gradients_match_jax(runs, grid):
    want = runs[0][grid]
    for got in _results(runs, grid):
        np.testing.assert_allclose(got["loss"], want["loss"], **FP32)
        assert got["grads"].keys() == want["grads"].keys()
        for k, g in want["grads"].items():
            scale = max(float(np.abs(g).max()), 1e-6)
            np.testing.assert_allclose(got["grads"][k], g, atol=max(1e-4 * scale, 1e-7),
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS)
def test_ring_train_step_matches_jax(runs, grid):
    want = runs[0][grid]
    for got in _results(runs, grid):
        assert set(got["metrics"]) == set(want["metrics"])
        for k, v in want["metrics"].items():
            np.testing.assert_allclose(got["metrics"][k], v, err_msg=k, **FP32)
        assert got["params"].keys() == want["params"].keys()
        for k, v in want["params"].items():
            g = want["grads"][k]
            resolved = np.abs(g) > 1e-4 * max(float(np.abs(g).max()), 1e-6)
            a, b = np.where(resolved, got["params"][k], v), v
            if k.endswith("attn/qkv/bias"):  # the key bias: its gradient is noise
                n = a.shape[0] // 3
                a, b = np.delete(a, slice(n, 2 * n)), np.delete(b, slice(n, 2 * n))
            np.testing.assert_allclose(a, b, atol=PARAM_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("grid", GRIDS)
def test_ring_step_ranks_agree_bit_for_bit(runs, grid):
    first, *rest = _results(runs, grid)
    for other in rest:
        assert other["loss"] == first["loss"] and other["metrics"] == first["metrics"]
        for key in ("grads", "params"):
            for k in first[key]:
                np.testing.assert_array_equal(other[key][k], first[key][k], err_msg=k)


# --------------------------------------------------------------------------- #
# the config's raises


def test_configs_raise_on_two_ranks(runs):
    _, _, two, _ = runs
    for r in two:
        tp, odd_model, data, batch, ok = r["errors"]
        assert tp == str({"data": 1, "model": 2})
        assert odd_model.startswith("ValueError") and "does not divide the 2 ranks" in odd_model
        assert data.startswith("ValueError") and "mesh_data=2" in data and "set -1 or 1" in data
        assert batch.startswith("ValueError") and "gcd(2, 3)" in batch
        assert ok == str({"data": 1, "model": 2})


def test_tensor_parallelism_raises_at_world_1():
    """Without a process group: ``mesh_model`` 2 without the ring is tensor
    parallelism, which needs 2 processes (the message names the launch);
    with the ring it is the one-process ring's mesh, and nothing raises."""
    cfg = tiny_config(mesh_model=2)
    with pytest.raises(ValueError, match="tensor parallelism.*torch.distributed.run"):
        cfg.set_device_info_in_place()
    cfg = dataclasses.replace(cfg, use_ring_attention=True)
    cfg.set_device_info_in_place()
    assert cfg.world_size == 1 and distributed.data_size() == 1


# --------------------------------------------------------------------------- #
# runs through main on the grid (2, 2)


def _untimed(h):
    return {k: v for k, v in h.items()
            if k not in ("loader_wait_ms", "epoch_seconds", "val_seconds")}


def test_main_on_the_grid_resumes_bit_equal(runs):
    _, four, _, _ = runs
    mains = [r["mains"] for r in four]
    full, cut, resumed, _ = zip(*mains)
    for runs_ in (full, cut, resumed):  # every rank the same history, times apart
        first = [_untimed(h) for h in runs_[0]["history"]]
        assert all([_untimed(h) for h in r["history"]] == first for r in runs_)
    hist = full[0]["history"]
    assert [h["epoch"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["val_loss"]) for h in hist)
    assert [h["epoch"] for h in resumed[0]["history"]] == [1]
    assert resumed[0]["history"][0]["loss"] == hist[1]["loss"]
    run = Path(full[0]["output_dir"]) / "checkpoints"
    a = torch.load(run / "checkpoint.pt", weights_only=True)
    b = torch.load(Path(resumed[0]["output_dir"]) / "checkpoints" / "checkpoint.pt",
                   weights_only=True)
    assert a["step"] == b["step"] == 4
    assert len(a["generators"]) == 2  # one a data index
    assert not torch.equal(a["generators"][0], a["generators"][1])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k


def test_main_on_the_grid_rank_0_alone_writes(runs):
    _, four, _, _ = runs
    written = [r["mains"][-1]["written"] for r in four]
    assert written[0] and not any(written[1:])
