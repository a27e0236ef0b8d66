"""The port's serving slice against the JAX package's scripts/serve.py.

Same tower weights (the JAX engine's random init, converted), same text
bank, same patch-major uint8 studies: the port's ``InferenceEngine``
must give the JAX engine's embeddings (atol 1e-4, fp32 on the CPU) and
exactly its top-k indices, on a full batch and on a short batch that is
zero-padded to ``max_batch``. Then one HTTP round trip of the port's
server on ``device="cpu"``, and the CUDA default of its entry points.
"""

import http.client
import json
import sys
import threading
from pathlib import Path

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))

import serve as jax_serve  # noqa: E402

from deepcoro_clip_tpu.flagship import tiny_config as jax_tiny  # noqa: E402

from deepcoro_clip_tpu_torch import serve  # noqa: E402
from deepcoro_clip_tpu_torch.convert import jax_tree_to_state_dict  # noqa: E402
from deepcoro_clip_tpu_torch.data.patch_wire import patchify_videos  # noqa: E402
from deepcoro_clip_tpu_torch.device import resolve_device  # noqa: E402
from deepcoro_clip_tpu_torch.flagship import tiny_config  # noqa: E402

CFG_KW = dict(multi_video=True, num_videos=3, use_cls_token=True,
              dataset_mean=[110.5, 98.2, 101.0], dataset_std=[37.8, 41.2, 39.9])


@pytest.fixture(scope="module")
def engines():
    r = np.random.default_rng(0)
    jcfg = jax_tiny(**CFG_KW)
    bank = r.normal(size=(40, jcfg.embedding_dim))
    texts = [f"report {i}" for i in range(40)]
    je = jax_serve.InferenceEngine(jcfg, bank, texts, max_batch=3, top_k=5)
    tree = jax.tree_util.tree_map(np.asarray, fnn.unbox(je.params))
    te = serve.InferenceEngine(tiny_config(**CFG_KW), bank, texts, max_batch=3,
                               top_k=5, video_params=jax_tree_to_state_dict(tree),
                               device="cpu")
    clips = r.integers(0, 256, size=(3, 3, 4, 32, 32, 3), dtype=np.uint8)
    studies = patchify_videos(clips, (2, 16, 16))
    masks = np.array([[1, 1, 1], [1, 0, 0], [1, 1, 0]], bool)
    return je, te, studies, masks


@pytest.mark.parametrize("b", [3, 2, 1])
def test_infer_batch_matches_jax_engine(engines, b):
    """b < max_batch pads with fully masked studies, cut from the reply."""
    je, te, studies, masks = engines
    emb_j, scores_j, idx_j = je.infer_batch(studies[:b], masks[:b])
    emb_t, scores_t, idx_t = te.infer_batch(studies[:b], masks[:b])
    assert emb_t.shape == emb_j.shape == (b, 32)
    np.testing.assert_allclose(emb_t, emb_j, atol=1e-4)
    np.testing.assert_allclose(scores_t, scores_j, atol=1e-4)
    np.testing.assert_array_equal(idx_t, idx_j)


def test_load_study_matches_jax_engine(engines, tmp_path):
    je, te, _, _ = engines
    r = np.random.default_rng(1)
    paths = []
    for i in range(4):  # 4 > num_videos: the first 3 are kept
        p = tmp_path / f"c{i}.npy"
        np.save(p, r.integers(0, 256, size=(6, 32, 32, 3), dtype=np.uint8))
        paths.append(str(p))
    study_j, mask_j = je.load_study(paths)
    study_t, mask_t = te.load_study(paths)
    np.testing.assert_array_equal(study_t, study_j)
    np.testing.assert_array_equal(mask_t, mask_j)
    short_t, short_m = te.load_study(paths[:1])
    assert short_m.tolist() == [True, False, False] and not short_t[1:].any()


def _args(**kw):
    args = serve.parse_args(["--tiny", "--port", "0", "--num_videos", "2",
                             "--max_batch", "2", "--top_k", "3",
                             "--demo_bank", "16", "--batch_window_ms", "50"])
    for k, v in kw.items():
        setattr(args, k, v)
    return args


def _request(port, method, path, payload=None):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    body = None if payload is None else json.dumps(payload)
    c.request(method, path, body, {"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, json.loads(r.read())


def test_http_round_trip_on_cpu(tmp_path):
    httpd, engine = serve.build_server(_args(device="cpu"))
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        port = httpd.server_address[1]
        r = np.random.default_rng(2)
        paths = []
        for i in range(3):
            p = tmp_path / f"clip{i}.npy"
            np.save(p, r.integers(0, 256, size=(8, 48, 48, 3), dtype=np.uint8))
            paths.append(str(p))
        assert _request(port, "GET", "/healthz") == (200, {"ok": True})
        results = [None, None]

        def hit(i):
            results[i] = _request(port, "POST", "/retrieve", {"videos": paths[i:]})

        ts = [threading.Thread(target=hit, args=(i,)) for i in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        for code, out in results:
            assert code == 200
            assert len(out["topk"]) == 3 and out["n_clips"] == 2
            scores = [t["score"] for t in out["topk"]]
            assert scores == sorted(scores, reverse=True)
        code, out = _request(port, "POST", "/embed", {"videos": paths[:1]})
        assert code == 200 and abs(np.linalg.norm(out["embedding"]) - 1.0) < 1e-4
        assert _request(port, "POST", "/retrieve", {"videos": []})[0] == 400
        code, stats = _request(port, "GET", "/stats")
        assert code == 200 and stats["requests"] == 3 and stats["bank_size"] == 16
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert not thread.is_alive()


def test_params_npz_loads_the_jax_tower(tmp_path):
    """The README recipe: a JAX VideoEncoder tree -> .npz -> --params."""
    import jax.numpy as jnp

    from deepcoro_clip_tpu.models.video_encoder import video_encoder_from_config
    from deepcoro_clip_tpu_torch.convert import save_params_npz

    cfg = jax_tiny(multi_video=True, num_videos=2)
    x = jnp.zeros((1, 2, 8, 1536), jnp.uint8)
    params = video_encoder_from_config(cfg).init(
        {"params": jax.random.PRNGKey(3), "dropout": jax.random.PRNGKey(3)},
        x, video_mask=jnp.ones((1, 2), bool))["params"]
    tree = jax.tree_util.tree_map(np.asarray, fnn.unbox(params))
    save_params_npz(tree, tmp_path / "video_params.npz")
    httpd, engine = serve.build_server(
        _args(device="cpu", params=str(tmp_path / "video_params.npz")))
    httpd.server_close()
    sd = engine.model.state_dict()
    want = jax_tree_to_state_dict(tree)
    assert sd.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(sd[k], want[k], rtol=0, atol=0)


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.InferenceEngine(tiny_config(), np.ones((4, 32)), list("abcd"),
                              max_batch=1, top_k=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.build_server(_args())
    assert resolve_device("cpu") == torch.device("cpu")


def test_base_config_yaml_sets_the_served_model(tmp_path):
    """``--base_config``: the YAML of a contrastive run (here the tiny
    configuration written out) decides the tower; ``--num_videos`` and
    multi-video mode are forced on top of it, as scripts/serve.py does."""
    import yaml

    cfg = tiny_config(num_videos=5, embedding_dim=48)
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(dict(cfg.to_dict(), pipeline_project="DeepCORO_clip",
                                        multi_video=False)))
    args = serve.parse_args(["--base_config", str(path), "--port", "0", "--num_videos", "2",
                             "--max_batch", "2", "--top_k", "3", "--demo_bank", "16",
                             "--device", "cpu"])
    httpd, engine = serve.build_server(args)
    httpd.server_close()
    assert engine.cfg.embedding_dim == 48 and engine.cfg.vit_dim == cfg.vit_dim
    assert engine.cfg.multi_video is True and engine.cfg.num_videos == 2
    study, mask = engine.load_study([])
    emb, scores, idx = engine.infer_batch(study[None], mask[None])
    assert np.asarray(emb).shape == (1, 48) and np.asarray(idx).shape == (1, 3)


# --------------------------------------------------------------------------- #
# --checkpoint: a port run's checkpoints


@pytest.fixture(scope="module")
def clip_run(tmp_path_factory):
    """A tiny contrastive run of the port's ``main`` (1 epoch, 2 steps, CPU):
    (its YAML, its checkpoints directory)."""
    import yaml

    from deepcoro_clip_tpu_torch.data.csv_utils import write_csv
    from deepcoro_clip_tpu_torch.main import main

    root = tmp_path_factory.mktemp("clip_run")
    r = np.random.default_rng(0)
    rows = []
    for i in range(10):
        p = root / f"clip{i}.npy"
        np.save(p, r.integers(0, 255, size=(4, 32, 32, 3)).astype(np.uint8))
        rows.append({"FileName": str(p), "Report": f"stenosis report {i % 3}",
                     "StudyInstanceUID": f"S{i}", "Split": "train" if i < 8 else "val"})
    write_csv(root / "data.csv", list(rows[0]), rows)
    cfg = dict(tiny_config(**CFG_KW).to_dict(), pipeline_project="DeepCORO_clip",
               data_filename=str(root / "data.csv"), output_dir=str(root / "out"),
               multi_video=False, num_videos=1, batch_size=4, epochs=1, num_workers=0,
               use_wandb=False, seed=0)
    path = root / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    res = main(["--base_config", str(path), "--device", "cpu"])
    return path, Path(res["output_dir"]) / "checkpoints"


def _ckpt_args(path, ck, *extra):
    return serve.parse_args(["--base_config", str(path), "--checkpoint", str(ck), "--port",
                             "0", "--num_videos", "3", "--max_batch", "2", "--top_k", "3",
                             "--demo_bank", "16", "--device", "cpu", *extra])


@pytest.mark.parametrize("name", ["checkpoint", "best_model_epoch_0"])
def test_checkpoint_serves_the_runs_video_tower(clip_run, name):
    """``--checkpoint``/``--ckpt_name``: the run's ``video_encoder`` tensors
    are the served tower's, key for key; the server's embeddings are an
    engine's on the same tree, bit for bit."""
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    path, ck = clip_run
    httpd, engine = serve.build_server(_ckpt_args(path, ck, "--ckpt_name", name))
    httpd.server_close()
    saved = CheckpointManager(ck).load(name)["params"]
    tower = {k[len("video_encoder."):]: v for k, v in saved.items()
             if k.startswith("video_encoder.")}
    sd = engine.model.state_dict()
    assert sd.keys() == tower.keys()
    for k in tower:
        assert torch.equal(sd[k], tower[k]), k
    assert serve.load_video_params(ck, name).keys() == tower.keys()
    other = serve.InferenceEngine(engine.cfg, np.random.default_rng(0).normal(size=(16, 32)),
                                  engine.bank_texts, max_batch=2, top_k=3, video_params=tower,
                                  device="cpu")
    r = np.random.default_rng(5)
    clips = r.integers(0, 256, size=(2, 3, 4, 32, 32, 3), dtype=np.uint8)
    studies, masks = patchify_videos(clips, (2, 16, 16)), np.array([[1, 1, 0], [1, 0, 0]], bool)
    for a, b in zip(engine.infer_batch(studies, masks), other.infer_batch(studies, masks)):
        np.testing.assert_array_equal(a, b)


def test_checkpoint_load_is_strict(clip_run, tmp_path):
    """A probing checkpoint's encoder (no aggregator) does not fit the served
    tower: the strict load raises; a checkpoint without a video tower too."""
    from deepcoro_clip_tpu_torch.configs import LinearProbingConfig
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager
    from deepcoro_clip_tpu_torch.train.linear_probe import build_probe_bundle
    from deepcoro_clip_tpu_torch.train.state import TrainState

    path, _ = clip_run
    tiny = tiny_config(**CFG_KW)
    probe = LinearProbingConfig.from_dict(dict(
        frames=4, resize=32, multi_video=True, num_videos=3, head_structure={"y": 1},
        loss_structure={"y": "bce_logit"}, vit_dim=tiny.vit_dim, vit_depth=tiny.vit_depth,
        vit_heads=tiny.vit_heads, vit_patch=[2, 16, 16], embedding_dim=tiny.embedding_dim,
        num_heads=2, precision="fp32", use_pallas_attention=False))
    _, state = build_probe_bundle(probe, device="cpu")
    CheckpointManager(tmp_path / "probe").save_latest(state, {})
    with pytest.raises(RuntimeError, match="Missing key"):
        serve.build_server(_ckpt_args(path, tmp_path / "probe"))
    CheckpointManager(tmp_path / "bare").save_latest(
        TrainState(step=0, params={"log_temp": torch.zeros(())}, opt_state={}), {})
    with pytest.raises(ValueError, match="no video_encoder"):
        serve.build_server(_ckpt_args(path, tmp_path / "bare"))
