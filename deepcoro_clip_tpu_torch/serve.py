"""Micro-batching HTTP retrieval server on the port (PyTorch/CUDA).

Counterpart of the JAX package's ``scripts/serve.py``: same request path,
endpoints and flags. Per study, the request thread loads, samples and
resizes the clips (uint8) and lays them out patch-major; the batcher
coalesces up to ``--max_batch`` studies inside ``--batch_window_ms`` and
answers them with one fixed-shape dispatch (short batches are zero-padded
and masked): study embeddings -> L2 normalize -> similarity against the
text bank -> top-k. On the card the video tower's attention runs in the
hand-written CUDA kernels (``csrc/flash_fwd.cu``).

Endpoints:
  POST /retrieve  {"videos": ["/path/a.npy", ...]}          -> top-k texts
  POST /embed     {"videos": [...]}                          -> study embedding
  GET  /healthz                                              -> liveness
  GET  /stats                                                -> batching/latency stats

Usage:
  python -m deepcoro_clip_tpu_torch.serve [--text_bank bank.npz]
      [--base_config cfg.yaml] [--checkpoint <run>/checkpoints [--ckpt_name checkpoint]]
      [--params video_params.npz] [--port 8080] [--max_batch 4]
      [--batch_window_ms 10] [--num_videos 10] [--top_k 5] [--device cuda]
  python -m deepcoro_clip_tpu_torch.serve --artifact <dir> [--port 8080] [--device cuda]

``bank.npz`` holds ``text_embeddings`` [M, D] and ``texts`` [M] (as
``python -m deepcoro_clip_tpu_torch.generate_embeddings`` writes it).
``--checkpoint`` is the checkpoints directory of a contrastive run of the
port (``train/checkpoint.py``): its ``video_encoder`` parameters of
``--ckpt_name`` go into the served tower with a strict load (a missing or
surplus key raises). ``--params`` is the video tower's parameter tree saved
by ``convert.save_params_npz`` (a JAX checkpoint's). Without either the
tower is randomly initialized from seed 0. ``--base_config`` is the YAML of
a contrastive run (``configs.parse_config``); without it the flagship
configuration is served. ``--artifact`` serves a frozen retrieval artifact
(``export_model.py export``) through the same batcher and handler, with no
model classes on the path (``serving.RetrievalArtifact``).
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from deepcoro_clip_tpu_torch.device import resolve_device

# ---------------------------------------------------------------------------
# model assembly


class InferenceEngine:
    """Video tower + text bank + the retrieval program, on one device.

    Parameters stay fp32 on the device; under ``precision="bf16"`` each
    layer casts its weights to bf16 at use, as the JAX package does.
    """

    def __init__(self, cfg, bank_emb: np.ndarray, bank_texts,
                 max_batch: int, top_k: int, video_params=None,
                 device=None):
        from deepcoro_clip_tpu_torch.models.video_encoder import (
            init_params,
            resolve_architecture,
            video_encoder_from_config,
        )

        self.device = resolve_device(device)
        self.cfg = cfg
        self.max_batch = int(max_batch)
        self.top_k = int(top_k)
        self.num_videos = int(cfg.num_videos)
        self.patch = tuple(resolve_architecture(cfg)["vit_patch"])
        self.bank_texts = list(map(str, bank_texts))

        model = video_encoder_from_config(cfg)
        if video_params is None:
            init_params(model, seed=0)
        else:
            model.load_state_dict(video_params, strict=True)
        self.model = model.eval().to(self.device)

        bank = np.asarray(bank_emb, np.float32).copy()
        bank /= np.maximum(np.linalg.norm(bank, axis=1, keepdims=True), 1e-8)
        self.bank = torch.from_numpy(bank).to(self.device)
        self.k = min(self.top_k, bank.shape[0])

    # -- host side ---------------------------------------------------------

    def load_study(self, paths) -> tuple[np.ndarray, np.ndarray]:
        """Paths -> ([num_videos, L, K] uint8 patch-major, [num_videos] mask).

        Short studies are zero-padded and masked; long ones keep the first
        ``num_videos`` clips.
        """
        from deepcoro_clip_tpu_torch.data.patch_wire import patchify_videos
        from deepcoro_clip_tpu_torch.data.video_io import load_video

        cfg, N = self.cfg, self.num_videos
        paths = list(paths)[:N]
        clips = np.zeros((1, N, cfg.frames, cfg.resize, cfg.resize, 3), np.uint8)
        mask = np.zeros((N,), bool)
        for i, p in enumerate(paths):
            clips[0, i] = load_video(str(p), n_frames=cfg.frames, resize=cfg.resize)
            mask[i] = True
        return patchify_videos(clips, self.patch)[0], mask

    @torch.inference_mode()
    def infer_batch(self, studies: np.ndarray, masks: np.ndarray):
        """[B<=max_batch, N, L, K] -> (emb [B,D], scores [B,k], idx [B,k]).

        Pads to the fixed ``max_batch`` shape; fully-masked pad studies
        ride the aggregator's uniform fallback and are cut off here.
        """
        b = studies.shape[0]
        if b < self.max_batch:
            pad = self.max_batch - b
            studies = np.concatenate(
                [studies, np.zeros((pad,) + studies.shape[1:], studies.dtype)])
            masks = np.concatenate([masks, np.zeros((pad,) + masks.shape[1:], bool)])
        x = torch.from_numpy(np.ascontiguousarray(studies)).to(self.device)
        m = torch.from_numpy(np.ascontiguousarray(masks, bool)).to(self.device)
        emb = self.model(x, video_mask=m, deterministic=True).float()
        emb = emb / emb.norm(dim=1, keepdim=True).clamp_min(1e-8)
        scores, idx = torch.topk(emb @ self.bank.T, self.k, dim=1)
        return (emb[:b].cpu().numpy(), scores[:b].cpu().numpy(),
                idx[:b].cpu().numpy())


# ---------------------------------------------------------------------------
# micro-batcher


class MicroBatcher:
    """Coalesces concurrent studies into one fixed-shape device dispatch."""

    def __init__(self, engine: InferenceEngine, window_ms: float = 10.0):
        self.engine = engine
        self.window = window_ms / 1e3
        self._lock = threading.Condition()
        self._queue: list[dict] = []
        self.stats = {"requests": 0, "batches": 0, "occupancy_sum": 0,
                      "latencies_ms": []}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, study: np.ndarray, mask: np.ndarray) -> dict:
        item = {"study": study, "mask": mask, "done": threading.Event()}
        with self._lock:
            self._queue.append(item)
            self.stats["requests"] += 1
            self._lock.notify()
        item["done"].wait()
        if "error" in item:
            raise RuntimeError(item["error"])
        return item

    def _run(self) -> None:
        B = self.engine.max_batch
        while True:
            with self._lock:
                while not self._queue:
                    self._lock.wait()
                deadline = time.perf_counter() + self.window
                while len(self._queue) < B:
                    left = deadline - time.perf_counter()
                    if left <= 0 or not self._lock.wait(timeout=left):
                        break
                batch, self._queue = self._queue[:B], self._queue[B:]
            t0 = time.perf_counter()
            try:
                emb, scores, idx = self.engine.infer_batch(
                    np.stack([it["study"] for it in batch]),
                    np.stack([it["mask"] for it in batch]),
                )
                for i, it in enumerate(batch):
                    it["emb"], it["scores"], it["idx"] = emb[i], scores[i], idx[i]
            except Exception as e:  # surface to every waiter, keep serving
                for it in batch:
                    it["error"] = f"{type(e).__name__}: {e}"
            dt_ms = (time.perf_counter() - t0) * 1e3
            self.stats["batches"] += 1
            self.stats["occupancy_sum"] += len(batch)
            self.stats["latencies_ms"].append(dt_ms)
            del self.stats["latencies_ms"][:-1000]  # bounded window
            for it in batch:
                it["done"].set()


# ---------------------------------------------------------------------------
# HTTP layer


def make_handler(engine: InferenceEngine, batcher: MicroBatcher):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet; /stats carries the numbers
            pass

        def _json(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self) -> None:
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                s = batcher.stats
                lat = sorted(s["latencies_ms"])
                self._json(200, {
                    "requests": s["requests"],
                    "batches": s["batches"],
                    "avg_occupancy": round(
                        s["occupancy_sum"] / max(1, s["batches"]), 3),
                    "dispatch_p50_ms": round(
                        lat[len(lat) // 2], 2) if lat else None,
                    "max_batch": engine.max_batch,
                    "num_videos": engine.num_videos,
                    "bank_size": len(engine.bank_texts),
                })
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self) -> None:
            if self.path not in ("/retrieve", "/embed"):
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                paths = req.get("videos") or []
                if not paths:
                    self._json(400, {"error": "no videos given"})
                    return
                t0 = time.perf_counter()
                study, mask = engine.load_study(paths)
                item = batcher.submit(study, mask)
                ms = round((time.perf_counter() - t0) * 1e3, 2)
                if self.path == "/embed":
                    self._json(200, {"embedding": item["emb"].tolist(),
                                     "latency_ms": ms})
                else:
                    self._json(200, {
                        "topk": [
                            {"text": engine.bank_texts[int(j)], "score": float(s)}
                            for s, j in zip(item["scores"], item["idx"])
                        ],
                        "n_clips": int(mask.sum()),
                        "latency_ms": ms,
                    })
            except FileNotFoundError as e:
                self._json(400, {"error": str(e)})
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})

    return Handler


def load_text_bank(path):
    """``(text_embeddings, texts)`` of a bank ``.npz``, as
    ``python -m deepcoro_clip_tpu_torch.generate_embeddings`` writes it."""
    bank = np.load(path, allow_pickle=True)
    return bank["text_embeddings"], bank["texts"]


def load_video_params(checkpoint, name: str = "checkpoint") -> dict:
    """The video tower's parameters of a port checkpoint (the
    ``video_encoder.*`` entries of ``{name}.pt`` in the checkpoints
    directory ``checkpoint``, without the prefix), read through
    ``CheckpointManager.load``."""
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    params = CheckpointManager(checkpoint).load(name)["params"]
    pre = "video_encoder."
    out = {k[len(pre):]: v for k, v in params.items() if k.startswith(pre)}
    if not out:
        raise ValueError(f"{checkpoint}/{name}.pt holds no video_encoder parameters")
    return out


def _serve(engine, args) -> tuple[ThreadingHTTPServer, object]:
    batcher = MicroBatcher(engine, window_ms=args.batch_window_ms)
    httpd = ThreadingHTTPServer((args.host, args.port), make_handler(engine, batcher))
    httpd.batcher = batcher  # tests reach the stats through the server
    return httpd, engine


def build_server(args, cfg=None) -> tuple[ThreadingHTTPServer, InferenceEngine]:
    """The server and its engine for parsed ``args``; ``cfg`` (a config
    object) replaces ``--tiny``/``--base_config``/the flagship for callers
    without a YAML reader (``--num_videos`` and multi-video mode are forced
    on it as on a YAML's)."""
    from deepcoro_clip_tpu_torch.flagship import flagship_config, tiny_config

    if getattr(args, "artifact", None):
        # a frozen torch.export program: no model classes or config system
        # on this path; RetrievalArtifact duck-types InferenceEngine
        from deepcoro_clip_tpu_torch.serving import RetrievalArtifact

        return _serve(RetrievalArtifact(args.artifact, device=getattr(args, "device", None)),
                      args)
    if cfg is not None:
        cfg.multi_video = True
        cfg.num_videos = args.num_videos
    elif args.tiny:
        cfg = tiny_config(multi_video=True, num_videos=args.num_videos)
    elif getattr(args, "base_config", None):
        from deepcoro_clip_tpu_torch.configs import parse_config

        cfg = parse_config(["--base_config", args.base_config])
        cfg.multi_video = True
        cfg.num_videos = args.num_videos
    else:
        cfg = flagship_config(multi_video=True, num_videos=args.num_videos)

    video_params = None
    if getattr(args, "checkpoint", None):
        video_params = load_video_params(args.checkpoint, args.ckpt_name)
    elif getattr(args, "params", None):
        from deepcoro_clip_tpu_torch.convert import (
            jax_tree_to_state_dict,
            load_params_npz,
        )

        video_params = jax_tree_to_state_dict(load_params_npz(args.params))

    if args.text_bank:
        bank_emb, bank_texts = load_text_bank(args.text_bank)
    else:  # wire/latency smoke without a bank
        r = np.random.default_rng(0)
        bank_emb = r.normal(size=(args.demo_bank, cfg.embedding_dim))
        bank_texts = [f"demo report {i}" for i in range(args.demo_bank)]

    engine = InferenceEngine(cfg, bank_emb, bank_texts,
                             max_batch=args.max_batch, top_k=args.top_k,
                             video_params=video_params,
                             device=getattr(args, "device", None))
    return _serve(engine, args)


def parse_args(argv: Optional[list] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n", 1)[0])
    ap.add_argument("--artifact", default=None,
                    help="serve a frozen retrieval artifact dir (export_model.py export); "
                         "overrides the model arguments")
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoints dir of a contrastive run of the port")
    ap.add_argument("--ckpt_name", default="checkpoint")
    ap.add_argument("--base_config", default=None,
                    help="YAML of a DeepCORO_clip run (default: the flagship config)")
    ap.add_argument("--params", default=None,
                    help="video-tower params .npz (convert.save_params_npz)")
    ap.add_argument("--text_bank", default=None,
                    help="npz with text_embeddings [M, D] and texts [M]")
    ap.add_argument("--demo_bank", type=int, default=1000)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max_batch", type=int, default=4)
    ap.add_argument("--batch_window_ms", type=float, default=10.0)
    ap.add_argument("--num_videos", type=int, default=10)
    ap.add_argument("--top_k", type=int, default=5)
    ap.add_argument("--tiny", action="store_true", help="tiny config (CPU smoke)")
    ap.add_argument("--device", default=None,
                    help="torch device; default cuda (raises without CUDA)")
    return ap.parse_args(argv)


def main(argv: Optional[list] = None) -> None:
    args = parse_args(argv)
    httpd, engine = build_server(args)
    # warm the kernels and the allocator before accepting traffic
    study, mask = engine.load_study([])
    engine.infer_batch(study[None], mask[None])
    print(f"serving on http://{args.host}:{httpd.server_address[1]} "
          f"(max_batch={engine.max_batch}, num_videos={engine.num_videos}, "
          f"bank={len(engine.bank_texts)}, device={engine.device})", flush=True)
    httpd.serve_forever()


if __name__ == "__main__":
    main()
