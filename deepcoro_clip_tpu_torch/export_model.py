"""Export, run and verify frozen serving artifacts (``torch.export`` programs).

The port's counterpart of the JAX package's ``scripts/export_model.py``:
the traced program itself is the deployable, one directory that
``serving.py`` (or ``serve --artifact``) replays without the model classes.

Usage:
  # freeze a trained tower + text bank into an artifact directory
  python -m deepcoro_clip_tpu_torch.export_model export --out art/ \\
      [--base_config cfg.yaml | --tiny] \\
      [--checkpoint <run>/checkpoints --ckpt_name best_model_epoch_16] \\
      [--text_bank bank.npz] [--max_batch 4 --num_videos 10 --top_k 5] [--device cpu]

  # freeze a linear-probing pipeline (the external-validation model)
  python -m deepcoro_clip_tpu_torch.export_model export-probe --out art/ \\
      --base_config config/linear_probing/stenosis_config.yaml \\
      [--checkpoint <probing run>/checkpoints] [--max_batch 4] [--device cpu]

  # serve a study from the artifact (no model code on this path; dispatches
  # on the artifact's kind: retrieval top-k or head predictions)
  python -m deepcoro_clip_tpu_torch.export_model run --artifact art/ --videos a.npy b.npy

  # verify the artifact against an in-process forward on a random study
  python -m deepcoro_clip_tpu_torch.export_model verify --artifact art/ \\
      [--base_config cfg.yaml | --tiny]

``--checkpoint`` is a checkpoints directory of a port run
(``train/checkpoint.py``): the video tower of a contrastive run for
``export``, the whole probing state (encoder and head) for
``export-probe``. ``bank.npz`` comes from ``python -m
deepcoro_clip_tpu_torch.generate_embeddings`` (``text_embeddings`` [M, D],
``texts`` [M]); without it a random demo bank is frozen (wire and latency
smoke only). Arguments the parser does not know override fields of
``--base_config`` (``--dataset_mean``, ``--dataset_std``: the patchify folds
them into the frozen weights, as the probing runner's encoder does). Every
subcommand runs on the card unless ``--device cpu`` is given; an artifact
runs only on the platform it was exported on.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch


def _build_cfg(args, rest=()):
    from deepcoro_clip_tpu_torch.flagship import flagship_config, tiny_config
    from deepcoro_clip_tpu_torch.registry import register_all

    register_all()
    if args.tiny:
        return tiny_config(multi_video=True, num_videos=args.num_videos)
    if args.base_config:
        from deepcoro_clip_tpu_torch.configs import parse_config

        cfg = parse_config(["--base_config", args.base_config, *rest])
        cfg.multi_video = True
        cfg.num_videos = args.num_videos
        return cfg
    return flagship_config(multi_video=True, num_videos=args.num_videos)


def _probe_cfg(args, rest=()):
    from deepcoro_clip_tpu_torch.configs import parse_config
    from deepcoro_clip_tpu_torch.registry import register_all

    register_all()
    return parse_config(["--base_config", args.base_config, *rest])


def _load_bank(args, cfg):
    if args.text_bank:
        from deepcoro_clip_tpu_torch.serve import load_text_bank

        emb, texts = load_text_bank(args.text_bank)
        return emb, [str(t) for t in texts]
    r = np.random.default_rng(0)
    return (r.normal(size=(args.demo_bank, cfg.embedding_dim)),
            [f"demo report {i}" for i in range(args.demo_bank)])


def _print_artifact(out_dir, meta) -> None:
    sizes = {p.name: p.stat().st_size for p in sorted(Path(out_dir).iterdir())}
    print(json.dumps({"meta": meta, "bytes": sizes}, indent=1), flush=True)


def cmd_export(args, rest) -> dict:
    from deepcoro_clip_tpu_torch.serve import load_video_params
    from deepcoro_clip_tpu_torch.serving import export_retrieval_artifact

    cfg = _build_cfg(args, rest)
    bank_emb, bank_texts = _load_bank(args, cfg)
    video_params = (load_video_params(args.checkpoint, args.ckpt_name)
                    if args.checkpoint else None)
    meta = export_retrieval_artifact(cfg, args.out, bank_emb, bank_texts,
                                     max_batch=args.max_batch, top_k=args.top_k,
                                     video_params=video_params, device=args.device)
    _print_artifact(args.out, meta)
    return meta


def cmd_export_probe(args, rest) -> dict:
    """Freeze a linear-probing pipeline (the external-validation model)."""
    from deepcoro_clip_tpu_torch.serving import export_probing_artifact
    from deepcoro_clip_tpu_torch.train.checkpoint import CheckpointManager

    cfg = _probe_cfg(args, rest)
    probe_params = None
    if args.checkpoint:
        probe_params = CheckpointManager(args.checkpoint).load(args.ckpt_name)["params"]
    meta = export_probing_artifact(cfg, args.out, max_batch=args.max_batch,
                                   probe_params=probe_params, device=args.device)
    _print_artifact(args.out, meta)
    return meta


def load_artifact(path, device=None):
    """Open either artifact kind by its meta."""
    from deepcoro_clip_tpu_torch.serving import META_FILE, ProbingArtifact, RetrievalArtifact

    kind = json.loads((Path(path) / META_FILE).read_text()).get("kind")
    cls = {"retrieval": RetrievalArtifact, "probing": ProbingArtifact}[kind]
    return cls(path, device=device)


def cmd_run(args, rest) -> dict:
    art = load_artifact(args.artifact, args.device)
    m = art.meta
    if args.videos:
        study, mask = art.load_study(args.videos)
    else:  # smoke: a random study at the exported shape
        r = np.random.default_rng(0)
        study = r.integers(0, 256, (m["num_videos"], m["tokens_per_clip"], m["patch_bytes"]),
                           dtype=np.uint8)
        mask = np.ones((m["num_videos"],), bool)
    t0 = time.perf_counter()
    if m["kind"] == "retrieval":
        _, scores, idx = art.infer_batch(study[None], mask[None])
        body = {"topk": [{"text": art.bank_texts[int(j)], "score": float(s)}
                         for j, s in zip(idx[0], scores[0])]}
    else:
        probs = art.predict(study[None], mask[None])
        body = {"predictions": {h: np.asarray(v)[0].tolist() for h, v in probs.items()}}
    body["latency_ms"] = round((time.perf_counter() - t0) * 1e3, 2)
    print(json.dumps(body, indent=1), flush=True)
    return body


def cmd_verify(args, rest) -> dict:
    """Artifact output against the same program run eagerly, in process, on
    the artifact's parameters and a shared random study."""
    from deepcoro_clip_tpu_torch.models.video_encoder import video_encoder_from_config
    from deepcoro_clip_tpu_torch.serving import _probing_fn, _retrieval_fn

    art = load_artifact(args.artifact, args.device)
    m = art.meta
    r = np.random.default_rng(1)
    studies = r.integers(0, 256, (m["max_batch"], m["num_videos"], m["tokens_per_clip"],
                                  m["patch_bytes"]), dtype=np.uint8)
    mask = np.ones((m["max_batch"], m["num_videos"]), bool)
    x = torch.from_numpy(studies).to(art.device)
    mk = torch.from_numpy(mask).to(art.device)

    if m["kind"] == "retrieval":
        cfg = _build_cfg(args, rest)
        model = video_encoder_from_config(cfg).eval().to(art.device)
        emb_a, sc_a, idx_a = art.infer_batch(studies, mask)
        with torch.no_grad():
            emb_b, sc_b, idx_b = (t.cpu().numpy() for t in _retrieval_fn(model, m["top_k"])(
                art._params, art._bank, x, mk))
        demb = float(np.max(np.abs(emb_a - emb_b)))
        dsc = float(np.max(np.abs(sc_a - sc_b)))
        ok = demb < 1e-5 and dsc < 1e-5 and np.array_equal(idx_a, idx_b)
        body = {"ok": bool(ok), "max_abs_emb": demb, "max_abs_score": dsc}
    else:
        from deepcoro_clip_tpu_torch.train.linear_probe import mil_from_config

        cfg = _probe_cfg(args, rest)
        video_model = video_encoder_from_config(
            cfg, aggregate=False, per_video=not m["hierarchical_tokens"],
            fused_outproj=m["fused_outproj"]).eval().to(art.device)
        fn = _probing_fn(video_model, mil_from_config(cfg).eval().to(art.device),
                         m["hierarchical_tokens"], m["has_view_ids"])
        fn_args = [art._params, x, mk]
        art_args = [studies, mask]
        if m["has_view_ids"]:
            vid = np.zeros((m["max_batch"], m["num_videos"]), np.int32)
            fn_args.append(torch.from_numpy(vid).to(art.device))
            art_args.append(vid)
        out_a = art.infer_batch(*art_args)
        with torch.no_grad():
            out_b = {h: v.float().cpu().numpy() for h, v in fn(*fn_args).items()}
        dmax = max(float(np.max(np.abs(out_a[h] - out_b[h]))) for h in out_a)
        ok = dmax < 1e-5
        body = {"ok": bool(ok), "max_abs_logit": dmax, "heads": sorted(out_a)}
    print(json.dumps(body), flush=True)
    if not ok:
        raise SystemExit(1)
    return body


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m deepcoro_clip_tpu_torch.export_model",
                                 description=__doc__.split("\n", 1)[0])
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--base_config", default=None)
        p.add_argument("--tiny", action="store_true")
        p.add_argument("--checkpoint", default=None)
        p.add_argument("--ckpt_name", default="checkpoint")
        p.add_argument("--num_videos", type=int, default=10)

    def device(p):
        p.add_argument("--device", default=None,
                       help="torch device; default cuda (raises without CUDA)")

    pe = sub.add_parser("export")
    common(pe)
    device(pe)
    pe.add_argument("--out", required=True)
    pe.add_argument("--text_bank", default=None)
    pe.add_argument("--demo_bank", type=int, default=1000)
    pe.add_argument("--max_batch", type=int, default=4)
    pe.add_argument("--top_k", type=int, default=5)

    pp = sub.add_parser("export-probe")
    pp.add_argument("--base_config", required=True, help="linear-probing pipeline YAML")
    pp.add_argument("--checkpoint", default=None)
    pp.add_argument("--ckpt_name", default="checkpoint")
    pp.add_argument("--out", required=True)
    pp.add_argument("--max_batch", type=int, default=4)
    device(pp)

    pr = sub.add_parser("run")
    pr.add_argument("--artifact", required=True)
    pr.add_argument("--videos", nargs="*", default=None)
    device(pr)

    pv = sub.add_parser("verify")
    common(pv)
    device(pv)
    pv.add_argument("--artifact", required=True)

    args, rest = ap.parse_known_args(argv)
    if rest and not getattr(args, "base_config", None):
        ap.error(f"unrecognized arguments: {' '.join(rest)}")
    return {"export": cmd_export, "export-probe": cmd_export_probe, "run": cmd_run,
            "verify": cmd_verify}[args.cmd](args, rest)


if __name__ == "__main__":
    main()
