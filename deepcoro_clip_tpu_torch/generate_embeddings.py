"""Write a text bank (and/or video embeddings) from a contrastive checkpoint.

    python -m deepcoro_clip_tpu_torch.generate_embeddings --base_config cfg.yaml \\
        --checkpoint <run dir>/checkpoints --texts_csv reports.csv \\
        --text_column Report --out text_bank.npz [--device cpu] [--any_config_field value]
    python -m deepcoro_clip_tpu_torch.generate_embeddings --base_config cfg.yaml \\
        --checkpoint <run dir>/checkpoints --videos --out video_embeddings.npz

The port's counterpart of the JAX package's ``scripts/generate_embeddings.py``.
The config builds a ``VideoContrastiveLearningRunner`` (its data split is
the config's ``run_mode``); ``--checkpoint`` (a port checkpoints directory,
whose ``checkpoint.pt`` is read, or a ``.pt``) loads every parameter,
and a parameter it lacks or shapes otherwise is an error. ``--texts_csv``:
the column's unique texts in first-seen order (a missing cell reads
"nan", as pandas' ``astype(str)`` gives it), encoded by the runner's
``_encode_texts``, saved as ``text_embeddings`` / ``texts``: the bank that
``run_mode: inference`` and ``serve --text_bank`` read. ``--videos``: the
embeddings of the config's split (``val`` when the config's mode has no
split), saved as ``video_embeddings`` / ``paths``. The manifest is read
with the port's separator fallback (``data/csv_utils.py``). Other
arguments override config fields; ``main(argv, config=...)`` takes a
config object instead of ``--base_config``, for callers without a YAML
reader.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from deepcoro_clip_tpu_torch.data.csv_utils import read_csv_with_fallback
from deepcoro_clip_tpu_torch.registry import register_all


def load_checkpoint_params(runner, path: str) -> None:
    """Every parameter of ``runner`` from a port checkpoint, in place."""
    p = Path(path)
    if p.is_dir():
        p = p / "checkpoint.pt"
    saved = torch.load(p, map_location="cpu", weights_only=True)["params"]
    params = runner.state.params
    bad = [k for k, v in params.items() if k not in saved or saved[k].shape != v.shape]
    if bad:
        raise ValueError(f"{p} does not fit the config: {len(bad)} parameters missing or "
                         f"shaped otherwise, e.g. {bad[:3]}")
    with torch.no_grad():
        for k, v in params.items():
            v.copy_(saved[k])


def main(argv: Optional[Sequence[str]] = None, config=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m deepcoro_clip_tpu_torch.generate_embeddings")
    ap.add_argument("--base_config", default=None)
    ap.add_argument("--checkpoint", default=None,
                    help="a port checkpoints directory (its checkpoint.pt is read) or a .pt")
    ap.add_argument("--texts_csv", default=None)
    ap.add_argument("--text_column", default="Report")
    ap.add_argument("--videos", action="store_true")
    ap.add_argument("--out", required=True)
    args, rest = ap.parse_known_args(argv)

    from deepcoro_clip_tpu_torch.runners.contrastive import VideoContrastiveLearningRunner

    register_all()
    if config is None:
        if args.base_config is None:
            ap.error("--base_config is required without a config object")
        from deepcoro_clip_tpu_torch.configs import parse_config

        config = parse_config(["--base_config", args.base_config] + list(rest))
    else:
        config.set_device_info_in_place()
    runner = VideoContrastiveLearningRunner(config)
    if args.checkpoint:
        load_checkpoint_params(runner, args.checkpoint)

    out: dict = {}
    if args.texts_csv:
        table = read_csv_with_fallback(args.texts_csv)
        texts = ["nan" if v is None else str(v) for v in table.column(args.text_column)]
        uniq = list(dict.fromkeys(texts))
        emb = runner._encode_texts(uniq)
        out["text_embeddings"] = emb
        out["texts"] = np.asarray(uniq)
        print(f"encoded {len(uniq)} unique texts -> {emb.shape}", flush=True)
    if args.videos:
        split = config.run_mode if config.run_mode in runner.loaders else "val"
        embs, paths = [], []
        for batch in runner.loaders[split]:
            embs.append(runner.video_embeddings(batch))
            paths.extend(p[0] for p in batch["paths"])
        out["video_embeddings"] = np.concatenate(embs)
        out["paths"] = np.asarray(paths)
        print(f"encoded {len(paths)} videos", flush=True)
    np.savez(args.out, **out)
    print(f"saved {args.out}", flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
