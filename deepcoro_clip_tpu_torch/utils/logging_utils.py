"""Experiment logging: a JSON-lines file, and Weights & Biases when asked.

The port's copy of the JAX package's ``utils/logging_utils.py``: the logger
always appends to ``metrics.jsonl`` in the run directory, and mirrors to
wandb only when ``use_wandb`` is set and wandb is installed (imported
inside the constructor).
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, output_dir: str | Path, use_wandb: bool = False,
                 config: Optional[Any] = None, is_ref_device: bool = True):
        self.dir = Path(output_dir)
        self.is_ref = is_ref_device
        self._wandb = None
        if self.is_ref:
            self.dir.mkdir(parents=True, exist_ok=True)
            self._file = open(self.dir / "metrics.jsonl", "a")
        else:
            self._file = None
        if use_wandb and self.is_ref:
            try:  # pragma: no cover - wandb not in test image
                import wandb

                self._wandb = wandb.init(
                    project=getattr(config, "project", "deepcoro_clip_tpu"),
                    entity=getattr(config, "entity", None) or None,
                    name=getattr(config, "name", None),
                    config=config.to_dict() if config else None,
                    dir=str(self.dir),
                )
            except Exception:
                self._wandb = None

    def log(self, metrics: Dict[str, Any], step: Optional[int] = None) -> None:
        if not self.is_ref:
            return
        rec = {"ts": time.time(), "step": step}
        rec.update(
            {k: (float(v) if hasattr(v, "item") or isinstance(v, (int, float)) else v)
             for k, v in metrics.items()}
        )
        self._file.write(json.dumps(rec, default=str) + "\n")
        self._file.flush()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.log(metrics, step=step)

    def finish(self) -> None:
        if self._file:
            self._file.close()
        if self._wandb is not None:  # pragma: no cover
            self._wandb.finish()
