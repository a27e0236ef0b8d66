"""Checkpoints on ``torch.save`` with the JAX package's retention policy.

The port's counterpart of the JAX package's ``train/checkpoint.py`` (orbax
there). Names and policy are the same: ``checkpoint`` (the latest, every
epoch), ``best_model_epoch_{e}`` (lowest validation loss) and
``highest_alignment_epoch_{e}`` (highest alignment), of which only the
newest of each kind is kept; ``save_debug`` writes a named snapshot that is
never the resume target. Each is one file ``{name}.pt`` beside a sidecar
``{name}.json`` with the meta (epoch, losses, best so far, dataset stats).

A ``.pt`` file holds the training step, the parameters (the flat training
dict, on the CPU), the optimizer state, the state of the run's dropout
``torch.Generator``, the state of a host-side batch sampler where the run
has one (``sampler``: the single-head SigLIP sampler's ``state_dict``) and
the meta: enough that a resumed run repeats an uninterrupted one. A file is written under a temporary name and moved into
place, so a crash mid-save leaves the previous checkpoint whole. A best or
alignment snapshot of the very state the latest checkpoint was just written
from (the same step, meta, generator and sampler states) is a hard link to
that file (a copy where the file system has no links): the same bytes,
serialised and written once.

Under data parallelism every rank calls the saves: the dropout generators
are gathered, one a data index of the process grid (``generators``, in
data order; ``generator`` is index 0's; the model ranks of an index share
theirs), rank 0 alone writes, and each rank restores its index's generator
and the shared parameters and moments. A checkpoint of one grid loads into
a run of another.

Under tensor parallelism a rank holds its part of each cut leaf
(``train/state.model_splits``); a save gathers the parts of every cut
parameter, moment and accumulator over the model group first, so a file
always holds the whole tree, and a restore hands each rank its part
(``state.take_shard``). A checkpoint written at one ``mesh_model`` so
restores at any other.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from deepcoro_clip_tpu_torch.parallel.distributed import (
    barrier,
    data_rank,
    gather_shard,
    grid,
    rank,
)
from deepcoro_clip_tpu_torch.parallel.mesh import MODEL_AXIS
from deepcoro_clip_tpu_torch.parallel.multihost import gather_objects
from deepcoro_clip_tpu_torch.train.state import Split, model_splits, take_shard


def _to_cpu(tree, splits: Dict[str, Split], key: str = ""):
    """A copy of ``tree`` on the CPU, each leaf under a cut parameter's
    name gathered whole (collective over the model group: every rank calls
    it)."""
    if isinstance(tree, dict):
        return {k: _to_cpu(v, splits, k) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        if key in splits:
            tree = gather_shard(tree, splits[key])
        return tree.detach().to("cpu", copy=True)
    return tree


def _load_into(dst, src, splits: Dict[str, Split], key: str = ""):
    """``src`` (from a file) into the live structure ``dst``: tensors are
    copied in place, so parameters stay the models' own; a leaf under a cut
    parameter's name takes this rank's part of the whole."""
    if isinstance(dst, dict):
        return {k: _load_into(dst[k], src[k], splits, k) if k in dst else src[k]
                for k in src}
    if isinstance(dst, torch.Tensor):
        if key in splits:
            g = grid()
            src = take_shard(src, splits[key], g.shape[MODEL_AXIS], g.index[MODEL_AXIS])
        with torch.no_grad():
            dst.copy_(src)
        return dst
    return src


def _snapshot_key(state: Any, meta: Dict[str, Any], states, sampler) -> bytes:
    """What a file written from ``state`` holds besides its tensors: the
    step, the meta, the generator states and the sampler's state."""
    return pickle.dumps((int(state.step), json.dumps(meta, default=float, sort_keys=True),
                         [None if g is None else bytes(g.numpy()) for g in states],
                         None if sampler is None else sampler.state_dict()))


class CheckpointManager:
    def __init__(self, directory: str | Path):
        self.dir = Path(directory)
        # the latest checkpoint's file, the state it was written from (a
        # weak reference) and its snapshot key
        self._latest = None
        if rank() == 0:
            self.dir.mkdir(parents=True, exist_ok=True)

    # ------------------------------------------------------------------ #

    def _save(self, name: str, state: Any, meta: Dict[str, Any],
              generator: Optional[torch.Generator] = None, sampler=None,
              reuse: bool = False) -> Path:
        """Every rank calls it (the generator states are gathered, those of
        model index 0 kept: one a data index); rank 0 writes, and no rank
        returns before the file is in place. ``reuse``: where the latest
        checkpoint was written from this same state (every rank agreeing),
        the file is linked to it instead of written again."""
        states = gather_objects([None if generator is None else generator.get_state()])
        states = states[::grid().shape[MODEL_AXIS]]
        path = self.dir / f"{name}.pt"
        if reuse or name == "checkpoint":
            key = _snapshot_key(state, meta, states, sampler)
        if reuse:
            last = self._latest
            same = last is not None and last[1]() is state and last[2] == key
            if all(gather_objects([same])):
                if rank() == 0:
                    tmp = self.dir / f"{name}.pt.tmp"
                    tmp.unlink(missing_ok=True)
                    try:
                        os.link(last[0], tmp)
                    except OSError:
                        shutil.copyfile(last[0], tmp)
                    os.replace(tmp, path)
                    (self.dir / f"{name}.json").write_text(json.dumps(meta, default=float))
                barrier()
                return path
        splits = model_splits(state.params)
        params = _to_cpu(dict(state.params), splits)
        opt_state = _to_cpu(state.opt_state, splits)
        if rank() == 0:
            tmp = self.dir / f"{name}.pt.tmp"
            torch.save({
                "step": int(state.step),
                "params": params,
                "opt_state": opt_state,
                "generator": states[0],
                "generators": states,
                "sampler": None if sampler is None else sampler.state_dict(),
                "meta": meta,
            }, tmp)
            os.replace(tmp, path)
            (self.dir / f"{name}.json").write_text(json.dumps(meta, default=float))
        if name == "checkpoint":
            try:
                self._latest = (path, weakref.ref(state), key)
            except TypeError:  # a state that takes no weak reference
                self._latest = None
        barrier()
        return path

    def _prune(self, prefix: str, keep: str) -> None:
        if rank() == 0:
            for p in self.dir.glob(f"{prefix}*"):
                if p.name.split(".")[0] != keep:
                    p.unlink(missing_ok=True)
        barrier()

    def save_latest(self, state: Any, meta: Dict[str, Any],
                    generator: Optional[torch.Generator] = None, sampler=None) -> Path:
        return self._save("checkpoint", state, meta, generator, sampler)

    def save_debug(self, name: str, state: Any, meta: Dict[str, Any],
                   generator: Optional[torch.Generator] = None) -> Path:
        """A diagnostic snapshot under its own name; never the resumable
        ``checkpoint``."""
        return self._save(name, state, meta, generator)

    def save_best(self, state: Any, epoch: int, meta: Dict[str, Any],
                  generator: Optional[torch.Generator] = None, sampler=None) -> Path:
        name = f"best_model_epoch_{epoch}"
        path = self._save(name, state, meta, generator, sampler, reuse=True)
        self._prune("best_model_epoch_", name)
        return path

    def save_alignment(self, state: Any, epoch: int, meta: Dict[str, Any],
                       generator: Optional[torch.Generator] = None, sampler=None) -> Path:
        name = f"highest_alignment_epoch_{epoch}"
        path = self._save(name, state, meta, generator, sampler, reuse=True)
        self._prune("highest_alignment_epoch_", name)
        return path

    # ------------------------------------------------------------------ #

    def load(self, name: str = "checkpoint") -> Dict[str, Any]:
        """The raw contents of ``{name}.pt``, on the CPU."""
        return torch.load(self.dir / f"{name}.pt", map_location="cpu",
                          weights_only=True)

    def restore(self, state_like: Any, name: str = "checkpoint",
                generator: Optional[torch.Generator] = None, sampler=None) -> Any:
        """Load ``name`` into ``state_like``'s tensors in place (and its
        generator state into ``generator``, its sampler state into
        ``sampler``); returns the state with the saved step."""
        saved = self.load(name)
        splits = model_splits(state_like.params)
        _load_into(state_like.params, saved["params"], splits)
        opt_state = _load_into(state_like.opt_state, saved["opt_state"], splits)
        # this rank's data index's generator; a checkpoint of fewer indices
        # (or one from before the per-index states) leaves the others fresh
        states = saved.get("generators") or [saved.get("generator")]
        d = data_rank()
        if generator is not None and d < len(states) and states[d] is not None:
            generator.set_state(states[d])
        if sampler is not None and saved.get("sampler") is not None:
            sampler.load_state_dict(saved["sampler"])
        return state_like.replace(step=int(saved["step"]), opt_state=opt_state)

    def load_meta(self, name: str = "checkpoint") -> Optional[Dict[str, Any]]:
        p = self.dir / f"{name}.json"
        if not p.exists():
            return None
        return json.loads(p.read_text())

    def latest_exists(self) -> bool:
        return (self.dir / "checkpoint.pt").exists()

    def find_best(self) -> Optional[str]:
        for p in sorted(self.dir.glob("best_model_epoch_*.pt")):
            return p.name[: -len(".pt")]
        return None
