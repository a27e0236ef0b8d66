"""Convert a reference (HeartWise-AI/DeepCORO_CLIP) torch checkpoint into the
port's state dicts.

The reference saves monolithic torch dicts keyed by component. Everything
but the mVIT video backbone maps exactly onto the port's modules
(``utils/torch_import.py``): the text tower, the video projection head, the
attention pool, the ``EnhancedVideoAggregator``, the MIL / probing heads
and the captioning decoder. The mVIT backbone has no mapping (the port's
video tower is CoroViT) and is reported as skipped.

Usage::

    python -m deepcoro_clip_tpu_torch.convert_checkpoint checkpoint.pt \
        --out converted.pt [--report report.json]

Read the result with ``utils.torch_import.load_converted("converted.pt")``:
``{component: state dict}``. ``states["text_encoder"]`` loads into a
``models.text_encoder.TextEncoder`` of the same sizes (``strict=True``
where the checkpoint has the projection head); ``states["video_encoder"]``
holds the ``proj.proj``, ``aggregator`` and ``pool`` entries of a
``VideoEncoder`` (``strict=False``, the backbone keeps its own);
``states["linear_probing"]`` fits a ``MultiInstanceLinearProbing`` built
with ``separate_video_attention=False``.
"""

from __future__ import annotations

import argparse
import json
from typing import Optional, Sequence


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("checkpoint", help="reference .pt checkpoint path")
    ap.add_argument("--out", required=True, help="output .pt path")
    ap.add_argument("--report", default=None,
                    help="optional path for the JSON conversion report")
    args = ap.parse_args(argv)

    from deepcoro_clip_tpu_torch.utils.torch_import import (
        convert_reference_checkpoint,
        load_torch_checkpoint,
        save_converted,
    )

    states, report = convert_reference_checkpoint(load_torch_checkpoint(args.checkpoint))
    if not states:
        print("nothing convertible found in", args.checkpoint)
        return 1
    save_converted(states, args.out)
    print(f"wrote {args.out}")
    print("converted:", ", ".join(report["converted"]))
    for k, n in report["skipped"].items():
        print(f"skipped:   {k} ({n} tensors)")
    if report["meta"]:
        print("metadata: ", json.dumps(report["meta"], default=str))
    if args.report:
        with open(args.report, "w") as f:
            json.dump(report, f, indent=2, default=str)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
