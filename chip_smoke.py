#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (deepcoro_clip_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each printing one line (or a few) before the last:

1. device: the card's name, and its name and power limit from nvidia-smi;
2. build: nvcc builds csrc/flash_fwd.cu for sm_90a (timed);
3. kernels: each CUDA kernel against its plain PyTorch version on the card
   in bf16, at the serving path's shapes and in one small case of every
   other mode it takes;
4. serving: the retrieval server at flagship width (num_videos 10,
   max_batch 4, seeded random weights, seeded 1000 x 512 demo bank) answers
   concurrent /retrieve requests, one /embed and /stats over HTTP; the
   kernels' launch counters, zeroed just before, must show both kernels on
   that path;
5. end to end: the same studies through the kernels and through the plain
   attention, same weights; embeddings must agree to cosine >= 0.999;
6. times (CUDA events, after warm-up): dispatch latency, a profiler
   breakdown of one tower pass by kernel, each kernel at its serving
   shapes beside its plain version, its bound and
   scaled_dot_product_attention (a yardstick only; the port never calls
   it), then one JSON "kernels" line.

The last line is {"ok": true, "device": {...}}. Any failing phase exits
non-zero before it, as does a machine without CUDA.
"""

from __future__ import annotations

import concurrent.futures
import http.client
import json
import math
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

# H100 SXM published dense peaks (NVIDIA data sheet) for the bounds
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# kernel vs plain, both bf16 on the card: the outputs are rounded to bf16
# (2^-8 relative) and P is rounded to bf16 against the running max in the
# kernel but against the final max in the plain version; the sums run in
# another order. |kernel - plain| <= ATOL + RTOL * |plain| elementwise.
KERNEL_ATOL = 1e-2
KERNEL_RTOL = 1e-2
# end to end, bf16 tower through the kernels vs through the plain attention
E2E_MIN_COSINE = 0.999
# timed launches per kernel (the plain version: a fifth of them)
REPS = 20

KERNEL_SOURCE = "deepcoro_clip_tpu_torch/csrc/flash_fwd.cu"
K1_REPLACES = "deepcoro_clip_tpu/ops/flash_attention_packed.py:63"
K3_REPLACES = "deepcoro_clip_tpu/ops/flash_attention.py:84"


class PhaseError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions


def kernel_cases(torch):
    """(name, kernel_fn, plain_fn) at the serving shapes and small modes."""
    from deepcoro_clip_tpu_torch.ops.attention import multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)

    def rope(dh, T, H, W):
        t = build_rope3d_tables(dh, T, H, W, n_special=1)
        return (torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev))

    def packed_plain(q, k, v, H, sin=None, cos=None, kv_mask=None, causal=False):
        B, Lq, D = q.shape
        heads = [t.unflatten(2, (H, D // H)).transpose(1, 2) for t in (q, k, v)]
        out = multi_head_attention(*heads, sin=sin, cos=cos, kv_mask=kv_mask,
                                   causal=causal)
        return out.transpose(1, 2).reshape(B, Lq, D)

    cases = []
    # K1 at the serving shapes: fused qkv [B*N, L, 3D] with RoPE
    for T, HW in ((8, 14), (8, 7)):
        sin, cos = rope(128, T, HW, HW)
        L = sin.shape[0]
        qkv = randn(40, L, 3 * 512)
        q, k, v = qkv.split(512, dim=-1)
        cases.append((
            f"K1 fused qkv + RoPE [40,{L},1536]",
            lambda qkv=qkv, s=sin, c=cos: flash_attention_packed(
                qkv=qkv, num_heads=4, sin=s, cos=c),
            lambda q=q, k=k, v=v, s=sin, c=cos: packed_plain(q, k, v, 4, s, c),
            True))
    # K1 small modes: separate q/k/v with a key mask (one row fully masked,
    # Lq != Lk), causal
    q, k, v = randn(3, 70, 256), randn(3, 200, 256), randn(3, 200, 256)
    mask = torch.rand(3, 200, generator=g, device=dev) > 0.3
    mask[2] = False
    cases.append(("K1 q/k/v + kv_mask [3,70|200,256]",
                  lambda: flash_attention_packed(q, k, v, num_heads=2, kv_mask=mask),
                  lambda: packed_plain(q, k, v, 2, kv_mask=mask), False))
    qc, kc, vc = randn(2, 150, 256), randn(2, 150, 256), randn(2, 150, 256)
    cases.append(("K1 causal [2,150,256]",
                  lambda: flash_attention_packed(qc, kc, vc, num_heads=2, causal=True),
                  lambda: packed_plain(qc, kc, vc, 2, causal=True), False))
    # K3 at the serving shape: the aggregator, one study fully masked
    q3, k3, v3 = randn(4, 8, 10, 64), randn(4, 8, 10, 64), randn(4, 8, 10, 64)
    m3 = torch.zeros(4, 10, dtype=torch.bool, device=dev)
    m3[0, :7], m3[1, :10], m3[2, :1] = True, True, True  # study 3: no video
    cases.append(("K3 kv_mask [4,8,10,64] (one row fully masked)",
                  lambda: flash_attention(q3, k3, v3, kv_mask=m3),
                  lambda: multi_head_attention(q3, k3, v3, kv_mask=m3), True))
    # K3 small modes: cross-attention Lq != Lk with a mask, causal at Dh 128,
    # RoPE at Dh 64
    qx, kx, vx = randn(2, 3, 37, 64), randn(2, 3, 300, 64), randn(2, 3, 300, 64)
    mx = torch.rand(2, 300, generator=g, device=dev) > 0.5
    cases.append(("K3 cross + kv_mask [2,3,37|300,64]",
                  lambda: flash_attention(qx, kx, vx, kv_mask=mx),
                  lambda: multi_head_attention(qx, kx, vx, kv_mask=mx), False))
    qc3, kc3, vc3 = randn(2, 2, 130, 128), randn(2, 2, 130, 128), randn(2, 2, 130, 128)
    cases.append(("K3 causal [2,2,130,128]",
                  lambda: flash_attention(qc3, kc3, vc3, causal=True),
                  lambda: multi_head_attention(qc3, kc3, vc3, causal=True), False))
    s64, c64 = rope(64, 2, 7, 7)
    qr, kr, vr = (randn(2, 3, s64.shape[0], 64) for _ in range(3))
    cases.append(("K3 RoPE [2,3,99,64]",
                  lambda: flash_attention(qr, kr, vr, sin=s64, cos=c64),
                  lambda: multi_head_attention(qr, kr, vr, sin=s64, cos=c64), False))
    return cases


def phase_kernels(torch) -> dict:
    errs = {"K1": 0.0, "K3": 0.0}
    for name, kern, plain, at_serving_shape in kernel_cases(torch):
        out = kern()
        torch.cuda.synchronize()
        ref = plain()
        d = (out.float() - ref.float()).abs()
        tol = KERNEL_ATOL + KERNEL_RTOL * ref.float().abs()
        err = float(d.max())
        ok = bool(torch.isfinite(out).all()) and bool((d <= tol).all())
        print(f"kernel check {name}: max|kernel-plain| {err:.3e} "
              f"(tol {KERNEL_ATOL}+{KERNEL_RTOL}|plain|) {'ok' if ok else 'FAIL'}",
              flush=True)
        check(ok, f"kernel {name} disagrees with its plain version")
        if at_serving_shape:
            key = name[:2]
            errs[key] = max(errs[key], err)
    return errs


# --------------------------------------------------------------------------- #
# phase 4: the retrieval server over HTTP


def _post(port, path, payload):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    c.request("POST", path, json.dumps(payload), {"Content-Type": "application/json"})
    r = c.getresponse()
    return r.status, json.loads(r.read())


def _get(port, path):
    c = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    c.request("GET", path)
    r = c.getresponse()
    return r.status, json.loads(r.read())


def phase_serving(torch, tmp: Path):
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.serve import build_server, parse_args

    args = parse_args(["--port", "0", "--max_batch", "4", "--num_videos", "10",
                       "--top_k", "5", "--demo_bank", "1000", "--device", "cuda"])
    t0 = time.perf_counter()
    httpd, engine = build_server(args)
    study, mask = engine.load_study([])
    engine.infer_batch(study[None], mask[None])  # warm the kernels
    print(f"serving: engine built and warmed in {time.perf_counter() - t0:.1f} s "
          f"(flagship, num_videos {engine.num_videos}, max_batch {engine.max_batch})",
          flush=True)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    try:
        r = np.random.default_rng(0)
        paths = []
        for i in range(6):
            p = tmp / f"clip{i}.npy"
            np.save(p, r.integers(0, 256, size=(32, 256, 256, 3), dtype=np.uint8))
            paths.append(str(p))
        port = httpd.server_address[1]
        requests = [("/retrieve", paths[: 1 + i % 6]) for i in range(8)]
        requests.append(("/embed", paths[:3]))

        flash_attention_packed.launches = 0
        flash_attention.launches = 0
        b0 = httpd.batcher.stats["batches"]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(requests)) as ex:
            futs = [ex.submit(_post, port, path, {"videos": v}) for path, v in requests]
            results = [f.result() for f in futs]
        wall = time.perf_counter() - t0
        k1, k3 = flash_attention_packed.launches, flash_attention.launches
        code, stats = _get(port, "/stats")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    for (path, v), (code_i, out) in zip(requests, results):
        check(code_i == 200, f"{path} answered {code_i}: {out}")
        if path == "/retrieve":
            check(len(out["topk"]) == 5, f"top-k of length {len(out['topk'])}")
            scores = [t["score"] for t in out["topk"]]
            check(all(math.isfinite(s) for s in scores), f"scores {scores}")
            check(scores == sorted(scores, reverse=True), "top-k not sorted")
            check(out["n_clips"] == len(v), f"n_clips {out['n_clips']} != {len(v)}")
        else:
            emb = np.asarray(out["embedding"])
            check(emb.shape == (512,) and np.isfinite(emb).all(), "bad embedding")
            check(abs(np.linalg.norm(emb) - 1.0) < 1e-3, "embedding not unit norm")
    check(code == 200, f"/stats answered {code}")
    batches = stats["batches"] - b0
    print(f"serving: {len(requests)} concurrent requests (8 /retrieve, 1 /embed) "
          f"all 200 in {wall:.2f} s, {batches} dispatches, "
          f"avg occupancy {stats['avg_occupancy']}, dispatch p50 "
          f"{stats['dispatch_p50_ms']} ms (host clock)", flush=True)
    print(f"serving: launches K1 {k1} (12 per dispatch), K3 {k3} (2 per dispatch)",
          flush=True)
    check(batches >= 1, "no dispatch ran")
    check(k1 == 12 * batches, f"K1 launched {k1} times in {batches} dispatches")
    check(k3 == 2 * batches, f"K3 launched {k3} times in {batches} dispatches")
    return engine, paths, {"K1": k1, "K3": k3}


# --------------------------------------------------------------------------- #
# phase 5: end to end against the plain attention


def phase_e2e(torch, engine, paths):
    import dataclasses

    from deepcoro_clip_tpu_torch.models.video_encoder import video_encoder_from_config

    cfg_plain = dataclasses.replace(engine.cfg, use_pallas_attention=False)
    plain = video_encoder_from_config(cfg_plain)
    plain.load_state_dict(engine.model.state_dict())
    plain = plain.eval().to(engine.device)

    studies, masks = zip(*(engine.load_study(paths[:n]) for n in (6, 1, 3, 2)))
    x = torch.from_numpy(np.stack(studies)).to(engine.device)
    m = torch.from_numpy(np.stack(masks)).to(engine.device)
    with torch.inference_mode():
        a = engine.model(x, video_mask=m).float()
        b = plain(x, video_mask=m).float()
    check(bool(torch.isfinite(a).all()), "non-finite kernel-path embeddings")
    cos = torch.nn.functional.cosine_similarity(a, b, dim=1)
    dmax = float((a - b).abs().max())
    print(f"end to end: 4 studies through the kernels vs the plain attention: "
          f"max|d| {dmax:.3e}, min cosine {float(cos.min()):.6f} "
          f"(bar >= {E2E_MIN_COSINE})", flush=True)
    check(float(cos.min()) >= E2E_MIN_COSINE, "end-to-end cosine below the bar")
    del plain
    torch.cuda.empty_cache()
    return x, m


# --------------------------------------------------------------------------- #
# phase 6: times


def phase_profile(torch, engine, x, m) -> None:
    """Device time of one tower pass by kernel name (torch.profiler)."""
    from collections import defaultdict

    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            engine.model(x, video_mask=m)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    per_name = defaultdict(float)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            per_name[e.name] += e.time_range.elapsed_us() / 1e3
    busy = sum(per_name.values())
    if not busy:
        print("profile: no device events in the trace (not measured)", flush=True)
        return
    print(f"profile: one tower pass, kernels busy {busy:.2f} ms of {wall_ms:.2f} ms "
          f"host wall (busy share {busy / wall_ms:.2f}, profiler on)", flush=True)
    for name, ms in sorted(per_name.items(), key=lambda kv: -kv[1])[:8]:
        print(f"profile:   {ms:8.3f} ms  {ms / busy:5.1%}  {name[:90]}", flush=True)


def phase_times(torch, engine, x, m, errs, launches):
    import torch.nn.functional as F

    from deepcoro_clip_tpu_torch.ops.attention import apply_rope, multi_head_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention import flash_attention
    from deepcoro_clip_tpu_torch.ops.flash_attention_packed import (
        flash_attention_packed,
    )
    from deepcoro_clip_tpu_torch.ops.rope3d import build_rope3d_tables

    # dispatch latency: a full batch of 4 studies, host clock, ends in a copy
    studies, masks = x.cpu().numpy(), m.cpu().numpy()
    for _ in range(2):
        engine.infer_batch(studies, masks)
    lat = []
    for _ in range(10):
        t0 = time.perf_counter()
        engine.infer_batch(studies, masks)
        lat.append((time.perf_counter() - t0) * 1e3)
    with torch.inference_mode():
        dev_ms = cuda_ms(torch, lambda: engine.model(x, video_mask=m), 5)
    print(f"times: dispatch at max_batch 4 (40 clips): host p50 "
          f"{float(np.median(lat)):.2f} ms, min {min(lat):.2f} ms; tower device "
          f"time {dev_ms:.2f} ms", flush=True)

    phase_profile(torch, engine, x, m)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)

    def timed(kern, plain, library, flops, nbytes):
        b_ms, b_by = bound(flops, nbytes)
        return {"ms": cuda_ms(torch, kern, REPS),
                "plain_ms": cuda_ms(torch, plain, REPS // 5),
                "library_ms": cuda_ms(torch, library, REPS),
                "bound_ms": b_ms, "bound_by": b_by}

    k1_shapes = []
    for T, HW in ((8, 14), (8, 7)):
        t = build_rope3d_tables(128, T, HW, HW, n_special=1)
        sin, cos = torch.from_numpy(t.sin).to(dev), torch.from_numpy(t.cos).to(dev)
        L = sin.shape[0]
        B, H, Dh, D = 40, 4, 128, 512
        qkv = torch.randn(B, L, 3 * D, generator=g, device=dev).to(torch.bfloat16)
        heads = [u.unflatten(2, (H, Dh)).transpose(1, 2) for u in qkv.split(D, -1)]
        qr, kr = apply_rope(heads[0], sin, cos), apply_rope(heads[1], sin, cos)
        flops = 4 * B * H * L * L * Dh
        nbytes = B * L * 3 * D * 2 + B * L * D * 2 + 2 * L * Dh * 4
        row = timed(
            lambda: flash_attention_packed(qkv=qkv, num_heads=H, sin=sin, cos=cos),
            lambda: multi_head_attention(*heads, sin=sin, cos=cos),
            # yardstick: SDPA on pre-rotated q/k (RoPE not included)
            lambda: F.scaled_dot_product_attention(qr, kr, heads[2]),
            flops, nbytes)
        row["shape"] = f"qkv [{B},{L},{3 * D}] bf16, H {H}, Dh {Dh}, RoPE"
        row["launches_per_dispatch"] = 3 if L == 1569 else 9
        k1_shapes.append(row)
        del qkv, heads, qr, kr

    B, H, L, Dh = 4, 8, 10, 64
    q3, k3, v3 = (torch.randn(B, H, L, Dh, generator=g, device=dev).to(torch.bfloat16)
                  for _ in range(3))
    m3 = torch.ones(B, L, dtype=torch.bool, device=dev)
    m3[1, 4:], m3[3] = False, False
    k3_row = timed(lambda: flash_attention(q3, k3, v3, kv_mask=m3),
               lambda: multi_head_attention(q3, k3, v3, kv_mask=m3),
               lambda: F.scaled_dot_product_attention(
                   q3, k3, v3, attn_mask=m3[:, None, None, :]),
               4 * B * H * L * L * Dh, 4 * B * H * L * Dh * 2 + B * L)
    k3_row["shape"] = "q/k/v [4,8,10,64] bf16, kv_mask [4,10]"
    k3_row["launches_per_dispatch"] = 2

    for name, rows in (("K1", k1_shapes), ("K3", [k3_row])):
        for r in rows:
            print(f"times: {name} {r['shape']}: kernel {r['ms']:.4f} ms, plain "
                  f"{r['plain_ms']:.4f} ms, sdpa {r['library_ms']:.4f} ms, bound "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)

    def entry(name, replaces, key, rows):
        head = rows[0]
        e = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
             "replaces": replaces, "launches": launches[key],
             "max_abs_err": errs[key]}
        e.update({k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")})
        e["shapes"] = rows
        return e

    entries = [
        entry("flash_attention_packed (K1 forward)", K1_REPLACES, "K1", k1_shapes),
        entry("flash_attention (K3 forward)", K3_REPLACES, "K3", [k3_row]),
    ]
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is false", file=sys.stderr)
        return 2
    # fail fast, before any work, where the port's package is missing
    from deepcoro_clip_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {kind}, torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(smi, flush=True)  # name, power limit
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    try:
        t0 = time.perf_counter()
        _build.load("flash_fwd")
        info = _build.build_info.get("flash_fwd", {})
        print(f"build: flash_fwd.cu ready in {time.perf_counter() - t0:.1f} s "
              f"(nvcc {info.get('seconds', 0.0):.1f} s)", flush=True)
        for line in info.get("log", "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: ptxas {line.strip()}", flush=True)

        errs = phase_kernels(torch)
        with tempfile.TemporaryDirectory() as tmp:
            engine, paths, launches = phase_serving(torch, Path(tmp))
            x, m = phase_e2e(torch, engine, paths)
        kernels = phase_times(torch, engine, x, m, errs, launches)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
