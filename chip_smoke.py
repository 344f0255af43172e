#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``burn_depth_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, that its kernels agree
with their plain versions, and that its main path runs on the card.

    python3 chip_smoke.py [--out PATH]

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

1. Device: name, power limit, torch and CUDA versions; TF32 off for matmuls
   and cuDNN (the parity form is f32).
2. Build: compiles every kernel under ``burn_depth_tpu_torch/csrc`` and
   prints the seconds and the ``-Xptxas -v`` register/shared-memory/spill
   lines.
3. Kernel vs plain: each kernel's wrapper against its plain PyTorch version
   on the same CUDA tensors at the main path's shapes, with the tolerance
   stated, and timed with CUDA events (median of several runs) beside the
   plain version and one PyTorch library call that computes the same
   function (timed here only; the port never calls it).
4. Main path: ``load_model("depth-pro")`` (flagship ``dinov2_l16_384``,
   random weights from a fixed seed, f32 on the card) → ``infer_from_rgb``
   on a seeded 1080×1920 RGB buffer, three times; depth must be finite of
   shape [1,1080,1920] and every kernel's launch count must match the path.
5. Main path with plain attention: the same model and input with
   ``attn_impl="plain"`` must agree with phase 4.

The second-to-last line is one JSON object ``{"kernels": [...]}`` and the
last line ``{"ok": true, "device": {...}}``.  ``--out`` also writes every
measurement as JSON to PATH.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np

# H100 SXM published peaks (dense): f32 on the FMA pipe, bf16 on the tensor
# cores, HBM3 bandwidth.  A card may run below them at a lower power limit.
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

F32_ATOL = 1e-5  # kernel vs plain, both f32 on the same inputs
F32_REL = 1e-5  # the same, relative to the largest output (max|diff| / max|plain|)
# bf16: the kernel keeps probabilities in f32 and rounds only its output, so
# it must sit within one bf16 rounding (2^-9 relative, doubled for margin)
# of the f32 result on the same values.  The plain version rounds the
# probabilities to bf16 before the product, as the TPU kernel does; it is
# held to a looser absolute bound.  Relative errors are taken against the
# largest output, as elementwise ratios are noise where outputs cancel to ~0.
BF16_KERNEL_REL = 2.0**-8
BF16_KERNEL_ATOL = 1e-5
BF16_PLAIN_ATOL = 1e-2
E2E_DEPTH_MAX_REL = 5e-3  # the reference gate's max_rel (DEPTH_PRO_THRESHOLDS)
E2E_FOCAL_REL = 1e-3

ATTN_REPLACES = "burn_depth_tpu/ops/attention.py:113"
ATTN_SOURCE = "burn_depth_tpu_torch/csrc/flash_attn_fwd.cu"
LAUNCHES_PER_INFER = {"flash_attn_fwd": 72}  # 3 ViT-L × 24 blocks
H, W = 1080, 1920


def log(msg: str) -> None:
    print(msg, flush=True)


def phase_device(torch) -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"[device] {name}; count {torch.cuda.device_count()}")
    log(f"[device] nvidia-smi: {smi}")
    log(f"[device] python {sys.version.split()[0]}, torch {torch.__version__}, CUDA {torch.version.cuda}")
    log("[device] tf32 off: torch.backends.cuda.matmul.allow_tf32=False, torch.backends.cudnn.allow_tf32=False")
    return {"name": name, "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda}


def phase_build(build) -> dict:
    t0 = time.perf_counter()
    seconds = build.build_all()
    total = time.perf_counter() - t0
    log(f"[build] {total:.2f} s wall; per source: {json.dumps({k: round(v, 2) for k, v in seconds.items()})}")
    keep = ("Compiling entry", "registers", "stack frame", "spill", "smem")
    for name, out in build.BUILD_LOGS.items():
        for line in out.splitlines():
            if any(k in line for k in keep):
                log(f"[build] {name}: {line.strip()}")
    return {"seconds": total, "per_source": seconds}


def time_ms(torch, fn, runs: int = 7, reps: int = 10, warmup: int = 3) -> float:
    """Median over ``runs`` of the mean time of ``reps`` back-to-back calls,
    timed with CUDA events after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def attention_bound_ms(b, h, t, hd, elem_bytes, peak_flops):
    ops = 4.0 * b * h * t * t * hd  # q·kᵀ and p·v, 2 operations per multiply-add
    nbytes = 4.0 * b * h * t * hd * elem_bytes  # q, k, v read once, o written once
    t_ops, t_bytes = ops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def phase_attention(torch, attn) -> list[dict]:
    F = torch.nn.functional
    cases = [
        # name, B, H, T, hd, dtype, quiet
        ("patch ViT-L, 35 tiles, f32", 35, 16, 577, 64, torch.float32, False),
        ("image/FOV ViT-L, batch 1, f32", 1, 16, 577, 64, torch.float32, False),
        ("patch ViT-L, 35 tiles, bf16", 35, 16, 577, 64, torch.bfloat16, False),
        ("image/FOV ViT-L, batch 1, bf16", 1, 16, 577, 64, torch.bfloat16, False),
        ("T=130, f32", 2, 16, 130, 64, torch.float32, False),
        ("DA3-L T=1374, f32", 1, 16, 1374, 64, torch.float32, False),
        ("batch 1, quiet softmax, f32", 1, 16, 577, 64, torch.float32, True),
        ("tiny_test hd=32, f32", 2, 2, 65, 32, torch.float32, False),
        ("tiny_test hd=32, bf16", 2, 2, 65, 32, torch.bfloat16, False),
    ]
    gen = torch.Generator(device="cuda").manual_seed(0)
    results = []
    for name, b, h, t, hd, dtype, quiet in cases:
        q, k, v = (torch.randn((b, h, t, hd), generator=gen, device="cuda").to(dtype) for _ in range(3))
        scale = hd**-0.5
        out = attn.flash_attention_cuda(q, k, v, scale, quiet)
        torch.cuda.synchronize()
        plain = attn.attention_plain(q, k, v, scale, quiet)
        ref = attn.attention_plain(q.float(), k.float(), v.float(), scale, quiet)
        err = (out.float() - ref).abs()
        plain_err = (plain.float() - ref).abs()
        if dtype == torch.float32:
            max_abs = float((out - plain).abs().max())
            rel = max_abs / float(plain.abs().max())
            ok = max_abs <= F32_ATOL and rel <= F32_REL
            tol = f"|kernel-plain| <= {F32_ATOL}, max|kernel-plain|/max|plain| <= {F32_REL}"
        else:
            max_abs = float(err.max())
            rel = max_abs / float(ref.abs().max())
            excess = float((err - BF16_KERNEL_REL * ref.abs()).max())
            ok = (excess <= BF16_KERNEL_ATOL and rel <= BF16_KERNEL_REL
                  and float(plain_err.max()) <= BF16_PLAIN_ATOL)
            tol = (f"|kernel-f32ref| <= 2^-8|f32ref| + {BF16_KERNEL_ATOL} (excess {excess:.3e}), "
                   f"max|kernel-f32ref|/max|f32ref| <= 2^-8, "
                   f"|plain-f32ref| <= {BF16_PLAIN_ATOL} (plain max {float(plain_err.max()):.3e})")
        ms = time_ms(torch, lambda: attn.flash_attention_cuda(q, k, v, scale, quiet))
        plain_ms = time_ms(torch, lambda: attn.attention_plain(q, k, v, scale, quiet))
        library_ms = None
        if not quiet:  # SDPA has no quiet-softmax form
            library_ms = time_ms(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        peak = PEAK_F32_FLOPS if dtype == torch.float32 else PEAK_BF16_FLOPS
        bound_ms, bound_by = attention_bound_ms(b, h, t, hd, q.element_size(), peak)
        row = {
            "case": name, "shape": [b, h, t, hd], "dtype": str(dtype).split(".")[-1], "quiet": quiet,
            "max_abs_err": max_abs, "max_rel_err": rel, "tolerance": tol, "ok": ok,
            "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
        }
        log(f"[attention] {json.dumps(row)}")
        results.append(row)
        del q, k, v, out, plain, ref, err, plain_err
        torch.cuda.empty_cache()
    bad = [r["case"] for r in results if not r["ok"]]
    if bad:
        raise AssertionError(f"flash_attention_cuda disagrees with attention_plain on: {bad}")
    return results


def phase_main_path(torch, api, build) -> tuple[dict, object, bytes]:
    t0 = time.perf_counter()
    model = api.load_model("depth-pro")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    cfg = model.model.config
    log(f"[main] load_model('depth-pro'): {load_s:.2f} s; working res {cfg.img_size}², "
        f"ViT-L embed {cfg.patch_encoder.embed_dim} depth {cfg.patch_encoder.depth} heads "
        f"{cfg.patch_encoder.num_heads}; device {model.device}")
    rgb = np.random.default_rng(0).integers(0, 256, (H * W * 3,), dtype=np.uint8).tobytes()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    walls, pred = [], None
    for i in range(3):
        before = dict(build.LAUNCH_COUNTS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred = api.infer_from_rgb(model, rgb, W, H)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        launched = {k: build.LAUNCH_COUNTS.get(k, 0) - before.get(k, 0) for k in LAUNCHES_PER_INFER}
        log(f"[main] infer {i}: {walls[-1] * 1e3:.1f} ms wall (synchronized); launches {launched}")
        if launched != LAUNCHES_PER_INFER:
            raise AssertionError(f"infer {i} launched {launched}, expected {LAUNCHES_PER_INFER}")
    launches = dict(build.LAUNCH_COUNTS)
    peak_mem = torch.cuda.max_memory_allocated()
    depth, focal = pred.depth, pred.focallength_px
    if tuple(depth.shape) != (1, H, W):
        raise AssertionError(f"depth shape {tuple(depth.shape)} != (1, {H}, {W})")
    if not bool(torch.isfinite(depth).all()) or not bool(torch.isfinite(focal).all()):
        raise AssertionError("non-finite depth or focal length")
    log(f"[main] depth {tuple(depth.shape)} finite, range [{float(depth.min()):.4g}, {float(depth.max()):.4g}]; "
        f"focallength_px {float(focal[0]):.6g}; fovy_rad {float(pred.fovy_rad[0]):.6g}")
    log(f"[main] peak device memory {peak_mem / 2**30:.3f} GiB (torch.cuda.max_memory_allocated)")
    info = {"load_s": load_s, "infer_wall_ms": [w * 1e3 for w in walls], "peak_mem_bytes": peak_mem,
            "launches": launches, "focallength_px": float(focal[0])}
    return info, model, (rgb, pred)


def phase_plain_path(torch, api, build, model, rgb_pred) -> dict:
    from burn_depth_tpu_torch.models.depth_pro import DepthPro
    from burn_depth_tpu_torch.ops.interpolate import resize_bilinear

    rgb, pred = rgb_pred
    plain_model = api.AnyDepthModel(
        model.kind, DepthPro(dataclasses.replace(model.model.config, attn_impl="plain"), model.model.params)
    )
    before = dict(build.LAUNCH_COUNTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = api.infer_from_rgb(plain_model, rgb, W, H)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if build.LAUNCH_COUNTS != before:
        raise AssertionError("the plain-attention run launched a kernel")
    rel = ((pred.depth - ref.depth).abs() / ref.depth.abs().clamp_min(1e-6)).max().item()
    focal_rel = abs(float(pred.focallength_px[0] - ref.focallength_px[0])) / abs(float(ref.focallength_px[0]))
    log(f"[plain] infer with attn_impl='plain': {wall * 1e3:.1f} ms wall; depth max rel diff {rel:.3e} "
        f"(<= {E2E_DEPTH_MAX_REL}), focal rel diff {focal_rel:.3e} (<= {E2E_FOCAL_REL})")
    # The metric depth saturates at the clamp wherever random weights give a
    # non-positive inverse depth, so the unclamped network output is held to
    # the same gate too, relative to its largest value.
    x = api.rgb_to_input_tensor(rgb, W, H, device=model.device)
    x = resize_bilinear(x, (model.model.img_size,) * 2)
    canon, _ = model.model.forward(x)
    canon_ref, _ = plain_model.model.forward(x)
    canon_rel = float((canon - canon_ref).abs().max() / canon_ref.abs().max().clamp_min(1e-30))
    log(f"[plain] canonical inverse depth: max |diff| / max |plain| {canon_rel:.3e} (<= {E2E_DEPTH_MAX_REL}); "
        f"depth at the clamp: {float((ref.depth >= 1e4).float().mean()):.3f} of pixels")
    if not (rel <= E2E_DEPTH_MAX_REL and focal_rel <= E2E_FOCAL_REL and canon_rel <= E2E_DEPTH_MAX_REL):
        raise AssertionError("kernel and plain-attention main paths disagree")
    return {"infer_wall_ms": wall * 1e3, "depth_max_rel": rel, "focal_rel": focal_rel,
            "canonical_rel": canon_rel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", help="also write every measurement as JSON to this path")
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    from burn_depth_tpu_torch import _build, api
    from burn_depth_tpu_torch.ops import attention as attn

    report = {"device": phase_device(torch)}
    report["build"] = phase_build(_build)
    report["attention"] = phase_attention(torch, attn)
    report["main"], model, rgb_pred = phase_main_path(torch, api, _build)
    report["plain"] = phase_plain_path(torch, api, _build, model, rgb_pred)

    main_case = report["attention"][0]
    kernels = [{
        "name": attn.KERNEL,
        "route": "cuda",
        "source": ATTN_SOURCE,
        "replaces": ATTN_REPLACES,
        "launches": report["main"]["launches"].get(attn.KERNEL, 0),
        "max_abs_err": main_case["max_abs_err"],
        "ms": main_case["ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "library_ms": main_case["library_ms"],
    }]
    missing = [k["name"] for k in kernels if k["launches"] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    log(f"[device] {report['device']['nvidia_smi']}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
