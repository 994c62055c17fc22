"""Batched greedy serving: prefill a batch of prompts, decode with the
full cache, then with the sliding-window ring cache past the window.

    python -m repro_torch.launch.serve_decode [--arch qwen2-1.5b] [--batch 8]
        [--prompt 4000] [--gen 160] [--window 4096] [--seed 0] [--smoke]
        [--device cuda] [--profile-steps 0]

``--arch`` takes every id: the dense ``qwen2-1.5b`` / ``qwen2-100m``,
``glm4-9b``, ``starcoder2-7b`` and ``yi-34b`` (64 GiB of bf16 weights:
``--batch 4`` fits its cache and prefill beside them on an 80 GB card),
the moe ``olmoe-1b-7b`` and ``grok-1-314b`` (316 G parameters: its full
config fits no card), the ssm ``mamba2-370m``, the hybrid
``zamba2-1.2b`` (an ssm or hybrid prompt must be a multiple of the SSD
chunk, 128: ``--prompt 4096``), the vlm ``phi-3-vision-4.2b`` and the
audio ``whisper-small``.  An ssm cache has no K/V slots: its runs report
``cache_slots`` None and never wrap.  The vlm and audio prompts come with
their modality stub, drawn from ``--seed`` in the config's dtype at the
reference's shapes: (B, 576, 1024) patch embeddings, which take 576 cache
slots and positions before the prompt (``--prompt 3520`` fills a
4,096-slot ring), and (B, 1500, 768) audio frames for the encoder, whose
cross-attention K/V the decoder reads at every step.  Whisper's own
decoder ceiling is 448 tokens: ``--prompt 192 --gen 256 --window 256``.

The port's counterpart of ``examples/serve_decode.py``, at full width on the
card by default: random weights and prompts from ``--seed``, prefill through
``make_prefill_step`` and greedy decode through ``make_serve_step``, whose
attention is the ``swa_decode`` CUDA kernel.  The full-cache run keeps
``prompt + gen`` slots (and the vlm's patch positions); the ring run keeps
``window`` slots and wraps once the position passes it.  Prints one JSON
line with the prefill time, prompt tokens/s (``prompt_tokens_per_s``
counts the prompt's tokens only; ``prefill_positions_per_s`` adds the
vlm's ``prefix_positions`` patch positions), decode ms per step,
generated tokens/s and peak device memory of each run (host clock around
work that ends in a device sync), after a short warm-up serve on the card
(the kernels' build at their first launch would otherwise land in the
first run's decode).
``--smoke`` takes the arch's smoke config; ``--device cpu`` runs the plain
versions on the CPU.  ``--profile-steps N`` runs N more steps of each run
under ``torch.profiler`` and reports the device's busy time per step (the
union of its kernel intervals), its idle share and the kernel time by group
(swa_decode_kernel, matrix products, the rest).
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.device import (card_name_and_power_limit, kernel_group,
                                 resolve_device, union_us)
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import transformer as tf


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _profile(step, params, tok, cache, n: int) -> tuple[dict, dict]:
    """``n`` serve steps under the profiler: device busy time and kernel
    time by group, per step; returns them and the cache."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            tok, cache, _ = step(params, tok, cache)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_group: dict[str, float] = {}
    for e in kernels:
        g = kernel_group(e.name)
        by_group[g] = by_group.get(g, 0.0) + e.time_range.elapsed_us()
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                         for e in kernels])
    return {"steps": n, "wall_ms_per_step": wall_us / n / 1e3,
            "device_busy_ms_per_step": busy_us / n / 1e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if kernels
            else None,
            "kernel_ms_per_step_by_group": {
                k: v / n / 1e3 for k, v in sorted(by_group.items())},
            "kernel_launches_per_step": len(kernels) / n}, cache


def stub_prefix(cfg: ArchConfig, batch: int, generator: torch.Generator,
                device: torch.device) -> torch.Tensor | None:
    """The modality stub of a vlm or audio prompt, normal draws in
    ``cfg.dtype`` at the reference's shapes (``repro/launch/shapes.py``):
    vlm (B, n_prefix_tokens, 1024) patch embeddings, audio (B,
    encoder_seq, d_model) frames; None for the other families."""
    if cfg.arch_type == "vlm":
        shape = (batch, cfg.n_prefix_tokens, tf.VIS_STUB_DIM)
    elif cfg.arch_type == "audio":
        shape = (batch, cfg.encoder_seq, cfg.d_model)
    else:
        return None
    return torch.randn(shape, generator=generator, device=device).to(
        cfg.dtype)


def serve(params: dict, cfg: ArchConfig, prompts: torch.Tensor, gen: int, *,
          prefix: torch.Tensor | None = None, window: int = 0,
          cache_len: int | None = None, profile_steps: int = 0,
          mesh=None) -> dict:
    """Prefill ``prompts`` (B, P) with the modality stub ``prefix`` where
    the family takes one, then ``gen`` greedy serve steps.

    Returns the timings, the generated tokens (B, gen + 1) -- the prefill's
    argmax, then one per step -- the final cache and ``pos``, whether the
    ring wrapped, and whether the prefill's and the last step's logits are
    finite.  With ``profile_steps`` (on the card) that many more steps run
    under the profiler afterwards; ``pos`` and the cache include them.

    ``mesh`` with a model axis P > 1 (the dense family, ROADMAP A12b; the
    other families, A12c): every rank of it calls ``serve`` with its
    shards of the params (``launch.sharding_rules.param_specs``), the same
    prompts and the same ``prefix`` (:func:`stub_prefix` from a generator
    seeded alike on every rank draws the same frames or patches); the
    cache is split as ``cache_specs`` splits it (the K/V on their slots,
    the SSD conv tails on their channels and states on their heads, the
    audio cross cache whole), and every rank returns the same tokens.
    ``cache_slots`` is the whole cache's.
    """
    dev = prompts.device
    b, p = prompts.shape
    batch = {"tokens": prompts} if prefix is None else \
        {"tokens": prompts, "prefix": prefix}
    prefill_step = make_prefill_step(cfg, cache_len, device=dev, mesh=mesh)
    serve_step = make_serve_step(cfg, window, device=dev, return_logits=True,
                                 mesh=mesh)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    logits0, cache = prefill_step(params, batch)
    tok = torch.argmax(logits0, -1).to(torch.int32)[:, None]
    n_prefix = cache["pos"] - p
    _sync(dev)
    t1 = time.perf_counter()
    toks, logits = [tok], logits0
    for _ in range(gen):
        tok, cache, logits = serve_step(params, tok, cache)
        toks.append(tok)
    _sync(dev)
    t2 = time.perf_counter()
    prof = None
    if profile_steps and dev.type == "cuda":
        prof, cache = _profile(serve_step, params, tok, cache,
                               profile_steps)
    slots = (cache.get("slots", cache["kv"]["k"].shape[3]) if "kv" in cache
             else None)
    prefill_s, decode_s = t1 - t0, t2 - t1
    return {
        "batch": b, "prompt": p, "gen": gen, "window": window,
        "cache_slots": slots, "prefix_positions": n_prefix,
        "prefill_s": prefill_s,
        "prompt_tokens_per_s": b * p / prefill_s,
        "prefill_positions_per_s": b * (n_prefix + p) / prefill_s,
        "decode_ms_per_step": decode_s / max(gen, 1) * 1e3,
        "generated_tokens_per_s": b * gen / decode_s if gen else None,
        "peak_mem_gib": (torch.cuda.max_memory_allocated(dev) / 2 ** 30
                         if dev.type == "cuda" else None),
        "pos": cache["pos"],
        "wrapped": bool(window) and slots is not None
        and cache["pos"] > slots,
        "logits_finite": bool(torch.isfinite(logits0).all()
                              and torch.isfinite(logits).all()),
        "tokens": torch.cat(toks, 1),
        "cache": cache,
        "profile": prof,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's tiny smoke config")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt", type=int, default=4000)
    ap.add_argument("--gen", type=int, default=160)
    ap.add_argument("--window", type=int, default=4096,
                    help="ring cache size of the second run (0: skip it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="steps of each run to profile on the card")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    if cfg.arch_type in ("ssm", "hybrid") \
            and args.prompt % min(cfg.ssm_chunk, args.prompt):
        ap.error(f"{cfg.name}: --prompt must be a multiple of the SSD "
                 f"chunk {cfg.ssm_chunk}")
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    params = tf.init_params(cfg, seed=args.seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt),
                            generator=gen, device=dev)
    prefix = stub_prefix(cfg, args.batch, gen, dev)
    positions = tf.prompt_positions(cfg, {"tokens": prompts,
                                          "prefix": prefix})
    out = {"card": (card_name_and_power_limit() if dev.type == "cuda"
                    else None),
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           "arch": cfg.name, "params": tf.param_count(cfg)}
    runs = {"full": dict(window=0,
                         cache_len=positions + args.gen)}
    if args.window:
        runs["ring"] = dict(window=args.window, cache_len=args.window)
    if dev.type == "cuda":
        # before any clock starts: the kernels' build at their first
        # launch, cuBLAS's handles, the allocator's pools
        serve(params, cfg, prompts[:, :min(args.prompt, 128)], 2,
              prefix=prefix, **runs["full"])
    for name, kw in runs.items():
        r = serve(params, cfg, prompts, args.gen, prefix=prefix,
                  profile_steps=args.profile_steps, **kw)
        r.pop("cache")
        r["tokens_row0"] = r.pop("tokens")[0].tolist()[:16]
        out[name] = r
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
