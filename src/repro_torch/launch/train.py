"""Training driver: real steps on the card with the port's step functions.

Port of ``repro/launch/train.py``, with its flags:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-100m \\
      --steps 20 --mode lgc_sparse --devices 2

``--mode sync`` takes one optimizer step (``cfg.optimizer``, AdamW with
the gradient clip for qwen2) on each batch; ``lgc`` (``dense_masked``),
``lgc_sparse`` (``sparse_gather``) and ``fedavg`` (``none``) run the LGC
step with ``--devices`` N FL devices as N rows on the one card, each on
its 1/N of the batch.  On the card the LGC compression takes the CUDA
kernels (``backend="cuda"``), on the CPU their plain versions: the same
bits.  The run exits with code 1 when the loss did not fall.

``--model-parallel P`` > 1 trains every family tensor-parallel (ROADMAP
A12, A12c): the driver spawns P ranks (``launch.mesh.spawn``), each on a
(data=1, model=P) mesh holding its
shard of every leaf (``launch.sharding_rules``), in every mode.  As in
the reference, ``--devices`` counts the mesh's devices, so the LGC modes
train ``devices // P`` FL devices as rows (a count that P does not
divide is the reference's ``make_host_mesh`` refusal).  The ranks share
the card over gloo (NCCL refuses two ranks on one card) unless there is
a card a rank, where they take NCCL; the header line names the
transport; every rank draws the same vlm patches (the audio frames are
zeros on every rank).  P must divide the config's kv heads (SSD heads)
and its padded vocab, which the driver checks before it spawns a rank.

Every arch id trains (``--arch mamba2-370m``, ``olmoe-1b-7b``,
``glm4-9b``, ...; grok-1's ``sgdm`` keeps its moment in the parameters'
dtype).  The driver has no depth flag: at full depth glm4-9b,
starcoder2-7b, yi-34b and grok-1-314b need more than one card's memory
in this step (``chip_smoke.py`` trains the dense three at 4 layers
through the step functions).
The vlm and audio families get a modality stub in every batch, at the
reference's shapes (:func:`modality_prefix`): patch embeddings (B,
``n_prefix_tokens``, 1024) drawn from a seed, or zero frame embeddings
(B, ``encoder_seq``, ``d_model``), in ``cfg.dtype``.  As in
the reference, the driver passes no per-leaf model axis to the LGC step,
so ``lgc_sparse`` selects over each leaf as one row, and it donates the
state to the step (the reference's ``donate_argnums``).

It runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.tokens import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.launch import mesh as meshlib
from repro_torch.launch import sharding_rules as rules
from repro_torch.launch.steps import (LGCStepConfig, init_ef_tree,
                                      make_lgc_train_step,
                                      make_sync_train_step)
from repro_torch.models import transformer as tf
from repro_torch.optim.optimizers import OptimizerConfig, get_optimizer

AGGREGATE_OF_MODE = {"lgc": "dense_masked", "lgc_sparse": "sparse_gather",
                     "fedavg": "none"}


def _parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "lgc", "lgc_sparse", "fedavg"])
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--sparsity", default="0.01,0.02,0.02")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def modality_prefix(cfg, batch: int, device) -> torch.Tensor | None:
    """The modality stub of every batch, at the reference's
    ``batch0["prefix"]`` shapes (train.py:71-77) in ``cfg.dtype`` on
    ``device``: the audio family's frame embeddings (B, ``encoder_seq``,
    ``d_model``) are zeros, as there; the vlm's patch embeddings (B,
    ``n_prefix_tokens``, 1024) are standard normal draws from seed 0 (on
    the CPU, then moved), not the reference's zeros.  Zero patches
    stay zero rows through every block, and RMSNorm's Jacobian at a zero
    row is 1 / sqrt(eps) = 1000, so the gradient that the text positions
    send back into the patch rows grows a thousandfold a block and
    overflows: non-finite from 16 blocks on, in the reference too
    (tests/test_torch_family_training.py).  None for the other
    families."""
    if cfg.arch_type == "audio":
        return torch.zeros((batch, cfg.encoder_seq, cfg.d_model),
                           dtype=cfg.dtype, device=device)
    if cfg.arch_type != "vlm":
        return None
    gen = torch.Generator().manual_seed(0)
    return torch.randn((batch, cfg.n_prefix_tokens, tf.VIS_STUB_DIM),
                       generator=gen).to(device, cfg.dtype)


def transport(device: torch.device, ranks: int) -> str:
    """The model axis's transport: NCCL when every rank has a card of its
    own, else gloo (CPU tensors, or ranks sharing one card)."""
    if device.type == "cuda" and torch.cuda.device_count() >= ranks:
        return "nccl"
    return "gloo"


def main(argv=None) -> list[float]:
    """Run the driver; returns the losses (exits 1 if they did not fall)."""
    args = _parse(argv)
    if args.model_parallel > 1:
        meshlib.check_factors(args.devices, args.model_parallel)
        tf.check_model_axis(get_smoke_config(args.arch) if args.smoke
                            else get_config(args.arch), args.model_parallel)
        dev = resolve_device(args.device)
        backend = transport(dev, args.model_parallel)
        ranks = meshlib.spawn(rank_main, args.model_parallel, backend,
                              args=(list(argv if argv is not None
                                         else sys.argv[1:]),),
                              timeout=3600.0)
        losses = ranks[0]
        if any(r != losses for r in ranks[1:]):
            raise RuntimeError(f"the ranks' losses differ: {ranks}")
    else:
        losses = train(args)
    if not (np.isfinite(losses[-1]) and losses[-1] < losses[0]):
        print("WARNING: loss did not decrease", file=sys.stderr)
        sys.exit(1)
    return losses


def rank_main(argv: list) -> list[float]:
    """One rank of ``--model-parallel P``: its mesh, then :func:`train`."""
    args = _parse(argv)
    mesh = meshlib.make_host_mesh(args.model_parallel,
                                  model=args.model_parallel,
                                  device=args.device)
    return train(args, mesh)


def train(args, mesh=None) -> list[float]:
    """The driver's run on this process (a rank of ``mesh``'s model axis
    when given); returns the losses."""
    dev = mesh.device if mesh is not None else resolve_device(args.device)
    tp = mesh is not None and mesh.model_size > 1
    say = print if not tp or mesh.rank == 0 else (lambda *a, **k: None)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    params = tf.init_params(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in params.values())
    specs = None
    if tp:
        specs = rules.param_specs(cfg, params, mesh)
        params = rules.shard_tree(params, specs, mesh)
    n_fl = args.devices // args.model_parallel
    say(f"arch={cfg.name} params={n_params / 1e6:.1f}M mode={args.mode} "
        f"devices={args.devices} on {dev}"
        + (f" model_parallel={mesh.model_size} fl_devices={n_fl} "
           f"transport={mesh.transport}" if tp else ""))

    pipe = TokenPipeline(cfg.vocab_size, args.seq, args.batch)
    pipe.next_batch()            # the reference's batch0, drawn at set-up
    prefix = modality_prefix(cfg, args.batch, dev)

    def batch():
        x, y = pipe.next_batch()
        out = {"tokens": torch.from_numpy(x).to(dev, torch.long),
               "labels": torch.from_numpy(y).to(dev, torch.long)}
        if prefix is not None:
            out["prefix"] = prefix
        return out

    losses = []
    if args.mode == "sync":
        opt_cfg = OptimizerConfig(lr=args.lr)
        opt_init, _ = get_optimizer(cfg.optimizer, opt_cfg)
        opt_state = opt_init(params)
        step = make_sync_train_step(cfg, opt_cfg=opt_cfg, mesh=mesh)
        for i in range(args.steps):
            params, opt_state, loss = step(params, opt_state, batch())
            losses.append(float(loss))
            if i % args.log_every == 0:
                say(f"step {i:5d} loss {losses[-1]:.4f}")
    else:
        lgc = LGCStepConfig(
            local_steps=args.local_steps,
            sparsity=tuple(float(x) for x in args.sparsity.split(",")),
            local_lr=args.lr, aggregate=AGGREGATE_OF_MODE[args.mode],
            backend="cuda" if dev.type == "cuda" else "exact")
        ef = init_ef_tree(params, n_fl)
        step = make_lgc_train_step(cfg, n_fl, lgc, donate=True, mesh=mesh)
        for i in range(args.steps):
            params, ef, loss = step(params, ef, batch())
            losses.append(float(loss))
            if i % args.log_every == 0:
                say(f"round {i:5d} (H={args.local_steps}) "
                    f"loss {losses[-1]:.4f}")
        if args.ckpt_dir:
            save_checkpoint(args.ckpt_dir, args.steps, params, mesh=mesh,
                            specs=specs)

    if args.ckpt_dir and args.mode == "sync" and args.ckpt_every:
        save_checkpoint(args.ckpt_dir, args.steps, params, mesh=mesh,
                        specs=specs)
    say(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    return losses


if __name__ == "__main__":
    main()
