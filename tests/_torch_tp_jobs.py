"""Jobs of the model axis's tests (tensor parallelism, ROADMAP A12), one at
a time, on the ranks that :func:`repro_torch.launch.mesh.spawn` starts
(tests/test_torch_tensor_parallel.py on the CPU, tests/test_torch_cuda.py
on the card).  It imports no jax, so the ranks start quickly.

A job is a plain dict, so it crosses into the ranks: :func:`rank_main`
builds the (data=1, model=P) mesh over the P ranks present and runs each
job on it, returning what the caller compares (numpy arrays, host floats):

* ``compress``: the LGC compression of a config's leaves at random
  (e, delta) drawn whole from a seeded CPU generator: the split pipeline
  (``steps.split_compress_rows``) on this rank's block, through the row
  kernels and through their plain versions, against the rank's block of
  ``kernels.lgc_compress_hist_rows`` of the whole leaf; and the train
  step's whole compression (``steps.make_lgc_compress``) of the sharded
  step against the unsharded one under an aggregate;
* ``loss_grads``: the tensor-parallel ``lm_loss`` and its gradient,
  gathered whole after ``transformer.sum_split_use_grads``, and the
  rank's own (unsummed) gradients of the leaves that sums; for the moe
  family each MoE layer's router ids and kept rows (``moe.dispatch``),
  for the audio family the encoder's output, and with ``fault``
  (:data:`FAULTS`) the run with that fault planted;
* ``task``: the 100M task at ``model_axis=P``: losses, each round's
  collectives and the LGC kernels' launches, and (``state``) the whole
  params and error memory after;
* ``sync``: the sync step (``cfg.optimizer``) over given batches;
* ``driver``: the train driver's rank body (``train.train``) on argv;
* ``lgc`` (ROADMAP A12c): ``steps.make_lgc_train_step`` of a config from
  the job's params over the job's batches and delivery masks: the losses,
  each round's collectives, and the whole params and error memory after;
* ``serve`` (ROADMAP A12b): each of the job's ``cases`` through the serve
  entry points at P ranks, from the rank's shards of the params: the
  prefill's logits and cache, then ``steps`` greedy steps' logits and
  tokens and the final cache (this rank's block of it: K/V, SSD conv
  tails and states, the audio family's cross cache), and each run's
  collectives; a case's ``prefix`` is the vlm's patch embeddings or the
  audio frames (with ``stub_seed`` the rank draws them itself,
  ``serve_decode.stub_prefix`` from a CPU generator of that seed; the
  audio family's encoder outputs are returned), with ``fault``
  (:data:`FAULTS`) planted; with ``conv_whole`` the
  prefill's conv tails are gathered whole on every rank before the steps
  (the layout ``cache_specs`` gives a conv that P does not divide).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

LGC_ROW_KERNELS = ("maxabs_rows", "histogram_rows", "sparsify_ef_rows")


def _numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _config(job: dict):
    """The job's ``arch`` (qwen2-100m), its smoke config with ``smoke``,
    in f32 with ``f32``, with the fields of ``replace`` changed."""
    from repro_torch.configs import get_config, get_smoke_config
    cfg = (get_smoke_config if job.get("smoke") else get_config)(
        job.get("arch", "qwen2-100m"))
    if job.get("f32"):
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    return dataclasses.replace(cfg, **job.get("replace", {}))


def _params(job: dict, cfg, device) -> dict:
    """The whole params: the job's (numpy) or the seed's draw."""
    from repro_torch.models import transformer as tf
    if job.get("params") is not None:
        return {k: torch.from_numpy(np.asarray(v)).to(device, cfg.dtype)
                for k, v in job["params"].items()}
    return tf.init_params(cfg, seed=job.get("seed", 0), device=device)


def _bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.shape == b.shape and bool(torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)))


def _compress(job: dict, mesh) -> dict:
    from repro_torch.core.compressor import PALLAS_MIN_ELEMS
    from repro_torch.kernels import lgc_compress_hist_rows
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tf
    cfg = _config(job)
    m = job.get("m", 2)
    min_elems = job.get("min_elems", PALLAS_MIN_ELEMS)
    aggregate = job.get("aggregate", "dense_masked")
    shapes = tf.init_params(cfg, device="meta")
    specs = rules.param_specs(cfg, shapes, mesh)
    step_cfg = steps.LGCStepConfig(aggregate=aggregate,
                                   backend=job.get("backend", "cuda"),
                                   pallas_min_elems=min_elems)
    # the task's selection rows (the leaves' model dims), or with
    # ``rule=None`` the driver's (each leaf one row)
    kw = dict(model_axis=job.get("rule", steps.leaf_model_axis))
    whole_compress = steps.make_lgc_compress(cfg, m, step_cfg, **kw)
    split_compress = steps.make_lgc_compress(cfg, m, step_cfg, mesh=mesh,
                                             **kw)
    n_ch = step_cfg.n_channels
    recv = torch.ones((m, n_ch), dtype=torch.int32, device=mesh.device)
    recv[-1, -1] = 0                           # a dropped channel
    names = job.get("leaves") or [
        k for k, v in shapes.items()
        if v.numel() >= job.get("min_leaf", min_elems)]
    out = {}
    for i, k in enumerate(names):
        shape, spec = tuple(shapes[k].shape), specs[k]
        ef_spec = (None, *spec)
        gen = torch.Generator().manual_seed(job.get("seed", 0) * 1000 + i)
        e = (torch.randn((m, *shape), generator=gen) * 0.01).to(mesh.device)
        d = (torch.randn((m, *shape), generator=gen) * 0.1).to(mesh.device)
        e_blk = rules.shard(e, ef_spec, mesh)
        d_blk = rules.shard(d, ef_spec, mesh)
        local = tuple(e_blk.shape[1:])
        row = {"shape": list(shape), "local": list(local),
               "split": rules.is_sharded(spec, mesh.shape)}
        cum = steps._leaf_cum_ks(int(np.prod(shape)), step_cfg.sparsity,
                                 mesh.device).expand(m, -1)
        if aggregate == "dense_masked" and row["split"]:
            g_w, e_w = lgc_compress_hist_rows(e.reshape(m, -1),
                                              d.reshape(m, -1), cum, recv)
            want = (rules.shard(g_w.reshape(m, *shape), ef_spec, mesh),
                    rules.shard(e_w.reshape(m, *shape), ef_spec, mesh))
            got = {kern: steps.split_compress_rows(
                e_blk.reshape(m, -1), d_blk.reshape(m, -1), cum, recv, mesh,
                kern) for kern in (True, False)}
            row["pipeline_bitwise"] = all(
                _bits_equal(a.reshape(b.shape), b)
                for a, b in zip(got[True], want))
            row["plain_bitwise"] = all(
                _bits_equal(a, b) for a, b in zip(got[True], got[False]))
            del g_w, e_w, want, got
        g_w, e_w = whole_compress(k, shape, e.reshape(m, -1),
                                  d.reshape(m, -1), recv)
        g_s, e_s = split_compress(k, local, e_blk.reshape(m, -1),
                                  d_blk.reshape(m, -1), recv)
        row["step_bitwise"] = (
            _bits_equal(g_s.reshape(local),
                        rules.shard(g_w.reshape(shape), spec, mesh))
            and (e_w is None or _bits_equal(
                e_s.reshape(m, *local),
                rules.shard(e_w.reshape(m, *shape), ef_spec, mesh))))
        out[k] = row
        del e, d, e_blk, d_blk, g_w, e_w, g_s, e_s
    return out


def _encode_unsummed(params, cfg, frames, mesh=None):
    """``transformer._encode`` without its ``copy_to_model``: each rank's
    gradient of the encoder output left its own heads' part."""
    from repro_torch.models import transformer as tf
    enc = frames.to(cfg.dtype) + params["enc_pos"][None, :frames.shape[1]]
    positions = torch.arange(enc.shape[1], device=enc.device)
    for bp in tf.layer_params(params, "enc_blocks"):
        enc, _ = tf._attn_block_train(enc, bp, cfg, positions, causal=False,
                                      mesh=mesh)
    return tf.apply_norm(enc, tf.subtree(params, "enc_norm"), cfg.norm)


def _cross_wo_unsummed(x, bp, cfg, enc, mesh=None):
    """``transformer._cross_train`` with the rank's cross ``wo`` output
    left unsummed."""
    from repro_torch import parallel
    from repro_torch.models import transformer as tf
    b, s, _ = x.shape
    n_h, n_kv = tf.local_heads(cfg.n_heads, cfg.n_kv_heads,
                               parallel.model_size(mesh))
    h = parallel.copy_to_model(mesh,
                               tf.apply_norm(x, bp["norm_x"], cfg.norm))
    q = (h @ bp["cross"]["wq"]).reshape(b, s, n_h, cfg.hd)
    ck, cv = tf._cross_kv(enc, bp["cross"], cfg, n_h, n_kv)
    att = tf.attention_train(q, ck, cv, causal=False,
                             q_chunk=cfg.attn_q_chunk)
    return x + att.reshape(b, s, -1) @ bp["cross"]["wo"], ck, cv


def _cross_cache_own_heads(ck_dst, cv_dst, ck, cv, mesh=None):
    """``transformer._write_cross`` writing only the rank's heads (no
    gather): the other ranks' heads of its cross cache stay zero."""
    r, n = mesh.model_rank, ck.shape[2]
    ck_dst[:, r * n:(r + 1) * n] = ck.transpose(1, 2)
    cv_dst[:, r * n:(r + 1) * n] = cv.transpose(1, 2)


#: fault -> (module name, attribute, its replacement): the load-balance
#: loss's gradient counted on every rank (``parallel.count_once`` made the
#: identity); the audio encoder's output gradient left unsummed, the cross
#: ``wo`` output left unsummed, the prefill's cross cache written with the
#: rank's heads only
FAULTS = {"aux_every_rank": ("parallel", "count_once", lambda mesh, x: x),
          "enc_unsummed": ("transformer", "_encode", _encode_unsummed),
          "cross_wo_unsummed": ("transformer", "_cross_train",
                                _cross_wo_unsummed),
          "cross_cache_own_heads": ("transformer", "_write_cross",
                                    _cross_cache_own_heads)}


def _planted(job: dict):
    """The job's ``fault`` (:data:`FAULTS`) put into this rank; returns
    its undo."""
    from repro_torch import parallel
    from repro_torch.models import transformer
    if job.get("fault") is None:
        return lambda: None
    if job["fault"] not in FAULTS:
        raise ValueError(f"no fault {job['fault']!r}")
    name, attr, new = FAULTS[job["fault"]]
    mod = {"parallel": parallel, "transformer": transformer}[name]
    old = getattr(mod, attr)
    setattr(mod, attr, new)
    return lambda: setattr(mod, attr, old)


def _encodings(outs: list):
    """A wrapper of ``transformer._encode`` that appends each call's
    output to ``outs``; returns its undo."""
    from repro_torch.models import transformer as tf
    old = tf._encode

    def new(*args, **kw):
        out = old(*args, **kw)
        outs.append(_numpy(out).copy())
        return out
    tf._encode = new
    return lambda: setattr(tf, "_encode", old)


def _dispatches(calls: list):
    """A wrapper of ``moe.dispatch`` that appends each call's (ids, kept
    rows in the sorted order) to ``calls``; returns its undo."""
    from repro_torch.models import moe
    old = moe.dispatch

    def new(ids, n_experts, capacity_factor):
        out = old(ids, n_experts, capacity_factor)
        calls.append((_numpy(ids).astype(np.int32), _numpy(out[2])))
        return out
    moe.dispatch = new
    return lambda: setattr(moe, "dispatch", old)


def _loss_grads(job: dict, mesh) -> dict:
    from repro_torch import parallel
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.models import transformer as tf
    cfg = _config(job)
    params = _params(job, cfg, mesh.device)
    specs = rules.param_specs(cfg, params, mesh)
    shards = rules.shard_tree(params, specs, mesh)
    batch = {k: torch.from_numpy(np.asarray(v)).to(mesh.device)
             for k, v in job["batch"].items()}
    names = list(shards)
    leaves = [shards[k].detach().requires_grad_(True) for k in names]
    calls: list = []
    encs: list = []
    undo = [_planted(job), _dispatches(calls), _encodings(encs)]
    try:
        with torch.enable_grad():
            loss = tf.lm_loss(dict(zip(names, leaves)), cfg, batch,
                              mesh=mesh)
            own = dict(zip(names, torch.autograd.grad(loss, leaves)))
    finally:
        for u in reversed(undo):      # the last wrapper first
            u()
    grads = tf.sum_split_use_grads(cfg, own, mesh)
    return {"loss": float(loss.detach()),
            "grads": {k: _numpy(parallel.gather_model(mesh, g, specs[k]))
                      for k, g in grads.items()},
            "unsummed": {k: _numpy(own[k])
                         for k in tf.split_use_leaves(cfg, names)},
            "dispatch": calls, "enc": encs}


def _task(job: dict, mesh) -> dict:
    from repro_torch.kernels import LAUNCHES
    from repro_torch.models.lgc_transformer import make_qwen2_100m_task
    from repro_torch.parallel import STATS
    cfg = _config(job)
    task = make_qwen2_100m_task(
        m_devices=job.get("m", 2), arch=cfg, aggregate=job["aggregate"],
        local_steps=job.get("local_steps", 2), seq=job.get("seq", 64),
        sparsity=tuple(job.get("sparsity", (0.01, 0.02, 0.02))),
        local_lr=job.get("local_lr", 3e-3), backend=job.get("backend",
                                                            "cuda"),
        pallas_min_elems=job.get("min_elems"), model_axis=mesh.model_size,
        device=mesh.device)
    params = None if job.get("params") is None else _params(job, cfg, "cpu")
    task.build(params=params)
    per_round = []
    mark = {"launches": dict(LAUNCHES), "calls": STATS["calls"],
            "bytes": STATS["bytes"]}

    def on_round(i: int, loss: float) -> None:
        per_round.append({
            "launches": {k: LAUNCHES[k] - mark["launches"].get(k, 0)
                         for k in LGC_ROW_KERNELS + ("maxabs", "histogram",
                                                     "sparsify_ef")},
            "collectives": STATS["calls"] - mark["calls"],
            "collective_bytes": STATS["bytes"] - mark["bytes"]})
        mark.update(launches=dict(LAUNCHES), calls=STATS["calls"],
                    bytes=STATS["bytes"])
    run = task.run(job.get("rounds", 3), on_round=on_round)
    out = {"losses": run["losses"], "per_round": per_round,
           "rank": mesh.rank, "transport": mesh.transport}
    if job.get("state"):
        params, ef = task.gathered_state()
        out["params"] = {k: _numpy(v) for k, v in params.items()}
        out["ef"] = {k: _numpy(v) for k, v in ef.items()}
    return out


def _sync(job: dict, mesh) -> dict:
    from repro_torch import parallel
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch.steps import make_sync_train_step
    from repro_torch.optim.optimizers import OptimizerConfig, get_optimizer
    cfg = _config(job)
    params = _params(job, cfg, mesh.device)
    specs = rules.param_specs(cfg, params, mesh)
    params = rules.shard_tree(params, specs, mesh)
    opt_cfg = OptimizerConfig(**job.get("opt", {}))
    state = get_optimizer(cfg.optimizer, opt_cfg)[0](params)
    step = make_sync_train_step(cfg, opt_cfg=opt_cfg, mesh=mesh,
                                accum_steps=job.get("accum_steps", 1))
    losses = []
    for b in job["batches"]:
        batch = {k: torch.from_numpy(np.asarray(v)).to(mesh.device)
                 for k, v in b.items()}
        params, state, loss = step(params, state, batch)
        losses.append(float(loss))
    return {"losses": losses,
            "params": {k: _numpy(parallel.gather_model(mesh, v, specs[k]))
                       for k, v in params.items()}}


def _driver(job: dict, mesh) -> dict:
    from repro_torch.launch import train
    return {"losses": train.train(train._parse(job["argv"]), mesh)}


def _lgc(job: dict, mesh) -> dict:
    from repro_torch import parallel
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch import steps
    from repro_torch.parallel import STATS
    cfg = _config(job)
    params = _params(job, cfg, mesh.device)
    specs = rules.param_specs(cfg, params, mesh)
    shards = rules.shard_tree(params, specs, mesh)
    m = job.get("m", 2)
    step = steps.make_lgc_train_step(
        cfg, m, steps.LGCStepConfig(**job["step"]), mesh=mesh)
    ef = steps.init_ef_tree(shards, m)
    losses, collectives = [], []
    for b, recv in zip(job["batches"], job["received"]):
        batch = {k: torch.from_numpy(np.asarray(v)).to(mesh.device)
                 for k, v in b.items()}
        calls = STATS["calls"]
        shards, ef, loss = step(shards, ef, batch,
                                torch.from_numpy(np.asarray(recv)))
        losses.append(float(loss))
        collectives.append(STATS["calls"] - calls)
    return {"losses": losses, "collectives": collectives,
            "params": {k: _numpy(parallel.gather_model(mesh, v, specs[k]))
                       for k, v in shards.items()},
            "ef": {k: _numpy(parallel.gather_model(mesh, v,
                                                   (None, *specs[k])))
                   for k, v in ef.items()}}


def _caches(cache: dict) -> dict:
    """The cache's tensors as numpy copies by name (``k``, ``v``,
    ``conv``, ``state``, ``cross_k``, ``cross_v``)."""
    out = {k: _numpy(t).copy() for g in ("kv", "ssm")
           for k, t in cache.get(g, {}).items()}
    return out | {k: _numpy(cache[k]).copy() for k in ("cross_k", "cross_v")
                  if k in cache}


def _serve(job: dict, mesh) -> dict:
    from repro_torch.launch import sharding_rules as rules
    cfg = _config(job)
    params = _params(job, cfg, mesh.device)
    shards = rules.shard_tree(params, rules.param_specs(cfg, params, mesh),
                              mesh)
    undo = _planted(job)
    try:
        return {case["name"]: _serve_case(case, cfg, shards, mesh)
                for case in job["cases"]}
    finally:
        undo()


def _serve_case(case: dict, cfg, shards: dict, mesh) -> dict:
    """One case of a ``serve`` job on this rank."""
    from repro_torch import parallel
    from repro_torch.launch import sharding_rules as rules
    from repro_torch.launch.serve_decode import stub_prefix
    from repro_torch.launch.steps import make_prefill_step, make_serve_step
    from repro_torch.parallel import STATS
    calls = STATS["calls"]
    prefill = make_prefill_step(cfg, case["cache_len"], mesh=mesh)
    step = make_serve_step(cfg, case["window"], mesh=mesh, return_logits=True)
    prompts = torch.from_numpy(np.asarray(case["prompts"]))
    batch = {"tokens": prompts}
    if case.get("stub_seed") is not None:
        batch["prefix"] = stub_prefix(
            cfg, prompts.shape[0],
            torch.Generator().manual_seed(case["stub_seed"]), mesh.device)
    elif case.get("prefix") is not None:
        batch["prefix"] = torch.from_numpy(np.asarray(case["prefix"]))
    encs: list = []
    undo = _encodings(encs)
    try:
        logits, cache = prefill(shards, batch)
    finally:
        undo()
    res = {"prefill_logits": _numpy(logits), "slots": cache.get("slots"),
           "enc": encs,
           "prefill_cache": _caches(cache),           # the steps write it
           "prefill_collectives": STATS["calls"] - calls}
    if case.get("conv_whole"):
        specs = rules.cache_specs(cfg, {"conv": cache["ssm"]["conv"]}, mesh)
        cache["ssm"]["conv"] = parallel.gather_model(
            mesh, cache["ssm"]["conv"], specs["conv"])
    tok = torch.argmax(logits, -1).to(torch.int32)[:, None]
    toks, step_logits = [tok], []
    for _ in range(case["steps"]):
        tok, cache, logits = step(shards, tok, cache)
        toks.append(tok)
        step_logits.append(_numpy(logits))
    return res | {"logits": np.stack(step_logits),
                  "tokens": _numpy(torch.cat(toks, 1)).astype(np.int32),
                  "cache": _caches(cache), "pos": cache["pos"],
                  "collectives": STATS["calls"] - calls}


RUNNERS = {"compress": _compress, "loss_grads": _loss_grads, "task": _task,
           "sync": _sync, "driver": _driver, "lgc": _lgc, "serve": _serve}


def rank_main(jobs: list, device: str = "cpu") -> dict:
    """Each rank's function under :func:`repro_torch.launch.mesh.spawn`:
    every job on a (1, P) mesh over the P ranks present, with each job's
    seconds; returns ``{"rank", "transport", "results"}``."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    world = dist.get_world_size()
    mesh = make_host_mesh(world, model=world, device=device)
    results = {}
    for job in jobs:
        t0 = time.perf_counter()
        results[job["name"]] = RUNNERS[job["kind"]](job, mesh)
        results[job["name"]]["seconds"] = time.perf_counter() - t0
    return {"rank": mesh.rank, "transport": mesh.transport,
            "results": results}
