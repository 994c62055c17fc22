"""Runs of the sharded engine, one case at a time, on any engine and mesh.

A case is a plain dict, so it crosses into the ranks that
:func:`repro_torch.launch.mesh.spawn` starts: a simulator run
(``run_baseline``'s fixed controllers, per-device gaps, or a DDPG fleet)
or a population run.  :func:`run_case` runs one case on an engine
("batched" for the unsharded oracle, "sharded" on a mesh) and returns
what a comparison needs: History, the decision log, the launch counts,
the host times and, for a population, the touched devices' state.
:func:`rank_main` is the function each rank runs (``spawn(rank_main,
world, backend, args=(cases, device, check_rows))``), and :func:`compare`
holds a sharded result against the unsharded one: bitwise under
``server_reduce="gather"``, loss and ``uplink_mb`` within
:data:`PSUM_ATOL` under "psum" (the reference's tests/test_sharded.py:82-91).

With ``check_rows`` each call of ``kernels.lgc_compress_hist_rows`` (the
LGC row kernels on the card) is held bitwise against its plain version on
the same inputs; the result counts the calls and the rows.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

PSUM_ATOL = 1e-4


def sim_case(name: str, **kw) -> dict:
    """A simulator case: ``task`` (lr_mnist), ``m`` (4), ``n_train``
    (1200; None: the factory's), ``rounds`` (12), ``eval_every`` (4),
    ``mode`` (lgc), ``backend`` (cuda), ``hs`` (None: every device h = 4)
    and ``ks`` (None: 5% of D), ``fleet`` (None or "ddpg"), ``cfg`` (more
    FLConfig fields), ``server_reduce`` (gather)."""
    case = {"kind": "sim", "name": name, "task": "lr_mnist", "m": 4,
            "n_train": 1200, "rounds": 12, "eval_every": 4, "mode": "lgc",
            "backend": "cuda", "hs": None, "ks": None, "fleet": None,
            "cfg": {}, "server_reduce": "gather"}
    case.update(kw)
    return case


def population_case(name: str, **kw) -> dict:
    """A population case: ``config`` ("population": the population task
    of 8 shards; or a task name), ``n`` (4,096), ``m_cohort`` (8),
    ``store`` (dense), ``rounds`` (12), ``h`` (4), ``mode`` (lgc),
    ``backend`` (cuda)."""
    case = {"kind": "population", "name": name, "config": "population",
            "n": 4096, "m_cohort": 8, "store": "dense", "rounds": 12,
            "h": 4, "mode": "lgc", "backend": "cuda",
            "server_reduce": "gather"}
    case.update(kw)
    return case


@contextlib.contextmanager
def rows_held_against_plain(stats: dict):
    """Wrap ``kernels.lgc_compress_hist_rows`` (the engines look it up at
    each call): each call's (g, e') must be bitwise its plain version's
    on the same inputs; ``stats`` counts the calls, the rows and the
    calls that differ."""
    from repro_torch import kernels
    from repro_torch.kernels import ref
    kern = kernels.lgc_compress_hist_rows

    def checked(e, delta, cum_ks, received):
        g, e_new = kern(e, delta, cum_ks, received)
        g_ref, e_ref = ref.hist_lgc_compress_rows(e, delta, cum_ks, received)
        same = (torch.equal(g.view(torch.int32), g_ref.view(torch.int32))
                and torch.equal(e_new.view(torch.int32),
                                e_ref.view(torch.int32)))
        stats["calls"] = stats.get("calls", 0) + 1
        stats["rows"] = stats.get("rows", 0) + e.shape[0]
        stats["differ"] = stats.get("differ", 0) + (not same)
        return g, e_new
    kernels.lgc_compress_hist_rows = checked
    try:
        yield
    finally:
        kernels.lgc_compress_hist_rows = kern


def _sim_run(case: dict, engine: str, device, mesh) -> dict:
    from repro_torch.core.compressor import tree_size
    from repro_torch.core.controller import make_fleet_ddpg
    from repro_torch.core.fl import (FixedController, FLConfig, LGCSimulator,
                                     baseline_ks)
    from repro_torch.core import prng
    from repro_torch.models.paper_models import make_task
    kw = {} if case["n_train"] is None else {"n_train": case["n_train"]}
    scenario = case["cfg"].get("scenario")
    task = make_task(case["task"], m_devices=case["m"], scenario=scenario,
                     **kw)
    cfg = FLConfig(rounds=case["rounds"], eval_every=case["eval_every"],
                   backend=case["backend"], **case["cfg"])
    d = tree_size(task.init(prng.PRNGKey(0)))
    if case["fleet"] == "ddpg":
        ctrls = make_fleet_ddpg(case["m"], d, action_space=cfg.action_space,
                                seed=1, h_max=cfg.max_gap, device=device)
        ctrls.cfg.batch_size = 2
    else:
        ks = case["ks"] or baseline_ks(d)
        hs = case["hs"] or [4] * case["m"]
        ctrls = [FixedController(h, ks) for h in hs]
    sim = LGCSimulator(task, cfg, ctrls, mode=case["mode"], engine=engine,
                       device=device, mesh=mesh,
                       server_reduce=case["server_reduce"])
    hist = sim.run()
    return {"hist": hist.asdict(), "decision_log": list(sim.decision_log),
            "window_ms": list(sim.batched_engine.window_ms)}


def _population_run(case: dict, engine: str, device, mesh) -> dict:
    from repro_torch.core.fl import FLConfig
    from repro_torch.core.population import (make_population,
                                             make_population_task,
                                             run_population)
    from repro_torch.models.paper_models import make_task
    if case["config"] == "population":
        task = make_population_task(n_shards=8, n_train=2048, seed=0)
    else:
        task = make_task(case["config"], m_devices=8)
    pop = make_population(task, case["n"], ef_store=case["store"],
                          device=device)
    cfg = FLConfig(rounds=case["rounds"], eval_every=4,
                   backend=case["backend"])
    if str(device).startswith("cuda"):
        torch.cuda.reset_peak_memory_stats()
    hist = run_population(pop, cfg, case["mode"], h=case["h"],
                          m_cohort=case["m_cohort"], engine=engine,
                          mesh=mesh)
    touched = np.flatnonzero(pop.participation)
    out = {"hist": hist.asdict(), "participation": pop.participation.copy(),
           "spend": pop.spend[touched].copy(),
           "carry_bw": pop.carry_bw[touched].copy(),
           "carry_good": pop.carry_good[touched].copy(),
           "ef": pop.ef_store.gather(touched).cpu().numpy(),
           "ef_bytes": pop.ef_nbytes,
           "window_ms": [sum(v) for v in zip(*pop.phase_ms.values())]}
    if str(device).startswith("cuda"):
        out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    return out


def run_case(case: dict, engine: str, device="cpu", mesh=None,
             check_rows: bool = False) -> dict:
    """One case on ``engine`` ("batched" or "sharded" on ``mesh``), with
    its launch counts and host seconds; ``check_rows``: every row
    kernel call held against its plain version (``rows_checked``)."""
    from repro_torch.kernels import LAUNCHES, reset_launch_counts
    run = _population_run if case["kind"] == "population" else _sim_run
    stats: dict = {}
    held = (rows_held_against_plain(stats) if check_rows
            else contextlib.nullcontext())
    cuda = str(device).startswith("cuda")
    if cuda:
        torch.cuda.synchronize()
    with held:
        reset_launch_counts()
        t0 = time.perf_counter()
        out = run(case, engine, device, mesh)
        if cuda:
            torch.cuda.synchronize()
        out["wall_s"] = time.perf_counter() - t0
        out["launches"] = dict(LAUNCHES)
    out["rows_checked"] = stats
    return out


def rank_main(cases: list, device: str = "cpu",
              check_rows: bool = False, timed: tuple = ()) -> dict:
    """Each rank's function under :func:`repro_torch.launch.mesh.spawn`:
    every case on the sharded engine over the ranks present; the cases
    named in ``timed`` run again unchecked, for their host times
    (``timed_window_ms``)."""
    from repro_torch.launch.mesh import make_host_mesh
    if device == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    mesh = make_host_mesh(device=device)
    results = {}
    for case in cases:
        out = run_case(case, "sharded", mesh.device, mesh, check_rows)
        if case["name"] in timed:
            out["timed_window_ms"] = run_case(case, "sharded", mesh.device,
                                              mesh)["window_ms"]
        results[case["name"]] = out
    return {"rank": mesh.rank, "transport": mesh.transport,
            "results": results}


def _equal(a, b) -> bool:
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and a.tobytes() == b.tobytes())
    return a == b


def compare(case: dict, sharded: dict, unsharded: dict) -> list[str]:
    """What differs between a sharded result and the unsharded one: under
    gather History, the decision log and a population's touched state
    must be bitwise equal; under psum loss and ``uplink_mb`` must lie
    within :data:`PSUM_ATOL`.  Each entry names the field and the largest
    difference."""
    bad = []
    if case["server_reduce"] == "psum":
        for field in ("loss", "uplink_mb"):
            gap = float(np.max(np.abs(np.subtract(sharded["hist"][field],
                                                  unsharded["hist"][field]))))
            if not gap <= PSUM_ATOL:
                bad.append(f"{field} differs by {gap:.3e}")
        return bad
    for field in ("hist", "decision_log", "participation", "spend",
                  "carry_bw", "carry_good", "ef"):
        if field in unsharded and not _equal(sharded[field],
                                             unsharded[field]):
            gap = _gap(sharded[field], unsharded[field])
            bad.append(f"{field} differs{gap}")
    return bad


def _gap(a, b) -> str:
    """The largest difference of two Histories (by field) or two float
    arrays of one shape, for a message."""
    if isinstance(a, dict):
        gaps = {k: float(np.max(np.abs(np.subtract(a[k], b[k]))))
                for k in a if a[k] != b[k] and len(a[k]) == len(b[k])}
        return f" (largest: {gaps})"
    if (isinstance(a, np.ndarray) and a.shape == b.shape
            and a.dtype.kind == "f"):
        return f" (largest {float(np.max(np.abs(a - b))):.3e})"
    return ""
