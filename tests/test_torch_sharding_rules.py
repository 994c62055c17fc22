"""The ported partition specs (``repro_torch.launch.sharding_rules``)
against the reference's (``repro/launch/sharding_rules.py``).

For every arch id, full and smoke, on stand-in meshes (an object with
``axis_names`` and ``devices`` of the mesh's shape: all that the
reference's ``_axis_size`` reads) of (data, model) = (4, 2), the
production (16, 16) and the multi-pod (pod, data, model) = (2, 16, 16):
``param_specs`` (the reference's params from ``jax.eval_shape``, the
port's on the meta device), ``opt_state_specs`` (AdamW or SGD momentum, as
the config's optimizer), ``ef_specs`` (with and without the FL axis),
``cache_specs`` and ``batch_specs`` (batches that divide the data axis,
that divide only part of the (pod, data) product, and that divide
nothing).  Then every full-size leaf divides its axes on (16, 16), as
tests/test_distributed.py asks of the reference, and ``shard`` /
``unshard`` round-trip every qwen2-100m smoke leaf at P in {2, 4}.
"""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_get  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.launch import sharding_rules as jrules  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro_torch.configs import get_config, get_smoke_config  # noqa: E402
from repro_torch.launch import sharding_rules as rules  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.optim import optimizers as popt  # noqa: E402

MESHES = {"4x2": (("data", "model"), (4, 2)),
          "16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
CASES = [(arch, preset) for arch in list_archs()
         for preset in ("full", "smoke")]


def _mesh(name: str):
    axes, shape = MESHES[name]
    return SimpleNamespace(axis_names=axes, devices=np.empty(shape))


def _flat(tree, prefix: str = "") -> dict:
    """The reference's nested spec (or shape) dict with "/" paths."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(_flat(v, prefix + k + "/"))
        else:
            out[prefix + k] = v
    return out


def _tuples(tree) -> dict:
    return {k: tuple(v) for k, v in _flat(tree).items()}


_SHAPES: dict = {}


def _shapes(arch: str, preset: str):
    """(reference config, its params' shapes, port config, meta params)."""
    key = (arch, preset)
    if key not in _SHAPES:
        jcfg = (j_get if preset == "full" else j_smoke)(arch)
        pcfg = (get_config if preset == "full" else get_smoke_config)(arch)
        jp = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
        _SHAPES[key] = (jcfg, jp, pcfg, ptf.init_params(pcfg, device="meta"))
    return _SHAPES[key]


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch,preset", CASES)
def test_param_opt_and_ef_specs_match_the_reference(arch, preset, mesh):
    jcfg, jp, pcfg, pp = _shapes(arch, preset)
    m = _mesh(mesh)
    want = jrules.param_specs(jcfg, jp, m)
    got = rules.param_specs(pcfg, pp, m)
    assert got == _tuples(want)
    for fl_ax in (None, "data", "pod"):
        assert rules.ef_specs(got, fl_ax) == _tuples(
            jrules.ef_specs(want, fl_ax))
    j_init, _ = jopt.get_optimizer(jcfg.optimizer)
    p_init, _ = popt.get_optimizer(pcfg.optimizer)
    j_state = jax.eval_shape(j_init, jp)
    j_spec = jrules.opt_state_specs(want, j_state)
    p_spec = rules.opt_state_specs(got, p_init({}))
    assert type(p_spec).__name__ == type(j_spec).__name__
    assert p_spec[0] == tuple(j_spec[0])
    for j_part, p_part in zip(j_spec[1:], p_spec[1:]):
        assert p_part == _tuples(j_part)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_cache_specs_match_the_reference(arch, mesh):
    jcfg, pcfg = j_smoke(arch), get_smoke_config(arch)
    m = _mesh(mesh)
    for batch, length in ((32, 64), (3, 48)):
        jc = jax.eval_shape(lambda: jtf.init_cache(jcfg, batch, length))
        pc = ptf.init_cache(pcfg, batch, length, device="meta")
        want = jrules.cache_specs(jcfg, jc, m)
        got = rules.cache_specs(pcfg, pc, m)
        assert _flat(got) == _tuples(want)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("include_pod", [True, False])
def test_batch_specs_match_the_reference(mesh, include_pod):
    m = _mesh(mesh)
    cfg, pcfg = j_smoke("qwen2-100m"), get_smoke_config("qwen2-100m")
    for b in (64, 32, 16, 6, 1):
        batch = {"tokens": np.zeros((b, 8), np.int32),
                 "labels": np.zeros((b, 8), np.int32),
                 "prefix": np.zeros((b, 4, 16), np.float32)}
        want = jrules.batch_specs(cfg, batch, m, include_pod)
        assert rules.batch_specs(pcfg, batch, m, include_pod) == {
            k: tuple(v) for k, v in want.items()}


@pytest.mark.parametrize("arch", list_archs())
def test_full_config_specs_divide_on_the_production_mesh(arch):
    """Every full-size leaf divides by its spec'd axes on (16, 16)."""
    _, _, pcfg, pp = _shapes(arch, "full")
    m = _mesh("16x16")
    sizes = rules.axis_sizes(m)
    for k, spec in rules.param_specs(pcfg, pp, m).items():
        assert len(spec) == pp[k].dim(), k
        for dim, ax in zip(pp[k].shape, spec):
            n = sizes[ax] if isinstance(ax, str) else 1
            assert dim % n == 0, (arch, k, tuple(pp[k].shape), spec)


@pytest.mark.parametrize("p", [2, 4])
def test_shard_unshard_round_trip(p):
    cfg = dataclasses.replace(get_smoke_config("qwen2-100m"),
                              dtype=torch.float32)
    params = ptf.init_params(cfg, seed=1, device="cpu")
    sizes = {"data": 1, "model": p}
    specs = rules.param_specs(cfg, params, SimpleNamespace(
        axis_names=("data", "model"), shape=sizes))
    for k, v in params.items():
        blocks = [rules.shard(v, specs[k], SimpleNamespace(
            axis_names=("data", "model"), shape=sizes, rank=r))
            for r in range(p)]
        split = rules.model_dim(specs[k])
        for b in blocks:
            want = list(v.shape)
            if split is not None:
                want[split] //= p
            assert list(b.shape) == want, k
        assert torch.equal(rules.unshard(blocks, specs[k], sizes), v), k
        if split is not None:        # contiguous blocks, in rank order
            assert torch.equal(torch.cat(blocks, split), v), k
    ef_spec = (None, *specs["blocks/attn/wq"])
    e = torch.arange(2 * 2 * 128 * 128, dtype=torch.float32).reshape(
        2, 2, 128, 128)
    blocks = [rules.shard(e, ef_spec, SimpleNamespace(
        axis_names=("data", "model"), shape=sizes, rank=r))
        for r in range(p)]
    assert torch.equal(rules.unshard(blocks, ef_spec, sizes), e)
    with pytest.raises(ValueError, match="does not split"):
        rules.shard(torch.zeros(3, 5), ("model", None), SimpleNamespace(
            axis_names=("data", "model"), shape=sizes, rank=0))
