"""The port's checkpoints (``repro_torch.checkpoint``) against the JAX
reference's (``repro.checkpoint.io``): each package reads the other's
files bit for bit, the manifest bytes are the reference's, the port's own
msgpack codec is ``msgpack``'s for the manifest's types, and the
reference's mismatch errors are raised.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import msgpack  # noqa: E402

from repro.checkpoint import io as jio  # noqa: E402
from repro.configs import get_smoke_config  # noqa: E402
from repro.launch.steps import init_ef_tree as j_init_ef  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.checkpoint import io as pio  # noqa: E402
from repro_torch.checkpoint import msgpack as pmsgpack  # noqa: E402
from repro_torch.launch.steps import init_ef_tree  # noqa: E402
from repro_torch.weights import params_from_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module: its reductions in XLA:CPU's
    order and its small trainers are thousands of tiny ops, and with the
    suite's workers sharing the cores OpenMP's barriers wait on descheduled
    threads.  Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _ref_state(n_fl=2):
    """bf16 params, stacked (M, .) f32 EF (non-zero) and a Python int."""
    params = jtf.init_params(get_smoke_config("qwen2-100m"),
                             jax.random.PRNGKey(0))
    ef = jax.tree_util.tree_map(lambda x: x + 0.125, j_init_ef(params, n_fl))
    return {"params": params, "ef": ef, "round": 7}


def _port_state(n_fl=2):
    """The same state as the port holds it: flat {path: tensor} dicts."""
    ref = _ref_state(n_fl)
    params = params_from_jax(ref["params"])
    ef = {k: v + 0.125 for k, v in init_ef_tree(params, n_fl).items()}
    return {"params": params, "ef": ef, "round": 7}


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x
        return x.numpy().reshape(-1).view(np.uint8)
    a = np.asarray(x).reshape(-1)
    return (a.view(np.uint16) if a.dtype == jnp.bfloat16 else a).view(np.uint8)


def _port_like(state):
    return {"params": {k: torch.zeros_like(v)
                       for k, v in state["params"].items()},
            "ef": {k: torch.zeros_like(v) for k, v in state["ef"].items()},
            "round": 0}


def test_port_writes_what_the_reference_reads(tmp_path):
    ours = _port_state()
    pio.save_checkpoint(str(tmp_path), 7, ours)
    like = jax.tree_util.tree_map(
        lambda x: 0 if isinstance(x, int) else jnp.zeros_like(x),
        _ref_state())
    back, step = jio.restore(str(tmp_path), like)
    assert step == 7 and back["round"] == 7 and type(back["round"]) is int
    flat = {"params": params_from_jax(back["params"]),
            "ef": params_from_jax(back["ef"])}
    for part in ("params", "ef"):
        for k, v in ours[part].items():
            assert flat[part][k].dtype == v.dtype, k
            np.testing.assert_array_equal(_bits(flat[part][k]), _bits(v))


def test_reference_writes_what_the_port_reads(tmp_path):
    ref = _ref_state()
    jio.save_checkpoint(str(tmp_path), 3, ref)
    ours = _port_state()
    back, step = pio.restore(str(tmp_path), _port_like(ours))
    assert step == 3 and back["round"] == 7 and type(back["round"]) is int
    assert list(back["params"]) == list(ours["params"])
    for part in ("params", "ef"):
        for k, v in ours[part].items():
            assert back[part][k].dtype == v.dtype, k
            np.testing.assert_array_equal(_bits(back[part][k]), _bits(v))


def test_manifest_bytes_are_the_references(tmp_path):
    """The same state saved by each package: byte-identical manifests
    and blobs."""
    jio.save_checkpoint(str(tmp_path / "ref"), 5, _ref_state())
    pio.save_checkpoint(str(tmp_path / "port"), 5, _port_state())
    ref_dir = tmp_path / "ref" / "step_00000005"
    port_dir = tmp_path / "port" / "step_00000005"
    assert sorted(os.listdir(ref_dir)) == sorted(os.listdir(port_dir))
    for name in os.listdir(ref_dir):
        assert (ref_dir / name).read_bytes() == (port_dir / name).read_bytes(), name


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -2**15 - 1, -2**31 - 1, -2**63,
    "", "x" * 31, "x" * 32, "y" * 256, "z" * 70000, "PyTreeDef({'a': *})",
    [], list(range(15)), list(range(16)), list(range(70000)),
    {}, {str(i): i for i in range(16)},
    {"n_leaves": 2, "treedef": "PyTreeDef(*)", "step": 3,
     "dtypes": ["bfloat16", "int64"], "shapes": [[2, 3], []]}])
def test_msgpack_codec_is_msgpacks(value):
    assert pmsgpack.packb(value) == msgpack.packb(value)
    assert pmsgpack.unpackb(msgpack.packb(value)) == msgpack.unpackb(
        msgpack.packb(value))


def test_treedef_strings_are_jaxs():
    tree = {"b": {"x": 1, "a": 2}, "a": [3, (4, 5)], "s": 6, "t": (7,),
            "l": []}
    assert pio._flatten(tree)[1] == str(jax.tree_util.tree_structure(tree))
    assert pio._flatten({"blocks/attn/wq": 1, "embed": 2})[1] == str(
        jax.tree_util.tree_structure({"blocks": {"attn": {"wq": 1}},
                                      "embed": 2}))


def test_python_scalars_latest_step_and_restore_empty(tmp_path):
    assert pio.latest_step(str(tmp_path / "nowhere")) is None
    assert pio.restore(str(tmp_path), {"w": torch.zeros(3)}) == (None, None)
    tree = {"round": 3, "lr": 0.125, "w": torch.arange(4.0),
            "big": np.array([2**40 + 17, -(2**35)], np.int64)}
    pio.save_checkpoint(str(tmp_path), 2, tree)
    pio.save_checkpoint(str(tmp_path), 11, dict(tree, round=4))
    like = {"round": 0, "lr": 0.0, "w": torch.zeros(4),
            "big": np.zeros(2, np.int64)}
    back, step = pio.restore(str(tmp_path), like)
    assert step == 11 and back["round"] == 4 and type(back["round"]) is int
    assert back["lr"] == 0.125 and type(back["lr"]) is float
    assert torch.equal(back["w"], tree["w"])
    np.testing.assert_array_equal(back["big"], tree["big"])


def test_the_references_mismatch_errors(tmp_path):
    """Leaf count, same-arity treedef, shape and a corrupt blob's dtype:
    the reference's error types and messages."""
    state = _port_state()
    path = pio.save_checkpoint(str(tmp_path), 0, state)
    like = _port_like(state)
    with pytest.raises(AssertionError, match="leaves"):
        pio.load_checkpoint(str(tmp_path), 0, {"params": like["params"]})
    flat = pio._flatten(like)[0]
    with pytest.raises(ValueError, match="treedef"):
        pio.load_checkpoint(str(tmp_path), 0,
                            {f"k{i:04d}": x for i, x in enumerate(flat)})
    other = _port_like(_port_state(n_fl=4))
    with pytest.raises(ValueError, match="shape"):
        pio.load_checkpoint(str(tmp_path), 0, other)
    np.save(os.path.join(path, "arr_00000.npy"), np.ones(
        state["ef"]["blocks/attn/bk"].shape, np.float64))
    with pytest.raises(ValueError, match="manifest"):
        pio.load_checkpoint(str(tmp_path), 0, like)
