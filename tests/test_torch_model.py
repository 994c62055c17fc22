"""The port's dense transformer held against the JAX reference.

Both sides run the TINY qwen2 config of tests/test_lgc_step.py in float32,
with the reference's initial weights carried into the port by
``repro_torch.weights.params_from_jax``; inputs are made with numpy from a
seed.  Tolerance rtol 1e-5 / atol 1e-6: XLA:CPU and ATen sum the same f32
products in different orders.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ArchConfig as PArch  # noqa: E402
from repro_torch.models import layers as pl_  # noqa: E402
from repro_torch.models import transformer as ptf  # noqa: E402
from repro_torch.weights import params_from_jax, params_to_jax  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6

TINY = dataclasses.replace(
    get_smoke_config("qwen2-100m"), name="qwen2-tiny", n_layers=1,
    d_model=32, n_heads=2, n_kv_heads=1, d_ff=64, vocab_size=64,
    attn_q_chunk=16, loss_chunk=16, dtype=jnp.float32)


def port_arch(cfg) -> PArch:
    """The port's ArchConfig with the reference config's fields, f32."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
          if f.name != "dtype"}
    return PArch(**kw, dtype=torch.float32)


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got: torch.Tensor, want, msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=RTOL, atol=ATOL, err_msg=msg)


@pytest.fixture(scope="module")
def jax_params():
    return jax.device_get(jtf.init_params(TINY, jax.random.PRNGKey(0)))


class TestLayers:
    def test_rmsnorm(self):
        x, s = _rand((2, 5, 32), 0), _rand((32,), 1)
        _close(pl_.rmsnorm(torch.from_numpy(x), torch.from_numpy(s)),
               jl.rmsnorm(jnp.asarray(x), jnp.asarray(s)))

    @pytest.mark.parametrize("batched_positions", [False, True])
    def test_apply_rope(self, batched_positions):
        x = _rand((2, 6, 2, 16), 2)
        pos = np.arange(6, dtype=np.int32) + 3
        if batched_positions:
            pos = np.stack([pos, pos * 2])
        _close(pl_.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              10_000.0),
               jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0))

    @pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                               (True, 8)])
    def test_attention_train_chunked(self, causal, window):
        # S=40 with 16-query chunks: three chunks, the last one padded
        q, k, v = (_rand((2, 40, 2, 8), s) for s in (3, 4, 5))
        got = pl_.attention_train(*map(torch.from_numpy, (q, k, v)),
                                  causal=causal, window=window, q_chunk=16)
        want = jl.attention_train(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, q_chunk=16)
        _close(got, want)

    def test_expand_kv_repeats_each_head(self):
        k = _rand((2, 3, 2, 4), 6)
        np.testing.assert_array_equal(
            pl_._expand_kv(torch.from_numpy(k), 4).numpy(),
            np.asarray(jl._expand_kv(jnp.asarray(k), 4)))

    def test_mlp_forward_swiglu(self, jax_params):
        x = _rand((2, 5, 32), 7)
        p = {k: v[0] for k, v in jax_params["blocks"]["mlp"].items()}
        _close(pl_.mlp_forward(torch.from_numpy(x),
                               {k: torch.from_numpy(np.array(v))
                                for k, v in p.items()}, "swiglu"),
               jl.mlp_forward(jnp.asarray(x), p, "swiglu"))


class TestModel:
    def test_leaf_names_and_shapes_match_reference(self, jax_params):
        ours = ptf.init_params(port_arch(TINY), device="cpu")
        theirs = params_from_jax(jax_params)
        assert list(ours) == list(theirs)
        assert [p.shape for p in ours.values()] == \
            [p.shape for p in theirs.values()]
        assert list(theirs) == [
            "/".join(str(k.key) for k in path)
            for path, _ in jax.tree_util.tree_leaves_with_path(jax_params)]

    @pytest.mark.parametrize("seq", [16, 32])
    def test_lm_loss_and_every_gradient_leaf(self, jax_params, seq):
        # seq 32 with loss_chunk 16 takes the chunked cross-entropy path
        rng = np.random.default_rng(seq)
        toks = rng.integers(0, TINY.vocab_size, (2, seq), dtype=np.int32)
        labels = rng.integers(0, TINY.vocab_size, (2, seq), dtype=np.int32)
        loss_j, grads_j = jax.value_and_grad(
            lambda p: jtf.lm_loss(p, TINY, {"tokens": jnp.asarray(toks),
                                            "labels": jnp.asarray(labels)})
        )(jax_params)
        params = {k: v.requires_grad_(True)
                  for k, v in params_from_jax(jax_params).items()}
        loss = ptf.lm_loss(params, port_arch(TINY),
                           {"tokens": torch.from_numpy(toks).long(),
                            "labels": torch.from_numpy(labels).long()})
        grads = torch.autograd.grad(loss, list(params.values()))
        _close(loss, loss_j)
        want = params_from_jax(jax.device_get(grads_j))
        for (name, w), g in zip(want.items(), grads):
            _close(g, w.numpy(), name)

    def test_full_config_param_count_on_meta(self):
        params = ptf.init_params(get_config("qwen2-100m"), device="meta")
        assert all(p.device.type == "meta" for p in params.values())
        assert sum(p.numel() for p in params.values()) == 128_419_584
        assert ptf.param_count(get_config("qwen2-100m")) == 128_419_584

    def test_default_dtype_is_bf16(self):
        assert get_config("qwen2-100m").dtype == torch.bfloat16


class TestWeights:
    def test_round_trip_is_exact(self, jax_params):
        back = params_to_jax(params_from_jax(jax_params))
        for (pa, a), (pb, b) in zip(
                jax.tree_util.tree_leaves_with_path(jax_params),
                jax.tree_util.tree_leaves_with_path(back)):
            assert pa == pb
            np.testing.assert_array_equal(np.asarray(a), b)

    def test_bf16_bits_carry_over(self):
        x = jnp.asarray(_rand((3, 4), 9)).astype(jnp.bfloat16)
        t = params_from_jax({"w": np.asarray(x)})["w"]
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      np.asarray(x).view(np.int16))
        back = params_to_jax({"w": t})["w"]
        np.testing.assert_array_equal(back.view(np.int16),
                                      np.asarray(x).view(np.int16))
