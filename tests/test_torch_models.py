"""The port's BERT + ColBERT head against the Flax model, and checkpoint conversion.

Both models get the same parameters (the Flax init, converted with
``state_dict_from_jax_params``) and the same seeded token ids.
Tolerances: at fp32 the two differ only by operation order (max |delta| <
1e-4); at bf16 they round at different places, so the check is per-token
cosine > 0.99.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colbert_tpu.config import ModelConfig, MultiviewConfig
from colbert_tpu.models import ColbertModel as FlaxColbert
from colbert_tpu.models.convert import colbert_params_to_torch_state_dict
from colbert_tpu_torch.models.colbert import ColbertModel
from colbert_tpu_torch.models.convert import (
    reference_state_dict, state_dict_from_jax_params, state_dict_from_reference,
)

CFG = ModelConfig(vocab_size=300, hidden_size=64, num_layers=2, num_heads=4,
                  intermediate_size=128, max_position_embeddings=64, dim=32, dtype="float32")
MV = MultiviewConfig(enabled=True, q_view=8, d_view=8)


def _inputs(seed, B, L):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, CFG.vocab_size, size=(B, L)).astype(np.int32)
    attn = np.ones((B, L), np.int32)
    for b in range(B):
        attn[b, rng.integers(L // 2, L + 1):] = 0
    ids[attn == 0] = 0
    return ids, attn


@pytest.fixture(scope="module")
def flax_params():
    model = FlaxColbert(CFG, MV)
    ids = jnp.zeros((1, 16), jnp.int32)
    params = model.init(jax.random.PRNGKey(3), ids, jnp.ones_like(ids), ids, jnp.ones_like(ids))["params"]
    # non-trivial LayerNorm and bias parameters, so the conversion of each is checked
    rng = np.random.default_rng(11)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.05, size=a.shape).astype(np.float32), params
    )


def _port(params, cfg):
    m = ColbertModel(cfg, MV)
    m.load_state_dict(state_dict_from_jax_params(params, cfg))
    return m.eval()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side,L", [("query", 16), ("doc", 24)])
def test_colbert_matches_flax(flax_params, dtype, side, L):
    cfg = dataclasses.replace(CFG, dtype=dtype)
    ids, attn = _inputs(5, 3, L)
    fm = FlaxColbert(cfg, MV)
    want = np.asarray(
        fm.apply({"params": flax_params}, jnp.asarray(ids), jnp.asarray(attn), method=getattr(fm, side))
    )
    with torch.no_grad():
        got = getattr(_port(flax_params, cfg), side)(torch.from_numpy(ids), torch.from_numpy(attn)).numpy()
    assert got.shape == want.shape == (3, 8, 32) and got.dtype == np.float32
    if dtype == "float32":
        assert np.abs(got - want).max() < 1e-4
    else:
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() > 0.99


def test_reference_checkpoint_round_trip(flax_params, tmp_path):
    """JAX params -> reference pytorch.bin -> port: the same weights and outputs."""
    ref_sd = {k: torch.from_numpy(np.ascontiguousarray(v))
              for k, v in colbert_params_to_torch_state_dict(flax_params, CFG).items()}
    path = tmp_path / "pytorch.bin"
    torch.save(ref_sd, path)
    from_ref = state_dict_from_reference(str(path), CFG)
    from_jax = state_dict_from_jax_params(flax_params, CFG)
    assert from_ref.keys() == from_jax.keys() == ColbertModel(CFG, MV).state_dict().keys()
    for k in from_jax:
        torch.testing.assert_close(from_ref[k], from_jax[k], rtol=0, atol=0)
    # and back: the port writes the layout it reads
    back = reference_state_dict(from_ref, CFG)
    assert back.keys() == ref_sd.keys()
    for k in back:
        torch.testing.assert_close(back[k], ref_sd[k], rtol=0, atol=0)


def test_reference_loader_names_missing_keys():
    with pytest.raises(KeyError, match="colbert_params_to_torch_state_dict"):
        state_dict_from_reference({"linear.weight": torch.zeros(32, 64)}, CFG)


def test_seeded_init_is_reproducible():
    a, b = ColbertModel(CFG, MV), ColbertModel(CFG, MV)
    a.init_weights(torch.Generator().manual_seed(0))
    b.init_weights(torch.Generator().manual_seed(0))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert float(a.bert.layers[0].attention.query.weight.detach().std()) == pytest.approx(0.02, rel=0.1)
