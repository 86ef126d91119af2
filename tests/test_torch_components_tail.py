"""The port's blocks that the DLDKD towers do not use, against the JAX
package on the CPU: `FeedForward` and `TransformerBlock` (with and without
self-attention), `RNNEncoder` (lstm / gru / rnn, one or two directions,
one or two layers, ragged lengths, a zero-length row with and without
`allow_zero`), `pool_across_time`, and the numpy sequence helpers.

Weights are random numpy arrays on the shapes `jax.eval_shape` gives,
carried to the port by its converter (`convert.*_state_from_jax`).
Tolerance: atol 1e-5 (f32, the same operations in another order); the
sequence helpers bitwise (the same numpy code)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.models.components import FeedForward as JaxFeedForward
from dldkd_tpu.models.components import \
    TransformerBlock as JaxTransformerBlock
from dldkd_tpu.models.rnn import RNNEncoder as JaxRNNEncoder
from dldkd_tpu.models.rnn import pool_across_time as jax_pool
from dldkd_tpu.utils import sequences as jax_seq
from dldkd_tpu_torch.convert import (feed_forward_state_from_jax,
                                     rnn_state_from_jax,
                                     transformer_block_state_from_jax)
from dldkd_tpu_torch.models.components import FeedForward, TransformerBlock
from dldkd_tpu_torch.models.rnn import RNNEncoder, pool_across_time
from dldkd_tpu_torch.utils import sequences

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _params(module, *args, seed=0):
    """Random numpy leaves (LayerNorm scales near 1) on eval_shape's
    shapes of module.init(*args)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    rng = np.random.RandomState(seed)
    paths, tree = jax.tree_util.tree_flatten_with_path(shapes)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.randn(*sd.shape)
        return np.asarray(1.0 + 0.1 * x if name == "scale" else 0.3 * x,
                          np.float32)

    return jax.tree_util.tree_unflatten(tree, [leaf(p, sd)
                                               for p, sd in paths])


def _mask(rng, b, l):
    lens = rng.randint(1, l + 1, b)
    return (np.arange(l)[None] < lens[:, None]).astype(np.float32)


def test_feed_forward_matches_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 5, 8).astype(np.float32)
    jm = JaxFeedForward(hidden=8, intermediate=12, dropout=0.1)
    params = _params(jm, jnp.asarray(x))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    mod = FeedForward(8, 12, 0.1).eval()
    mod.load_state_dict(feed_forward_state_from_jax(params["params"]),
                        strict=True)
    with torch.no_grad():
        out = mod(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("attn", [True, False], ids=["attention", "ffn"])
def test_transformer_block_matches_jax(attn):
    rng = np.random.RandomState(2)
    x = rng.randn(3, 6, 8).astype(np.float32)
    mask = _mask(rng, 3, 6)
    jm = JaxTransformerBlock(hidden=8, intermediate=12, n_heads=2,
                             attn_dropout=0.1, hidden_dropout=0.1,
                             use_self_attention=attn)
    params = _params(jm, jnp.asarray(x), jnp.asarray(mask))
    ref = jax.jit(jm.apply)(params, jnp.asarray(x), jnp.asarray(mask))
    mod = TransformerBlock(8, 12, 2, 0.1, 0.1, use_self_attention=attn)
    mod.load_state_dict(
        transformer_block_state_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        out = mod.eval()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    assert (mod.attention is not None) == attn


def test_transformer_block_dropout_draws_from_the_generator():
    mod = TransformerBlock(8, 12, 2, 0.3, 0.3).train()
    x = torch.randn(2, 5, 8, generator=torch.Generator().manual_seed(0))

    def run(seed):
        torch.manual_seed(seed + 50)
        return mod(x, None, torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.allclose(run(1), run(2))


@pytest.mark.parametrize("rnn_type", ["lstm", "gru", "rnn"])
@pytest.mark.parametrize("bidirectional", [False, True], ids=["uni", "bi"])
@pytest.mark.parametrize("n_layers", [1, 2])
def test_rnn_encoder_matches_jax(rnn_type, bidirectional, n_layers):
    rng = np.random.RandomState(3)
    x = rng.randn(4, 7, 5).astype(np.float32)
    lengths = np.array([7, 3, 5, 1], np.int32)
    jm = JaxRNNEncoder(hidden_size=6, bidirectional=bidirectional,
                       n_layers=n_layers, rnn_type=rnn_type,
                       dropout_p=0.2)
    params = _params(jm, jnp.asarray(x), jnp.asarray(lengths))
    ref_out, ref_h = jax.jit(jm.apply)(params, jnp.asarray(x),
                                       jnp.asarray(lengths))
    mod = RNNEncoder(5, 6, bidirectional=bidirectional, n_layers=n_layers,
                     rnn_type=rnn_type, dropout_p=0.2).eval()
    mod.load_state_dict(rnn_state_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        out, h = mod(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL,
                               rtol=0)
    assert out.shape == (4, 7, 6 * (2 if bidirectional else 1))
    assert not out[1, 3:].any()


@pytest.mark.parametrize("allow_zero", [False, True])
def test_rnn_encoder_zero_length_row(allow_zero):
    rng = np.random.RandomState(4)
    x = rng.randn(3, 5, 4).astype(np.float32)
    lengths = np.array([5, 0, 2], np.int32)
    jm = JaxRNNEncoder(hidden_size=3, n_layers=2, allow_zero=allow_zero)
    params = _params(jm, jnp.asarray(x), jnp.asarray(lengths))
    ref_out, ref_h = jm.apply(params, jnp.asarray(x), jnp.asarray(lengths))
    mod = RNNEncoder(4, 3, n_layers=2, allow_zero=allow_zero).eval()
    mod.load_state_dict(rnn_state_from_jax(params["params"]), strict=True)
    with torch.no_grad():
        out, h = mod(torch.from_numpy(x), torch.from_numpy(lengths))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), atol=ATOL,
                               rtol=0)
    assert bool(out[1].any()) == allow_zero


def test_rnn_encoder_return_flags_and_type():
    x, lengths = torch.randn(2, 4, 3), torch.tensor([4, 2])
    out, h = RNNEncoder(3, 2, return_hidden=False)(x, lengths)
    assert out.shape == (2, 4, 4) and h is None
    out, h = RNNEncoder(3, 2, return_outputs=False)(x, lengths)
    assert out is None and h.shape == (2, 4)
    with pytest.raises(ValueError, match="rnn_type"):
        RNNEncoder(3, 2, rnn_type="transformer")


@pytest.mark.parametrize("pool_type", ["max", "mean"])
def test_pool_across_time_matches_jax(pool_type):
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6, 3).astype(np.float32)
    lengths = np.array([6, 2, 0, 4], np.int32)
    ref = np.asarray(jax_pool(jnp.asarray(x), jnp.asarray(lengths),
                              pool_type))
    out = pool_across_time(torch.from_numpy(x), torch.from_numpy(lengths),
                           pool_type).numpy()
    np.testing.assert_allclose(out, ref, atol=ATOL, rtol=0)
    if pool_type == "max":
        assert np.all(out[2] == -np.inf)
    else:
        assert np.all(np.isnan(out[2]))
    with pytest.raises(NotImplementedError):
        pool_across_time(torch.from_numpy(x), torch.from_numpy(lengths),
                         "sum")


def test_sequence_padding_matches_jax():
    rng = np.random.RandomState(6)
    seqs = [rng.randn(n, 3) for n in (4, 1, 6)]
    for kw in ({}, {"fixed_length": 8}, {"dtype": np.int64}):
        for a, b in zip(sequences.pad_sequences_1d(seqs, **kw),
                        jax_seq.pad_sequences_1d(seqs, **kw)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="fixed_length"):
        sequences.pad_sequences_1d(seqs, fixed_length=5)
    nested = [[rng.randn(n, 2) for n in (3, 1)], [rng.randn(5, 2)]]
    for a, b in zip(sequences.pad_sequences_2d(nested),
                    jax_seq.pad_sequences_2d(nested)):
        np.testing.assert_array_equal(a, b)


def test_span_search_matches_jax():
    rng = np.random.RandomState(7)
    st, ed = rng.rand(3, 9), rng.rand(3, 9)
    arr = rng.rand(5, 6)
    np.testing.assert_array_equal(sequences.top_n_array_2d(arr, 4),
                                  jax_seq.top_n_array_2d(arr, 4))
    for thd in (None, 0.3):
        ours = sequences.find_max_triples(st, ed, top_n=4, prob_thd=thd)
        theirs = jax_seq.find_max_triples(st, ed, top_n=4, prob_thd=thd)
        assert len(ours) == len(theirs) == 3
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)
        assert all(np.all(t[:, 0] < t[:, 1]) for t in ours)
