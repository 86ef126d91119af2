"""The port's ablation losses (`ops/losses.py`: clip_mse .. batch_kl_loss)
against the JAX package's on seeded numpy inputs, value and gradient of
every input: rtol 1e-5, atol 1e-6 (f32, the same operations in another
order). Padded rows (`valid` masks, labels -1) and ragged frame masks are
in the inputs. The random ones (`sample_neg_scores`, `frame_trip_loss`)
are compared at hard_pool_size 1, where the draw is deterministic; the
uniform draw is checked against its candidate set and its spread."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.ops import losses as jl
from dldkd_tpu_torch.ops import losses as tl

RTOL, ATOL = 1e-5, 1e-6
NQ, NV, L = 7, 4, 6


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    labels = np.array([0, 0, 1, 2, 3, -1, -1], np.int32)
    vlen = np.array([6, 3, 1, 4])
    vmask = (np.arange(L)[None] < vlen[:, None]).astype(np.float32)
    return {
        "frame_x": rng.randn(NQ, L, NV).astype(np.float32),
        "frame_t": rng.randn(NQ, L, NV).astype(np.float32),
        "scores_x": rng.randn(NQ, NV).astype(np.float32),
        "scores_t": rng.randn(NQ, NV).astype(np.float32),
        "square": rng.randn(5, 5, 3).astype(np.float32),
        "vmask": vmask, "labels": labels,
        "valid": labels >= 0,
    }


def _check(jax_fn, torch_fn, diff, static):
    """Value and gradient of every array in `diff` against JAX;
    `static` are the other (non-differentiated) arguments, numpy."""
    names = list(diff)

    def jf(*xs):
        return jax_fn(**dict(zip(names, xs)),
                      **{k: jnp.asarray(v) if isinstance(v, np.ndarray)
                         else v for k, v in static.items()})

    j_val, j_grads = jax.value_and_grad(jf, argnums=tuple(
        range(len(names))))(*(jnp.asarray(diff[n]) for n in names))
    ts = {n: torch.tensor(diff[n], requires_grad=True) for n in names}
    t_val = torch_fn(**ts, **{k: torch.from_numpy(v)
                              if isinstance(v, np.ndarray) else v
                              for k, v in static.items()})
    t_val.backward()
    np.testing.assert_allclose(float(t_val.detach()), float(j_val),
                               rtol=RTOL, atol=ATOL)
    for n, g in zip(names, j_grads):
        np.testing.assert_allclose(ts[n].grad.numpy(), np.asarray(g),
                                   rtol=RTOL, atol=ATOL, err_msg=n)
    return float(t_val.detach())


@pytest.mark.parametrize("valid", [False, True], ids=["all", "valid"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_clip_mse(valid, ndim):
    d = _inputs()
    x, t = ((d["frame_x"], d["frame_t"]) if ndim == 3
            else (d["scores_x"], d["scores_t"]))
    static = {"valid": d["valid"]} if valid else {}
    _check(jl.clip_mse, tl.clip_mse, {"x": x, "target": t}, static)


@pytest.mark.parametrize("name", ["clip_mse_pos_pair",
                                  "clip_mse_only_pos_max"])
def test_positive_frame_ablations(name):
    d = _inputs(1)
    v = _check(getattr(jl, name), getattr(tl, name),
               {"frame_x": d["frame_x"], "frame_t": d["frame_t"]},
               {"video_mask": d["vmask"], "labels": d["labels"]})
    assert v > 0


def test_clip_mse_max_pos_pair():
    d = _inputs(2)
    _check(jl.clip_mse_max_pos_pair, tl.clip_mse_max_pos_pair,
           {"scores_x": d["scores_x"], "scores_t": d["scores_t"]},
           {"labels": d["labels"]})


def test_only_pos_max_takes_the_first_tie():
    """Teacher ties on the positive's valid frames: the first frame, as
    jnp.argmax takes it."""
    d = _inputs(3)
    d["frame_t"][:, :, :] = 0.5
    _check(jl.clip_mse_only_pos_max, tl.clip_mse_only_pos_max,
           {"frame_x": d["frame_x"], "frame_t": d["frame_t"]},
           {"video_mask": d["vmask"], "labels": d["labels"]})


@pytest.mark.parametrize("valid", [None, np.array([1, 1, 0, 1, 0], bool)],
                         ids=["all", "valid"])
def test_frame_nce(valid):
    d = _inputs(4)
    static = {} if valid is None else {"valid": valid}
    _check(jl.frame_nce, tl.frame_nce, {"scores": d["square"]}, static)
    if valid is not None:
        per = tl.frame_nce(torch.from_numpy(d["square"]), reduction=False,
                           valid=torch.from_numpy(valid))
        ref = jl.frame_nce(jnp.asarray(d["square"]), reduction=False,
                           valid=jnp.asarray(valid))
        np.testing.assert_allclose(per.numpy(), np.asarray(ref), rtol=RTOL,
                                   atol=ATOL)
        assert not per[~torch.from_numpy(valid)].any()


def test_ranking_loss():
    rng = np.random.RandomState(5)
    pos, neg = rng.randn(6).astype(np.float32), rng.randn(6).astype(
        np.float32)
    neg[0] = pos[0] - 0.2       # exactly at the hinge: JAX's tie rule
    _check(jl.ranking_loss, tl.ranking_loss,
           {"pos_score": pos, "neg_score": neg}, {"margin": 0.2})


def test_frame_trip_loss_at_pool_one():
    """With hard negatives from a pool of 1 the negative is rank 1 of the
    masked sort: deterministic in both packages."""
    rng = np.random.RandomState(6)
    scores = rng.randn(5, 5).astype(np.float32)
    jf = (lambda s: jl.frame_trip_loss(s, jax.random.PRNGKey(0), 0.3, True,
                                       1))
    j_val, j_grad = jax.value_and_grad(jf)(jnp.asarray(scores))
    s = torch.tensor(scores, requires_grad=True)
    v = tl.frame_trip_loss(s, torch.Generator().manual_seed(0), 0.3, True, 1)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(j_val), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(s.grad.numpy(), np.asarray(j_grad),
                               rtol=RTOL, atol=ATOL)


def test_sample_neg_scores_at_pool_one_matches_jax():
    rng = np.random.RandomState(7)
    scores = rng.randn(6, 5).astype(np.float32)
    masked = scores.copy()
    masked[np.arange(5), np.arange(5)] = 999.0
    ref = jl.sample_neg_scores(jnp.asarray(scores), jnp.asarray(masked),
                               jax.random.PRNGKey(1), True, 1)
    out = tl.sample_neg_scores(torch.from_numpy(scores),
                               torch.from_numpy(masked),
                               torch.Generator().manual_seed(1), True, 1)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("hard,pool", [(False, 0), (True, 3)])
def test_uniform_negative_draws(hard, pool):
    """The draw is uniform over ranks [1, max_idx) of the masked
    descending sort: every draw is one of those scores, and over 4,000
    draws each is taken 1/(max_idx - 1) of the time within 0.03."""
    rng = np.random.RandomState(8)
    n = 6
    scores = rng.randn(n, n).astype(np.float32)
    masked = scores.copy()
    masked[np.arange(n), np.arange(n)] = 999.0
    k = min(1 + pool, n) if hard else n
    order = np.argsort(-masked, axis=1, kind="stable")[:, 1:k]
    cands = np.take_along_axis(scores, order, axis=1)
    gen = torch.Generator().manual_seed(2)
    draws = np.stack([tl.sample_neg_scores(
        torch.from_numpy(scores), torch.from_numpy(masked), gen, hard,
        pool).numpy() for _ in range(4000)])
    for row in range(n):
        freq = np.array([np.mean(draws[:, row] == c) for c in cands[row]])
        assert abs(freq.sum() - 1.0) < 1e-9
        np.testing.assert_allclose(freq, 1.0 / (k - 1), atol=0.03)


def test_sample_neg_scores_one_column_is_nan():
    s = torch.randn(3, 1)
    assert torch.isnan(tl.sample_neg_scores(s, s, torch.Generator(), True,
                                            4)).all()


@pytest.mark.parametrize("padded", [False, True])
def test_batch_kl_loss(padded):
    d = _inputs(9)
    static = {"temperature": 0.5}
    if padded:
        static["valid_q"] = d["valid"]
    v = _check(jl.batch_kl_loss, tl.batch_kl_loss,
               {"predict": d["scores_x"], "target": d["scores_t"]}, static)
    assert v > 0
    same = tl.batch_kl_loss(torch.from_numpy(d["scores_t"]),
                            torch.from_numpy(d["scores_t"]), 0.5)
    assert abs(float(same)) < 1e-6
