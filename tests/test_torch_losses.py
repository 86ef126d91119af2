"""The port's training losses (`dldkd_tpu_torch/ops/losses.py`) against the
JAX package's, value and gradient (`jax.grad` against autograd), on a
batch of 12 query rows (10 valid, 2 padded), 5 videos and 7 frames with
ragged frame masks. The deterministic samplers (hard negatives with a
pool of 1) are held exactly; the uniform sampler by a chi-square test of
its draws. Tolerance: 1e-5 relative (f32, the same operations, sums taken
in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.ops import losses as jl
from dldkd_tpu.ops.masking import mask_logits as jax_mask_logits
from dldkd_tpu_torch.ops import losses as tl

RTOL, ATOL = 1e-5, 1e-6
NQ, NV, L = 12, 5, 7


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    # 2 captions per video, video-major; the last two rows are padding
    labels = np.array([0, 0, 1, 1, 2, 2, 3, 3, 4, 4, -1, -1], np.int32)
    scores = rng.uniform(-1, 1, (NQ, NV)).astype(np.float32)
    sims = rng.uniform(-1, 1, (NQ, NV)).astype(np.float32)
    raw = (3 * rng.randn(NQ, NV)).astype(np.float32)
    lengths = np.array([7, 3, 5, 1, 6])
    vmask = (np.arange(L)[None] < lengths[:, None]).astype(np.float32)
    frames = [np.asarray(jax_mask_logits(
        rng.uniform(-1, 1, (NQ, L, NV)).astype(np.float32),
        vmask.T[None])) for _ in range(2)]
    return dict(labels=labels, scores=scores, sims=sims, raw=raw,
                vmask=vmask, student=frames[0], teacher=frames[1])


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


def _check(jax_fn, torch_fn, args, wrt):
    """Value and gradients w.r.t. the args named in `wrt`."""
    j_val, j_grads = jax.value_and_grad(
        lambda *xs: jax_fn(**dict(args, **dict(zip(wrt, xs)))),
        argnums=tuple(range(len(wrt))))(*(jnp.asarray(args[k]) for k in wrt))
    t_args = {k: _t(v, k in wrt) if isinstance(v, np.ndarray) else v
              for k, v in args.items()}
    t_val = torch_fn(**t_args)
    t_grads = torch.autograd.grad(t_val, [t_args[k] for k in wrt])
    _close(t_val.detach(), j_val)
    for k, a, b in zip(wrt, t_grads, j_grads):
        _close(a, b)
    return float(t_val.detach())


def test_one_hot_and_masked_logsumexp(batch):
    _close(tl._one_hot_labels(_t(batch["labels"]), NV),
           jl._one_hot_labels(jnp.asarray(batch["labels"]), NV))
    mask = batch["raw"] > 0
    _close(tl._masked_logsumexp(_t(batch["raw"]), _t(mask), 1),
           jl._masked_logsumexp(jnp.asarray(batch["raw"]), mask, 1))


@pytest.mark.parametrize("pool", [1, 20])
def test_hard_triplet_pool_1_matches_jax(batch, pool):
    """Hard negatives: v2t takes the top negative; t2v a rank in
    [1, min(1 + pool, Nv)) -- with pool 1 only rank 1, so deterministic.
    Pool 20 checks the v2t half only (t2v margin made unreachable)."""
    margin = 0.1 if pool == 1 else -10.0
    args = dict(scores=batch["scores"], labels=batch["labels"],
                margin=margin, use_hard_negative=True, hard_pool_size=pool)
    val = _check(
        lambda **a: jl.clip_triplet_loss(key=jax.random.PRNGKey(0), **a),
        lambda **a: tl.clip_triplet_loss(
            generator=torch.Generator().manual_seed(0), **a),
        args, ["scores"])
    assert val > 0 or pool == 20


def test_hard_triplet_single_video_batch_matches_jax():
    """A one-video batch has no rank-1 negative: both packages give NaN
    for the loss and no gradient."""
    scores = np.array([[0.3], [0.2], [0.1]], np.float32)
    labels = np.array([0, 0, -1], np.int32)
    j_val, j_grad = jax.value_and_grad(lambda s: jl.clip_triplet_loss(
        s, jnp.asarray(labels), jax.random.PRNGKey(0), 0.1, True, 1))(
            jnp.asarray(scores))
    s = _t(scores, True)
    t_val = tl.clip_triplet_loss(s, _t(labels), torch.Generator(), 0.1,
                                 True, 1)
    (t_grad,) = torch.autograd.grad(t_val, [s])
    assert np.isnan(float(j_val)) and torch.isnan(t_val)
    _close(t_grad, j_grad)


def test_uniform_triplet_is_finite_with_gradient(batch):
    s = _t(batch["scores"], True)
    val = tl.clip_triplet_loss(s, _t(batch["labels"]),
                               torch.Generator().manual_seed(1), 0.2,
                               False, 20)
    (g,) = torch.autograd.grad(val, [s])
    assert torch.isfinite(val) and torch.isfinite(g).all()
    assert (g[10:] == 0).all()   # padded queries count nowhere


def test_uniform_choice_is_uniform_over_candidates():
    """20,000 draws from a fixed generator over 4 candidates of 6:
    chi-square below the p = 0.001 critical value for 3 degrees of
    freedom (16.27); masked positions never drawn."""
    n = 20000
    mask = torch.tensor([True, False, True, True, False, True]).expand(n, 6)
    values = torch.arange(6, dtype=torch.float32).expand(n, 6)
    picks = tl._uniform_choice(torch.Generator().manual_seed(1234), mask,
                               values).long()
    counts = torch.bincount(picks, minlength=6).double()
    assert counts[1] == 0 and counts[4] == 0
    observed = counts[[0, 2, 3, 5]]
    chi2 = float(((observed - n / 4) ** 2 / (n / 4)).sum())
    assert chi2 < 16.27, (counts, chi2)


def test_clip_nce_matches_jax(batch):
    _check(jl.clip_nce, tl.clip_nce,
           dict(scores=batch["raw"], labels=batch["labels"]), ["scores"])


# alpha 0 and 1 put the whole batch in one part; 0.7 splits the 10 valid
# queries at 7; the linear decay's 0.19999999999999996 splits the 5 videos
# at floor(f32(alpha) * 5) = 1 in float32 (0 in float64)
@pytest.mark.parametrize("alpha,belta", [(0.0, 0.8), (1.0, 0.8),
                                         (0.7, 0.55),
                                         (0.19999999999999996, 0.3)])
@pytest.mark.parametrize("self_target", [False, True])
def test_clip_nce_soft_matches_jax(batch, alpha, belta, self_target):
    a32, b32 = np.float32(alpha), np.float32(belta)
    args = dict(scores=batch["raw"], labels=batch["labels"],
                alpha=a32, belta=b32)
    if self_target:
        # self-distillation: the gradient flows through the soft target
        _check(lambda scores, **a: jl.clip_nce_soft(scores, scores, **a),
               lambda scores, **a: tl.clip_nce_soft(scores, scores, **a),
               args, ["scores"])
    else:
        args["sims"] = batch["sims"]
        _check(jl.clip_nce_soft, tl.clip_nce_soft, args, ["scores", "sims"])


def test_alpha_partition_is_float32():
    """hard_count against the JAX package's expression (losses.py:161)
    for every alpha the four decay families give over epochs 0-120 and
    every n up to 128; at some of them a float64 floor splits otherwise."""
    from dldkd_tpu_torch.optim import schedules

    alphas = np.array([schedules.alpha_schedule(d, e, 0.8, 120, 0.95, 800)
                       for d in ("sigmoid", "exp", "linear", "cosine")
                       for e in range(121)], np.float32)
    n = np.arange(1, 129, dtype=np.int32)
    ours = tl.hard_count(torch.tensor(alphas)[:, None],
                         torch.tensor(n, dtype=torch.long)[None])
    theirs = jnp.floor(jnp.asarray(alphas)[:, None]
                       * jnp.asarray(n)[None]).astype(jnp.int32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(theirs))
    f64 = np.floor(alphas.astype(np.float64)[:, None] * n[None])
    assert (f64 != ours.numpy()).any()


def test_frame_kl_matches_jax(batch):
    _check(jl.frame_kl_loss, tl.frame_kl_loss,
           dict(student_frame=batch["student"],
                teacher_frame=batch["teacher"], video_mask=batch["vmask"],
                labels=batch["labels"], temperature=0.2),
           ["student_frame", "teacher_frame"])
