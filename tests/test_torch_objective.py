"""The port's training objective (`models/objective.py:compute_losses`)
against the JAX package's on a tiny model: the loss dict and the whole
gradient tree (carried to the port's names by the converter), for hard and
soft labels and one and two branches, with dropout 0 and hard negatives
from a pool of 1 (deterministic in both packages). Tolerance: 1e-5
relative and 1e-7 absolute, for the gradients 1e-5 of each tensor's
largest entry if that is larger (f32; the same operations, sums in another
order, which leaves a few 1e-7 on entries near zero; the attention keys'
bias has a zero gradient, rounding noise of ~3e-9 in both packages).
Also: the training forward's dropout (keep rate 1 - p, scaling 1 / (1 - p),
masks from the generator only) and the settings that raise (stacked
towers without two branches of one hidden size).

The JAX parameters are made with numpy on the shapes `jax.eval_shape`
gives, and each JAX configuration is compiled once (`jax.jit`)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.config import TrainConfig as JaxTrainConfig
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.models import objective as jax_objective
from dldkd_tpu_torch.config import ModelConfig, TrainConfig
from dldkd_tpu_torch.convert import load_jax_params, state_dict_from_jax
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.models.components import Dropout
from dldkd_tpu_torch.models.objective import LossScalars, compute_losses

RTOL, ATOL = 1e-5, 1e-7
DIMS = dict(visual_input_size=20, query_input_size=14, inheritance_hidden=16,
            exploration_hidden=16, max_ctx_l=16, max_desc_l=7, n_heads=2,
            input_drop=0.0, drop=0.0, margin=0.1, use_hard_negative=True,
            hard_pool_size=1)
SCALARS = (0.9, 0.7, 0.6)   # kd_weight, alpha, belta


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    precision = torch.get_float32_matmul_precision()
    torch.set_num_threads(1)
    torch.set_float32_matmul_precision("highest")
    yield
    torch.set_num_threads(threads)
    torch.set_float32_matmul_precision(precision)


def _jax_params(cfg: JaxModelConfig, seed: int = 0):
    """Every leaf random (kernels and positions normal x 0.2, LayerNorm
    scales 1 + normal x 0.1, biases normal x 0.05), on eval_shape's
    shapes."""
    video = jnp.zeros((1, cfg.max_ctx_l, cfg.visual_input_size))
    text = jnp.zeros((1, cfg.max_desc_l, cfg.query_input_size))
    shapes = jax.eval_shape(
        JaxDLDKD(config=cfg).init, jax.random.PRNGKey(0), video,
        jnp.ones(video.shape[:2]), text, jnp.ones(text.shape[:2]))
    rng = np.random.RandomState(seed)
    paths, tree = jax.tree_util.tree_flatten_with_path(shapes)

    def leaf(path, sd):
        name = str(getattr(path[-1], "key", path[-1]))
        x = rng.randn(*sd.shape)
        x = (1.0 + 0.1 * x if name == "scale" else
             0.05 * x if name == "bias" else 0.2 * x)
        return np.asarray(x, np.float32)

    return jax.tree_util.tree_unflatten(tree, [leaf(p, sd)
                                               for p, sd in paths])


def make_batch(seed: int = 1, caps=(4, 3, 2, 1), q_pad: int = 16):
    """A loader-shaped batch: videos sorted by caption count, captions
    video-major, the query axis padded with label -1, ragged masks."""
    rng = np.random.RandomState(seed)
    nv, l, lq = len(caps), DIMS["max_ctx_l"], DIMS["max_desc_l"]

    def unit(*shape):
        x = rng.randn(*shape).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    vlen = rng.randint(3, l + 1, nv)
    vmask = (np.arange(l)[None] < vlen[:, None]).astype(np.float32)
    labels = np.full(q_pad, -1, np.int32)
    labels[:sum(caps)] = np.repeat(np.arange(nv), caps)
    n_q = sum(caps)
    qlen = rng.randint(2, lq + 1, q_pad)
    tmask = (np.arange(lq)[None] < qlen[:, None]).astype(np.float32)
    tmask[n_q:] = 0
    text = unit(q_pad, lq, DIMS["query_input_size"]) * tmask[..., None]
    t_text = rng.randn(q_pad, 10).astype(np.float32)
    t_text[n_q:] = 0
    return {
        "student_videos": unit(nv, l, DIMS["visual_input_size"])
        * vmask[..., None],
        "student_videos_mask": vmask,
        "teacher_videos": (rng.randn(nv, l, 10) * vmask[..., None]
                           ).astype(np.float32),
        "student_text": text, "student_text_mask": tmask,
        "teacher_text": t_text, "text_labels": labels,
    }


def _cfgs(label_style: str, double: bool):
    jm = JaxModelConfig(label_style=label_style, double_branch=double,
                        **DIMS)
    pm = ModelConfig(label_style=label_style, double_branch=double, **DIMS)
    return jm, JaxTrainConfig(), pm, TrainConfig()


@pytest.mark.parametrize("label_style", ["soft", "hard"])
@pytest.mark.parametrize("double", [True, False])
def test_compute_losses_matches_jax(label_style, double):
    jm, jt, pm, pt = _cfgs(label_style, double)
    params = _jax_params(jm)
    batch = make_batch()
    jmodel = JaxDLDKD(config=jm)
    scal = jax_objective.LossScalars(*(jnp.float32(v) for v in SCALARS))

    @jax.jit
    def jax_loss(p):
        return jax_objective.compute_losses(
            jmodel, p, {k: jnp.asarray(v) for k, v in batch.items()},
            jax.random.PRNGKey(0), jm, jt, scal, train=True)

    (j_loss, j_dict), j_grads = jax.value_and_grad(jax_loss, has_aux=True)(
        jax.tree.map(jnp.asarray, params))

    model = load_jax_params(DLDKD(pm), params).train()
    loss, loss_dict = compute_losses(
        model, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0), pm, pt,
        LossScalars(*(torch.tensor(v, dtype=torch.float32)
                      for v in SCALARS)))
    loss.backward()

    assert set(loss_dict) == set(j_dict)
    for k in j_dict:
        np.testing.assert_allclose(float(loss_dict[k].detach()),
                                   float(j_dict[k]),
                                   rtol=RTOL, atol=ATOL, err_msg=k)
    assert float(loss_dict["inher_trip"].detach()) > 0
    if double:
        assert float(loss_dict["explore_nce"].detach()) > 0
    theirs = state_dict_from_jax(jax.tree.map(np.asarray, j_grads))
    named = dict(model.named_parameters())
    assert set(named) == set(theirs)
    for name, p in named.items():
        assert p.grad is not None, name
        ref = theirs[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), ref, rtol=RTOL,
                                   atol=max(ATOL, RTOL * float(
                                       np.abs(ref).max())),
                                   err_msg=name)


def test_dropout_keep_rate_and_scale():
    drop = Dropout(0.3).train()
    x = torch.ones(200_000)
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.005
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert torch.equal(drop.eval()(x), x)
    with pytest.raises(ValueError, match="generator"):
        drop.train()(x)


def test_training_forward_masks_come_from_the_generator():
    """The same generator state gives the same masks (and outputs), on a
    model with dropout on; another seed gives other masks; eval mode
    gives the deterministic forward, whatever the generator."""
    jm, _, pm, _ = _cfgs("soft", True)
    pm = dataclasses.replace(pm, input_drop=0.2, drop=0.2)
    model = load_jax_params(DLDKD(pm), _jax_params(jm)).train()
    b = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    args = (b["student_videos"], b["student_videos_mask"],
            b["student_text"], b["student_text_mask"])

    def run(seed):
        torch.manual_seed(seed + 100)   # the global RNG must not matter
        (ci, ce), (qi, qe) = model(*args,
                                   generator=torch.Generator().manual_seed(seed))
        return torch.cat([ci.flatten(), ce.flatten(), qi.flatten(),
                          qe.flatten()])

    a, a2, other = run(3), run(3), run(4)
    assert torch.equal(a, a2)
    assert not torch.allclose(a, other)
    model.eval()
    det = run(3)
    assert torch.equal(det, run(4))
    assert not torch.allclose(det, a)


@pytest.mark.parametrize("change,match", [
    (dict(train=dict(stacked_towers=True), model=dict(double_branch=False)),
     "stacked"),
    (dict(train=dict(stacked_towers=True),
          model=dict(dtype="bfloat16", exploration_hidden=32)), "stacked"),
])
def test_untrainable_settings_raise(change, match):
    """Stacked towers need two branches of one hidden size; bf16 and
    stacked training otherwise run (tests/test_torch_stacked.py,
    tests/test_torch_bf16_train.py)."""
    _, _, pm, pt = _cfgs("soft", True)
    pm = dataclasses.replace(pm, **change.get("model", {}))
    pt = dataclasses.replace(pt, **change.get("train", {}))
    model = DLDKD(pm)
    b = {k: torch.from_numpy(v) for k, v in make_batch().items()}
    with pytest.raises(ValueError, match=match):
        compute_losses(model, b, torch.Generator(), pm, pt,
                       LossScalars(*(torch.tensor(v) for v in SCALARS)))
