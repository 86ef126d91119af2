"""The port's optimizer toolkit (`dldkd_tpu_torch/optim/`) against the JAX
package's: a 5-step BertAdam trajectory (parameters after each step within
1e-6; the moments within 1e-5 of each tensor's scale, and the step count,
through the converter), the
weight-decay mask name for name, every LR schedule over 121 steps and
every decay family over epochs 0-120, and the EMA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.optim.bert_adam import bert_adam as jax_bert_adam_fn
from dldkd_tpu.optim import default_wd_mask as jax_wd_mask
from dldkd_tpu.optim import ema as jax_ema
from dldkd_tpu.optim import schedules as jax_sched
from dldkd_tpu_torch.config import ModelConfig
from dldkd_tpu_torch.convert import (load_jax_params, opt_state_from_jax,
                                     opt_state_to_jax, state_dict_from_jax,
                                     wd_mask_from_jax)
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.optim import (BertAdam, default_wd_mask, ema_init,
                                   ema_swap, ema_update, schedules)

DIMS = dict(visual_input_size=12, query_input_size=10, inheritance_hidden=8,
            exploration_hidden=8, max_ctx_l=6, max_desc_l=5, n_heads=2,
            double_branch=True)


@pytest.fixture(autouse=True, scope="module")
def _torch_numerics():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def params():
    cfg = JaxModelConfig(**DIMS)
    video = jnp.zeros((1, cfg.max_ctx_l, cfg.visual_input_size))
    text = jnp.zeros((1, cfg.max_desc_l, cfg.query_input_size))
    from dldkd_tpu.models import DLDKD as JaxDLDKD
    shapes = jax.eval_shape(
        JaxDLDKD(config=cfg).init, jax.random.PRNGKey(0), video,
        jnp.ones(video.shape[:2]), text, jnp.ones(text.shape[:2]))
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda sd: (0.3 * rng.randn(*sd.shape)).astype(np.float32), shapes)


def test_wd_mask_name_for_name(params):
    model = DLDKD(ModelConfig(**DIMS))
    ours = default_wd_mask(dict(model.named_parameters()))
    theirs = wd_mask_from_jax(jax.tree.map(np.asarray, jax_wd_mask(params)))
    assert ours == theirs
    assert not ours["query_input_proj.LayerNorm.weight"]
    assert not ours["exp_visual_encoder.output.dense.bias"]
    assert ours["exp_visual_encoder.output.dense.weight"]
    assert ours["query_pos_embed.position_embeddings.weight"]
    # per branch: 2 position tables, 2 input projections, 8 attention
    # kernels, the pooling head and the output mapping
    assert sum(ours.values()) == 2 * 14


def test_bert_adam_five_steps_match_jax(params):
    """Warmup-linear over 8 steps at warmup 0.25 (multipliers 0, 0.5, 1,
    0.83, 0.67), gradients large enough that the per-tensor clip to norm 1
    acts, weight decay masked; parameters after every step, then the
    moments and the step count through the converter, within 1e-6."""
    lr, wd = 0.05, 0.01
    sched = jax_sched.make_lr_schedule("warmup_linear", 0.25, 8.0)
    opt = jax_bert_adam_fn(lr, sched, weight_decay=wd,
                           wd_mask=jax_wd_mask(params))
    jp = jax.tree.map(jnp.asarray, params)
    state = opt.init(jp)

    model = load_jax_params(DLDKD(ModelConfig(**DIMS)), params)
    named = dict(model.named_parameters())
    ours = BertAdam(named, lr, schedules.make_lr_schedule(
        "warmup_linear", 0.25, 8.0), weight_decay=wd,
        wd_mask=default_wd_mask(named))

    rng = np.random.RandomState(1)
    for step in range(5):
        grads = jax.tree.map(
            lambda p: (3 * rng.randn(*p.shape)).astype(np.float32), params)
        updates, state = opt.update(jax.tree.map(jnp.asarray, grads), state,
                                    jp)
        jp = jax.tree.map(lambda p, u: p + u, jp, updates)
        g_named = state_dict_from_jax(grads)
        ours.step([g_named[n] for n in named])
        theirs = state_dict_from_jax(jax.tree.map(np.asarray, jp))
        for n, p in named.items():
            np.testing.assert_allclose(p.detach().numpy(), theirs[n].numpy(),
                                       rtol=0, atol=1e-6,
                                       err_msg=f"step {step}: {n}")
    # the moments within 1e-5 of each tensor's largest entry (the clip
    # coefficient and the moment updates round once more or less where
    # XLA fuses them, and m cancels toward 0 in places)
    theirs = opt_state_from_jax(jax.tree.map(np.asarray, state._asdict()))
    assert theirs["step"] == ours.state_dict()["step"] == 5
    for key in ("m", "v"):
        for n, t in ours.state_dict()[key].items():
            ref = theirs[key][n].numpy()
            np.testing.assert_allclose(t.numpy(), ref, rtol=1e-5,
                                       atol=1e-5 * float(np.abs(ref).max()),
                                       err_msg=n)
    # and the port's state survives the trip through the JAX layout
    back = opt_state_from_jax(opt_state_to_jax(ours.state_dict()))
    assert back["step"] == 5
    for key in ("m", "v"):
        for n, t in ours.state_dict()[key].items():
            assert torch.equal(back[key][n], t)


@pytest.mark.parametrize("name", sorted(
    k for k in jax_sched.SCHEDULES if k is not None))
def test_lr_schedules_match_jax(name):
    steps = np.arange(121, dtype=np.int32)
    for warmup in (0.0, 0.1, 0.3):
        theirs = np.asarray(jax_sched.make_lr_schedule(
            name, warmup, 120.0)(jnp.asarray(steps)))
        fn = schedules.make_lr_schedule(name, warmup, 120.0)
        ours = np.array([fn(int(s)) for s in steps], np.float32)
        np.testing.assert_allclose(ours, np.broadcast_to(theirs, ours.shape),
                                   rtol=1e-6, atol=1e-7,
                                   err_msg=f"{name} warmup {warmup}")


@pytest.mark.parametrize("decay", [None, "None", "exp", "linear", "sigmoid",
                                   "cosine"])
def test_epoch_decays_match_jax(decay):
    kw = dict(exponential_k=0.95, linear_k=-0.01, linear_b=1.0,
              sigmoid_k=800.0)
    for epoch in range(121):
        if decay != "cosine":
            assert schedules.distill_weight(decay, epoch, **kw) == \
                jax_sched.distill_weight(decay, epoch, **kw)
        for init in (0.8, 0.3):
            args = (decay, epoch, init, 120, 0.95, 800.0)
            assert schedules.alpha_schedule(*args) == \
                jax_sched.alpha_schedule(*args)
            assert schedules.belta_schedule(*args) == \
                jax_sched.belta_schedule(*args)


def test_ema_matches_jax(params):
    rng = np.random.RandomState(2)
    named = {k: v for k, v in state_dict_from_jax(params).items()}
    shadow, jshadow = ema_init(named), jax_ema.ema_init(params)
    live = params
    for step in (0, 1, 7, 500):
        live = jax.tree.map(
            lambda p: (p + 0.1 * rng.randn(*p.shape)).astype(np.float32),
            live)
        jshadow = jax_ema.ema_update(jshadow, live, step)
        shadow = ema_update(shadow, state_dict_from_jax(live), step)
    theirs = state_dict_from_jax(jax.tree.map(np.asarray, jshadow))
    for n, t in shadow.items():
        np.testing.assert_allclose(t.numpy(), theirs[n].numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=n)
    eval_p, saved = ema_swap(shadow, named)
    assert eval_p is shadow and saved is named
