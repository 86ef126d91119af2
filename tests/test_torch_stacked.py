"""The port's stacked towers (`models/stacked.py`, `--stacked_towers`) on
the CPU, on the tiny model of tests/test_torch_objective.py:

- the stacked encode against `dldkd_tpu.models.stacked.encode_stacked`
  (f32, deterministic) and against the port's sequential forward: rtol
  1e-5, atol 1e-6 (the JAX package's own bound, tests/test_model.py);
  in bf16 the stacked forward against the sequential one: atol 3e-2 (the
  bf16 tower tolerance);
- with dropout 0, `compute_losses(stacked_towers=True)` against the JAX
  package's: rtol 1e-5 per loss term; the stacked and sequential
  gradients in the port: atol 1e-6;
- dropout on: the stacked masks come from the generator only;
- a single-branch config and one with unequal hidden sizes raise
  ValueError naming "stacked"."""

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
from dldkd_tpu.models.stacked import encode_stacked as jax_encode_stacked
from dldkd_tpu_torch.config import ModelConfig, TrainConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.models.objective import (LossScalars, check_trainable,
                                              compute_losses)
from dldkd_tpu_torch.models.stacked import can_stack, encode_stacked
from tests.test_torch_objective import (DIMS, SCALARS, _jax_params,
                                        make_batch)
from tests.test_torch_objective import _torch_numerics  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
BF16_ATOL = 3e-2


@pytest.fixture(scope="module")
def setup():
    jm = JaxModelConfig(label_style="soft", double_branch=True, **DIMS)
    params = _jax_params(jm)
    batch = make_batch()
    return jm, params, batch


def _args(batch, lib):
    conv = jnp.asarray if lib == "jax" else torch.from_numpy
    return tuple(conv(batch[k]) for k in (
        "student_videos", "student_videos_mask", "student_text",
        "student_text_mask"))


def _flat_t(outs):
    (ci, ce), (qi, qe) = outs
    return (ci, ce, qi, qe)


def _flat(outs):
    return [np.asarray(x) for x in _flat_t(outs)]


def _port(params, dtype="float32", **over):
    cfg = ModelConfig(label_style="soft", double_branch=True, dtype=dtype,
                      **dict(DIMS, **over))
    return load_jax_params(DLDKD(cfg), params)


def test_stacked_encode_matches_jax(setup):
    jm, params, batch = setup
    jmodel = JaxDLDKD(config=jm)
    ref = jax.jit(lambda p, *a: jax_encode_stacked(
        jmodel, p, *a, deterministic=True))(
            jax.tree.map(jnp.asarray, params), *_args(batch, "jax"))
    model = _port(params).eval()
    with torch.no_grad():
        ours = encode_stacked(model, *_args(batch, "torch"))
    for a, b in zip(_flat(ours), _flat(ref)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_stacked_forward_matches_sequential(setup, dtype):
    _, params, batch = setup
    model = _port(params, dtype).eval()
    args = _args(batch, "torch")
    with torch.no_grad():
        seq, st = model(*args), encode_stacked(model, *args)
    for a, b in zip(_flat_t(st), _flat_t(seq)):
        assert a.dtype == b.dtype
        if dtype == "float32":
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                                       atol=ATOL)
        else:
            np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                       rtol=0, atol=BF16_ATOL)


def _losses_and_grads(model, batch, stacked: bool):
    pm = model.config
    pt = TrainConfig(stacked_towers=stacked)
    model.zero_grad()
    loss, ld = compute_losses(
        model.train(), {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.Generator().manual_seed(0), pm, pt,
        LossScalars(*(torch.tensor(v, dtype=torch.float32)
                      for v in SCALARS)))
    loss.backward()
    return ({k: float(v.detach()) for k, v in ld.items()},
            {n: p.grad.clone() for n, p in model.named_parameters()})


def test_stacked_losses_match_jax_and_sequential(setup):
    jm, params, batch = setup
    jt = dataclasses.replace(JaxTrainConfig(), stacked_towers=True)
    jmodel = JaxDLDKD(config=jm)
    scal = jax_objective.LossScalars(*(jnp.float32(v) for v in SCALARS))
    _, j_dict = jax.jit(lambda p: jax_objective.compute_losses(
        jmodel, p, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(0), jm, jt, scal, train=True))(
            jax.tree.map(jnp.asarray, params))

    model = _port(params)
    st_losses, st_grads = _losses_and_grads(model, batch, stacked=True)
    seq_losses, seq_grads = _losses_and_grads(model, batch, stacked=False)
    assert set(st_losses) == set(j_dict)
    for k in j_dict:
        np.testing.assert_allclose(st_losses[k], float(j_dict[k]),
                                   rtol=RTOL, err_msg=k)
        np.testing.assert_allclose(st_losses[k], seq_losses[k], rtol=RTOL,
                                   err_msg=k)
    assert set(st_grads) == set(seq_grads)
    for name, g in st_grads.items():
        assert g.abs().max() > 0 or seq_grads[name].abs().max() == 0, name
        torch.testing.assert_close(g, seq_grads[name], rtol=0, atol=ATOL,
                                   msg=name)


def test_stacked_dropout_comes_from_the_generator(setup):
    _, params, batch = setup
    model = _port(params, input_drop=0.2, drop=0.2).train()
    args = _args(batch, "torch")

    def run(seed):
        torch.manual_seed(seed + 100)   # the global RNG must not matter
        return torch.cat([x.flatten() for x in _flat_t(encode_stacked(
            model, *args, generator=torch.Generator().manual_seed(seed)))])

    a = run(3)
    assert torch.equal(a, run(3))
    assert not torch.allclose(a, run(4))
    with torch.no_grad():
        det = torch.cat([x.flatten() for x in _flat_t(
            encode_stacked(model.eval(), *args))])
    assert not torch.allclose(det, a)


@pytest.mark.parametrize("over", [dict(double_branch=False),
                                  dict(exploration_hidden=32)],
                         ids=["single_branch", "unequal_hidden"])
def test_unstackable_configs_raise(setup, over):
    _, _, batch = setup
    cfg = ModelConfig(**dict(dict(DIMS, label_style="soft",
                                  double_branch=True), **over))
    assert not can_stack(cfg)
    model = DLDKD(cfg)
    with pytest.raises(ValueError, match="stacked"):
        encode_stacked(model, *_args(batch, "torch"))
    with pytest.raises(ValueError, match="stacked"):
        check_trainable(cfg, TrainConfig(stacked_towers=True))
    check_trainable(cfg, TrainConfig())
