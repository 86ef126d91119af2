"""bf16 training in the port (`--dtype bfloat16`, with and without
`--stacked_towers`) on the CPU.

- The bf16 forward (query and context towers) against flax's with
  `dtype=bfloat16` on the same weights: atol 3e-2 (the bf16 tower
  tolerance of tests/test_torch_cuda.py). XLA's CPU backend may skip some
  bf16 roundings (ROADMAP C1), so the two need not agree bitwise: on this
  model 54-59 % of the video towers' bf16 entries and 98-100 % of the
  pooled queries' f32 entries differ, by at most 1.6e-2 (one bf16 ulp at
  the largest outputs, |x| ~ 2.7). The witness for the rounding points
  is flax applied op by op (`jax.disable_jit()`: every primitive rounds
  its output to bf16): the port's bf16 forward agrees with it on >= 90 %
  of the video towers' entries bitwise (93-98 % measured; a port that
  rounds only its f32 outputs, 30 %), and its mean distance to it stays
  under 0.15 of the port's f32 forward's (0.014-0.07 measured).
- A 6-step bf16 trajectory (dropout 0, hard negatives from a pool of 1:
  deterministic in both packages) from the same weights and batches
  against `dldkd_tpu.train.train_step` in bf16: `loss_overall` within rtol
  1e-2 per step; against the port's own f32 trajectory: rtol 0.05 (the
  JAX package's check, tests/test_train.py:162-213). Parameters,
  gradients, BertAdam's moments and the losses stay f32.
- `start_training` with `--dtype bfloat16 --stacked_towers` on the small
  fixture: its checkpoint restores in `dldkd_tpu.checkpoint` with f32
  parameters and `"dtype": "bfloat16"` in model_cfg.json; with dropout on,
  3 epochs straight equal 2 epochs plus `--resume`, bitwise.
- `python -m dldkd_tpu_torch.tools.train_bench` on the CPU at a tiny
  workload, in the four settings (float32 / bfloat16 x sequential /
  stacked): one JSON line, every stage timed, the device numbers null.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dldkd_tpu import checkpoint as jax_ckpt
from dldkd_tpu import train as jax_train
from dldkd_tpu.config import ModelConfig as JaxModelConfig
from dldkd_tpu.config import TrainConfig as JaxTrainConfig
from dldkd_tpu.models import DLDKD as JaxDLDKD
from dldkd_tpu.models.objective import LossScalars as JaxLossScalars
from dldkd_tpu.optim import bert_adam as jax_bert_adam
from dldkd_tpu.optim import default_wd_mask as jax_wd_mask
from dldkd_tpu.optim import schedules as jax_schedules
from dldkd_tpu_torch import train as train_mod
from dldkd_tpu_torch.config import ModelConfig, TrainConfig
from dldkd_tpu_torch.convert import load_jax_params
from dldkd_tpu_torch.models import DLDKD
from dldkd_tpu_torch.models.objective import LossScalars
from dldkd_tpu_torch.optim import BertAdam, default_wd_mask, schedules
from dldkd_tpu_torch.tools import train_bench
from tests.test_torch_objective import DIMS, _jax_params, make_batch
from tests.test_torch_train import (_numerics_and_writers,  # noqa: F401
                                    assert_resume_exact, small_root)

BF16_TOL = 3e-2
LR, N_STEPS = 1e-3, 6
SCALARS = (1.0, 0.8, 0.8)   # kd_weight, alpha, belta


def _cfgs(dtype: str):
    kw = dict(label_style="soft", double_branch=True, dtype=dtype, **DIMS)
    return JaxModelConfig(**kw), ModelConfig(**kw)


def _args(batch, conv):
    return tuple(conv(batch[k]) for k in (
        "student_videos", "student_videos_mask", "student_text",
        "student_text_mask"))


def test_bf16_forward_matches_flax():
    jm, pm = _cfgs("bfloat16")
    params = _jax_params(jm)
    batch = make_batch()
    jmodel = JaxDLDKD(config=jm)
    (rci, rce), (rqi, rqe) = jax.jit(lambda p, *a: jmodel.apply(
        p, *a, deterministic=True))(jax.tree.map(jnp.asarray, params),
                                    *_args(batch, jnp.asarray))
    model = load_jax_params(DLDKD(pm), params).eval()
    with torch.no_grad():
        (ci, ce), (qi, qe) = model(*_args(batch, torch.from_numpy))
    assert ci.dtype == ce.dtype == torch.bfloat16
    assert qi.dtype == qe.dtype == torch.float32
    assert rci.dtype == jnp.bfloat16 and rqi.dtype == jnp.float32
    for ours, ref in ((ci, rci), (ce, rce), (qi, rqi), (qe, rqe)):
        a = ours.float().numpy()
        b = np.asarray(ref).astype(np.float32)
        assert np.abs(a).max() > 0.1
        np.testing.assert_allclose(a, b, rtol=0, atol=BF16_TOL)


def _flat(outs):
    (ci, ce), (qi, qe) = outs
    return [np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                       dtype=np.float32) for x in (ci, ce, qi, qe)]


def test_bf16_rounding_points_match_eager_flax():
    """flax op by op rounds at every op's output as the port does; the
    port's f32 forward (or one rounding only its outputs) is far off."""
    jm, pm = _cfgs("bfloat16")
    _, pm32 = _cfgs("float32")
    params = _jax_params(jm)
    batch = make_batch()
    with jax.disable_jit():
        witness = _flat(JaxDLDKD(config=jm).apply(
            jax.tree.map(jnp.asarray, params), *_args(batch, jnp.asarray),
            deterministic=True))
    with torch.no_grad():
        bf16 = _flat(load_jax_params(DLDKD(pm), params).eval()(
            *_args(batch, torch.from_numpy)))
        f32 = _flat(load_jax_params(DLDKD(pm32), params).eval()(
            *_args(batch, torch.from_numpy)))
    for i, (ours, ref, full) in enumerate(zip(bf16, witness, f32)):
        err, err32 = np.abs(ours - ref).mean(), np.abs(full - ref).mean()
        assert err <= 0.15 * err32, (i, err, err32)
        if i < 2:                      # the video towers' bf16 outputs
            assert (ours == ref).mean() >= 0.9, i


def _batches():
    return [make_batch(seed=s) for s in (1, 2, 3)]


def _jax_trajectory(jm, params):
    tcfg = JaxTrainConfig(lr=LR)
    model = JaxDLDKD(config=jm)
    p = jax.tree.map(jnp.asarray, params)
    opt = jax_bert_adam(LR, jax_schedules.make_lr_schedule(
        "warmup_linear", 0.01, 100.0), weight_decay=0.01,
        wd_mask=jax_wd_mask(p))
    state = opt.init(p)
    scalars = JaxLossScalars(*(jnp.float32(v) for v in SCALARS))
    batches = _batches()
    losses = []
    for i in range(N_STEPS):
        p, state, ld = jax_train.train_step(
            model, jm, tcfg, opt, p, state,
            {k: jnp.asarray(v) for k, v in batches[i % 3].items()},
            jax.random.PRNGKey(7 + i), scalars)
        losses.append(float(ld["loss_overall"]))
    return losses


def _port_trajectory(pm, params, stacked=False):
    tcfg = TrainConfig(lr=LR, stacked_towers=stacked)
    model = load_jax_params(DLDKD(pm), params)
    named = dict(model.named_parameters())
    opt = BertAdam(named, LR, schedules.make_lr_schedule(
        "warmup_linear", 0.01, 100.0), weight_decay=0.01,
        wd_mask=default_wd_mask(named))
    gen = torch.Generator().manual_seed(0)
    scalars = LossScalars(*(torch.tensor(v, dtype=torch.float32)
                            for v in SCALARS))
    batches = [{k: torch.from_numpy(v) for k, v in b.items()}
               for b in _batches()]
    losses = []
    for i in range(N_STEPS):
        ld = train_mod.train_step(model, pm, tcfg, opt, batches[i % 3], gen,
                                  scalars)
        assert all(v.dtype == torch.float32 for v in ld.values())
        losses.append(float(ld["loss_overall"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    state = opt.state_dict()
    assert all(t.dtype == torch.float32
               for key in ("m", "v") for t in state[key].values())
    assert any(float(t.abs().max()) > 0 for t in state["m"].values())
    return losses


@pytest.fixture(scope="module")
def trajectories():
    jm, pm = _cfgs("bfloat16")
    _, pm32 = _cfgs("float32")
    params = _jax_params(jm, seed=3)
    return {"jax_bf16": _jax_trajectory(jm, params),
            "bf16": _port_trajectory(pm, params),
            "bf16_stacked": _port_trajectory(pm, params, stacked=True),
            "f32": _port_trajectory(pm32, params)}


@pytest.mark.parametrize("run", ["bf16", "bf16_stacked"])
def test_bf16_trajectory_matches_jax(trajectories, run):
    ours, ref = trajectories[run], trajectories["jax_bf16"]
    assert np.all(np.isfinite(ours))
    np.testing.assert_allclose(ours, ref, rtol=1e-2)
    assert abs(ours[-1] - ours[0]) > 1e-3    # the trajectory moves


def test_bf16_trajectory_tracks_f32(trajectories):
    np.testing.assert_allclose(trajectories["bf16"], trajectories["f32"],
                               rtol=0.05)


def test_bf16_stacked_run_checkpoint_restores_in_jax(small_root, tmp_path,
                                                     monkeypatch):
    """The stacked bf16 twin of test_resume_is_exact; its run's best
    checkpoint restores in the JAX package: f32 parameters, a bf16
    model config."""
    cfg = assert_resume_exact(small_root, tmp_path, monkeypatch,
                              dtype="bfloat16", stacked_towers=True)
    with open(os.path.join(cfg.ckpt_dir, "model_cfg.json")) as f:
        assert json.load(f)["dtype"] == "bfloat16"
    mcfg = jax_ckpt.load_model_cfg(cfg.ckpt_dir)
    template = jax_train.init_params(JaxDLDKD(config=mcfg), mcfg, 0)
    params, epoch = jax_ckpt.restore_params_only(cfg.ckpt_dir, template)
    leaves = jax.tree.leaves(params)
    assert leaves and all(np.asarray(x).dtype == np.float32 for x in leaves)
    assert 0 <= int(epoch) <= 2
    with open(cfg.train_log_filepath) as f:
        log = f.read()
    assert "[Epoch] 002" in log and "nan" not in log.lower()


TINY_BENCH = dict(bsz=4, frames=6, d_video=12, tokens=5, d_query=10,
                  d_teacher=8, hidden=8, n_heads=2, hard_pool_size=2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [False, True], ids=["seq", "stacked"])
def test_train_bench_on_cpu(monkeypatch, capsys, dtype, stacked):
    monkeypatch.setattr(train_bench, "WORKLOAD",
                        dict(train_bench.WORKLOAD, **TINY_BENCH))
    rec = train_bench.main(["--torch_device", "cpu", "--reps", "2",
                            "--dtype", dtype, "--rng", "rbg"]
                           + (["--stacked"] if stacked else []))
    assert json.loads(capsys.readouterr().out.strip()) == rec
    assert rec["dtype"] == dtype and rec["stacked"] == stacked
    assert rec["matmul_precision"] == (
        "highest" if dtype == "float32" else "default")
    assert rec["device"] == "cpu" and rec["bsz"] == 4
    assert set(rec["stages_ms"]) == set(train_bench.STAGES)
    assert all(np.isfinite(v) and v > 0 for v in rec["stages_ms"].values())
    assert rec["samples_per_s"] > 0
    assert rec["device_busy_ms_per_step"] is None
    assert rec["kernels_per_step"] is None and rec["peak_gb"] is None


def test_train_bench_precision_flag_and_span_union(monkeypatch, capsys):
    monkeypatch.setattr(train_bench, "WORKLOAD",
                        dict(train_bench.WORKLOAD, **TINY_BENCH))
    rec = train_bench.main(["--torch_device", "cpu", "--reps", "1",
                            "--stacked", "--matmul_precision", "highest"])
    assert rec["dtype"] == "bfloat16" and rec["matmul_precision"] == "highest"
    assert json.loads(capsys.readouterr().out.strip()) == rec
    spans = [(5.0, 7.0), (0.0, 2.0), (1.0, 3.0), (5.5, 6.0), (10.0, 10.5)]
    assert train_bench.span_union(spans) == 5.5
    assert train_bench.span_union([]) == 0.0
