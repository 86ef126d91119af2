"""The eval loop: the program's retrieval eval, called back to back.

Set-up makes the split (host numpy arrays, as the packers hand them) and
the weights from the seed, builds the program's kernels once
(`ops/kernels/build.build()`, into the checkout's `csrc/_build`), and
makes one warm call. The window then calls
`evaluate.run_retrieval_eval(model, videos, queries, eval_cfg,
                                       device=device)` until
`--seconds` have passed; the call in flight at the deadline finishes and
counts. A traced run then traces `traced_calls` more calls, outside the
window. Before call k every parameter is set to its seeded value + salt
* (k + 1), as a new epoch's checkpoint would be, so no call can reuse
another's results; the host arrays are the same every call.

eval_qps: all queries of every call / the window (from its start to the
end of its last call; a call ends with its metric dicts on the host).

For `correct`, one call of the window, drawn from the seed, keeps what
it produced: the encoded corpus (`evaluate.embed_corpus`), the pooled
queries (`evaluate.encode_query_best`), the score matrices
(`evaluate.score_all_queries`), the ranks (`evaluate.rank_of_gt`) and
its returned metrics. The harness sees them by wrapping those module
functions, which the eval looks up by name at every call; the wrappers
keep references and add no device work. Once the window has closed and
the peak memory is read, the reference recomputes that call from the
host arrays and the seeded weights + that call's salt.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import harness, inputs
from benchmark.cost import model_ops
from benchmark.loops import common
from benchmark.reference import eval_ref


class Capture:
    """Wraps the eval module's functions; while armed, keeps their
    outputs."""

    NAMES = ("embed_corpus", "encode_query_best", "score_all_queries",
             "rank_of_gt")

    def __init__(self, module):
        self.module = module
        self.armed = False
        self.kept: Dict[str, List] = {n: [] for n in self.NAMES}
        self.originals = {n: getattr(module, n) for n in self.NAMES}
        for n in self.NAMES:
            setattr(module, n, self._wrap(n, self.originals[n]))

    def _wrap(self, name, fn):
        def wrapped(*args, **kwargs):
            out = fn(*args, **kwargs)
            if self.armed:
                self.kept[name].append(out)
            return out
        return wrapped

    def restore(self) -> None:
        for n, fn in self.originals.items():
            setattr(self.module, n, fn)

    def program_outputs(self, metrics: dict) -> dict:
        """The kept call as `eval_ref.compare_eval` reads it."""
        (ci, ce, _mask), = self.kept["embed_corpus"]
        (si, se), = self.kept["score_all_queries"]
        batches = self.kept["encode_query_best"]
        qi = torch.cat([b[0] for b in batches])
        qe = torch.cat([b[1] for b in batches]) if ce is not None else None
        ranks = dict(zip(("inher", "explore", "fused"),
                         self.kept["rank_of_gt"]))
        return {"frames": {"inher": ci, "explore": ce},
                "queries": {"inher": qi, "explore": qe},
                "scores": {"inher": si, "explore": se},
                "ranks": ranks, "metrics": metrics}


def run(cell: harness.Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t_start: float) -> harness.Result:
    from dldkd_tpu_torch import evaluate, float32_matmul_precision
    from dldkd_tpu_torch.config import EvalConfig
    from dldkd_tpu_torch.data.ingest import PackedQueries, PackedVideos

    cfg, mix = cell.config, cell.mix
    if device.type == "cuda":
        from dldkd_tpu_torch.ops.kernels import build

        build.build()
    data = inputs.eval_inputs(cfg, mix, seed, device)
    nv, nq = cfg["n_videos"], cfg["n_queries"]
    videos = PackedVideos(data["vfeats"], data["vmask"], inputs.ids("v", nv))
    queries = PackedQueries(data["qfeats"], data["qmask"],
                            [f"v{g}#{i}" for i, g in enumerate(data["gt"])],
                            [f"v{g}" for g in data["gt"]])
    base = inputs.weights(cfg, seed, device)
    model = common.port_model(cfg, base, device).eval()
    params = dict(model.named_parameters())
    eval_cfg = EvalConfig(eval_query_bsz=cfg["eval_query_bsz"],
                          eval_context_bsz=cfg["eval_context_bsz"],
                          score_quant=cfg["score_quant"],
                          corpus_stream_bsz=cfg["corpus_stream_bsz"])
    salt = float(mix["salt"])
    checked = int(np.random.RandomState(seed % 2**32).randint(
        mix["checked_call"][0], mix["checked_call"][1] + 1))

    @torch.no_grad()
    def set_salt(k: int) -> None:
        for n, p in params.items():
            p.copy_(base[n] + salt * (k + 1))

    capture = Capture(evaluate)
    n_traced = int(mix["traced_calls"]) if traced else 0
    window = common.TracedWindow(device) if traced else None
    try:
        with float32_matmul_precision(cfg["matmul_precision"]):
            set_salt(-1)
            evaluate.run_retrieval_eval(model, videos, queries, eval_cfg,
                                        device=device)
            common.sync(device)
            setup_s = time.perf_counter() - t_start
            common.log(f"set-up {setup_s:.3f} s; checked call {checked}")
            calls, kept_metrics, times = 0, None, []
            t0 = time.perf_counter()
            deadline = t0 + seconds
            while calls <= checked or time.perf_counter() < deadline:
                t_call = time.perf_counter()
                set_salt(calls)
                capture.armed = calls == checked
                metrics = evaluate.run_retrieval_eval(
                    model, videos, queries, eval_cfg, device=device)
                capture.armed = False
                times.append(time.perf_counter() - t_call)
                if calls == checked:
                    kept_metrics = metrics
                calls += 1
            t_end = time.perf_counter()
            if window is not None:
                # the traced calls follow the window and are not in it
                window.start()
                for k in range(calls, calls + n_traced):
                    with record_function("bench/eval_call"):
                        set_salt(k)
                        evaluate.run_retrieval_eval(
                            model, videos, queries, eval_cfg, device=device)
                window.stop()
    finally:
        capture.restore()
    window_s = t_end - t0
    common.log("call s: " + " ".join(f"{t:.4f}" for t in times))
    peak = common.memory_peak(device)
    prog = capture.program_outputs(kept_metrics)
    del model, params, capture
    if device.type == "cuda":
        torch.cuda.empty_cache()
    limits = cell.params["limits"]
    P = {n: base[n] + salt * (checked + 1) for n in base}
    t_ref = time.perf_counter()
    reference = eval_ref.reference_eval(P, cfg, data, device,
                                        cfg["eval_context_bsz"])
    checks = eval_ref.compare_eval(prog, reference, data["gt"],
                                   data["vmask"], limits["scores_abs_err"])
    common.log(f"reference and comparison {time.perf_counter() - t_ref:.3f}"
               " s")
    work = model_ops.eval_work(cfg)
    return harness.Result(
        attempted=calls, failed=0,
        metrics={"eval_qps": calls * nq / window_s, "setup_s": setup_s},
        checks=checks, window_s=window_s, units=calls,
        memory_peak_bytes=peak,
        extra={"traced_calls": n_traced},
        trace=window.trace if window is not None else None, work=work)
