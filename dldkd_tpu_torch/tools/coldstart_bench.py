"""Cold start to first result of int8 serving on the card (port of
dldkd_tpu/tools/coldstart_bench.py).

Measures, in THIS process (run it fresh), the wall time from process start
to the first search result of a two-stage `Retriever` (score_quant,
rescore) over the TVR serving corpus (`tools/workload.py`'s model, seeded
weights; a cheap deterministic filler corpus: cold-start timings do not
depend on feature values), for one policy:

  python -m dldkd_tpu_torch.tools.coldstart_bench --policy cold
      a fresh, empty kernel-library directory as `aot_cache_dir`, so nvcc
      builds each CUDA source at its first launch
  ... --policy aot
      ~/.cache/dldkd_torch_kernels as `aot_cache_dir` (run twice: the
      first run builds the libraries there, the second loads them)
  ... --policy artifact
      `load_index` of ~/.cache/dldkd_torch_index_bench plus that library
      directory; a run that finds no artifact for this corpus size builds
      the index and saves it with a prewarm manifest (32 tokens, k 10)
  ... --policy warm
      `Retriever(warm_start=True)`. The JAX package serves from the exact
      path while its int8 program compiles in a thread, then swaps; the
      port never swaps (every route runs the same kernel libraries), so
      `int8_ready_s` and `int8_search_s` are null: no swap exists to time
  ... --policy both
      warm, cold, aot twice and artifact twice, each in a fresh subprocess
  ... --policy fleet
      the replica drill: one subprocess builds and saves the prewarmed
      artifact and fills the library directory, then --replicas fresh
      subprocesses each load it and serve; per-replica start to first
      result, p50 and p95

The process start is read from /proc/self/stat (the interpreter's start,
before torch's import), or this module's import time where /proc is
absent. `--mesh` runs the retriever on `make_mesh()` over every visible GPU
(a mesh of one on a one-GPU machine, which still takes the sharded route;
with `--torch_device cpu` a one-shard CPU mesh), as the JAX tool's
`--mesh` does; the subprocess policies pass it on. Runs on the card unless
`--torch_device cpu`.
Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

from dldkd_tpu_torch.tools.workload import REPO_ROOT

_T_IMPORT = time.time()
ARTIFACT_DIR = "~/.cache/dldkd_torch_index_bench"
KERNEL_DIR = "~/.cache/dldkd_torch_kernels"
PROCESS_TIMEOUT_S = 1200


def _process_start() -> float:
    """Wall-clock time at which this process started, from the kernel's
    record of it; this module's import time without /proc."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        start_ticks = int(fields[19])   # field 22, starttime
        return time.time() - uptime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _T_IMPORT


def _filler_videos(n_videos: int):
    """Deterministic frames without an RNG pass over the corpus."""
    import numpy as np

    from dldkd_tpu_torch.data.ingest import PackedVideos
    from dldkd_tpu_torch.tools.workload import D_STUDENT, L_FRAMES

    base = np.linspace(-1.0, 1.0, L_FRAMES * D_STUDENT,
                       dtype=np.float32).reshape(L_FRAMES, D_STUDENT)
    feats = np.empty((n_videos, L_FRAMES, D_STUDENT), np.float32)
    feats[:] = base  # one broadcast memcpy pass
    feats += (np.arange(n_videos, dtype=np.float32)[:, None, None]
              / n_videos)
    return PackedVideos(feats=feats,
                        mask=np.ones((n_videos, L_FRAMES), np.float32),
                        ids=[f"v{i}" for i in range(n_videos)])


def _measure(policy: str, n_videos: int, n_queries: int,
             device: str = "cuda", use_mesh: bool = False) -> dict:
    t0 = _process_start()

    def mark(what):
        print(f"[{policy}] {what}: t+{time.time() - t0:.1f}s",
              file=sys.stderr, flush=True)

    import numpy as np

    from dldkd_tpu_torch.ops.kernels import build
    from dldkd_tpu_torch.parallel import make_mesh
    from dldkd_tpu_torch.serving import Retriever
    from dldkd_tpu_torch.tools import workload as wl
    from dldkd_tpu_torch.utils import index_io

    mark("imports done")
    model = wl.serving_model(0)
    mark("model init done")

    artifact_dir = os.path.expanduser(ARTIFACT_DIR)
    have_artifact = False
    if policy == "artifact":
        # only reuse a leftover artifact that matches THIS run's corpus
        # size: a stale one would time the wrong index; a weights or
        # config mismatch load_index refuses on its own
        try:
            have_artifact = (index_io.read_meta(artifact_dir)["n_videos"]
                             == n_videos)
        except (OSError, ValueError, KeyError):
            have_artifact = False
    videos = None if have_artifact else _filler_videos(n_videos)
    rng = np.random.RandomState(0)
    qf = rng.rand(n_queries, wl.L_TOK_PAD, wl.D_QUERY).astype(np.float32)
    qm = np.ones((n_queries, wl.L_TOK_PAD), np.float32)
    mark("host data gen done")

    build_dir_before = build.BUILD_DIR
    cold_dir = (tempfile.mkdtemp(prefix="dldkd_torch_cold_kernels_")
                if policy == "cold" else None)
    kernel_dir = (os.path.expanduser(KERNEL_DIR)
                  if policy in ("aot", "artifact") else cold_dir)
    try:
        # the timed route is the sharded one, the default on a host with
        # several GPUs
        mesh = (None if not use_mesh else make_mesh() if device == "cuda"
                else make_mesh(devices=[device]))
        r = Retriever(model, query_bsz=256, score_quant=True, rescore=True,
                      warm_start=(policy == "warm"),
                      aot_cache_dir=kernel_dir, mesh=mesh, device=device)
        t_index0 = time.time()
        if have_artifact:
            r.load_index(artifact_dir)
            mark("index artifact loaded")
        else:
            r.index(videos)
            if policy == "artifact":
                # the manifest covers the signature searched below (32
                # tokens, k 10 at query_bsz 256): replicas run it at load
                r.save_index(artifact_dir, prewarm=[(wl.L_TOK_PAD, 10)])
                mark("index artifact saved (prewarm 32:10)")
        t_index = time.time() - t_index0
        t_s0 = time.time()
        _, idx = r.search(qf, qm, k=10)
        first_result = time.time()
    finally:
        if cold_dir:
            # later launches in this process build where they did before
            build.set_build_dir(build_dir_before)
            shutil.rmtree(cold_dir, ignore_errors=True)
    out = {"policy": policy, "first_result_s": first_result - t0,
           "index_s": t_index, "first_search_s": first_result - t_s0}
    if policy == "warm":
        # no swap to a second program exists in the port
        out["int8_ready_s"] = None
        out["int8_search_s"] = None
    if idx.shape != (n_queries, 10):
        raise RuntimeError(f"search returned ids of shape {idx.shape}")
    return out


def _command(policy: str, args) -> list:
    return [sys.executable, "-m", "dldkd_tpu_torch.tools.coldstart_bench",
            "--policy", policy, "--n_videos", str(args.n_videos),
            "--n_queries", str(args.n_queries),
            "--torch_device", args.torch_device] + (
                ["--mesh"] if args.mesh else [])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--policy",
                   choices=["warm", "cold", "aot", "artifact", "both",
                            "fleet"],
                   default="both",
                   help="cold: a fresh library directory (nvcc builds); "
                        "aot: the library directory (run TWICE: the first "
                        "builds ~/.cache/dldkd_torch_kernels, the second "
                        "measures the loaded cold start); artifact: the "
                        "saved index (save_index) + the library directory "
                        "(also run twice); warm: warm_start=True; both: "
                        "warm+cold+aot(x2)+artifact(x2) in fresh "
                        "subprocesses; fleet: build one prewarmed "
                        "artifact, then launch --replicas fresh processes "
                        "against it and report p50/p95 start to first "
                        "result")
    p.add_argument("--n_videos", type=int, default=2179)
    p.add_argument("--n_queries", type=int, default=256)
    p.add_argument("--replicas", type=int, default=4,
                   help="fleet mode: number of fresh replica processes")
    p.add_argument("--mesh", action="store_true",
                   help="run on a mesh over every visible GPU (a mesh of "
                        "one on a one-GPU machine), so the timed route is "
                        "the sharded one")
    p.add_argument("--torch_device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    if args.policy == "fleet":
        # one build process saves the prewarmed artifact and fills the
        # library directory, then N fresh processes each pay only the
        # replica cold start (artifact load, library load, the manifest's
        # searches); sequential launches, so each is measured alone
        def run_once(label):
            try:
                proc = subprocess.run(
                    _command("artifact", args), capture_output=True,
                    text=True, timeout=PROCESS_TIMEOUT_S, cwd=REPO_ROOT)
            except subprocess.TimeoutExpired:
                # a process overrunning its budget is a per-replica data
                # point, not a drill abort
                return {"error": f"timeout after {PROCESS_TIMEOUT_S}s",
                        "label": label}
            if proc.returncode:
                return {"error": proc.stderr[-300:], "label": label}
            return json.loads(proc.stdout.strip().splitlines()[-1])

        # a leftover artifact (an interrupted run) would turn populate into
        # a pure load: always build fresh
        shutil.rmtree(os.path.expanduser(ARTIFACT_DIR), ignore_errors=True)
        try:
            results = {"populate": run_once("populate"), "replicas": []}
            if "error" in results["populate"]:
                # without the artifact every replica would measure a full
                # build, not the fleet posture
                results["errors"] = 1 + args.replicas
                print(json.dumps(results))
                return results
            for i in range(args.replicas):
                results["replicas"].append(run_once(f"replica{i}"))
            errors = sum(1 for r in results["replicas"] if "error" in r)
            if errors:
                results["errors"] = errors
            firsts = sorted(r["first_result_s"] for r in results["replicas"]
                            if "first_result_s" in r)
            if firsts:
                results["p50_first_result_s"] = firsts[len(firsts) // 2]
                results["p95_first_result_s"] = firsts[
                    min(len(firsts) - 1, int(0.95 * len(firsts)))]
            print(json.dumps(results))
            return results
        finally:
            # every exit (a failed populate may have published the
            # artifact before dying) removes the drill's artifact
            shutil.rmtree(os.path.expanduser(ARTIFACT_DIR),
                          ignore_errors=True)

    if args.policy == "both":
        results = {}
        # aot and artifact run twice: the first populates, the second is
        # the measured cold start
        for label, policy in (("warm", "warm"), ("cold", "cold"),
                              ("aot_populate", "aot"), ("aot", "aot"),
                              ("artifact_populate", "artifact"),
                              ("artifact", "artifact")):
            proc = subprocess.run(_command(policy, args), capture_output=True,
                                  text=True, timeout=PROCESS_TIMEOUT_S,
                                  cwd=REPO_ROOT)
            if proc.returncode:
                results[label] = {"error": proc.stderr[-300:]}
            else:
                results[label] = json.loads(proc.stdout.strip()
                                            .splitlines()[-1])
        # the populate run left the index artifact; do not leak it
        shutil.rmtree(os.path.expanduser(ARTIFACT_DIR), ignore_errors=True)
        print(json.dumps(results))
        return results

    out = _measure(args.policy, args.n_videos, args.n_queries,
                   args.torch_device, args.mesh)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
