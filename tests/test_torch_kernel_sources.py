"""The CUDA sources against the Python that builds and binds them, on the
CPU: no compiler and no card needed.

- Every `extern "C"` entry of `dldkd_tpu_torch/csrc/*.cu` is bound by a
  wrapper with `build.bind(library, symbol, n_ptrs, n_ints[, n_floats])`,
  from the library it is defined in, with the arity of its C signature
  (pointers, then ints, then floats, then the stream; an int return). A
  mismatch would pass arguments in the wrong registers, which only a card
  would show.
- Every source is in `build.SOURCES`, once; the four scoring entries live
  in the one tensor-core source.
- The scoring wrappers' depth padding (f32 rows to 4 values, bf16 rows to
  8, int8 rows to 16, the exact kernel's f32 query and bf16 frames to 8)
  leaves the plain versions' results bitwise unchanged; at TVR's depth it
  copies nothing.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import dldkd_tpu_torch
from dldkd_tpu_torch.ops.kernels import build, sim_max

PACKAGE = Path(dldkd_tpu_torch.__file__).resolve().parent
_EXTERN = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\b(\w+)\s*\(([^)]*)\)',
                     re.S)


def _param_kind(param: str) -> str:
    """"ptr" for a pointer parameter, else its type's last word."""
    return "ptr" if "*" in param else param.split()[-2]


def _c_entries():
    """{symbol: (source stem, return type, [parameter kinds])}."""
    out = {}
    for path in sorted(build.CSRC.glob("*.cu")):
        for ret, name, params in _EXTERN.findall(path.read_text()):
            kinds = [_param_kind(p) for p in params.split(",") if p.strip()]
            assert name not in out, f"{name} defined twice"
            out[name] = (path.stem, ret.strip(), kinds)
    return out


def _bind_calls():
    """(library, symbol, arity, where) of every build.bind call in the
    package whose library and symbol are literal strings."""
    calls = []
    for path in sorted(PACKAGE.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            if not ((isinstance(f, ast.Name) and f.id == "bind")
                    or (isinstance(f, ast.Attribute) and f.attr == "bind")):
                continue
            args = node.args
            if len(args) < 4 or not all(isinstance(a, ast.Constant)
                                        for a in args):
                continue
            lib, sym, *arity = (a.value for a in args)
            if isinstance(lib, str) and isinstance(sym, str):
                arity = tuple(arity) + (0,) * (3 - len(arity))
                calls.append((lib, sym, arity, f"{path.name}:{node.lineno}"))
    return calls


ENTRIES = _c_entries()


def _arity(kinds):
    """(n_ptrs, n_ints, n_floats) of C parameter kinds in bind's order;
    None if the order is not pointers, ints, floats, stream pointer."""
    if not kinds or kinds[-1] != "ptr":
        return None
    kinds = kinds[:-1]
    order = {"ptr": 0, "int": 1, "float": 2}
    if any(k not in order for k in kinds) \
            or [order[k] for k in kinds] != sorted(order[k] for k in kinds):
        return None
    return tuple(kinds.count(k) for k in ("ptr", "int", "float"))


def test_the_sources_define_entries():
    assert {"sim_max_f32", "sim_max_bf16", "sim_max_int8", "sim_max_exact",
            "tower_gemm_mma", "tower_attention_mma"} <= set(ENTRIES)


@pytest.mark.parametrize("symbol", sorted(ENTRIES))
def test_entry_bound_with_its_c_arity(symbol):
    stem, ret, kinds = ENTRIES[symbol]
    assert ret == "int", f"{symbol} returns {ret}, not cudaGetLastError()"
    want = _arity(kinds)
    assert want is not None, f"{symbol}: parameters {kinds} are not in " \
                             f"bind's order (pointers, ints, floats, stream)"
    calls = [c for c in _bind_calls() if c[1] == symbol]
    assert calls, f"no wrapper binds {symbol}"
    for lib, _, arity, where in calls:
        assert lib == stem, f"{where} binds {symbol} from {lib}, but " \
                            f"csrc/{stem}.cu defines it"
        assert arity == want, f"{where} binds {symbol} with (ptrs, ints, " \
                              f"floats) {arity}; the C signature has {want}"


def test_arity_reads_pointers_ints_floats():
    kinds = [_param_kind(p) for p in ("const void* x", "void *y", "int n",
                                      "int bf16", "float scale",
                                      "void* stream")]
    assert kinds == ["ptr", "ptr", "int", "int", "float", "ptr"]
    assert _arity(kinds) == (2, 2, 1)
    assert _arity(["ptr", "int", "ptr", "ptr"]) is None
    assert _arity(["ptr", "int"]) is None


def test_every_source_is_built_once():
    on_disk = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    assert len(build.SOURCES) == len(set(build.SOURCES))
    assert sorted(build.SOURCES) == on_disk
    bound = {c[0] for c in _bind_calls()}
    assert bound == set(build.SOURCES)


def test_scoring_entries_live_in_the_tensor_core_source():
    """f32 scoring and exact rescoring moved into csrc/sim_max_mma.cu beside
    bf16 and int8 scoring; no SIMT scoring source is left to build."""
    for symbol in ("sim_max_bf16", "sim_max_f32", "sim_max_int8",
                   "sim_max_exact"):
        assert ENTRIES[symbol][0] == "sim_max_mma", symbol
    assert build.SOURCES == ("sim_max_mma", "tower", "tower_mma")
    calls = {c[1]: c[0] for c in _bind_calls()}
    assert calls["sim_max_f32"] == calls["sim_max_exact"] == "sim_max_mma"


def _dyadic(rng, shape, scale):
    """Small multiples of 1/scale: every product and partial sum of the
    scoring functions is exact in f32, so any summation order gives the
    same bits and only a change of value could show."""
    return rng.randint(-7, 8, size=shape).astype(np.float32) / scale


@pytest.mark.parametrize("nq,nv,l_frames,d", [(3, 5, 4, 20), (7, 2, 9, 5),
                                              (1, 6, 1, 13)])
def test_bf16_depth_padding_keeps_plain_scores(nq, nv, l_frames, d):
    rng = np.random.RandomState(d)
    q = torch.from_numpy(_dyadic(rng, (nq, d), 8)).to(torch.bfloat16)
    c = torch.from_numpy(_dyadic(rng, (nv, l_frames, d), 8)).to(
        torch.bfloat16)
    mask = torch.from_numpy((rng.rand(nv, l_frames) > 0.3).astype(
        np.float32))
    mask[0] = 0.0
    qp, cp = sim_max.pad_depth(8, q, c)
    assert qp.shape[-1] % 8 == 0 and qp.shape[-1] - d < 8
    assert cp.shape[:2] == c.shape[:2] and cp.shape[-1] == qp.shape[-1]
    assert torch.equal(cp[..., :d], c) and not cp[..., d:].any()
    assert torch.equal(sim_max.sim_max_plain(qp, cp, mask),
                       sim_max.sim_max_plain(q, c, mask))


@pytest.mark.parametrize("nq,nv,l_frames,d", [(3, 5, 4, 22), (7, 2, 9, 5),
                                              (1, 6, 1, 13)])
def test_f32_depth_padding_keeps_plain_scores(nq, nv, l_frames, d):
    """f32 rows pad to 4 values (16 bytes) for the 3xTF32 instance."""
    rng = np.random.RandomState(d + 1)
    q = torch.from_numpy(_dyadic(rng, (nq, d), 8))
    c = torch.from_numpy(_dyadic(rng, (nv, l_frames, d), 8))
    mask = torch.from_numpy((rng.rand(nv, l_frames) > 0.3).astype(
        np.float32))
    mask[0] = 0.0
    qp, cp = sim_max.pad_depth(4, q, c)
    assert qp.dtype == torch.float32 and qp.shape[-1] % 4 == 0
    assert qp.shape[-1] - d < 4
    assert torch.equal(cp[..., :d], c) and not cp[..., d:].any()
    assert torch.equal(sim_max.sim_max_plain(qp, cp, mask),
                       sim_max.sim_max_plain(q, c, mask))


@pytest.mark.parametrize("nq,nv,l_frames,d", [(3, 5, 4, 22), (2, 3, 9, 100)])
def test_exact_depth_padding_keeps_plain_scores(nq, nv, l_frames, d):
    """The exact kernel pads its f32 query and bf16 frames to 8 values; the
    frame scales come from the unpadded frames and do not change."""
    rng = np.random.RandomState(d + 2)
    q = torch.from_numpy(_dyadic(rng, (nq, d), 8))
    c = torch.from_numpy(_dyadic(rng, (nv, l_frames, d), 8)).to(
        torch.bfloat16)
    mask = torch.from_numpy((rng.rand(nv, l_frames) > 0.3).astype(
        np.float32))
    mask[0] = 0.0
    inv, bias = sim_max.exact_frame_scales(c, mask)
    qp, cp = sim_max.pad_depth(8, q, c)
    assert qp.dtype == torch.float32 and cp.dtype == torch.bfloat16
    assert qp.shape[-1] % 8 == 0 and cp.shape[-1] == qp.shape[-1]
    assert torch.equal(sim_max.exact_frame_scales(cp, mask)[0], inv)
    assert torch.equal(sim_max.sim_max_exact_plain(qp, cp, inv, bias),
                       sim_max.sim_max_exact_plain(q, c, inv, bias))


@pytest.mark.parametrize("nq,nv,l_frames,d", [(3, 5, 4, 22), (7, 2, 9, 40),
                                              (2, 6, 1, 7)])
def test_int8_depth_padding_keeps_plain_scores(nq, nv, l_frames, d):
    rng = np.random.RandomState(d)
    q8 = torch.from_numpy(rng.randint(-127, 128, (nq, d)).astype(np.int8))
    c8 = torch.from_numpy(rng.randint(-127, 128, (nv, l_frames, d))
                          .astype(np.int8))
    mask = torch.from_numpy((rng.rand(nv, l_frames) > 0.3).astype(
        np.float32))
    mask[0] = 0.0
    bias = sim_max.q8_index_bias(mask)
    qp, cp = sim_max.pad_depth(16, q8, c8)
    assert qp.dtype == torch.int8 and qp.shape[-1] % 16 == 0
    assert torch.equal(cp[..., :d], c8) and not cp[..., d:].any()
    assert torch.equal(sim_max.sim_max_int8_plain(qp, cp, bias),
                       sim_max.sim_max_int8_plain(q8, c8, bias))


def test_depth_padding_copies_nothing_at_tvr_depth():
    q = torch.zeros(4, 384, dtype=torch.bfloat16)
    c = torch.zeros(3, 2, 384, dtype=torch.bfloat16)
    for multiple in (8, 16):
        qp, cp = sim_max.pad_depth(multiple, q, c)
        assert qp is q and cp is c
    q32, c32 = q.float(), c.float()
    for multiple, pair in ((4, (q32, c32)), (8, (q32, c))):
        out = sim_max.pad_depth(multiple, *pair)
        assert all(a is b for a, b in zip(out, pair))
