"""Fused masked cosine scoring with a max over frames (kernel 1).

Replaces dldkd_tpu/ops/pallas/sim_max.py:_sim_max_kernel, reached there
through `fused_clip_scores(quantized=False)`. The CUDA source is
`csrc/sim_max.cu`; its header says what bounds it on an H100 and how the
design answers that.

`fused_clip_scores(qn, cn, mask)` takes L2-normalized inputs, as the
Pallas kernel does (normalization stays outside, in plain torch):
qn (Nq, D) and cn (Nv, L, D) of one dtype (f32 or bf16) and mask (Nv, L)
f32; it returns (Nq, Nv) f32. On a CUDA tensor it launches the kernel or
raises; on a CPU tensor it runs `sim_max_plain`, the same function in plain
PyTorch, which the CPU tests hold against the Pallas kernel.
"""

from __future__ import annotations

import torch

from dldkd_tpu_torch.ops.masking import mask_logits

# launches of the CUDA kernel since the count was last set to 0
LAUNCHES = {"sim_max": 0}

# bytes of f32 frame scores the plain version holds at once
_PLAIN_CHUNK_BYTES = 256 * 1024 * 1024


def sim_max_plain(qn: torch.Tensor, cn: torch.Tensor, mask: torch.Tensor
                  ) -> torch.Tensor:
    """max_l mask_logits(<qn[q], cn[v, l]>, mask[v, l]) in f32, in query
    chunks so the (Nq, Nv, L) tensor is never built whole (at TVR scale it
    would be 12 GB). bf16 inputs widen exactly to f32, so the products are
    exact and the sums f32 like the kernel's. On a GPU this assumes f32
    matmuls in full f32 (torch.backends.cuda.matmul.allow_tf32 False, the
    default)."""
    nq, d = qn.shape
    nv, l_frames, _ = cn.shape
    c2 = cn.reshape(nv * l_frames, d).float()
    m = mask.float()
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(1, nv * l_frames * 4))
    out = torch.empty((nq, nv), dtype=torch.float32, device=qn.device)
    for s in range(0, nq, chunk):
        frame = (qn[s:s + chunk].float() @ c2.T).reshape(-1, nv, l_frames)
        out[s:s + chunk] = mask_logits(frame, m[None]).amax(dim=-1)
    return out


def _check(qn, cn, mask):
    if qn.dim() != 2 or cn.dim() != 3 or mask.dim() != 2:
        raise ValueError("want qn (Nq, D), cn (Nv, L, D), mask (Nv, L)")
    nq, d = qn.shape
    nv, l_frames, d2 = cn.shape
    if d != d2 or tuple(mask.shape) != (nv, l_frames):
        raise ValueError(f"shape mismatch: qn {tuple(qn.shape)}, cn "
                         f"{tuple(cn.shape)}, mask {tuple(mask.shape)}")
    if qn.dtype != cn.dtype or qn.dtype not in (torch.float32,
                                                torch.bfloat16):
        raise ValueError(f"qn and cn need one dtype, f32 or bf16; got "
                         f"{qn.dtype} and {cn.dtype}")
    if mask.dtype != torch.float32:
        raise ValueError(f"mask must be f32, got {mask.dtype}")
    devs = {qn.device, cn.device, mask.device}
    if len(devs) != 1:
        raise ValueError(f"inputs on several devices: {devs}")
    for name, t in (("qn", qn), ("cn", cn), ("mask", mask)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_clip_scores(qn: torch.Tensor, cn: torch.Tensor,
                      mask: torch.Tensor) -> torch.Tensor:
    """(Nq, Nv) f32 scores from normalized queries and frames."""
    _check(qn, cn, mask)
    if qn.device.type == "cpu":
        return sim_max_plain(qn, cn, mask)
    if qn.device.type != "cuda":
        raise ValueError(f"unsupported device {qn.device}")
    from dldkd_tpu_torch.ops.kernels.build import bind, check

    nq, d = qn.shape
    nv, l_frames, _ = cn.shape
    sym = "sim_max_f32" if qn.dtype == torch.float32 else "sim_max_bf16"
    out = torch.empty((nq, nv), dtype=torch.float32, device=qn.device)
    with torch.cuda.device(qn.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = bind("sim_max", sym, 4, 4)(
            qn.data_ptr(), cn.data_ptr(), mask.data_ptr(), out.data_ptr(),
            nq, nv, l_frames, d, stream)
    check(rc, sym)
    LAUNCHES["sim_max"] += 1
    return out
