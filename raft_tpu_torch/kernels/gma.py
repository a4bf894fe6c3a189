"""Kernels 6 and 7: GMA's global motion aggregation, in CUDA C++ for
Hopper.

They replace no Pallas kernel: the JAX package runs RAFT alone. They came
with the port's GMA model (``models.gma``; Jiang et al., "Learning to
Estimate Hidden Motions with Global Motion Aggregation", ICCV 2021), whose
attention spans every position of the 1/8 grid. The kernels are
``csrc/gma.cu``, built into the same library as the others; its notes say
what bounds them and how they are laid out.

- :func:`gma_attention` (K6): ``A = softmax_rows((scale·q) kᵀ)`` for q, k
  (B, N, 128); A is (B, N, N) float32, its rows 16 bytes apart (a row
  stride rounded up to a multiple of 4 where N is not one). Once a pair.
- :func:`gma_aggregate` (K7): ``g = m + γ·(A v)`` for A (B, N, N) and v, m
  (B, N, 128); g is (B, N, 128), dense. Every refinement step. γ is a
  one-element tensor the kernel reads on the device, so a captured graph
  reads the live weight.

Both compute to float32 accuracy on the tensor cores, each product as
three TF32 products of split operands (``csrc/tf32_wgmma.cuh``). Operands
are float32, each (B, N, 128) operand read in place through its strides
with its 128 channels contiguous (the q and k halves of the W_qk conv's
channels-last output: rows 256 apart); q, k and v rows, and A's, 16 bytes
apart. An A the kernel cannot read in place (a transposed view) is first
copied into a layout it can.

On CPU tensors each wrapper runs its plain version; on CUDA tensors it
launches its kernel or raises. Neither kernel has a backward: a CUDA
operand that requires grad raises. Traced by ``torch.export`` (or
``torch.compile``), the wrappers call the operators
``torch.ops.raft_tpu_torch.gma_attention`` and ``.gma_aggregate``.
"""

import ctypes

import torch

from raft_tpu_torch.kernels._build import (check, count_launch, library,
                                           stream, tracing)

#: kernel launches since the counts were last set to 0
launches = {"gma_attention": 0, "gma_aggregate": 0}

#: the channels the kernels take (GMA's published ``dim_head``)
D = 128


def gma_attention_plain(q, k, scale: float) -> torch.Tensor:
    """The plain version of :func:`gma_attention`: GMA's own order, q
    scaled, then the product and the row softmax."""
    return torch.softmax(torch.matmul(q * scale, k.transpose(1, 2)), -1)


def gma_aggregate_plain(attn, v, m, gamma) -> torch.Tensor:
    """The plain version of :func:`gma_aggregate`: ``m + γ·(A v)``."""
    return m + gamma * torch.matmul(attn, v)


def _rows(name: str, *ts) -> None:
    """Check (B, N, 128) float32 operands on one CUDA device, each with its
    128 channels contiguous."""
    t0 = ts[0]
    for t in ts:
        if t.dim() != 3 or t.shape != t0.shape:
            raise ValueError(f"{name}: operands must be (B, N, D) of one "
                             f"shape, got {[tuple(x.shape) for x in ts]}")
        if t.device != t0.device or t.dtype != torch.float32:
            raise ValueError(f"{name}: float32 operands on one device")
        if t.shape[2] > 1 and t.stride(2) != 1:
            raise ValueError(f"{name}: each row's D elements must be "
                             f"contiguous (strides {t.stride()})")
        if t.requires_grad and torch.is_grad_enabled():
            raise ValueError(f"{name}: the kernel has no backward; run "
                             "under torch.no_grad()")
    B, _, d = t0.shape
    if d != D or B > 65535:
        raise ValueError(f"{name}: D={d} must be {D} and B={B} at most 65535")


def _aligned(t) -> bool:
    """Rows of ``t`` (B, N, ·) contiguous and 16 bytes apart."""
    return (t.stride(2) == 1 and t.stride(1) % 4 == 0
            and t.stride(0) % 4 == 0 and t.data_ptr() % 16 == 0)


def _rows_aligned(name: str, *ts) -> None:
    for t in ts:
        if not _aligned(t):
            raise ValueError(f"{name}: rows must start 16 bytes apart "
                             f"(strides {t.stride()})")


def _attention_buffer(B: int, N: int, device) -> torch.Tensor:
    """An empty (B, N, N) float32 A whose rows start 16 bytes apart."""
    pad = -N % 4
    buf = torch.empty((B, N, N + pad), dtype=torch.float32, device=device)
    return buf[:, :, :N] if pad else buf


def _attention(q, k, scale: float) -> torch.Tensor:
    if q.device.type == "cpu":
        return gma_attention_plain(q, k, scale)
    if q.device.type != "cuda":
        raise ValueError(f"gma_attention: no kernel for {q.device}")
    _rows("gma_attention", q, k)
    _rows_aligned("gma_attention", q, k)
    B, N, _ = q.shape
    attn = _attention_buffer(B, N, q.device)
    if q.numel():
        strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1),
                   attn.stride(0), attn.stride(1))
        with torch.cuda.device(q.device):
            code = library().lib.gma_attention_launch(
                q.data_ptr(), k.data_ptr(), attn.data_ptr(), B, N,
                float(scale), (ctypes.c_longlong * 6)(*strides), stream(q))
        check(code, "gma_attention")
        count_launch(launches, "gma_attention", q.dtype)
    return attn


def _aggregate(attn, v, m, gamma) -> torch.Tensor:
    if attn.device.type == "cpu":
        return gma_aggregate_plain(attn, v, m, gamma)
    if attn.device.type != "cuda":
        raise ValueError(f"gma_aggregate: no kernel for {attn.device}")
    _rows("gma_aggregate", v, m)
    _rows_aligned("gma_aggregate", v)
    B, N, _ = v.shape
    if (attn.shape != (B, N, N) or attn.dtype != torch.float32
            or attn.device != v.device):
        raise ValueError(f"gma_aggregate: attention {tuple(attn.shape)} "
                         f"{attn.dtype} does not fit v {tuple(v.shape)}")
    if (gamma.numel() != 1 or gamma.dtype != torch.float32
            or gamma.device != v.device):
        raise ValueError("gma_aggregate: gamma must be one float32 element "
                         "on the operands' device")
    if torch.is_grad_enabled() and (attn.requires_grad or gamma.requires_grad):
        raise ValueError("gma_aggregate: the kernel has no backward; run "
                         "under torch.no_grad()")
    out = torch.empty((B, N, D), dtype=torch.float32, device=v.device)
    if v.numel():
        if not _aligned(attn):
            attn = _attention_buffer(B, N, v.device).copy_(attn)
        strides = (attn.stride(0), attn.stride(1), v.stride(0), v.stride(1),
                   m.stride(0), m.stride(1), out.stride(0), out.stride(1))
        with torch.cuda.device(v.device):
            code = library().lib.gma_aggregate_launch(
                attn.data_ptr(), v.data_ptr(), m.data_ptr(), out.data_ptr(),
                gamma.data_ptr(), B, N, (ctypes.c_longlong * 8)(*strides),
                stream(v))
        check(code, "gma_aggregate")
        count_launch(launches, "gma_aggregate", v.dtype)
    return out


@torch.library.custom_op("raft_tpu_torch::gma_attention", mutates_args=(),
                         schema="(Tensor q, Tensor k, float scale) -> Tensor")
def gma_attention_op(q, k, scale):
    """K6 as an operator a traced program can hold."""
    return _attention(q, k, scale)


@gma_attention_op.register_fake
def _(q, k, scale):
    B, N, _ = q.shape
    pad = -N % 4
    out = q.new_empty((B, N, N + pad), dtype=torch.float32)
    return out[:, :, :N] if pad else out


@torch.library.custom_op(
    "raft_tpu_torch::gma_aggregate", mutates_args=(),
    schema="(Tensor attn, Tensor v, Tensor m, Tensor gamma) -> Tensor")
def gma_aggregate_op(attn, v, m, gamma):
    """K7 as an operator a traced program can hold."""
    return _aggregate(attn, v, m, gamma)


@gma_aggregate_op.register_fake
def _(attn, v, m, gamma):
    return v.new_empty(v.shape, dtype=torch.float32)


def gma_attention(q, k, scale: float) -> torch.Tensor:
    """K6: ``softmax_rows((scale·q) kᵀ)``, (B, N, N) float32."""
    if tracing():
        return torch.ops.raft_tpu_torch.gma_attention(q, k, float(scale))
    return _attention(q, k, scale)


def gma_aggregate(attn, v, m, gamma) -> torch.Tensor:
    """K7: ``m + γ·(A v)``, (B, N, D) float32."""
    if tracing():
        return torch.ops.raft_tpu_torch.gma_aggregate(attn, v, m, gamma)
    return _aggregate(attn, v, m, gamma)
