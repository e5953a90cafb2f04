"""Dense flash attention on Hopper: the chunked-prefill attention of the
dense slot layout (gemma2's sliding windows and logit softcaps included).

Replaces the Pallas TPU kernel ``flash_attention``
(``src/repro/kernels/flash_attention.py:116``, body ``_kernel``); the CUDA
source is ``csrc/flash_attention.cu``. Queries ``(B, Hq, Sq, D)`` attend
over ``(B, Hkv, Skv, D)`` keys and values with GQA; row ``i`` sits at kv
position ``q_offset + i``. Score ``(q.k) * D**-0.5``, then ``c*tanh(s/c)``
for a softcap ``c``, then the causal and window masks. Every operand is
passed with its strides (last dimension contiguous), so the model's
``(B, Sq, Hq, D)`` queries and a dense cache slot ``(B, Smax, Hkv, D)``
reach the kernel as transposed views, never as copies; the output is
allocated with the query's memory layout.

What bounds it on the H100: a chunk of C queries over N visible keys does
about ``4 * C * N * Hq * D`` flops against ``2 * Skv * Hkv * D *
itemsize`` bytes of KV, so prefill chunks are compute-bound, and the
tensor cores (989 TFLOP/s in bf16) are the resource. The kernel has two
paths, chosen by dtype:

- **bfloat16** (every serving path) runs the tensor-core core shared with
  the paged kernel (``csrc/attn_mma.cuh``): blocks of 4 warps and 64 query
  rows, Q held as ``ldmatrix`` fragments, 64-key K/V tiles copied with
  ``cp.async`` into a 2-stage shared-memory ring, ``mma.sync`` bf16 products
  with f32 accumulation, the online softmax in f32 registers. Its copies
  need each operand 16-byte aligned with (b, h, s) strides that are
  multiples of 8 elements; anything else raises (no fallback).
- **float32** (the parity sweeps and the f32 model phases; TF32 would not
  hold their 2e-5) keeps the CUDA-core body: 64 query rows per block in
  registers, 32-key tiles in shared memory, f32 FMAs.

Both walk only the keys their rows can see (window start to causal end,
never past ``Skv``) and mask ragged Sq rows themselves. PERF.md records the
times against the bound.

On a CPU tensor the wrapper runs the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); on a CUDA tensor it
launches the kernel or raises. ``.launches`` counts launches.

Gradient: where grad mode is on and q, k or v requires grad, the call on
the card goes through :class:`_FlashAttention`, whose forward is the
kernel and whose backward recomputes ``flash_attention_ref`` and returns
autograd's gradient of it (``_grad.plain_backward``): the gradient XLA
takes of the JAX package's jnp attention. A direct launch with such an
input raises (``_grad.refuse_grad``).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, _grad
from repro_torch.kernels.ref import flash_attention_ref

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)
_vp, _int, _f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_attention
    if fn.argtypes is None:
        fn.argtypes = [_int, _vp, _vp, _vp, _vp, _vp, _int, _int, _int, _int,
                       _int, _int, _f32, _int, _int, _f32, _int, _vp]
        fn.restype = _int
        lib.flash_rows_per_block.argtypes = []
        lib.flash_rows_per_block.restype = _int
    return lib


def _check(q, k, v, window, softcap, q_offset):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError("q must be (B, Hq, Sq, D), k/v (B, Hkv, Skv, D)")
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, Dk = k.shape
    if v.shape != k.shape or k.shape[0] != B or Dk != D or Hq % Hkv:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if D not in _HEAD_DIMS:
        raise ValueError(f"head dim {D} not in {_HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"unsupported dtype {q.dtype}")
    for t in (k, v):
        if t.dtype != q.dtype:
            raise TypeError(f"k/v dtype {t.dtype} != q {q.dtype}")
    for t in (q, k, v):
        if t.device != q.device:
            raise ValueError(f"tensors on {t.device} and {q.device}")
        if t.stride(-1) != 1:
            raise ValueError("flash attention needs a contiguous last "
                             "dimension")
    if q_offset < 0:
        raise ValueError(f"q_offset {q_offset} < 0")
    if window is not None and window <= 0:
        raise ValueError(f"window {window} must be positive")
    if softcap is not None and softcap <= 0:
        raise ValueError(f"softcap {softcap} must be positive")
    if q.dtype == torch.bfloat16:    # the tensor-core path's cp.async rows
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"bf16 {name} must start on a 16-byte "
                                 "boundary")
            if any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                   if n > 1):
                raise ValueError(f"bf16 {name} strides {t.stride()} must be "
                                 "multiples of 8 elements")


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None, q_offset: int = 0):
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D) -> (B, Hq, Sq, D).

    ``Sq`` and ``Skv`` may be any length; rows past ``Skv - q_offset``
    (padded lanes of a chunk) see keys up to ``Skv - 1`` only. The operands
    may be strided views with a contiguous last dimension (in bf16, 16-byte
    aligned with strides that are multiples of 8 elements)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for {q.device}")
    q_offset = int(q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, softcap,
                                     q_offset)
    return _launch(q, k, v, causal, window, softcap, q_offset)


class _FlashAttention(torch.autograd.Function):
    """The kernel forward; the plain version's gradient backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap, q_offset):
        ctx.save_for_backward(q, k, v)
        ctx.opts = dict(causal=causal, window=window, softcap=softcap,
                        q_offset=q_offset)
        return _launch(q, k, v, causal, window, softcap, q_offset)

    @staticmethod
    def backward(ctx, do):
        dq, dk, dv = _grad.plain_backward(
            flash_attention_ref, ctx.saved_tensors, ctx.needs_input_grad[:3],
            (do,), **ctx.opts)
        return dq, dk, dv, None, None, None, None


def _launch(q, k, v, causal, window, softcap, q_offset: int):
    """One kernel launch on CUDA tensors; raises on grad-requiring
    inputs under grad mode (the Function's forward runs without it)."""
    _grad.refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window, softcap, q_offset)
    B, Hq, Sq, D = q.shape
    _, Hkv, Skv, _ = k.shape
    G = Hq // Hkv
    o = torch.empty_like(q)           # keeps q's layout (dense views too)
    if B == 0 or Sq == 0:
        return o
    lib = _lib()
    if G > lib.flash_rows_per_block():
        raise ValueError(f"{G} query heads per kv head exceed one block")
    strides = (ctypes.c_int64 * 12)(*(s for t in (q, k, v, o)
                                      for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention(
            _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), ctypes.addressof(strides), B, Sq, Skv, Hkv, G, D,
            D ** -0.5, int(causal), int(window or 0), float(softcap or 0.0),
            q_offset, stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
